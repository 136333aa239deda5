"""Dry run: every (architecture x input shape x mesh) case described
without allocating anything (counterpart of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k [--mode fed|standard] [--mesh 1x2] [--out f.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out f.json]

For each case the model is built on the meta device and the inputs are
meta tensors (:func:`repro_torch.models.model.input_specs`); a case
reports its parameter count, its model FLOPs (6 N D for a train shape,
times ``N_EPOCHS`` in fed mode, as the reference counts a round), the
bytes each rank of the ``AGENTSxMODEL`` mesh (:mod:`repro_torch.launch.mesh`)
holds resident, the inputs' bytes, and the H100 roofline terms
(:mod:`repro_torch.launch.roofline`) of FLOPs and bytes taken
analytically.  The reference's 16x16 and 2x16x16 TPU pods do not exist
here: the meshes are the port's ``(agent, model)`` shapes.

Resident bytes per rank, fed mode, ``N_AGENTS`` agents: the state ``x``
and ``z`` (``t`` under compression, ``y_tag`` under async rounds: one more
each) in both layouts -- the packed ``(N / agents, width / model)`` block
(:mod:`repro_torch.fed.sharding`'s column rule; None where the leaves'
dtypes differ, which the packed layout refuses) and the tree layout's
per-leaf blocks (:func:`repro_torch.fed.sharding.param_specs`).  The
other modes hold the parameters by the same per-leaf specs, and a decode
shape its cache (batch rows over the agent axis where they divide).

THE MEMORY COLUMN IS A LOWER BOUND: it counts resident state and inputs,
not activations, gradients' temporaries or the allocator's slack.  A
round's measured peak comes from the card (``chip_smoke.py --analysis``,
phase 22a).  Likewise the analytic bytes of the roofline count the state
passes of the round's edges and updates (:mod:`repro_torch.kernels.costs`)
and one read of the inputs, not the activations' traffic.

A case's status is ``ok``, ``skipped`` (the reason from
:func:`repro_torch.models.model.shape_supported`) or ``FAILED`` (the
exception); the exit code is 1 on any ``FAILED``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.fed import compress as compress_lib
from repro_torch.fed import sharding
from repro_torch.fed.api import FedSpec
from repro_torch.kernels import costs
from repro_torch.launch import roofline
from repro_torch.models import model as model_lib

MESHES = ("1x1", "1x2", "2x1")
N_AGENTS = 4          # the agents a fed case prices
N_EPOCHS = 4          # local epochs of a fed round (the reference's default)


def _elt(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    return model_lib.build_model(get_config(arch))


def parse_mesh(text: str) -> tuple:
    """``(agents, model)`` of an ``AGENTSxMODEL`` mesh (the spec's
    parser and checks)."""
    return FedSpec(mesh_shape=text).mesh_axes()


def leaf_blocks(shapes: dict, agents: int, model: int) -> dict:
    """``{name: entries this rank holds}`` of each leaf (shape without
    the agent axis) under the tree layout's per-leaf specs."""
    specs = sharding.param_specs(shapes, fsdp_axis=None,
                                 axis_sizes={"agent": agents,
                                             "model": model})
    return {n: math.prod(s) // (model if "model" in specs[n] and model > 1
                                else 1)
            for n, s in shapes.items()}


def state_bytes(mdl, n_agents: int, agents: int = 1, model: int = 1) -> dict:
    """Resident bytes a rank holds of ONE agent-stacked state buffer
    (``x``; ``z``, ``t`` and ``y_tag`` are one more each) of ``mdl`` with
    ``n_agents`` agents on an ``agents x model`` mesh: ``{"packed": bytes
    or None (mixed dtypes), "tree": bytes, "rows": agents a rank holds,
    "packed_width", "packed_cols"}``."""
    if n_agents % agents:
        raise ValueError(f"n_agents={n_agents} is not divisible by the "
                         f"mesh's agent extent {agents}")
    rows = n_agents // agents
    shapes = mdl.param_shapes()
    dtypes = {d for _, d in shapes.values()}
    held = leaf_blocks({n: s for n, (s, _) in shapes.items()}, agents, model)
    tree = rows * sum(held[n] * _elt(d) for n, (_, d) in shapes.items())
    out = {"rows": rows, "tree": tree, "packed": None, "packed_width": None,
           "packed_cols": None}
    if len(dtypes) == 1:
        meta = compress_lib.packed_meta(
            {n: torch.empty((1,) + s, dtype=d, device="meta")
             for n, (s, d) in shapes.items()})
        cols = sharding.block_cols(meta.width, model, 0)
        out.update(packed=rows * (cols.stop - cols.start) * _elt(meta.dtype),
                   packed_width=meta.width, packed_cols=cols.stop - cols.start)
    return out


def _fed_costs(mdl, agents, model, input_bytes):
    """Analytic per-device costs of one fed round (the state passes of the
    edges and each epoch's update; the collectives)."""
    st = state_bytes(mdl, N_AGENTS, agents, model)
    shapes = mdl.param_shapes()
    elt = _elt(next(iter(shapes.values()))[1])
    layout = "packed" if st["packed"] is not None else "tree"
    entries = st[layout] // elt                       # a rank's entries
    rows = st["rows"]
    per_row = entries // rows
    up = costs.round_uplink_partial(rows, per_row, elt) if agents > 1 \
        else costs.round_uplink(rows, per_row, elt, False)
    down = costs.round_downlink(rows, per_row, elt, False)
    upd = costs.fedplt_update(entries, elt, False)
    flops_state = up[0] + down[0] + N_EPOCHS * upd[0]
    nbytes = up[1] + down[1] + N_EPOCHS * upd[1] + input_bytes
    coll = {}
    if agents > 1:                       # the (1, width) partial sums
        coll["all-reduce"] = per_row * elt
    if model > 1:                        # per agent-epoch: gather, grad sum
        full_row = sum(math.prod(s) * _elt(d) for s, d in shapes.values())
        coll["all-reduce"] = coll.get("all-reduce", 0) \
            + 2 * rows * N_EPOCHS * full_row
    return flops_state, nbytes, coll, st, layout


class _Analytic:
    """The per-device counts the roofline reads, taken analytically."""

    def __init__(self, flops, nbytes, coll):
        self.flops, self.bytes = float(flops), float(nbytes)
        self.coll_by_kind = dict(coll)
        self.coll_counts = {k: 1 for k in coll}


def run_case(arch: str, shape_name: str, mesh: str = "1x1",
             mode: str = "fed", verbose: bool = True) -> dict:
    """One case's record (module docstring)."""
    result = {"arch": arch, "shape": shape_name, "mesh": mesh,
              "mode": mode}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = model_lib.shape_supported(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=reason)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh}: SKIPPED "
                  f"({reason})")
        return result
    try:
        agents, model = parse_mesh(mesh)
        mdl = _model(arch)
        n_dev = agents * model
        inputs = model_lib.input_specs(cfg, shape)
        in_bytes = _nbytes(inputs)
        shapes = {n: s for n, (s, _) in mdl.param_shapes().items()}
        held = leaf_blocks(shapes, agents, model)
        param_bytes = sum(held[n] * _elt(d)
                          for n, (_, d) in mdl.param_shapes().items())
        if shape.kind == "train" and mode == "fed":
            mf = roofline.model_flops(cfg, shape, "train") * N_EPOCHS
            flops_state, nbytes, coll, st, layout = _fed_costs(
                mdl, agents, model, in_bytes // agents)
            resident = {
                lay: (None if st[lay] is None else
                      {"x": st[lay], "z": st[lay], "t": st[lay],
                       "y_tag": st[lay], "sync": 2 * st[lay]})
                for lay in ("packed", "tree")}
            result["n_agents"], result["layout_priced"] = N_AGENTS, layout
            flops = mf / n_dev + flops_state
        else:
            mf = roofline.model_flops(cfg, shape, shape.kind)
            cache = _nbytes(inputs.get("cache", {}))
            cache_rank = (cache // agents
                          if shape.global_batch % agents == 0 else cache)
            resident = {"params": param_bytes, "cache": cache_rank}
            passes = 4 if shape.kind == "train" else 1
            nbytes = passes * param_bytes + cache_rank \
                + (in_bytes - cache) // agents
            coll = ({"all-reduce": 2 * param_bytes} if model > 1 else {})
            if shape.kind == "train" and agents > 1:
                coll["all-reduce"] = coll.get("all-reduce", 0) + param_bytes
            flops = mf / n_dev
        rl = roofline.analyze(_Analytic(flops, nbytes, coll), mf, n_dev)
    except Exception as e:  # noqa: BLE001 -- dry-run failures are bugs
        result.update(status="FAILED", error=f"{type(e).__name__}: {e}")
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh}: FAILED "
                  f"{result['error']}")
        return result
    result.update(status="ok", params=mdl.param_count(), model_flops=mf,
                  resident_bytes_per_rank=resident, input_bytes=in_bytes,
                  input_bytes_per_rank=in_bytes // agents,
                  roofline=rl.as_dict())
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh} [{mode}]: OK "
              f"params={result['params']:,} model_flops={mf:.3e} "
              f"resident/rank={_resident_line(resident)} "
              f"inputs/rank={in_bytes / agents / 1e9:.3f}GB "
              f"compute={rl.compute_s:.3e}s memory={rl.memory_s:.3e}s "
              f"collective={rl.collective_s:.3e}s -> {rl.bottleneck}")
    return result


def _resident_line(resident: dict) -> str:
    parts = []
    for k, v in resident.items():
        if isinstance(v, dict):
            v = v["sync"]
        parts.append(f"{k} {'n/a' if v is None else f'{v / 1e9:.3f}GB'}")
    return ", ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None,
                    help="AGENTSxMODEL (default: 1x1; --all: every mesh "
                         f"of {', '.join(MESHES)})")
    ap.add_argument("--mode", default="fed", choices=["fed", "standard"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None \
        else [args.shape]
    meshes = [args.mesh] if args.mesh else (MESHES if args.all else ["1x1"])
    results = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                results.append(run_case(arch, shape, mesh, args.mode))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
