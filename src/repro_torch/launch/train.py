"""Training entry point (counterpart of ``repro/launch/train.py``, fed
mode).

Runs Fed-PLT rounds of an architecture on one device: CUDA unless
``--device cpu``.  :func:`run_fed` holds the round loop for a built
config and spec, so other scripts (``chip_smoke.py``) run the same loop
on a config cut in depth.

Example (the slice's main path, on a card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --n-agents 4 --batch 8 --seq-len 512 --n-epochs 2 \\
      --state-layout packed --engine-backend fused --use-fused-update \\
      --weight-decay 0.01

The same with the compressed z-uplink (one rank_select kernel per
round; ``--compression int8|adaptive_topk`` likewise):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --n-agents 4 --batch 8 --seq-len 512 --n-epochs 2 \\
      --state-layout packed --engine-backend fused --use-fused-update \\
      --weight-decay 0.01 --compression topk --compress-ratio 0.25

The byzantine-robust, fault-screened round (one sort_aggregate kernel
per round; ``--aggregator coord_median|norm_clip_mean`` likewise):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --n-agents 4 --batch 8 --seq-len 512 --n-epochs 2 \\
      --state-layout packed --engine-backend fused --use-fused-update \\
      --weight-decay 0.01 --aggregator trimmed_mean --aggregator-param 1 \\
      --guard-increments

Sharded rounds: one process per rank of the ``(agent, model)`` mesh,
started by torchrun (``--mesh-shape 1x1`` runs in one process, without
it); every rank draws the same global batch and keeps its agents, and
only rank 0 prints.  On cards torchrun starts one rank per card (NCCL).
Two gloo ranks on the CPU:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --n-agents 4 --agent-shards 2 --state-layout packed \\
      --engine-backend fused --use-fused-update --device cpu
The model axis (``--mesh-shape AxM``, M > 1; packed layout): each model
rank holds a column block of the state and runs a share of each agent's
batch:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --n-agents 4 --mesh-shape 1x2 --state-layout packed \\
      --engine-backend fused --use-fused-update --device cpu
The paper's dense front end (``--problem logreg``: N agents, ``--dim``
features, ``--q`` samples each; one criterion line a round), sharded the
same way:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --problem logreg \\
      --n-agents 100 --dim 100 --mesh-shape 2x2 --state-layout packed \\
      --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.problem import make_logreg_problem
from repro_torch.data.synthetic import make_batch_for
from repro_torch.fed import api
from repro_torch.models.model import build_model


def run_fed(cfg: ModelConfig, spec: api.FedSpec, *, steps: int,
            seq_len: int, batch: int, device=None, seed: int = 0,
            local_dataset_size=None, log=print):
    """``steps`` Fed-PLT rounds of ``cfg`` under ``spec`` on synthetic
    per-agent batches; logs one line per round (and the privacy position
    first when ``tau > 0``).  Returns ``(trainer, state, history)``."""
    device = resolve_device(device)
    spec.validate()
    trainer = api.build_trainer(build_model(cfg), spec, device)
    log = _mesh_log(trainer.mesh, log)
    if spec.privacy.tau > 0:
        q = local_dataset_size or max(1, batch // spec.n_agents)
        rep = trainer.privacy_report(steps, q)
        caveat = "" if spec.privacy.clip is not None else \
            " (UNCLIPPED: per-sample sensitivity assumed 1.0 -- pass --clip)"
        log(f"privacy: ({rep.adp_eps:.3f}, {rep.adp_delta:.0e})-ADP"
            f" over K={rep.K} rounds x N_e={rep.n_epochs};"
            f" ceiling as K*Ne->inf: eps={rep.eps_ceiling:.3f}"
            f" at Renyi order {rep.rdp_order:.1f}{caveat}")
    state, gen = trainer.init(seed)
    shape = InputShape("cli", seq_len, batch, "train")
    history = []
    for i in range(steps):
        b = make_batch_for(cfg, shape, gen, n_agents=spec.n_agents,
                           device=trainer.device)
        t0 = time.time()
        state, metrics = trainer.step(state, b, gen)
        m = {k: float(v) for k, v in metrics.items()}   # waits for the device
        m["dt"] = time.time() - t0
        history.append(m)
        log(f"round {i:4d} loss={m['loss']:.4f} "
            f"part={m['participation']:.2f} dt={m['dt']:.2f}s")
    return trainer, state, history


def _silent(*args, **kwargs):
    """The log of ranks other than 0."""


def _mesh_log(mesh, log):
    """The log of this rank (silent but on rank 0 of a mesh), after the
    reference's mesh line."""
    if mesh is None:
        return log
    if dist.get_rank() != 0:
        log = _silent
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    log(f"mesh: {sizes} over {mesh.size()} devices (agent axis sharded)")
    return log


def run_dense(spec: api.FedSpec, *, steps: int, dim: int, q: int,
              device=None, seed: int = 0, log=print):
    """``steps`` Fed-PLT rounds of the paper's logistic-regression
    federation (``spec.n_agents`` agents, ``dim`` features, ``q`` samples
    each, seeded); logs the criterion ``||sum_i grad f_i(x_bar)||^2`` a
    round.  Returns ``(trainer, state, criterion history)``."""
    device = resolve_device(device)
    problem = make_logreg_problem(n_agents=spec.n_agents, q=q, dim=dim,
                                  seed=seed, device=device)
    trainer = api.build_trainer(problem, spec.validate(), device)
    log = _mesh_log(trainer.mesh, log)
    t0 = time.time()
    state, crit = trainer.run(seed, steps)
    crit = crit.tolist()                      # waits for the device
    dt = (time.time() - t0) / max(steps, 1)
    for i, c in enumerate(crit):
        log(f"round {i:4d} criterion={c:.4e}")
    log(f"{dt * 1e3:.2f} ms a round")
    return trainer, state, crit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model architecture (or --problem)")
    ap.add_argument("--problem", default=None, choices=["logreg"],
                    help="the paper's dense front end instead of a model")
    ap.add_argument("--dim", type=int, default=5,
                    help="--problem: features n")
    ap.add_argument("--q", type=int, default=250,
                    help="--problem: samples a agent q_i")
    ap.add_argument("--mode", default="fed", choices=["fed"],
                    help="fed only (standard training is a later slice)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d_model 256)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local-dataset-size", type=int, default=None,
                    help="local dataset size q_i for the privacy report "
                         "(default: per-agent batch)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    api.add_spec_args(ap)
    args = ap.parse_args(argv)

    if (args.arch is None) == (args.problem is None):
        ap.error("give one of --arch and --problem")
    device = resolve_device(args.device)
    spec = api.spec_from_args(args).validate()
    if args.problem is not None:
        trainer, _, _ = run_dense(spec, steps=args.steps, dim=args.dim,
                                  q=args.q, device=device, seed=args.seed)
        if trainer.mesh is not None:
            dist.destroy_process_group()
        return
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    trainer, state, _ = run_fed(
        cfg, spec, steps=args.steps, seq_len=args.seq_len, batch=args.batch,
        device=device, seed=args.seed,
        local_dataset_size=args.local_dataset_size)
    final = trainer.consensus(state)
    if trainer.mesh is None or dist.get_rank() == 0:
        n = sum(p.numel() for p in final.values())
        print(f"done: {args.arch} ({n / 1e6:.2f}M params) on "
              f"{trainer.device}")
        if device.type == "cuda":
            print(f"peak device memory: "
                  f"{torch.cuda.max_memory_allocated(trainer.device) / 2**30:.2f}"
                  f" GiB")
    if trainer.mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
