"""Sharded Fed-PLT rounds of the port over several ranks against its
unsharded run.

Each rank is a process (``torch.multiprocessing`` spawn) in one gloo
process group on a ``FileStore`` (no ports); the ranks build the port's
trainer with ``FedSpec(agent_shards=S)``, so each holds its ``N / S``
agent rows, and run 3 rounds of reduced gemma2-2b (fp32, 2 KV heads, 2
sequences of 32 tokens per agent, N_e = 2, gamma 0.05, weight decay
0.01) on the same global numpy batches and fault rows.  The test process
runs the same spec unsharded and compares the gathered row blocks of
``x``, ``z`` (and ``t``), the consensus and the metrics to rtol 1e-5 and
atol 1e-6: the reference's multi-device contract (the all-reduce adds
the ranks' partial sums, not the rows in order).

Cases: 2 ranks x N = 4 and 4 ranks x N = 4 (packed, fused); 2 ranks x
N = 6 (packed, fused: the reciprocal 1/6 is inexact); 2 ranks, packed,
the torch backend; 2 ranks, topk compression; 2 ranks, ``trimmed_mean``
f = 1 with guards, agent 1 sign-flipped and agent 3 -- on the other rank
-- evicted (the all-gather of the row blocks, and the global ``n_live``);
2 ranks, tree layout (torch backend, one all-reduce per leaf); 2 ranks,
DP noisy GD (tau 0.05, clip 1); 2 ranks, agent groups (one a rank, with
their own participation, epochs and step size) under DP noise.  Rounds draw their participation
(p = 0.7) from each rank's generator: the ranks draw the same global row
as the unsharded run, and each rank draws all N agents' DP noise and
keeps its own rows, so every agent's noise is the unsharded run's (two
agents on different ranks sharing a draw would fail the comparison).  Under topk the sharded
and unsharded increments ``z_new - t`` differ by float32 rounding, which
can swap two near-equal magnitudes at the k-th position of a segment: an
entry then differs by a whole transmitted value.  As in
``tests/test_torch_rounds_compressed.py``, such a mismatch is allowed
only in a column where an entry of the unsharded run's own increment sat
on a near-tie in some round (its magnitude rank within 3 of the
segment's kept count) -- a flipped entry of ``t`` moves the coordinator
``y`` of its column, and with it every agent's ``x`` and ``z`` there --
and at most 16 of them per state variable.  The model axis (``mesh_shape`` 1x2 on 2 ranks and 2x2 on 4, packed,
from the reference's seeded parameters, participation 1): each rank holds
a column block of the state and runs half of each agent's batch rows, so
its gradients differ from the unsharded run's by the split's float32
rounding.  Cases: mean (fused and torch backends), topk, int8,
trimmed_mean f = 1 with guards, a sign flip and an eviction,
norm_clip_mean (radius 0.5) with guards and a sign flip, and noisy GD
(tau 0.05, clip 1: the clip norm is over whole rows, the noise each
agent's unsharded draw), and at 1x2 the model with an untied LM head
(the port's own init; its ``lm_head`` a packed segment split over the
model ranks); all held to the unsharded run at rtol 1e-5 /
atol 1e-6 with the near-tie allowance for the compressors (see
``_close``), and the unsharded run of each spec to the reference's
``build_trainer`` run on the same start and batches
(``test_model_axis_specs_unsharded_match_reference``).  The dense front
end (``test_dense_meshes_match_the_reference``): the reference's problem
(N 8, q 20, n 12 and n 5) under 2x1, 1x2 and 2x2 meshes, 30 rounds,
against the reference's unsharded run, and at 50% participation (given
rows) and under a prox that is not elementwise against the port's
unsharded run.  Checkpoints of a sharded state
(``test_mesh_checkpoint_resumes_bit_for_bit``): under 2x1, 1x2 and 2x2
meshes, ``run_fed`` (packed, fused backend and update, participation
0.7, N_e 1, the port's seeded init, 2 sequences of 16 tokens an agent)
runs 4
rounds with a checkpoint every 2, and again 2 rounds, then ``resume``
to 4: each rank's block of ``x`` and ``z`` equals the uninterrupted run's
bit for bit; the round-2 file restores into the unsharded port, and
through the reference's ``restore_checkpoint``, as the ranks' gathered
round-2 blocks, bit for bit; the N 4 file (and, where the mesh splits no
columns, a tree-layout state saved under the mesh) raises a shape
mismatch in an N 8 trainer on the same mesh.  The dense trainer likewise
(``ckpt-dense-2x2``: the reference's problem at n 12, 50% participation
drawn from the generator, 4 rounds, a checkpoint, 4 more, and a resume
from it to the same round; the file restored unsharded).  The tree
layout under a model axis (each leaf's tensor-parallel dim split over
the model ranks by the reference's per-leaf specs; from the reference's
seeded parameters, participation 1): reduced falcon-mamba-7b (fused
backend), qwen2-moe-a2.7b (torch backend; 4 experts split at 1x2 and
2x2, and 6 experts at 1x4, where the expert axis does not divide and
stays whole) and gemma2-2b (fused; and under DP noise at 1x2), each
held to its unsharded run as above, and that run to the reference's
tree-layout run on the same start and batches to the tolerances of
``tests/test_torch_rounds_ssm.py`` and ``tests/test_torch_rounds_moe.py``
(1e-4 absolute, losses 1e-6 relative;
``test_tree_model_axis_unsharded_match_reference``); a tree state
checkpointed under 1x2 (``ckpt-1x2-tree``) resumes bit for bit and
restores unsharded and through the reference.  Async rounds
(K 2, packed, fused, a fixed schedule with stale arrivals on both ranks'
agents): ``2x1-async`` and ``1x2-async`` (``y_tag`` a column block)
against the unsharded port, ``y_tag``, the counters and the realised
rows included; ``ckpt-2x1-async`` resumes bit for bit with ``y_tag``, the
counters and the checkpoint's arrival rows, and its file restores
unsharded and through the reference.  All 2-rank
cases run in one
spawn of 2 processes, the 4-rank cases in another: about a minute of
wall time in all, on a CPU, with one thread per rank.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROUNDS, TOKENS = 3, 32
BASE = dict(n_epochs=2, gamma=0.05, weight_decay=0.01, participation=0.7)
FUSED = dict(engine_backend="fused", use_fused_update=True)
FLIP = [[0.0, 0.0], [-1.0, 0.0], [0.0, 0.0], [0.0, 0.0]]
LIVE = [1.0, 1.0, 1.0, 0.0]
# name -> (ranks, n_agents, spec kwargs, step kwargs)
CASES = {
    "2x4-packed-fused": (2, 4, dict(state_layout="packed", **FUSED), {}),
    "4x4-packed-fused": (4, 4, dict(state_layout="packed", **FUSED), {}),
    "2x6-packed-fused": (2, 6, dict(state_layout="packed", **FUSED), {}),
    "2x4-packed-torch": (2, 4, dict(state_layout="packed"), {}),
    "2x4-topk": (2, 4, dict(state_layout="packed", compression="topk",
                            **FUSED), {}),
    "2x4-trimmed-mean": (2, 4, dict(state_layout="packed",
                                    aggregator="trimmed_mean",
                                    aggregator_param=1,
                                    guard_increments=True, **FUSED),
                         dict(corrupt=FLIP, live=LIVE)),
    "2x4-tree": (2, 4, dict(state_layout="tree"), {}),
    "2x4-noisy-gd": (2, 4, dict(state_layout="packed", privacy=(0.05, 1.0),
                                **FUSED), {}),
    # agent groups, one a rank: per-group participation and step size,
    # each group's DP noise from its own generator (a seed drawn from the
    # round's generator on every rank)
    "2x4-groups-noisy": (2, 4, dict(
        state_layout="packed", privacy=(0.05, 1.0),
        agent_groups="2*gd:participation=0.5,2*gd:n_epochs=1:gamma=0.02",
        **FUSED), {}),
}
# the model axis: packed, from the reference's parameters, participation 1
# (the spec's mesh_shape; "ref" marks the cases that share the reference's
# start); the unsharded run of each spec is the same for both meshes
MODEL_SPECS = {
    "packed-fused": (dict(**FUSED), {}),
    "packed-torch": ({}, {}),
    "topk": (dict(compression="topk", **FUSED), {}),
    "int8": (dict(compression="int8", **FUSED), {}),
    "trimmed-mean": (dict(aggregator="trimmed_mean", aggregator_param=1,
                          guard_increments=True, **FUSED),
                     dict(corrupt=FLIP, live=LIVE)),
    "norm-clip-mean": (dict(aggregator="norm_clip_mean",
                            aggregator_param=0.5, guard_increments=True,
                            **FUSED), dict(corrupt=FLIP)),
    "noisy-gd": (dict(privacy=(0.05, 1.0), **FUSED), {}),
}
for _mesh, _ranks in (("1x2", 2), ("2x2", 4)):
    for _k, (_kw, _step) in MODEL_SPECS.items():
        CASES[f"{_mesh}-{_k}"] = (_ranks, 4, dict(
            state_layout="packed", mesh_shape=_mesh, participation=1.0,
            ref=True, **_kw), _step)
del _mesh, _ranks, _k, _kw, _step
# the untied LM head under the model axis: its (d, vocab) leaf is one
# more packed segment, split over the model ranks with the others
CASES["1x2-untied"] = (2, 4, dict(state_layout="packed", mesh_shape="1x2",
                                  participation=1.0, untied=True, **FUSED),
                       {})
# bounded-staleness async rounds (K 2) on a fixed schedule: agent 1 misses
# round 0 and arrives stale in round 1, agent 3 misses round 1 and arrives
# stale in round 2 -- on the agent axis (the two agents on different
# ranks) and on the model axis (y_tag a column block like x)
ASYNC = dict(state_layout="packed", async_mode="stale", max_staleness=2,
             **FUSED)
ASYNC_ROWS = ([1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 1.0, 0.0],
              [1.0, 0.0, 1.0, 1.0])
CASES["2x1-async"] = (2, 4, dict(ASYNC), dict(arrivals=ASYNC_ROWS))
CASES["1x2-async"] = (2, 4, dict(ASYNC, mesh_shape="1x2"),
                      dict(arrivals=ASYNC_ROWS))
# the tree layout under a model axis: each leaf's block by its spec; the
# spec's arch (and expert count) picks the reduced model; "ref": the
# reference's seeded start (of that model)
TREE_SPECS = {
    "falcon-mamba": dict(arch="falcon-mamba-7b", **FUSED),
    "qwen2-moe": dict(arch="qwen2-moe-a2.7b"),
    "gemma2": dict(arch="gemma2-2b", **FUSED),
}
for _mesh, _ranks in (("1x2", 2), ("2x2", 4)):
    for _k, _kw in TREE_SPECS.items():
        CASES[f"{_mesh}-tree-{_k}"] = (_ranks, 4, dict(
            state_layout="tree", mesh_shape=_mesh, participation=1.0,
            ref=True, **_kw), {})
del _mesh, _ranks, _k, _kw
# 6 experts over 4 model ranks: the expert axis stays whole and the
# expert leaves split their hidden dims (the reference's _sanitize)
CASES["1x4-tree-qwen2-moe-6"] = (4, 4, dict(
    state_layout="tree", mesh_shape="1x4", participation=1.0, ref=True,
    arch="qwen2-moe-a2.7b", experts=6), {})
# DP noise: each split leaf's noise drawn at its full shape and cut, the
# clip norm over whole rows (a replicated leaf counted once)
CASES["1x2-tree-gemma2-noisy"] = (2, 4, dict(
    state_layout="tree", mesh_shape="1x2", participation=1.0,
    arch="gemma2-2b", privacy=(0.05, 1.0), **FUSED), {})

# the dense front end: the reference's problem (N 8, q 20, n 12 or 5),
# packed, fused backend (plain on the CPU), N_e 2, DENSE_ROUNDS rounds;
# name -> (ranks, mesh_shape, n, participation)
DENSE_N, DENSE_Q, DENSE_ROUNDS = 8, 20, 30
DENSE = {f"dense-{m}-n{n}": (int(m[0]) * int(m[2]), m, n, 1.0)
         for m in ("2x1", "1x2", "2x2") for n in (12, 5)}
DENSE["dense-2x2-n12-p0.5"] = (4, "2x2", 12, 0.5)
# a prox that is not elementwise (the coordinator row's group shrinkage):
# under a model axis it gathers the (1, n) row over the model group
DENSE["dense-1x2-n12-group-prox"] = (2, "1x2", 12, 1.0)
GROUP_PROX = ("dense-1x2-n12-group-prox",)
# the tree layout under a model axis (the dense state's one leaf a column
# block, run as the packed round)
DENSE["dense-1x2-n12-tree"] = (2, "1x2", 12, 1.0)

# checkpoints of a sharded state: name -> (ranks, mesh_shape); run_fed
# saves every CKPT_EVERY rounds of CKPT_ROUNDS
CKPT = {"ckpt-2x1": (2, "2x1"), "ckpt-1x2": (2, "1x2"),
        "ckpt-2x2": (4, "2x2"), "ckpt-dense-2x2": (4, "2x2"),
        "ckpt-2x1-async": (2, "2x1"), "ckpt-1x2-tree": (2, "1x2")}
CKPT_ROUNDS, CKPT_EVERY, CKPT_TOKENS = 4, 2, 16


def _group_prox(v, rho_eff, lam=0.5):
    """``prox_{rho lam ||.||_2}(v)``: shrink the whole vector toward 0."""
    return v * torch.clamp(1.0 - rho_eff * lam
                           / torch.clamp(torch.linalg.vector_norm(v),
                                         min=1e-12), min=0.0)


def _spec(n_agents, kw, shards=1):
    """The case's spec: sharded over ``mesh_shape`` (or ``shards`` agent
    shards) when ``shards > 1``, unsharded otherwise."""
    from repro_torch.fed import api

    kw = {**BASE, **kw}
    for k in ("ref", "untied", "arch", "experts"):
        kw.pop(k, None)
    mesh = kw.pop("mesh_shape", None)
    if shards > 1:
        kw.update(mesh_shape=mesh) if mesh else kw.update(agent_shards=shards)
    comp = kw.pop("compression", "none")
    tau, clip = kw.pop("privacy", (0.0, None))
    return api.FedSpec(n_agents=n_agents,
                       compression=api.CompressionSpec(comp),
                       privacy=api.PrivacySpec(tau=tau, clip=clip), **kw)


def _batches(vocab, n_agents):
    rng = np.random.default_rng(n_agents)
    out = []
    for _ in range(ROUNDS):
        tok = rng.integers(0, vocab, (n_agents, 2, TOKENS))
        out.append({"tokens": torch.from_numpy(tok),
                    "labels": torch.from_numpy(np.roll(tok, -1, axis=-1))})
    return out


def _reduced(get_config, arch="gemma2-2b", experts=None, untied=False):
    """The reduced config of ``arch`` (either package's ``get_config``):
    gemma2-2b with 2 KV heads (and an untied head on request), an MoE
    model with ``experts`` experts where given."""
    cfg = get_config(arch).reduced(
        **({} if experts is None else {"n_experts": experts}))
    if arch == "gemma2-2b":
        cfg = dataclasses.replace(cfg, n_kv_heads=2,
                                  tie_embeddings=not untied)
    return cfg


def _start_key(spec_kw) -> str:
    """The reference start a case takes (one per model)."""
    return f"{spec_kw.get('arch', 'gemma2-2b')}-{spec_kw.get('experts')}"


def _model(untied=False, arch="gemma2-2b", experts=None):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = _reduced(get_config, arch, experts, untied)
    return cfg, build_model(cfg)


def _run(n_agents, spec_kw, step_kw, shards=1, params=None):
    """3 rounds of the port's trainer (this rank's block when sharded)
    from ``params`` (else the port's own seeded init): returns the state
    as plain tensors, the consensus, the metrics, and each round's
    compressed increment ``z_r - t_{r-1}`` (packed, when compressed)."""
    from repro_torch.fed import api

    cfg, model = _model(spec_kw.get("untied", False),
                        spec_kw.get("arch", "gemma2-2b"),
                        spec_kw.get("experts"))
    tr = api.build_trainer(model, _spec(n_agents, spec_kw, shards), "cpu")
    state, gen = tr.init(0, params=params)
    hist, increments = [], []
    step_kw = dict(step_kw)
    arrivals = step_kw.pop("arrivals", None)
    for r, b in enumerate(_batches(cfg.vocab, n_agents)):
        t_prev = None if state.t is None else state.t.clone()
        if arrivals is not None:
            step_kw["arrival"] = torch.tensor(arrivals[r])
        state, m = tr.step(state, b, gen, **step_kw)
        hist.append({k: float(v) if v.ndim == 0 else v.tolist()
                     for k, v in m.items()})
        if t_prev is not None:
            increments.append(state.z - t_prev)
    cons = tr.consensus(state)
    return dict(x=state.x, z=state.z, t=state.t, y_tag=state.y_tag,
                staleness=state.staleness, consensus=cons, hist=hist,
                increments=increments, meta=tr.packed_meta)


def _dense_spec(name, sharded):
    from repro_torch.fed import api

    _, mesh, _, p = DENSE[name]
    return api.FedSpec(n_agents=DENSE_N, n_epochs=2, participation=p,
                       state_layout="tree" if name.endswith("-tree")
                       else "packed", engine_backend="fused",
                       mesh_shape=mesh if sharded else None)


def _dense_run(name, out_dir, sharded):
    """The port's dense trainer on the saved problem: the state (this
    rank's block when sharded), the criterion history and the realized
    participation schedule (given rows at p < 1)."""
    from repro_torch.convert import problem_from_arrays
    from repro_torch.fed import api

    _, _, n, p = DENSE[name]
    arrays = torch.load(os.path.join(out_dir, f"dense-n{n}.pt"))
    problem = problem_from_arrays(arrays["A"].numpy(), arrays["b"].numpy())
    tr = api.build_trainer(problem, _dense_spec(name, sharded), "cpu")
    if name in GROUP_PROX:
        from repro_torch.core.fedplt import FedPLT

        tr.algo = FedPLT(tr.problem, tr.spec.to_dense_config(),
                         prox_h=_group_prox, mesh=tr.mesh)
    u = None
    if p < 1.0:
        u = torch.from_numpy((np.random.default_rng(5).random(
            (DENSE_ROUNDS, DENSE_N)) < p).astype(np.float32))
    state, crit, sched = tr.algo.run_recorded(0, DENSE_ROUNDS, u=u)
    return dict(x=state.x, z=state.z, crit=crit, sched=sched)


def _ckpt_spec(mesh_shape=None, stale=False, layout="packed"):
    """The resume cases' spec; ``stale``: async rounds, K 2."""
    from repro_torch.fed import api

    kw = dict(async_mode="stale", max_staleness=2) if stale else {}
    return api.FedSpec(n_agents=4, **{**BASE, "n_epochs": 1},
                       state_layout=layout, **FUSED, mesh_shape=mesh_shape,
                       **kw)


def _ckpt_layout(name) -> str:
    return "tree" if name.endswith("-tree") else "packed"


def _ckpt_run(name, out_dir):
    """The uninterrupted sharded ``run_fed`` of ``CKPT_ROUNDS`` rounds, and
    the same run stopped after ``CKPT_EVERY`` and resumed from its
    checkpoint: this rank's ``x`` and ``z`` of each (the stopped run's
    at its stop)."""
    from repro_torch.checkpoint import checkpoint_extra
    from repro_torch.launch.train import run_fed

    cfg, _ = _model()
    spec = _ckpt_spec(CKPT[name][1], "async" in name, _ckpt_layout(name))
    root = os.path.join(out_dir, name)
    kw = dict(seq_len=CKPT_TOKENS, batch=8, device="cpu",
              checkpoint_every=CKPT_EVERY, log=lambda *a: None)
    out = {}
    for leg, steps, resume, where in (
            ("whole", CKPT_ROUNDS, False, "whole"),
            ("first", CKPT_EVERY, False, "split"),
            ("second", CKPT_ROUNDS, True, "split")):
        _, state, _ = run_fed(cfg, spec, steps=steps, resume=resume,
                              checkpoint=os.path.join(root, where), **kw)
        out[leg] = {"x": state.x, "z": state.z, "step": state.step,
                    "y_tag": state.y_tag, "staleness": state.staleness,
                    "arrivals": checkpoint_extra(os.path.join(
                        root, where, "rounds", f"step-{steps:06d}"))[
                            "arrivals"]}
    out["refused"] = _other_agent_count(
        spec, os.path.join(root, "split", "rounds", f"step-{CKPT_EVERY:06d}"),
        os.path.join(root, "tree"))
    return out


def _other_agent_count(spec, packed_path, tree_path):
    """The errors of restoring an N 4 file into an N 8 trainer on the same
    mesh: the packed round checkpoint and, where the mesh splits no
    columns, a tree-layout state that this mesh saves (which first
    restores into its own N 4 trainer as it was saved); of a tree-layout
    run, its round checkpoint."""
    from repro_torch.fed import api

    _, model = _model()

    def refused(path, layout):
        tr = api.build_trainer(model, dataclasses.replace(
            spec, n_agents=8, state_layout=layout), "cpu")
        try:
            tr.restore_state(path, tr.init(1)[0])
        except ValueError as e:
            return str(e)
        return None

    if spec.state_layout == "tree":
        return {"tree": refused(packed_path, "tree")}
    out = {"packed": refused(packed_path, "packed")}
    if spec.mesh_shape.endswith("x1"):
        tr = api.build_trainer(model, dataclasses.replace(
            spec, state_layout="tree"), "cpu")
        state, gen = tr.init(0)
        tr.save_state(tree_path, state, gen)
        back, _ = tr.restore_state(tree_path, tr.init(1)[0])
        assert all(torch.equal(back.x[k], state.x[k]) for k in state.x)
        out["tree"] = refused(tree_path, "tree")
    return out


def _dense_ckpt_run(name, out_dir):
    """The dense trainer under the case's mesh: 4 rounds, ``save_state``,
    4 more; then the saved state restored and run the same 4 rounds.
    This rank's blocks of each."""
    from repro_torch.convert import problem_from_arrays
    from repro_torch.fed import api

    arrays = torch.load(os.path.join(out_dir, "dense-n12.pt"))
    problem = problem_from_arrays(arrays["A"].numpy(), arrays["b"].numpy())
    tr = api.build_trainer(problem, _dense_ckpt_spec(CKPT[name][1]), "cpu")
    path = os.path.join(out_dir, name, "ck")
    blocks = lambda st: {"x": st.x, "z": st.z, "y": st.y, "k": st.k}
    st = tr.init(0)
    for _ in range(4):
        st = tr.step(st)
    tr.save_state(path, st)
    out = {"first": blocks(st)}
    for leg in ("whole", "second"):
        for _ in range(4):
            st = tr.step(st)
        out[leg] = blocks(st)
        st, _ = tr.restore_state(path, tr.init(1))
    return out


def _dense_ckpt_spec(mesh_shape=None):
    from repro_torch.fed import api

    return api.FedSpec(n_agents=DENSE_N, n_epochs=2, participation=0.5,
                       state_layout="packed", engine_backend="fused",
                       mesh_shape=mesh_shape)


def _worker(rank, world, store_path, out_dir, names):
    """One rank: join the gloo group and run every case of ``names``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        params = torch.load(os.path.join(out_dir, "params.pt"))
        for name in names:
            if name in CKPT:
                run = (_dense_ckpt_run if "dense" in name else _ckpt_run)
                torch.save(run(name, out_dir),
                           os.path.join(out_dir, f"{name}-{rank}.pt"))
                continue
            if name in DENSE:
                torch.save(_dense_run(name, out_dir, True),
                           os.path.join(out_dir, f"{name}-{rank}.pt"))
                continue
            _, n_agents, spec_kw, step_kw = CASES[name]
            run = _run(n_agents, spec_kw, step_kw, shards=world,
                       params=params[_start_key(spec_kw)]
                       if spec_kw.get("ref") else None)
            torch.save({k: run[k] for k in ("x", "z", "t", "y_tag",
                                            "staleness", "consensus",
                                            "hist")},
                       os.path.join(out_dir, f"{name}-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, names, tmp, timeout=300):
    ctx = mp.start_processes(
        _worker, args=(world, str(tmp / f"store-{world}"), str(tmp), names),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {timeout} s")


@pytest.fixture(scope="module")
def reference_start():
    """The reference's seeded parameters of each reduced model that a
    ``ref`` case runs (numpy), as the port's tensors, by
    :func:`_start_key`: the model-axis cases' start."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.model import build_model as jax_build_model
    from repro_torch.convert import params_from_jax

    out = {}
    for _, _, kw, _ in CASES.values():
        key = _start_key(kw)
        if not kw.get("ref") or key in out:
            continue
        arch, experts = kw.get("arch", "gemma2-2b"), kw.get("experts")
        cfg, _ = _model(False, arch, experts)
        jcfg = _reduced(jax_get_config, arch, experts)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        out[key] = params_from_jax(tree, cfg)
    return out


@pytest.fixture(scope="module")
def dense_problems():
    """The reference's dense problems (N 8, q 20; n 12 and 5)."""
    from repro.core import problem as jproblem

    return {n: jproblem.make_logreg_problem(n_agents=DENSE_N, q=DENSE_Q,
                                            dim=n, seed=0) for n in (12, 5)}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory, reference_start, dense_problems):
    """Every case's per-rank results, from one spawn per rank count."""
    tmp = tmp_path_factory.mktemp("sharded")
    torch.save(reference_start, tmp / "params.pt")
    for n, jp in dense_problems.items():
        torch.save({"A": torch.from_numpy(np.array(jp.A)),
                    "b": torch.from_numpy(np.array(jp.b))},
                   tmp / f"dense-n{n}.pt")
    ranks = {**{k: c[0] for k, c in CASES.items()},
             **{k: c[0] for k, c in DENSE.items()},
             **{k: c[0] for k, c in CKPT.items()}}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for world in sorted(set(ranks.values())):
            _spawn(world, [k for k, r in ranks.items() if r == world], tmp)
    finally:
        torch.set_num_threads(n)
    out = {name: [torch.load(tmp / f"{name}-{r}.pt") for r in range(k)]
           for name, k in ranks.items()}
    out["dir"] = tmp
    return out


def _tree_dims(spec_kw, model) -> dict:
    """The split dim (agent axis first) of each leaf of a case's tree
    layout over ``model`` model ranks, None where it is replicated."""
    from repro_torch.fed import sharding

    _, mdl = _model(False, spec_kw.get("arch", "gemma2-2b"),
                    spec_kw.get("experts"))
    specs = sharding.param_specs(
        {n: s for n, (s, _) in mdl.param_shapes().items()}, fsdp_axis=None,
        axis_sizes={"agent": 1, "model": model})
    return {n: (1 + s.index("model") if "model" in s else None)
            for n, s in specs.items()}


def _gather(blocks, model=1, width=None, dims=None):
    """The global state from the ranks' blocks: rank ``r * model + c``
    holds agent block ``r`` and model block ``c`` (``width`` the packed
    width: the model blocks are its columns where they are narrower, and
    replicated copies otherwise, which must agree; ``dims`` a tree's
    split dim a leaf, :func:`_tree_dims`)."""
    if blocks[0] is None:
        return None
    if isinstance(blocks[0], dict):
        out = {}
        for k in blocks[0]:
            rows = []
            for r in range(len(blocks) // model):
                own = [b[k] for b in blocks[r * model:(r + 1) * model]]
                d = None if dims is None else dims[k]
                if d is None:
                    assert all(torch.equal(b, own[0]) for b in own), k
                    rows.append(own[0])
                else:
                    rows.append(torch.cat(own, d))
            out[k] = torch.cat(rows)
        return out
    rows = []
    for r in range(len(blocks) // model):
        own = blocks[r * model:(r + 1) * model]
        if own[0].shape[1] == width:
            assert all(torch.equal(b, own[0]) for b in own)
            rows.append(own[0])
        else:
            rows.append(torch.cat(own, 1))
    return torch.cat(rows)


def _near_ties(run, compression):
    """The columns of the packed state where an entry of the increments
    sat on a near-tie of the compressor in some round, as a ``(1,
    width)`` mask: for topk its magnitude rank within 3 of its (agent,
    segment)'s kept count, for int8 ``|x| / scale`` within 0.01 of a
    half (the scale of its (agent, segment))."""
    from repro_torch.kernels.compress.ref import INV_127, seg_k

    near = None
    for dz in run["increments"]:
        cur = torch.zeros(dz.shape, dtype=torch.bool)
        for a, b in run["meta"].segments:
            mag = dz[:, a:b].abs()
            if compression == "int8":
                scale = mag.amax(dim=1, keepdim=True) * INV_127
                r = mag / scale.clamp_min(1e-30)
                cur[:, a:b] = (r - torch.floor(r) - 0.5).abs() < 0.01
                continue
            k = seg_k(0.25, b - a)
            desc = torch.sort(mag, dim=1, descending=True).values
            hi = desc[:, max(k - 4, 0)][:, None]
            lo = desc[:, min(k + 2, b - a - 1)][:, None]
            cur[:, a:b] = (mag <= hi) & (mag >= lo)
        near = cur if near is None else near | cur
    return near.any(dim=0, keepdim=True)


def _close(got, want, near=None, model_axis=False):
    """rtol 1e-5, atol 1e-6; with a ``near`` mask a mismatch is allowed
    in a near-tie column (a flipped entry of ``t`` moves the coordinator
    ``y`` of its column, and with it every agent's ``x`` and ``z``
    there): at most 16 entries, or under a model axis in at most 0.2%
    of the columns (its gradients differ from the unsharded run's by the
    batch split's rounding at every epoch, and ``z_new - t``, a
    difference of nearby numbers, carries that to the increment: more
    near-ties flip, each in all N rows of its column; measured, 9 to 29
    columns under topk, 158 to 526 under int8 and 1,499 against the
    reference's int8, of 1,312,000)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
        return
    assert got.shape == want.shape
    if near is not None:
        bad = ~((got - want).abs() <= 1e-6 + 1e-5 * want.abs())
        assert not (bad & ~near).any(), (
            f"{int((bad & ~near).sum())} entries off any near-tie")
        if model_axis:
            assert int(bad.any(dim=0).sum()) <= want.shape[1] // 500
        else:
            assert int(bad.sum()) <= 16
        got = torch.where(bad, want, got)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def unsharded_runs():
    """The port's unsharded run of each spec (shared by the 1x2 and 2x2
    cases of one spec)."""
    return {}


def _unsharded(unsharded_runs, name, reference_start):
    _, n_agents, spec_kw, step_kw = CASES[name]
    key = name.split("-", 1)[1] if spec_kw.get("ref") else name
    if key not in unsharded_runs:
        unsharded_runs[key] = _run(
            n_agents, spec_kw, step_kw,
            params=reference_start[_start_key(spec_kw)]
            if spec_kw.get("ref") else None)
    return unsharded_runs[key]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rounds_match_unsharded(sharded_runs, unsharded_runs,
                                        reference_start, name):
    ranks, n_agents, spec_kw, step_kw = CASES[name]
    torch.set_num_threads(2)
    want = _unsharded(unsharded_runs, name, reference_start)
    got = sharded_runs[name]
    assert len(got) == ranks
    agents, model = ((int(e) for e in spec_kw["mesh_shape"].split("x"))
                     if "mesh_shape" in spec_kw else (ranks, 1))
    near = (_near_ties(want, spec_kw.get("compression"))
            if want["increments"] else None)
    for var in ("x", "z", "t", "y_tag"):
        if want[var] is None:
            assert all(g[var] is None for g in got)
            continue
        blocks = [g[var] for g in got]
        rows = {(b.shape[0] if isinstance(b, torch.Tensor)
                 else next(iter(b.values())).shape[0]) for b in blocks}
        assert rows == {n_agents // agents}, rows
        dims = None
        if model > 1 and isinstance(want[var], dict):
            # every split leaf is this rank's block of its dim
            dims = _tree_dims(spec_kw, model)
            assert any(d is not None for d in dims.values())
            for b in blocks:
                for k, d in dims.items():
                    if d is not None:
                        assert b[k].shape[d] * model == want[var][k].shape[d]
                    assert b[k].dtype == want[var][k].dtype
        elif model > 1:     # the reduced model's packed width splits
            assert {b.shape[1] for b in blocks} == {
                want[var].shape[1] // model}
        width = (want[var].shape[-1] if isinstance(want[var], torch.Tensor)
                 else None)
        _close(_gather(blocks, model, width, dims), want[var], near,
               model_axis=model > 1)
    if want["staleness"] is not None:
        # the counters advance locally: each rank holds its agents', the
        # same on every rank of a model group
        assert torch.equal(torch.cat([got[r * model]["staleness"]
                                      for r in range(agents)]),
                           want["staleness"])
        assert all(torch.equal(g["staleness"],
                               got[i // model * model]["staleness"])
                   for i, g in enumerate(got))
    for g in got:
        if near is None:
            _close(g["consensus"], want["consensus"])
        for hg, hw in zip(g["hist"], want["hist"]):
            np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=1e-5)
            assert hg["participation"] == hw["participation"]
            assert hg.get("arrivals") == hw.get("arrivals")
    if name == "2x4-trimmed-mean":
        # agent 3 was evicted: it never took part
        assert all(h["participation"] <= 0.75 for h in want["hist"])


def _reference_state(spec_name, cfg):
    """The reference's ``build_trainer`` run of a model-axis spec,
    unsharded (xla backend), 3 rounds from the same parameters and numpy
    batches: its final ``x``, ``z`` and ``t`` as the port's packed
    buffers, and its losses."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.fed import api as japi
    from repro.fed import compress as jcompress
    from repro.models.model import build_model as jax_build_model
    from repro_torch.convert import params_from_jax
    from repro_torch.fed import compress as tcompress

    kw, step_kw = MODEL_SPECS[spec_name]
    kw = {**BASE, **kw, "participation": 1.0}
    for k in ("engine_backend", "use_fused_update"):
        kw.pop(k, None)
    comp = kw.pop("compression", "none")
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(
        n_agents=4, state_layout="packed", engine_backend="xla",
        compression=japi.CompressionSpec(comp), **kw))
    key = jax.random.PRNGKey(0)
    state, losses = jtr.init(key), []
    rows = {k: None if v is None else jnp.asarray(np.asarray(v, np.float32))
            for k, v in (("corrupt", step_kw.get("corrupt")),
                         ("live", step_kw.get("live")))}
    for r, b in enumerate(_batches(cfg.vocab, 4)):
        state, m = jtr.step(
            state, {k: jnp.asarray(v.numpy().astype(np.int32))
                    for k, v in b.items()},
            jax.random.fold_in(key, r), **rows)
        losses.append(float(m["loss"]))

    def packed(buf):
        if buf is None:
            return None
        tree = jax.tree_util.tree_map(
            np.asarray, jcompress.unpack_leaves(buf, jtr.packed_meta))
        return tcompress.pack_leaves(params_from_jax(tree, cfg))[0]

    return dict(x=packed(state.x), z=packed(state.z),
                t=packed(state.t) if comp != "none" else None,
                losses=losses)


@pytest.mark.parametrize("spec_name", [k for k in MODEL_SPECS
                                       if k not in ("packed-torch",
                                                    "noisy-gd")])
def test_model_axis_specs_unsharded_match_reference(
        unsharded_runs, reference_start, spec_name):
    """The port's unsharded run of each model-axis spec, which the 1x2 and
    2x2 cases are held to above, against the reference's on the same
    start and batches (rtol 1e-5, atol 1e-6; topk with the near-tie
    allowance).  The torch backend shares the reference's xla run with
    the fused one (tests/test_torch_rounds.py holds both backends);
    noisy_gd's draws cannot be the reference's threefry bits, and
    tests/test_torch_rounds_dp.py holds the port's noisy rounds to the
    reference with its draws replayed."""
    torch.set_num_threads(2)
    cfg, _ = _model()
    port = _unsharded(unsharded_runs, f"1x2-{spec_name}", reference_start)
    want = _reference_state(spec_name, cfg)
    near = (_near_ties(port, MODEL_SPECS[spec_name][0].get("compression"))
            if port["increments"] else None)
    for var in ("x", "z", "t"):
        if want[var] is None:
            assert port[var] is None
            continue
        _close(port[var], want[var], near, model_axis=True)
    np.testing.assert_allclose([h["loss"] for h in port["hist"]],
                               want["losses"], rtol=1e-5)


TREE_REF = ["1x2-tree-falcon-mamba", "1x2-tree-qwen2-moe", "1x2-tree-gemma2"]


@pytest.mark.parametrize("name", TREE_REF)
def test_tree_model_axis_unsharded_match_reference(unsharded_runs,
                                                   reference_start, name):
    """The port's unsharded tree-layout run of each tree model-axis spec,
    which the 1x2 and 2x2 cases are held to above, against the
    reference's tree-layout run (xla backend) from the same start and
    batches: the states to 1e-4 absolute and the losses to 1e-6 relative,
    the tolerances of ``tests/test_torch_rounds_ssm.py`` and
    ``tests/test_torch_rounds_moe.py`` for these models' tree rounds."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.fed import api as japi
    from repro.models.model import build_model as jax_build_model
    from repro_torch.convert import params_to_jax

    torch.set_num_threads(2)
    _, n_agents, spec_kw, _ = CASES[name]
    port = _unsharded(unsharded_runs, name, reference_start)
    arch, experts = spec_kw["arch"], spec_kw.get("experts")
    cfg, _ = _model(False, arch, experts)
    jmodel = jax_build_model(_reduced(jax_get_config, arch, experts))
    jtr = japi.build_trainer(jmodel, japi.FedSpec(
        n_agents=n_agents, state_layout="tree", engine_backend="xla",
        **{**BASE, "participation": 1.0}))
    key = jax.random.PRNGKey(0)
    state, losses = jtr.init(key), []
    for r, b in enumerate(_batches(cfg.vocab, n_agents)):
        state, m = jtr.step(state, {k: jnp.asarray(v.numpy().astype(np.int32))
                                    for k, v in b.items()},
                            jax.random.fold_in(key, r))
        losses.append(float(m["loss"]))
    for var in ("x", "z"):
        want = jax.tree_util.tree_map(lambda l: np.asarray(l, np.float32),
                                      getattr(state, var))
        jax.tree_util.tree_map(
            lambda p, q: np.testing.assert_allclose(q, p, atol=1e-4, rtol=0),
            want, params_to_jax(port[var]))
    np.testing.assert_allclose([h["loss"] for h in port["hist"]], losses,
                               rtol=1e-6)


def _hit(crit, threshold):
    hit = np.flatnonzero(np.asarray(crit) <= threshold)
    return int(hit[0]) + 1 if hit.size else None


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_meshes_match_the_reference(sharded_runs, dense_problems,
                                          name):
    """The dense front end under 2x1, 1x2 and 2x2 meshes (n 12: the model
    axis splits the columns; n 5: they are replicated; at 1x2 n 12 in
    the tree layout too) against the
    reference's unsharded ``build_trainer(problem, spec).run``, as the
    reference holds its own 4x2 run to its unsharded one: the gathered
    blocks of ``x`` and ``z`` to 1e-5 absolute after 30 rounds (the
    port's closed-form gradients round at other places than ``jax.grad``:
    tests/test_torch_rounds_dense.py), the criterion history to 1e-4
    relative, and the same ``hitting_round`` of a threshold halfway (in
    log) between the reference's last two rounds above 1e-5 of its first
    (below that the criterion, a squared norm of a sum that cancels, is
    float32 rounding: the histories are held to 1e-4 relative with 1e-8
    absolute).  At 50% participation
    (given rows, which the reference's threefry draws cannot be) the mesh
    is held to the port's unsharded run instead, to rtol 1e-5 / atol 1e-6,
    with the same realized schedule; so is a 1x2 run whose coordinator
    prox is not elementwise (a group shrinkage of the whole row: the
    engine gathers the row over the model group for it)."""
    import jax

    from repro.fed import api as japi

    ranks, mesh, n, p = DENSE[name]
    agents, model = (int(e) for e in mesh.split("x"))
    got = sharded_runs[name]
    torch.set_num_threads(1)
    for g in got:       # every rank holds the global criterion
        torch.testing.assert_close(g["crit"], got[0]["crit"], rtol=0,
                                   atol=0)
        assert torch.equal(g["sched"], got[0]["sched"])
    state = {v: _gather([g[v] for g in got], model, n) for v in ("x", "z")}
    crit = got[0]["crit"].numpy()
    if p < 1.0 or name in GROUP_PROX:
        want = _dense_run(name, sharded_runs["dir"], False)
        assert torch.equal(got[0]["sched"], want["sched"])
        for v in ("x", "z"):
            _close(state[v], want[v])
        np.testing.assert_allclose(crit, want["crit"].numpy(), rtol=1e-5,
                                   atol=1e-8)
        return
    jtr = japi.build_trainer(dense_problems[n], japi.FedSpec(
        n_epochs=2, state_layout="packed", engine_backend="xla"))
    jstate, jcrit = jtr.run(jax.random.PRNGKey(0), DENSE_ROUNDS)
    jcrit = np.asarray(jcrit)
    for v in ("x", "z"):
        np.testing.assert_allclose(state[v].numpy(),
                                   np.asarray(getattr(jstate, v)), rtol=0,
                                   atol=1e-5, err_msg=v)
    np.testing.assert_allclose(crit, jcrit, rtol=1e-4, atol=1e-8)
    # the last two rounds the criterion resolves to float32 rounding
    k = int(np.flatnonzero(jcrit > 1e-5 * jcrit[0])[-1]) - 1
    threshold = float(np.sqrt(jcrit[k] * jcrit[k + 1]))
    assert _hit(crit, threshold) == _hit(jcrit, threshold) == k + 2


def _int_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", list(CKPT))
def test_mesh_checkpoint_resumes_bit_for_bit(sharded_runs, name):
    """A sharded run resumed from its checkpoint equals the uninterrupted
    sharded run bit for bit on every rank; the checkpoint (the global
    state, in the reference's columns) restores into the unsharded port
    and into the reference as the ranks' gathered blocks."""
    import jax

    from repro.checkpoint import io as jio
    from repro.configs import get_config as jax_get_config
    from repro.fed import api as japi
    from repro.models.model import build_model as jax_build_model
    from repro_torch.checkpoint import io as tio
    from repro_torch.fed import api

    torch.set_num_threads(1)
    ranks, mesh = CKPT[name]
    agents, model = (int(e) for e in mesh.split("x"))
    got = sharded_runs[name]
    if "dense" in name:
        _check_dense_ckpt(sharded_runs, name, model)
        return
    if _ckpt_layout(name) == "tree":
        _check_tree_ckpt(sharded_runs, name, model)
        return
    stale = "async" in name
    packed_vars = ("x", "z", "y_tag") if stale else ("x", "z")
    for g in got:
        assert g["second"]["step"] == g["whole"]["step"] == CKPT_ROUNDS
        # a file of N 4 does not restore into an N 8 run on this mesh
        assert set(g["refused"]) == ({"packed", "tree"} if model == 1
                                     else {"packed"})
        for layout, err in g["refused"].items():
            assert err is not None and "shape mismatch" in err, layout
        for var in packed_vars + (("staleness",) if stale else ()):
            assert torch.equal(_int_bits(g["second"][var]),
                               _int_bits(g["whole"][var])), var
        # the resumed run restored the first leg's arrival rows
        assert g["second"]["arrivals"] == g["whole"]["arrivals"]
        assert len(g["whole"]["arrivals"]) == (CKPT_ROUNDS if stale else 0)
    cfg, mdl = _model()
    path = os.path.join(sharded_runs["dir"], name, "split", "rounds",
                        f"step-{CKPT_EVERY:06d}")
    tr = api.build_trainer(mdl, _ckpt_spec(stale=stale), "cpu")
    like, _ = tr.init(1)
    state, extra = tr.restore_state(path, like)
    assert state.step == CKPT_EVERY and extra["round"] == CKPT_EVERY
    width = tr.packed_meta.width
    full = {}
    for var in packed_vars:
        blocks = [g["first"][var] for g in got]
        if model > 1:
            assert {b.shape[1] for b in blocks} == {width // model}
        full[var] = _gather(blocks, model, width)
        assert torch.equal(_int_bits(getattr(state, var)),
                           _int_bits(full[var])), var
    if stale:
        counters = torch.cat([got[r * model]["first"]["staleness"]
                              for r in range(agents)])
        assert torch.equal(state.staleness, counters)
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(
        n_agents=4, gamma=0.05, state_layout="packed",
        **(dict(async_mode="stale", max_staleness=2) if stale else {})))
    jstate = jio.restore_checkpoint(
        path, jax.eval_shape(jtr.init, jax.random.PRNGKey(0)))
    assert int(jstate.step) == CKPT_EVERY
    if stale:
        np.testing.assert_array_equal(np.asarray(jstate.staleness),
                                      counters.numpy())
    for var in packed_vars:
        ref = np.asarray(getattr(jstate, var))
        want = tio.to_reference_packed(full[var], tr.packed_meta).numpy()
        assert ref.shape == want.shape
        assert np.array_equal(ref.view(np.uint32), want.view(np.uint32)), var


def _tree_bits_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(_int_bits(a[k]), _int_bits(b[k])) for k in a)


def _check_tree_ckpt(sharded_runs, name, model):
    """The tree-layout case of :func:`test_mesh_checkpoint_resumes_bit_for_bit`:
    each rank's leaf blocks resumed bit for bit; the round-2 file (the
    gathered leaves) restored unsharded and through the reference as the
    ranks' gathered blocks."""
    import jax

    from repro.checkpoint import io as jio
    from repro.configs import get_config as jax_get_config
    from repro.fed import api as japi
    from repro.models.model import build_model as jax_build_model
    from repro_torch.convert import params_to_jax
    from repro_torch.fed import api

    got = sharded_runs[name]
    dims = _tree_dims({}, model)
    for g in got:
        assert g["second"]["step"] == g["whole"]["step"] == CKPT_ROUNDS
        assert set(g["refused"]) == {"tree"}
        assert "shape mismatch" in g["refused"]["tree"]
        for var in ("x", "z"):
            assert _tree_bits_equal(g["second"][var], g["whole"][var]), var
    _, mdl = _model()
    path = os.path.join(sharded_runs["dir"], name, "split", "rounds",
                        f"step-{CKPT_EVERY:06d}")
    tr = api.build_trainer(mdl, _ckpt_spec(layout="tree"), "cpu")
    state, extra = tr.restore_state(path, tr.init(1)[0])
    assert state.step == CKPT_EVERY and extra["round"] == CKPT_EVERY
    jcfg = _reduced(jax_get_config)
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(
        n_agents=4, gamma=0.05, state_layout="tree"))
    jstate = jio.restore_checkpoint(
        path, jax.eval_shape(jtr.init, jax.random.PRNGKey(0)))
    assert int(jstate.step) == CKPT_EVERY
    for var in ("x", "z"):
        full = _gather([g["first"][var] for g in got], model, dims=dims)
        assert _tree_bits_equal(getattr(state, var), full), var
        ref = jax.tree_util.tree_map(np.asarray, getattr(jstate, var))
        want = params_to_jax(full)
        assert jax.tree_util.tree_structure(ref) == \
            jax.tree_util.tree_structure(want)
        for r, w in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(want)):
            assert r.shape == w.shape
            assert np.array_equal(r.view(np.uint32), w.view(np.uint32)), var


def _check_dense_ckpt(sharded_runs, name, model):
    """The dense case of :func:`test_mesh_checkpoint_resumes_bit_for_bit`:
    resumed bit for bit on every rank, the file restored unsharded as the
    gathered blocks (the coordinator row ``y`` gathered by columns)."""
    from repro_torch.convert import problem_from_arrays
    from repro_torch.fed import api

    got = sharded_runs[name]
    for g in got:
        assert g["second"]["k"] == g["whole"]["k"] == 8
        for var in ("x", "z", "y"):
            assert torch.equal(_int_bits(g["second"][var]),
                               _int_bits(g["whole"][var])), var
    arrays = torch.load(os.path.join(sharded_runs["dir"], "dense-n12.pt"))
    problem = problem_from_arrays(arrays["A"].numpy(), arrays["b"].numpy())
    tr = api.build_trainer(problem, _dense_ckpt_spec(), "cpu")
    st, extra = tr.restore_state(
        os.path.join(sharded_runs["dir"], name, "ck"), tr.init(1))
    assert st.k == 4 and "generator" in extra
    for var in ("x", "z"):
        want = _gather([g["first"][var] for g in got], model, 12)
        assert torch.equal(_int_bits(getattr(st, var)), _int_bits(want)), var
    y = torch.cat([g["first"]["y"] for g in got[:model]])
    assert torch.equal(_int_bits(st.y), _int_bits(y))
