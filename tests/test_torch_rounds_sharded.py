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
DP noisy GD (tau 0.05, clip 1).  Rounds draw their participation
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
and at most 16 of them per state variable.  All 2-rank cases run in
one spawn of 2 processes, the 4-rank case in another: about 30 s of wall
time in all, on a CPU, with one thread per rank.
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
}


def _spec(n_agents, kw, shards=1):
    from repro_torch.fed import api

    kw = dict(kw)
    comp = kw.pop("compression", "none")
    tau, clip = kw.pop("privacy", (0.0, None))
    return api.FedSpec(n_agents=n_agents, agent_shards=shards,
                       compression=api.CompressionSpec(comp),
                       privacy=api.PrivacySpec(tau=tau, clip=clip), **BASE,
                       **kw)


def _batches(vocab, n_agents):
    rng = np.random.default_rng(n_agents)
    out = []
    for _ in range(ROUNDS):
        tok = rng.integers(0, vocab, (n_agents, 2, TOKENS))
        out.append({"tokens": torch.from_numpy(tok),
                    "labels": torch.from_numpy(np.roll(tok, -1, axis=-1))})
    return out


def _model():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    return cfg, build_model(cfg)


def _run(n_agents, spec_kw, step_kw, shards=1):
    """3 rounds of the port's trainer (this rank's rows when sharded):
    returns the state as plain tensors, the consensus, the metrics, and
    each round's compressed increment ``z_r - t_{r-1}`` (packed, when
    compressed)."""
    from repro_torch.fed import api

    cfg, model = _model()
    tr = api.build_trainer(model, _spec(n_agents, spec_kw, shards), "cpu")
    state, gen = tr.init(0)
    hist, increments = [], []
    for b in _batches(cfg.vocab, n_agents):
        t_prev = None if state.t is None else state.t.clone()
        state, m = tr.step(state, b, gen, **step_kw)
        hist.append({k: float(v) for k, v in m.items()})
        if t_prev is not None:
            increments.append(state.z - t_prev)
    cons = tr.consensus(state)
    return dict(x=state.x, z=state.z, t=state.t, consensus=cons, hist=hist,
                increments=increments, meta=tr.packed_meta)


def _worker(rank, world, store_path, out_dir, names):
    """One rank: join the gloo group and run every case of ``names``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for name in names:
            _, n_agents, spec_kw, step_kw = CASES[name]
            run = _run(n_agents, spec_kw, step_kw, shards=world)
            torch.save({k: run[k] for k in ("x", "z", "t", "consensus",
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
def sharded_runs(tmp_path_factory):
    """Every case's per-rank results, from one spawn per rank count."""
    tmp = tmp_path_factory.mktemp("sharded")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for world in sorted({c[0] for c in CASES.values()}):
            _spawn(world, [k for k, c in CASES.items() if c[0] == world], tmp)
    finally:
        torch.set_num_threads(n)
    return {name: [torch.load(tmp / f"{name}-{r}.pt")
                   for r in range(CASES[name][0])] for name in CASES}


def _gather(blocks):
    if blocks[0] is None:
        return None
    if isinstance(blocks[0], dict):
        return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}
    return torch.cat(blocks)


def _near_ties(run):
    """The columns of the packed state where an entry of the increments
    sat on a top-k near-tie of its (agent, segment) in some round
    (magnitude rank within 3 of the kept count), as a ``(1, width)``
    mask."""
    from repro_torch.kernels.compress.ref import seg_k

    near = None
    for dz in run["increments"]:
        cur = torch.zeros(dz.shape, dtype=torch.bool)
        for a, b in run["meta"].segments:
            k = seg_k(0.25, b - a)
            mag = dz[:, a:b].abs()
            desc = torch.sort(mag, dim=1, descending=True).values
            hi = desc[:, max(k - 4, 0)][:, None]
            lo = desc[:, min(k + 2, b - a - 1)][:, None]
            cur[:, a:b] = (mag <= hi) & (mag >= lo)
        near = cur if near is None else near | cur
    return near.any(dim=0, keepdim=True)


def _close(got, want, near=None):
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
        assert int(bad.sum()) <= 16
        got = torch.where(bad, want, got)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rounds_match_unsharded(sharded_runs, name):
    ranks, n_agents, spec_kw, step_kw = CASES[name]
    torch.set_num_threads(2)
    want = _run(n_agents, spec_kw, step_kw)
    got = sharded_runs[name]
    assert len(got) == ranks
    near = _near_ties(want) if want["increments"] else None
    for var in ("x", "z", "t"):
        if want[var] is None:
            assert all(g[var] is None for g in got)
            continue
        blocks = [g[var] for g in got]
        rows = {(b.shape[0] if isinstance(b, torch.Tensor)
                 else next(iter(b.values())).shape[0]) for b in blocks}
        assert rows == {n_agents // ranks}, rows
        _close(_gather(blocks), want[var], near)
    for g in got:
        if near is None:
            _close(g["consensus"], want["consensus"])
        for hg, hw in zip(g["hist"], want["hist"]):
            np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=1e-5)
            assert hg["participation"] == hw["participation"]
    if name == "2x4-trimmed-mean":
        # agent 3 was evicted: it never took part
        assert all(h["participation"] <= 0.75 for h in want["hist"])
