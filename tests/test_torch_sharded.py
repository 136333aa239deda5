"""The port's agent-sharded rounds, in one process: the sharded
round-edge plain versions against the reference, the 1x1 mesh against
the unsharded trainer, and the mesh validation.

Kernel tier.  The plain versions of the two sharded kernels against the
reference's ops in interpret mode, on the same numpy inputs at the
reference's test shapes:

* ``round_uplink_partial_ref`` equals ``ops.round_uplink_partial`` bit for
  bit in float32 and bfloat16 (both sum in float32 in row order and
  round once to the buffer dtype);
* ``round_downlink_presummed_ref``: the selected ``x`` bit for bit; ``z``
  bit for bit in float32 at damping 1 (``2 (w - y)`` is exact) and within
  1e-6 at damping 0.65, where XLA on the CPU contracts ``z + c (w - y)``
  into a fused multiply-add (the port rounds each operation, as its
  unsharded downlink kernel does); in bfloat16 the reference rounds
  ``c = 2 damping``, ``w - y`` and ``c (w - y)`` to bfloat16 before the
  add, the port only the result (``c`` in float32): they agree within one
  bfloat16 ulp of the result, one of ``c |w - y|``, ``c`` of ``|w - y|``,
  plus ``|c - bf16(c)| |w - y|``;
* ``round_uplink_sharded_ref`` against the reference's, jitted as its
  ``shard_map`` body is: ``y`` bit for bit where the prox is none, l1 or
  elastic_net -- XLA turns ``sum / N`` into a multiply by the float32
  reciprocal ``1/N``, as the port does (at N = 3 and N = 6 a true
  division differs) -- and everything within 1e-6 (XLA folds
  ``2 * (1/N)`` and the weight-decay scale into single constants).

Mesh of one.  The port's ``build_trainer`` with ``mesh_shape="1x1"`` (a
1-rank gloo group in this process) against its unsharded trainer, bit for
bit in float32 over packed x tree, torch x fused, compression none /
topk / int8 and aggregator mean / trimmed_mean (f = 1, with a
sign-flipped agent and an eviction): 3 rounds of reduced gemma2-2b, N =
4, participation 0.7 drawn from the trainer's generator.  And against the
reference's ``mesh_shape="1x1"`` trainer on the same converted
parameters and numpy batches: states within 1e-4, losses within 1e-5
relative (the tolerances of ``tests/test_torch_rounds.py``), N = 2 and
N = 3.

Validation mirrors ``tests/test_sharded_engine.py``.  The card-only test
(``cuda`` marker) holds the two kernels against their plain versions and
counts the launches of a 1x1-mesh round; it skips here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro.configs import get_config as jax_get_config
from repro.core import prox as jprox
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.kernels.round_edge import ops as jops
from repro.kernels.round_edge import ref as jref
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import prox as tprox
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.fed import engine as tengine
from repro_torch.kernels.round_edge import ops as tops
from repro_torch.kernels.round_edge import ref as tref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model

PROX_TABLE = [
    ("none", None, None),
    ("l1", jprox.prox_l1, tprox.make_prox("l1")),
    ("weight_decay", jprox.make_prox("weight_decay", weight=0.1),
     tprox.make_prox("weight_decay", weight=0.1)),
    ("elastic_net", jprox.make_prox("elastic_net", l1=0.3, l2=0.7),
     tprox.make_prox("elastic_net", l1=0.3, l2=0.7)),
]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs (the suite runs
    several test workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(a, dt):
    """The same values as a reference array and a port tensor."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a, jdt)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# Kernel tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n,m", [(3, 7), (8, 300), (2, 1000)])
def test_uplink_partial_plain_matches_reference(n, m, dt):
    z = np.random.default_rng(n * m).normal(size=(n, m)).astype(np.float32)
    jz, tz = _pair(z, dt)
    got = tops.round_uplink_partial(tz)
    assert got.shape == (1, m) and got.dtype == tz.dtype
    np.testing.assert_array_equal(
        _np(got), np.asarray(jops.round_uplink_partial(jz), np.float32))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("damping", [1.0, 0.65])
@pytest.mark.parametrize("n,m", [(3, 7), (6, 300), (4, 513)])
def test_downlink_presummed_plain_matches_reference(n, m, damping, dt):
    rng = np.random.default_rng(n + m)
    x, w, z = (rng.normal(size=(n, m)).astype(np.float32) for _ in range(3))
    y = rng.normal(size=(1, m)).astype(np.float32)
    w[0] = np.nan                   # a diverged solve of an inactive agent
    u = (rng.random(n) < 0.5).astype(np.float32)
    u[0] = 0.0
    (jx, tx), (jw, tw), (jz, tz), (jy, ty) = (_pair(a, dt)
                                              for a in (x, w, z, y))
    jxn, jzn = jops.round_downlink_presummed(jx, jw, jz, jy, jnp.asarray(u),
                                             damping=damping)
    txn, tzn = tops.round_downlink_presummed(tx, tw, tz, ty,
                                             torch.from_numpy(u),
                                             damping=damping)
    np.testing.assert_array_equal(_np(txn), np.asarray(jxn, np.float32))
    assert torch.equal(tzn[0], tz[0]) and torch.equal(txn[0], tx[0])
    got, want = _np(tzn), np.asarray(jzn, np.float32)
    if dt == "fp32" and damping == 1.0:
        np.testing.assert_array_equal(got, want)
    elif dt == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        def ulp(v):
            return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
                           - 7)
        c = 2.0 * damping
        c_ref = float(jnp.asarray(c, jnp.bfloat16))
        d = np.abs(_np(tw) - _np(ty))
        tol = (ulp(np.maximum(np.abs(got), np.abs(want))) + ulp(c * d)
               + c * ulp(d) + abs(c - c_ref) * d)
        assert ((got == want) | (np.abs(got - want) <= tol)).all()


@pytest.mark.parametrize("lagged", [False, True], ids=["exact", "lagged"])
@pytest.mark.parametrize("pname,jp,tp", PROX_TABLE,
                         ids=[p[0] for p in PROX_TABLE])
@pytest.mark.parametrize("n,m", [(3, 1000), (6, 300), (8, 300)])
def test_uplink_sharded_plain_matches_reference(n, m, pname, jp, tp,
                                                lagged):
    rng = np.random.default_rng(7 * n + m)
    z, t = (rng.normal(size=(n, m)).astype(np.float32) for _ in range(2))
    seen = t if lagged else None
    jy, jv = jax.jit(lambda a, b: jref.round_uplink_sharded_ref(
        a, b, jp, 0.7, n))(jnp.asarray(z),
                           None if seen is None else jnp.asarray(seen))
    ty, tv = tref.round_uplink_sharded_ref(
        torch.from_numpy(z), None if seen is None else torch.from_numpy(seen),
        tp, 0.7, n)
    if pname != "weight_decay":
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n", [3, 6])
def test_sharded_mean_is_the_reciprocal_multiply(n):
    """At an inexact 1/N the reference's compiled ``sum / N`` is a multiply
    by the float32 reciprocal -- the port's rule -- not a division."""
    s = np.random.default_rng(n).normal(size=(1, 4096)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a / n)(jnp.asarray(s)))
    part = torch.from_numpy(s)
    np.testing.assert_array_equal(
        tref.finish_coordinator(part, n).numpy(), want)
    assert not torch.equal(part / n, torch.tensor(want))


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_noise_draws_are_each_agents_own(shards):
    """A rank's DP noise, drawn with its ``agent_rows``, is its block of
    the unsharded draw from the same seed (a packed-like buffer and a
    per-agent scalar leaf): agents on different ranks never share it."""
    from repro_torch.core.solvers import draw_noise

    n, rows = 4, 4 // shards

    def tree(a):
        return {"buf": torch.zeros((a, 6, 5)), "scalar": torch.zeros((a,))}

    want = draw_noise(tree(n), 0.5, torch.Generator().manual_seed(1))
    blocks = [draw_noise(tree(rows), 0.5, torch.Generator().manual_seed(1),
                         (slice(r * rows, (r + 1) * rows), n))
              for r in range(shards)]
    for k, leaf in want.items():
        torch.testing.assert_close(torch.cat([b[k] for b in blocks]), leaf,
                                   rtol=0, atol=0)
    assert not torch.equal(blocks[0]["buf"][0], blocks[1]["buf"][0])


class _FakeMesh:
    """The parts of a ``DeviceMesh`` the placement rules read: dim
    names, shape and this rank's coordinates (no process group)."""

    mesh_dim_names = ("agent", "model")

    def __init__(self, shape, coord):
        self.shape, self._coord = shape, dict(zip(self.mesh_dim_names, coord))

    def get_local_rank(self, name):
        return self._coord[name]


def test_column_rule_splits_a_divisible_width_and_replicates_the_rest():
    """The rank at model coordinate c owns [c W/m, (c+1) W/m) when m
    divides W, every column otherwise (the reference's
    ``fed_state_specs(packed=True)`` / ``_mesh_col_axis``); the blocks of
    a divisible width tile it."""
    from repro_torch.convert import rank_block
    from repro_torch.fed import sharding

    assert [sharding.block_cols(12, 2, c) for c in range(2)] == [
        slice(0, 6), slice(6, 12)]
    assert sharding.block_cols(5, 2, 1) == slice(0, 5)
    assert sharding.block_cols(12, 1, 0) == slice(0, 12)
    for shape, width, split in (((2, 2), 12, True), ((1, 2), 5, False),
                                ((2, 1), 12, False)):
        blocks = {}
        for r in range(shape[0]):
            for c in range(shape[1]):
                mesh = _FakeMesh(shape, (r, c))
                assert sharding.cols_split(mesh, width) is split
                t = torch.arange(4 * width).reshape(4, width)
                blocks[r, c] = sharding.col_block(t, mesh)[
                    sharding.agent_rows(mesh, 4)]
                assert torch.equal(blocks[r, c], rank_block(
                    t.numpy(), shape, (r, c)))
        rows = [torch.cat([blocks[r, c] for c in range(shape[1])], 1)
                if split else blocks[r, 0] for r in range(shape[0])]
        assert torch.equal(torch.cat(rows),
                           torch.arange(4 * width).reshape(4, width))
    # a packing's segments cut to a block, in its coordinates
    assert sharding.block_segments(((0, 10), (64, 100), (128, 130)),
                                   slice(64, 128)) == ((0, 36),)
    assert sharding.fed_axes({"agent": 2, "model": 2}) == ("agent", None)
    assert sharding.fed_axes({"data": 8}) == ("data", None)
    # each agent's batch rows over the model ranks: contiguous, covering
    shares = [sharding.batch_share(_FakeMesh((1, 3), (0, c)), 8)
              for c in range(3)]
    assert shares == [slice(0, 3), slice(3, 6), slice(6, 8)]
    assert sharding.batch_share(_FakeMesh((1, 4), (0, 3)), 2) == slice(2, 2)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 1)])
def test_sharded_noise_blocks_are_the_unsharded_draw(shape):
    """Under a model axis each rank draws every agent's full row and
    keeps its rows and columns: concatenated over rows and columns the
    blocks are the unsharded draw bit for bit, so no two column blocks
    (and no two agents) share noise."""
    from repro_torch.core.solvers import StateBlock, draw_noise
    from repro_torch.fed import sharding

    n, width = 4, 10
    want = draw_noise(torch.zeros((n, width)), 0.5,
                      torch.Generator().manual_seed(1))
    rows = []
    for r in range(shape[0]):
        blocks = []
        for c in range(shape[1]):
            mesh = _FakeMesh(shape, (r, c))
            ag, cols = sharding.agent_rows(mesh, n), sharding.model_cols(
                mesh, width)
            w = torch.zeros((ag.stop - ag.start, cols.stop - cols.start))
            blocks.append(draw_noise(
                w, 0.5, torch.Generator().manual_seed(1),
                StateBlock(ag, n, cols, width)))
        rows.append(torch.cat(blocks, 1))
    torch.testing.assert_close(torch.cat(rows), want, rtol=0, atol=0)
    if shape[1] > 1:
        assert not torch.equal(rows[0][:, :width // 2],
                               rows[0][:, width // 2:])


def test_clipped_norm_under_a_model_axis_is_the_whole_rows():
    """``clip_grad`` on two column blocks, each completing its per-agent
    squares with the other's (the model group's sum), clips exactly as
    the whole rows are clipped."""
    from repro_torch.core.solvers import clip_grad

    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 12)).astype(np.float32))
    g[2] *= 1e-3                        # one row below the clip
    want = clip_grad(g.clone(), 1.0, batched=True)
    halves = [g[:, :6].clone(), g[:, 6:].clone()]
    sq = [torch.sum(h * h, dim=1) for h in halves]
    got = [clip_grad(h, 1.0, batched=True,
                     row_sum=lambda s, other=sq[1 - i]: s + other)
           for i, h in enumerate(halves)]
    torch.testing.assert_close(torch.cat(got, 1), want, rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(want[2], g[2])
    # without the model group's sum each block would clip its own norm
    alone = clip_grad(g[:, :6].clone(), 1.0, batched=True)
    assert not torch.allclose(alone, want[:, :6])


# ---------------------------------------------------------------------------
# Mesh of one: the port's 1x1 trainer against its unsharded trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _port_run(reduced, n_agents, step_kw=None, u=None, **kw):
    cfg, model, params = reduced
    tr = tapi.build_trainer(model, tapi.FedSpec(
        n_agents=n_agents, n_epochs=2, gamma=0.05, **kw), "cpu")
    state, gen = tr.init(0, params=params)
    rng = np.random.default_rng(n_agents)
    hist = []
    kernels.reset_launch_counts()
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (n_agents, 2, 32))
        b = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, axis=-1))}
        state, m = tr.step(state, b, gen, u=u, **(step_kw or {}))
        hist.append({k: float(v) for k, v in m.items()})
    return tr, state, hist


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else list(x.values())


MATRIX = [(lay, be, comp, agg) for lay in ("packed", "tree")
          for be in ("torch", "fused") for comp in ("none", "topk", "int8")
          for agg in ("mean", "trimmed_mean")]


@pytest.mark.parametrize("layout,backend,comp,agg", MATRIX,
                         ids=["-".join(c) for c in MATRIX])
def test_mesh_of_one_bitwise_matrix(reduced, layout, backend, comp, agg):
    kw = dict(state_layout=layout, engine_backend=backend,
              use_fused_update=backend == "fused",
              compression=tapi.CompressionSpec(comp), aggregator=agg,
              aggregator_param=1 if agg == "trimmed_mean" else 0,
              weight_decay=0.01, participation=0.7)
    step_kw = None
    if agg == "trimmed_mean":
        step_kw = dict(corrupt=[0.0, -1.0, 0.0, 0.0],
                       live=[1.0, 1.0, 1.0, 0.0])
    tr0, s0, h0 = _port_run(reduced, 4, step_kw, **kw)
    tr1, s1, h1 = _port_run(reduced, 4, step_kw, mesh_shape="1x1", **kw)
    assert tr0.mesh is None
    assert tmesh.mesh_axis_sizes(tr1.mesh) == {"agent": 1, "model": 1}
    assert h0 == h1
    for var in ("x", "z", "t"):
        a, b = getattr(s0, var), getattr(s1, var)
        if a is None:
            assert b is None
            continue
        for la, lb in zip(_leaves(a), _leaves(b)):
            assert torch.equal(la, lb)
    c0, c1 = tr0.consensus(s0), tr1.consensus(s1)
    assert all(torch.equal(c0[k], c1[k]) for k in c0)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain


# ---------------------------------------------------------------------------
# Against the reference's mesh of one
# ---------------------------------------------------------------------------

REFERENCE_CASES = {
    "packed-fused-N2": (2, dict(state_layout="packed",
                                engine_backend="pallas", use_pallas=True,
                                weight_decay=0.01),
                        dict(state_layout="packed", engine_backend="fused",
                             use_fused_update=True, weight_decay=0.01)),
    "packed-fused-N3": (3, dict(state_layout="packed",
                                engine_backend="pallas", use_pallas=True,
                                weight_decay=0.01),
                        dict(state_layout="packed", engine_backend="fused",
                             use_fused_update=True, weight_decay=0.01)),
    "tree-torch-N3": (3, {}, {}),
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_mesh_of_one_matches_reference_mesh_of_one(case):
    n, jkw, tkw = REFERENCE_CASES[case]
    common = dict(n_agents=n, n_epochs=2, gamma=0.05, mesh_shape="1x1")
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jmodel = jax_build_model(jcfg)
    jtr = japi.build_trainer(jmodel, japi.FedSpec(**common, **jkw))
    assert jtr.mesh is not None
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**common, **tkw),
                             device="cpu")
    key = jax.random.PRNGKey(0)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(key))
    jstate = jtr.init(key)
    tstate, gen = ttr.init(0, params=params_from_jax(tree, tcfg))
    rng = np.random.default_rng(n)
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab, (n, 2, 32)).astype(np.int32)
        lab = np.roll(tok, -1, axis=-1)
        jstate, jm = jtr.step(jstate, {"tokens": jnp.asarray(tok),
                                       "labels": jnp.asarray(lab)},
                              jax.random.fold_in(key, i))
        tstate, tm = ttr.step(tstate, {"tokens": torch.from_numpy(tok).long(),
                                       "labels": torch.from_numpy(lab).long()},
                              gen, u=torch.ones(n))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tm["participation"]) == float(jm["participation"]) == 1.0
    for var in ("x", "z"):
        jx, tx = getattr(jstate, var), getattr(tstate, var)
        if jtr.packed_meta is not None:
            jx = jcompress.unpack_leaves(jx, jtr.packed_meta)
            tx = tcompress.unpack_leaves(tx, ttr.packed_meta)
        jax.tree_util.tree_map(
            lambda p, q: np.testing.assert_allclose(q, np.asarray(p),
                                                    atol=1e-4, rtol=0),
            jax.tree_util.tree_map(np.asarray, jx), params_to_jax(tx))


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def test_spec_rejects_non_divisible_agents():
    with pytest.raises(ValueError, match="not divisible by"):
        tapi.FedSpec(n_agents=6, agent_shards=4).validate()
    with pytest.raises(ValueError, match="not divisible by"):
        tapi.FedSpec(n_agents=3, mesh_shape="2x1").validate()


def test_spec_rejects_malformed_mesh_shape():
    with pytest.raises(ValueError, match="AGENTSxMODEL"):
        tapi.FedSpec(mesh_shape="8").validate()
    with pytest.raises(ValueError, match="integers"):
        tapi.FedSpec(mesh_shape="ax1").validate()
    with pytest.raises(ValueError, match=">= 1"):
        tapi.FedSpec(mesh_shape="0x1").validate()


def test_spec_rejects_agent_shards_disagreeing_with_mesh_shape():
    with pytest.raises(ValueError, match="disagrees"):
        tapi.FedSpec(agent_shards=2, mesh_shape="4x1").validate()
    assert tapi.FedSpec(n_agents=4, agent_shards=2,
                        mesh_shape="2x1").validate().mesh_axes() == (2, 1)


def test_mesh_larger_than_the_world_raises_naming_torchrun():
    spec = tapi.FedSpec(n_agents=4, agent_shards=2).validate()
    with pytest.raises(ValueError, match="mesh of 2x1 needs 2 devices.*"
                                         "torch.distributed.run"):
        spec.build_mesh("cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_fed_mesh(2, 1, device="cpu")


def test_model_extent_above_one_validates_in_both_layouts():
    """A model axis takes the tree layout (per-leaf specs) as it takes the
    packed layout: 1x2 and 2x2 validate in both."""
    for layout in ("tree", "packed"):
        for shape in ("1x2", "2x2"):
            spec = tapi.FedSpec(n_agents=4, state_layout=layout,
                                mesh_shape=shape).validate()
            assert spec.mesh_axes() == (int(shape[0]), 2)


def test_round_config_rejects_bad_shards():
    with pytest.raises(ValueError, match="agent_shards"):
        tengine.RoundConfig(n_agents=4, agent_shards=0)
    with pytest.raises(ValueError, match="equal"):
        tengine.RoundConfig(n_agents=6, agent_shards=4)
    with pytest.raises(ValueError, match="integer"):
        tengine.RoundConfig(n_agents=4, agent_shards=1.5)


def test_validate_mesh_rejects_shard_mismatch():
    cfg = tengine.RoundConfig(n_agents=8, agent_shards=8)
    tmesh.make_fed_mesh(1, 1, device="cpu")      # the 1-rank group
    mesh = tmesh.make_host_mesh(device="cpu")
    assert tmesh.mesh_axis_sizes(mesh) == {"agent": 1, "model": 1}
    with pytest.raises(ValueError, match="agent_shards=8"):
        tengine.validate_mesh(cfg, mesh)
    tengine.validate_mesh(tengine.RoundConfig(n_agents=8), mesh)


def test_validate_mesh_requires_agent_axis():
    tmesh.make_fed_mesh(1, 1, device="cpu")      # the 1-rank group
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("rows", "cols"))
    with pytest.raises(ValueError, match="'agent'"):
        tengine.mesh_agent_shards(mesh)
    with pytest.raises(ValueError, match="'agent'"):
        tengine.validate_mesh(tengine.RoundConfig(n_agents=2), mesh)


def test_cli_shard_flags_roundtrip():
    spec = tapi.spec_from_args(["--agent-shards", "2"])
    assert spec.agent_shards == 2 and spec.resolved_agent_shards() == 2
    assert spec.round_config().agent_shards == 2
    spec = tapi.spec_from_args(["--mesh-shape", "2x1"])
    assert spec.mesh_axes() == (2, 1) and spec.resolved_agent_shards() == 2
    spec = tapi.spec_from_args([])
    assert spec.mesh_axes() is None and spec.resolved_agent_shards() == 1


def test_train_cli_runs_a_mesh_of_one(capsys):
    ttrain.main(["--arch", "gemma2-2b", "--smoke", "--steps", "2",
                 "--n-agents", "2", "--n-epochs", "1", "--seq-len", "16",
                 "--batch", "4", "--mesh-shape", "1x1", "--state-layout",
                 "packed", "--engine-backend", "fused", "--use-fused-update",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("mesh: {'agent': 1, 'model': 1} over 1 devices (agent axis "
            "sharded)") in out
    assert out.count("round ") == 2 and "done: gemma2-2b" in out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py phase 8 is their full check)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_kernels_match_plain_versions_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, w, z = (torch.randn((3, 1000), generator=gen, device=cuda_device
                           ).to(dtype) for _ in range(3))
    w[1] = float("nan")
    u = torch.tensor([1.0, 0.0, 1.0], device=cuda_device)
    kernels.reset_launch_counts()
    s = tops.round_uplink_partial(z)
    assert torch.equal(s, tref.round_uplink_partial_ref(z))
    got = tops.round_downlink_presummed(x, w, z, s, u, damping=0.65)
    want = tref.round_downlink_presummed_ref(x, w, z, u, s, 0.65)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts = kernels.launch_counts()
    assert counts["round_uplink_partial"] == 1
    assert counts["round_downlink_presummed"] == 1
