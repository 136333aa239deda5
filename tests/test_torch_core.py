"""The port's prox table, packing, local solvers, privacy report and
FedSpec against the JAX reference (float32; tolerances stated per
test)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.core import solvers as jsolvers
from repro.fed import api as japi
from repro_torch.core import prox as tprox
from repro_torch.core import solvers as tsolvers
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress

TABLE = [("zero", {}), ("l1", {}), ("l2sq", {}),
         ("weight_decay", {"weight": 0.3}),
         ("elastic_net", {"l1": 0.5, "l2": 2.0}),
         ("box", {"lo": -0.2, "hi": 0.3}), ("linf_ball", {"radius": 0.25})]


@pytest.mark.parametrize("name,kw", TABLE, ids=[t[0] for t in TABLE])
def test_prox_table_matches_jax(name, kw):
    y = np.random.default_rng(0).normal(size=(257,)).astype(np.float32)
    jfn, tfn = jprox.make_prox(name, **kw), tprox.make_prox(name, **kw)
    assert tfn.elementwise
    for rho in (0.05, 0.7, 3.0):
        np.testing.assert_array_equal(
            tfn(torch.from_numpy(y), rho).numpy(), np.asarray(jfn(y, rho)))


def test_make_prox_rejects_unknown():
    with pytest.raises(ValueError, match="unknown prox"):
        tprox.make_prox("nuclear")


def _tree(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(n, 4, 5)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
            "c": torch.from_numpy(rng.normal(size=(n, 2, 2, 2)).astype(
                np.float32))}


def test_pack_unpack_round_trip_returns_views():
    tree = _tree()
    buf, meta = tcompress.pack_leaves(tree)
    assert buf.shape == (3, meta.width) and meta.width % 64 == 0
    assert meta.m_total == 20 + 3 + 8
    back = tcompress.unpack_leaves(buf, meta)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    back["b"][1, 2] = 42.0          # a view: writes land in the buffer
    s0 = meta.segments[1][0]
    assert buf[1, s0 + 2] == 42.0
    row = tcompress.unpack_row(buf[2], meta)
    assert torch.equal(row["c"], tree["c"][2])
    assert row["c"].data_ptr() == buf[2, meta.segments[2][0]:].data_ptr()


def test_pack_coord_round_trip():
    tree = _tree()
    _, meta = tcompress.pack_leaves(tree)
    coord = {k: v[0] for k, v in tree.items()}
    buf = tcompress.pack_coord(coord, meta)
    assert buf.shape == (1, meta.width)
    for k, v in tcompress.unpack_coord(buf, meta).items():
        assert torch.equal(v, coord[k])


def test_single_leaf_is_its_own_buffer():
    x = torch.randn(4, 10)
    buf, meta = tcompress.pack_leaves({"x": x})
    assert meta.width == 10 and torch.equal(buf, x)


def _quadratic(seed=0, n=3, dim=6):
    """Per-agent quadratic f_i(w) = 0.5 w'Q_i w + c_i'w on a stacked tree."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, dim, dim)).astype(np.float32)
    Q = np.einsum("nij,nkj->nik", A, A) / dim + np.eye(dim, dtype=np.float32)
    c = rng.normal(size=(n, dim)).astype(np.float32)
    w0 = {"p": rng.normal(size=(n, dim)).astype(np.float32),
          "q": rng.normal(size=(n, 2)).astype(np.float32)}
    v = {"p": rng.normal(size=(n, dim)).astype(np.float32),
         "q": rng.normal(size=(n, 2)).astype(np.float32)}

    def jgrad(w, key):
        del key
        return {"p": jnp.einsum("nij,nj->ni", Q, w["p"]) + c,
                "q": 2.0 * w["q"]}

    def tgrad(w, epoch):
        del epoch
        return {"p": torch.einsum("nij,nj->ni", torch.from_numpy(Q), w["p"])
                + torch.from_numpy(c), "q": 2.0 * w["q"]}

    return jgrad, tgrad, w0, v


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["gd", "agd", "sgd"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_local_train_matches_jax(name, clip):
    jgrad, tgrad, w0, v = _quadratic()
    cfg_kw = dict(name=name, n_epochs=4, step_size=0.05, clip=clip)
    ref = jsolvers.local_train(jgrad, w0, v, 1.0,
                               jsolvers.SolverConfig(**cfg_kw),
                               jax.random.PRNGKey(0), 0.5, 19.0,
                               batched=True)
    out = tsolvers.local_train(tgrad, _t(w0), _t(v), 1.0,
                               tsolvers.SolverConfig(**cfg_kw), 0.5, 19.0,
                               batched=True, use_fused=True)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-5)


def test_noisy_gd_with_injected_noise_matches_jax():
    """The reference draws its noise from threefry; the port replays
    those draws through its ``noise`` hook, and the iterates agree."""
    jgrad, tgrad, w0, v = _quadratic(seed=1)
    cfg_kw = dict(name="noisy_gd", n_epochs=3, step_size=0.05, tau=0.1,
                  clip=1.0)
    key = jax.random.PRNGKey(7)
    ref = jsolvers.local_train(jgrad, w0, v, 1.0,
                               jsolvers.SolverConfig(**cfg_kw), key, 0.0, 1.0,
                               batched=True, use_pallas=True)
    scale = jnp.sqrt(2.0 * 0.05) * 0.1
    keys = jax.random.split(key, 3)
    draws = [_t(jsolvers._leaf_noise(w0, jax.random.split(k)[1], scale))
             for k in keys]
    out = tsolvers.local_train(tgrad, _t(w0), _t(v), 1.0,
                               tsolvers.SolverConfig(**cfg_kw), 0.0, 1.0,
                               batched=True, use_fused=True,
                               noise=lambda e, w: draws[e])
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-5)


def test_noisy_gd_generator_draw_is_seeded():
    _, tgrad, w0, v = _quadratic(seed=2)
    cfg = tsolvers.SolverConfig(name="noisy_gd", n_epochs=2, step_size=0.05,
                                tau=0.1)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tsolvers.local_train(tgrad, _t(w0), _t(v), 1.0, cfg, 0.0, 1.0,
                                    batched=True, generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a["p"], b["p"]) and not torch.equal(a["p"], c["p"])


@pytest.mark.parametrize("kw", [dict(tau=0.01, clip=1.0),
                                dict(tau=0.5, clip=None, weight_decay=0.1)])
def test_privacy_report_matches_exactly(kw):
    kw = dict(kw)
    wd = kw.pop("weight_decay", 0.0)
    common = dict(n_agents=4, gamma=0.05, n_epochs=2, weight_decay=wd)
    jrep = japi.privacy_report(
        japi.FedSpec(privacy=japi.PrivacySpec(**kw), **common), 3, 2)
    trep = tapi.privacy_report(
        tapi.FedSpec(privacy=tapi.PrivacySpec(**kw), **common), 3, 2)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)


def test_fedspec_defaults_and_cli_match_reference():
    jdef, tdef = japi.FedSpec(), tapi.FedSpec()
    renamed = {"use_pallas": "use_fused_update"}
    for f in jdef.__dataclass_fields__:
        if f in ("privacy", "compression", "engine_backend"):
            continue
        assert getattr(tdef, renamed.get(f, f)) == getattr(jdef, f), f
    assert tdef.privacy == tapi.PrivacySpec()
    assert tdef.engine_backend == "torch"
    spec = tapi.spec_from_args(["--tau", "0.1", "--clip", "1.0",
                                "--engine-backend", "fused",
                                "--state-layout", "packed",
                                "--use-fused-update"])
    assert spec.privacy.tau == 0.1 and spec.use_fused_update
    assert spec.solver_name() == "noisy_gd"
    assert tapi.spec_from_args([]) == tapi.FedSpec(n_agents=4, gamma=0.05)


# async rounds, agent groups and the tree layout under a model axis are
# ported (tests/test_torch_async.py, tests/test_torch_groups.py, the tree
# cases of tests/test_torch_rounds_sharded.py); the case ids are those of
# the raises these specs once met
@pytest.mark.parametrize("kw,agents", [
    pytest.param(dict(state_layout="tree", mesh_shape="1x2"), 1,
                 id="kw0-tensor-parallel"),
    pytest.param(dict(async_mode="stale", max_staleness=2,
                      state_layout="tree", mesh_shape="1x2"), 1,
                 id="kw1-tensor-parallel"),
    pytest.param(dict(state_layout="tree", mesh_shape="2x2"), 2,
                 id="kw2-tensor-parallel"),
    pytest.param(dict(state_layout="tree", agent_shards=2, mesh_shape="2x2"),
                 2, id="kw3-tensor-parallel"),
])
def test_unported_fields_raise_naming_the_slice(kw, agents):
    """Each spec that once raised for the tree layout under a model axis
    validates, keeps its other fields, and resolves its agent shards from
    the mesh."""
    spec = tapi.FedSpec(n_agents=4, gamma=0.05, **kw).validate()
    assert spec.mesh_axes() == (agents, 2) and spec.state_layout == "tree"
    assert spec.resolved_agent_shards() == agents
    assert spec.async_mode == kw.get("async_mode", "off")


def test_custom_registered_solver_runs_on_the_tree_under_packing():
    """A solver outside the core set gets the tree (``wrap_packed_solver``)
    while the core gd runs on the buffer directly; both agree."""
    from repro_torch.fed import solvers as tfsolvers

    _, tgrad, w0, v = _quadratic(seed=3)
    x_buf, meta = tcompress.pack_leaves(_t(w0))
    v_buf = tcompress.pack_leaves(_t(v), meta)[0]
    seen = []

    @tfsolvers.register_solver("tree_gd_probe")
    def _factory(scfg, fgrad, rho, mu, L, **kw):
        def solver(x, v):
            seen.append(type(x))
            cfg = dataclasses.replace(scfg, name="gd")
            return tsolvers.local_train(fgrad, x, v, rho, cfg, mu, L,
                                        batched=True), None
        return solver

    def fgrad_buf(w_buf, epoch):
        g = tgrad(tcompress.unpack_leaves(w_buf, meta), epoch)
        return tcompress.pack_leaves(g, meta)[0]

    try:
        outs = {}
        for name in ("gd", "tree_gd_probe"):
            solver = tfsolvers.make_packed_local_solver(
                tsolvers.SolverConfig(name=name, n_epochs=3, step_size=0.05),
                fgrad_buf, 1.0, meta=meta)
            outs[name] = solver(x_buf, v_buf)[0]
    finally:
        tfsolvers._REGISTRY.pop("tree_gd_probe")
    assert seen == [dict]
    torch.testing.assert_close(outs["tree_gd_probe"], outs["gd"])
