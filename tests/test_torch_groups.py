"""Heterogeneous agent groups of the port against the reference, on the CPU.

* The spec: ``parse_agent_groups`` gives the reference's groups and
  errors; ``--agent-groups`` goes through the generated CLI (and
  ``launch.train``, whose DP run prints the per-agent table); the
  validation errors of both packages are equal, message for message.
* One group is the ungrouped round bit for bit (port against port): the
  dense front end (gd, agd, noisy GD and sgd with generator draws,
  partial participation, topk, async K 2) and reduced gemma2-2b (packed,
  DP with generator draws).
* Dense grouped rounds (the reference's problem, N 8, q 20, n 5), 5
  rounds with the reference's draws replayed: its participation row
  ``bernoulli(k_part, p_i)``, and group g's keys ``fold_in(k_solve, g)``
  split over its agents and then its epochs, which draw the sgd rows and
  the noise; the port takes them at the global shapes ``(N_e, N, ...)``
  with ``N_e`` the groups' largest.  Mixed gd / agd (epochs and step
  sizes per group) in both layouts and both backends, sgd beside gd,
  noisy GD groups, per-group participation; async K 2 with the
  reference's realised arrival rows.  States to 1e-5 absolute.
* Reduced gemma2-2b cut to one layer (fp32, 2 KV heads, N 4,
  ``2*gd,2*agd:n_epochs=1:gamma=0.02``, 2 sequences of 32 tokens an
  agent; one layer keeps the reference's compiles short), 3 rounds from the
  reference's parameters: packed with the fused backend and update
  against the reference's packed pallas run, and the tree layout with the
  torch backend against its tree xla run; states 1e-4 absolute, losses
  1e-6 relative.  One noisy-GD grouped round with the reference's
  per-group draws replayed (``noise(epoch, w)`` returns the epoch's draw
  for every agent, each group keeps its rows); async K 0 bit for bit the
  synchronous grouped round with generator draws.
* ``privacy_report`` with per-agent q_i and with a grouped spec, and
  ``effective_privacy_report`` under groups: the reference's ``adp_eps``
  and table to 1e-12 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import problem as jproblem
from repro.core import solvers as jsolvers
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.convert import problem_from_arrays
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.fed import engine as tengine
from repro_torch.models.model import build_model

BACKENDS = {"torch": "xla", "fused": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The dense problems are tiny: one intra-op thread runs them faster
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The spec: grammar, CLI, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "2*gd,2*agd", "3*gd:participation=0.5,1*agd:n_epochs=1:gamma=0.02",
    "3", " 2*gd , 1*sgd:n_epochs=4 "])
def test_grammar_matches_reference(text):
    assert ([dataclasses.astuple(g) for g in tapi.parse_agent_groups(text)]
            == [dataclasses.astuple(g) for g in japi.parse_agent_groups(text)])


@pytest.mark.parametrize("text", ["gd*2", "2*gd:epochs=3", "2*gd,,1",
                                  "2*gd:n_epochs"])
def test_grammar_errors_match_reference(text):
    with pytest.raises(ValueError) as want:
        japi.parse_agent_groups(text)
    with pytest.raises(ValueError) as got:
        tapi.parse_agent_groups(text)
    assert str(got.value) == str(want.value)


def test_agent_groups_cli_round_trip():
    argv = ["--n-agents", "5", "--gamma", "0.05",
            "--agent-groups", "3*gd:participation=0.5,2*agd:n_epochs=1"]
    spec = tapi.spec_from_args(argv).validate()
    jspec = japi.spec_from_args(argv).validate()
    assert ([dataclasses.astuple(g) for g in spec.resolved_groups()]
            == [dataclasses.astuple(g) for g in jspec.resolved_groups()])
    assert spec.participation_schedule() == jspec.participation_schedule() \
        == (0.5,) * 3 + (1.0,) * 2
    assert spec.round_config().participation == \
        jspec.round_config().participation
    assert [dataclasses.astuple(c) for c in spec.group_solver_configs()] == \
        [dataclasses.astuple(c) for c in jspec.group_solver_configs()]
    assert tapi.FedSpec(agent_groups="2*gd").agent_groups == \
        (tapi.AgentGroupSpec(size=2, solver="gd"),)


def test_train_cli_prints_the_per_agent_table(capsys):
    from repro_torch.launch import train

    train.main(["--arch", "gemma2-2b", "--smoke", "--steps", "1",
                "--seq-len", "16", "--batch", "4", "--state-layout",
                "packed", "--tau", "0.01", "--clip", "1.0", "--device",
                "cpu", "--agent-groups", "2*gd,2*gd:n_epochs=1:gamma=0.02"])
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if l.startswith("  agent")]
    assert len(rows) == 4 and "N_e=1 gamma=0.02" in rows[3]
    assert "N_e=5 gamma=0.05" in rows[0] and "round    0" in out


BAD_SPECS = [
    dict(n_agents=4, gamma=0.1, agent_groups="2*gd,1*agd"),
    dict(n_agents=4, gamma=0.1, agent_groups="2*gd,2*gd:n_epochs=0"),
    dict(n_agents=2, gamma=0.1, agent_groups="2*gd:participation=1.5"),
    dict(n_agents=4, gamma=0.1, agent_groups="2*gd,2*gd:gamma=-1"),
    dict(n_agents=2, agent_groups="2*agd:gamma=2.0"),
    dict(n_agents=2, gamma=0.1, L=0.5, mu=1.0, agent_groups="2*agd"),
    dict(n_agents=2, gamma=0.1, agent_groups="2*agd", tau=0.1),
    dict(n_agents=2, gamma=0.1, agent_groups="2*warp"),
    dict(n_agents=2, gamma=0.1, agent_groups="0*gd,2*gd"),
    dict(n_agents=2, gamma=0.1, agent_groups=()),
    dict(n_agents=4, gamma=0.1, agent_groups="1*gd,3*agd", agent_shards=2),
    dict(n_agents=8, gamma=0.1, agent_groups="3*gd,5*agd", mesh_shape="4x1"),
]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_validation_errors_match_reference(kw):
    kw = dict(kw)
    tau = kw.pop("tau", 0.0)
    with pytest.raises(ValueError) as want:
        japi.FedSpec(privacy=japi.PrivacySpec(tau=tau), **kw).validate()
    with pytest.raises(ValueError) as got:
        tapi.FedSpec(privacy=tapi.PrivacySpec(tau=tau), **kw).validate()
    assert str(got.value) == str(want.value)


def test_engine_refuses_uncovered_groups():
    cfg = tengine.RoundConfig(n_agents=4)
    x = torch.zeros((4, 2))
    dummy = tengine.SolverGroup(3, lambda x, v: (x, None))
    with pytest.raises(ValueError, match="cover 3 agents"):
        tengine.round_step(cfg, x, x, x, [dummy], u=torch.ones(4))


def test_groups_write_their_rows_of_one_output():
    """Two groups, one solver taking ``out=`` and one that does not: each
    writes its rows, and the auxes come back in group order."""
    x = torch.arange(12.0).reshape(4, 3)

    def plus(k):
        def solver(xs, vs):
            return xs + k, torch.full((1, xs.shape[0]), float(k))
        return solver

    def into(xs, vs, out=None):
        return out.copy_(xs * 2), None
    into.takes_out = True
    w, aux = tengine.run_solvers(
        (tengine.SolverGroup(1, plus(5)), tengine.SolverGroup(2, into),
         tengine.SolverGroup(1, plus(7))), x, x, 4)
    assert torch.equal(w, torch.cat([x[:1] + 5, x[1:3] * 2, x[3:] + 7]))
    assert aux[1] is None and aux[0].tolist() == [[5.0]]
    assert aux[2].tolist() == [[7.0]]


# ---------------------------------------------------------------------------
# Dense front end
# ---------------------------------------------------------------------------

N, Q, DIM, ROUNDS = 8, 20, 5, 5


@pytest.fixture(scope="module")
def problems():
    jp = jproblem.make_logreg_problem(n_agents=N, q=Q, dim=DIM, seed=0)
    return jp, problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b))


def _specs(kw):
    kw = dict(kw)
    tau = kw.pop("tau", 0.0)
    comp = kw.pop("compression", "none")
    jkw, tkw = dict(kw), dict(kw)
    if "engine_backend" in jkw:
        jkw["engine_backend"] = BACKENDS[jkw["engine_backend"]]
    return (japi.FedSpec(privacy=japi.PrivacySpec(tau=tau),
                         compression=japi.CompressionSpec(comp), **jkw),
            tapi.FedSpec(privacy=tapi.PrivacySpec(tau=tau),
                         compression=tapi.CompressionSpec(comp), **tkw))


def _group_draws(jtr, key, batch_size):
    """The draws of the reference's grouped dense round from ``key``: the
    participation row, then the sgd rows and the standard-normal noise of
    each group's agents (keys ``fold_in(k_solve, g)``), at the port's
    global shapes ``(N_e, N, ...)``, ``N_e`` the groups' largest."""
    _, k_part, k_solve = jax.random.split(key, 3)
    p = jtr.algo._ecfg.participation
    p = jnp.asarray(p, jnp.float32) if isinstance(p, tuple) else p
    u = np.asarray(jax.random.bernoulli(k_part, p, (N,)), np.float32)
    groups = jtr.algo._solvers
    if not isinstance(groups, tuple):      # one group: the key unchanged
        groups = ((N, jtr.algo.cfg.solver, k_solve),)
    else:
        cfgs = [c for _, c in jtr._resolved_groups]
        groups = tuple((g.size, cfgs[i], jax.random.fold_in(k_solve, i))
                       for i, g in enumerate(groups))
    n_epochs = max(c.n_epochs for _, c, _ in groups)
    idx = np.zeros((n_epochs, N, batch_size or 1), np.int64)
    noise = np.zeros((n_epochs, N, DIM), np.float32)
    start = 0
    for size, scfg, k_g in groups:
        for i, k in enumerate(jax.random.split(k_g, size)):
            for e, ke in enumerate(jax.random.split(k, scfg.n_epochs)):
                if scfg.name == "sgd" and batch_size:
                    idx[e, start + i] = np.asarray(jax.random.randint(
                        ke, (batch_size,), 0, Q))
                noise[e, start + i] = np.asarray(jax.random.normal(
                    jax.random.split(ke)[1], (DIM,)))
        start += size
    return u, idx, noise


def _dense_replay(problems, kw, rounds=ROUNDS, arrivals=None):
    jp, tp = problems
    jspec, tspec = _specs(kw)
    jtr = japi.build_trainer(jp, jspec)
    jtr._resolved_groups = tuple(
        (g.size, c) for g, c in zip(jtr._resolved.resolved_groups() or (),
                                    jtr._resolved.group_solver_configs()
                                    or ()))
    ttr = tapi.build_trainer(tp, tspec, device="cpu")
    jstate = jtr.init(jax.random.PRNGKey(3))
    tstate = ttr.init(0, x0=np.asarray(jstate.x))
    for r in range(rounds):
        u, idx, noise = _group_draws(jtr, jstate.key, jspec.batch_size)
        draws = dict(batch_idx=idx, noise=noise)
        if arrivals is None:
            jstate = jtr.step(jstate)
            tstate = ttr.step(tstate, u=u, **draws)
        else:
            jstate, ju = jtr.round_with_faults(jstate, arrivals[r])
            tstate, tu = ttr.round_with_faults(
                tstate, torch.from_numpy(np.asarray(arrivals[r])), **draws)
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    for var in ("x", "z", "t", "y_tag"):
        j, t = getattr(jstate, var, None), getattr(tstate, var)
        if j is None:
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5, err_msg=f"{kw}: {var}")
    return jtr, ttr, jstate, tstate


DENSE_GROUPS = {
    "gd-agd": dict(agent_groups="5*gd,3*agd:n_epochs=2"),
    "gd-agd-gamma-fused-packed": dict(
        gamma=0.2, agent_groups="4*gd:n_epochs=3,4*agd:gamma=0.1",
        engine_backend="fused", state_layout="packed"),
    "gd-agd-fused-tree": dict(agent_groups="5*gd,3*agd:n_epochs=2",
                              engine_backend="fused"),
    "sgd-gd": dict(batch_size=5, agent_groups="3*sgd:n_epochs=6,5*gd"),
    "noisy": dict(tau=0.02, agent_groups="3*gd:n_epochs=7,5*gd:gamma=0.2"),
    "participation": dict(
        agent_groups="3*gd:participation=0.5,5*agd:participation=0.8",
        state_layout="packed"),
    "three-groups-topk": dict(
        agent_groups="2*gd,3*agd:n_epochs=1,3*gd:participation=0.6",
        compression="topk", damping=0.5),
}


@pytest.mark.parametrize("name", list(DENSE_GROUPS))
def test_dense_grouped_rounds_match_reference(problems, name):
    _dense_replay(problems, DENSE_GROUPS[name])


def test_dense_grouped_async_matches_reference(problems):
    """K 2 with per-group participation: the reference's realised arrival
    rows (stale arrivals and forced ones) given to the port."""
    jp, _ = problems
    kw = dict(agent_groups="4*gd:participation=0.4,4*agd:n_epochs=2",
              async_mode="stale", max_staleness=2)
    jtr = japi.build_trainer(jp, _specs(kw)[0])
    _, _, sched = jtr.run_recorded(jax.random.PRNGKey(3), ROUNDS)
    sched = np.asarray(sched)
    assert 0 < sched.sum() < sched.size
    _, _, jstate, tstate = _dense_replay(problems, kw, arrivals=sched)
    assert torch.equal(tstate.staleness, torch.from_numpy(
        np.asarray(jstate.staleness)).to(torch.int32))


HOMOGENEOUS = {
    "gd": {}, "agd": dict(solver="agd"), "noisy": dict(tau=0.02),
    "sgd": dict(solver="sgd", batch_size=5),
    "p0.6-topk-packed": dict(participation=0.6, compression="topk",
                             state_layout="packed"),
    "async-K2": dict(participation=0.5, async_mode="stale",
                     max_staleness=2),
}


@pytest.mark.parametrize("name", list(HOMOGENEOUS))
def test_one_dense_group_is_the_ungrouped_round(problems, name):
    _, tp = problems
    kw = HOMOGENEOUS[name]
    runs = []
    for groups in (None, "8"):
        spec = _specs(dict(kw, agent_groups=groups))[1]
        runs.append(tapi.build_trainer(tp, spec, device="cpu").run(5, 6))
    (a, ca), (b, cb) = runs
    assert torch.equal(ca, cb)
    for var in ("x", "z", "t", "y_tag"):
        if getattr(a, var) is not None:
            assert torch.equal(getattr(a, var), getattr(b, var)), var


def test_dense_group_participation_freezes_a_group(problems):
    """A group at a (nearly) zero rate never takes part: its rows keep
    their zero start while the others move."""
    _, tp = problems
    spec = tapi.FedSpec(n_epochs=2,
                        agent_groups="2*gd:participation=1e-6,6*agd")
    state, _ = tapi.build_trainer(tp, spec, device="cpu").run(0, 10)
    assert state.x[:2].abs().max() == 0.0
    assert state.x[2:].abs().min() > 0.0


# ---------------------------------------------------------------------------
# Model scale: reduced gemma2-2b
# ---------------------------------------------------------------------------

MN, MROUNDS = 4, 3
GROUPS = "2*gd,2*agd:n_epochs=1:gamma=0.02"
MCOMMON = dict(n_agents=MN, n_epochs=2, gamma=0.05, agent_groups=GROUPS)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jax_get_config("gemma2-2b").reduced(n_layers=1), n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(n_layers=1),
                               n_kv_heads=2)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    toks = [rng.integers(0, jcfg.vocab, (MN, 2, 32)).astype(np.int32)
            for _ in range(MROUNDS)]
    return dict(jmodel=jmodel, tmodel=build_model(tcfg), tcfg=tcfg,
                params=params_from_jax(tree, tcfg),
                jbatches=[{"tokens": jnp.asarray(t),
                           "labels": jnp.asarray(np.roll(t, -1, -1))}
                          for t in toks],
                tbatches=[{"tokens": torch.from_numpy(t).long(),
                           "labels": torch.from_numpy(
                               np.roll(t, -1, -1)).long()} for t in toks])


def _trees(trainer, x, port):
    if trainer.packed_meta is not None:
        x = (tcompress if port else jcompress).unpack_leaves(
            x, trainer.packed_meta)
    return params_to_jax(x) if port else jax.tree_util.tree_map(np.asarray, x)


def _close(jtr, jstate, ttr, tstate, atol=1e-4):
    for var in ("x", "z"):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(b, a, atol=atol, rtol=0),
            _trees(jtr, getattr(jstate, var), False),
            _trees(ttr, getattr(tstate, var), True))


MODEL_CASES = {
    "packed-fused": (dict(state_layout="packed", engine_backend="pallas",
                          use_pallas=True, weight_decay=0.01),
                     dict(state_layout="packed", engine_backend="fused",
                          use_fused_update=True, weight_decay=0.01)),
    "tree-torch": ({}, {}),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_grouped_model_rounds_match_reference(models, name):
    jkw, tkw = MODEL_CASES[name]
    jtr = japi.build_trainer(models["jmodel"], japi.FedSpec(**MCOMMON, **jkw))
    ttr = tapi.build_trainer(models["tmodel"], tapi.FedSpec(**MCOMMON, **tkw),
                             device="cpu")
    key = jax.random.PRNGKey(0)
    jstate = jtr.init(key)
    tstate, gen = ttr.init(0, params=models["params"])
    kernels.reset_launch_counts()
    for i in range(MROUNDS):
        jstate, jm = jtr.step(jstate, models["jbatches"][i],
                              jax.random.fold_in(key, i))
        tstate, tm = ttr.step(tstate, models["tbatches"][i], gen)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        assert float(tm["participation"]) == 1.0
    _close(jtr, jstate, ttr, tstate)
    # on the CPU the kernels' wrappers take their plain versions
    assert set(kernels.launch_counts().values()) == {0}


def test_noisy_grouped_round_replays_reference_draws(models):
    tau, clip = 0.01, 1.0
    groups = "2*gd,2*gd:n_epochs=1:gamma=0.02"
    common = dict(MCOMMON, agent_groups=groups, state_layout="packed",
                  weight_decay=0.01)
    jtr = japi.build_trainer(models["jmodel"], japi.FedSpec(
        **common, privacy=japi.PrivacySpec(tau=tau, clip=clip)))
    ttr = tapi.build_trainer(models["tmodel"], tapi.FedSpec(
        **common, privacy=tapi.PrivacySpec(tau=tau, clip=clip),
        engine_backend="fused", use_fused_update=True), device="cpu")
    key = jax.random.PRNGKey(5)
    jstate0 = jtr.init(jax.random.PRNGKey(0))
    jstate, jm = jtr.step(jstate0, models["jbatches"][0], key)

    # the reference's keys: group g solves under fold_in(k_solve, g), one
    # key an epoch, its noise _leaf_noise(split(k)[1]) over the group rows
    _, _, k_solve = jax.random.split(jax.random.fold_in(key, 0), 3)
    shapes = jcompress.unpack_leaves(jstate0.x, jtr.packed_meta)
    draws = [torch.zeros_like(tcompress.pack_leaves(
        params_from_jax(jax.tree_util.tree_map(np.asarray, shapes),
                        models["tcfg"]), ttr.packed_meta)[0])
        for _ in range(2)]
    start = 0
    for g, (size, epochs, gamma) in enumerate(((2, 2, 0.05), (2, 1, 0.02))):
        rows = jax.tree_util.tree_map(lambda l: l[start:start + size], shapes)
        k_g = jax.random.fold_in(k_solve, g)
        for e, k in enumerate(jax.random.split(k_g, epochs)):
            noise = jsolvers._leaf_noise(rows, jax.random.split(k)[1],
                                         jnp.sqrt(2.0 * gamma) * tau)
            tree = params_from_jax(jax.tree_util.tree_map(np.asarray, noise),
                                   models["tcfg"])
            draws[e][start:start + size] = tcompress.pack_leaves(
                tree, ttr.packed_meta)[0]
        start += size
    t0, _ = ttr.init(0, params=models["params"])
    tstate, tm = ttr.step(t0, models["tbatches"][0],
                          noise=lambda e, w: draws[e])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    _close(jtr, jstate, ttr, tstate)


def test_one_model_group_and_async_k0_bit_for_bit(models):
    """Reduced gemma2-2b, packed, DP (generator draws), participation
    0.5, 2 rounds: one group equals the ungrouped round, and the grouped
    round under async K 0 equals the synchronous grouped round."""
    base = dict(n_agents=MN, n_epochs=2, gamma=0.05, participation=0.5,
                state_layout="packed",
                privacy=tapi.PrivacySpec(tau=0.01, clip=1.0))
    specs = {"plain": {}, "one-group": dict(agent_groups="4"),
             "groups": dict(agent_groups="2*gd,2*gd:n_epochs=1"),
             "groups-K0": dict(agent_groups="2*gd,2*gd:n_epochs=1",
                               async_mode="stale", max_staleness=0)}
    out = {}
    for name, kw in specs.items():
        tr = tapi.build_trainer(models["tmodel"], tapi.FedSpec(**base, **kw),
                                device="cpu")
        state, gen = tr.init(0, params=models["params"])
        hist = []
        for b in models["tbatches"][:2]:
            state, m = tr.step(state, b, gen)
            hist.append((float(m["loss"]), float(m["participation"])))
        out[name] = (state, hist)
    for a, b in (("plain", "one-group"), ("groups", "groups-K0")):
        assert out[a][1] == out[b][1]
        assert torch.equal(out[a][0].x, out[b][0].x)
        assert torch.equal(out[a][0].z, out[b][0].z)
    assert not torch.equal(out["plain"][0].x, out["groups"][0].x)


# ---------------------------------------------------------------------------
# Privacy
# ---------------------------------------------------------------------------

def _same_report(trep, jrep):
    assert trep.adp_eps == pytest.approx(jrep.adp_eps, rel=1e-12)
    assert trep.eps_ceiling == pytest.approx(jrep.eps_ceiling, rel=1e-12)
    assert len(trep.per_agent) == len(jrep.per_agent)
    for t, j in zip(trep.per_agent, jrep.per_agent):
        assert (t.agent, t.q, t.n_epochs, t.K, t.arrivals) == \
            (j.agent, j.q, j.n_epochs, j.K, j.arrivals)
        assert t.gamma == pytest.approx(j.gamma, rel=1e-12)
        assert t.adp_eps == pytest.approx(j.adp_eps, rel=1e-12)
        assert t.eps_ceiling == pytest.approx(j.eps_ceiling, rel=1e-12)


PRIVACY = {
    "per-agent-q": (dict(n_agents=5, gamma=0.05, n_epochs=3),
                    [10, 20, 40, 80, 160]),
    "groups": (dict(n_agents=5, gamma=0.05, agent_groups=(
        "3*gd:n_epochs=1,2*gd:n_epochs=50:gamma=0.02")), 100),
    "groups-per-agent-q": (dict(n_agents=4, gamma=0.05,
                                agent_groups="2,2:n_epochs=9"),
                           [30, 60, 90, 120]),
}


@pytest.mark.parametrize("name", list(PRIVACY))
@pytest.mark.parametrize("clip", [None, 1.0])
def test_per_agent_privacy_matches_reference(name, clip):
    kw, q = PRIVACY[name]
    jrep = japi.privacy_report(japi.FedSpec(
        **kw, privacy=japi.PrivacySpec(tau=0.1, clip=clip)), 20, q)
    trep = tapi.privacy_report(tapi.FedSpec(
        **kw, privacy=tapi.PrivacySpec(tau=0.1, clip=clip)), 20, q)
    _same_report(trep, jrep)
    assert trep.adp_eps == max(a.adp_eps for a in trep.per_agent)


def test_dense_grouped_privacy_and_effective_report(problems):
    jp, tp = problems
    kw = dict(agent_groups="4*gd:n_epochs=2,4*gd:gamma=0.3", tau=0.05,
              async_mode="stale", max_staleness=2, participation=0.5)
    jspec, tspec = _specs(kw)
    jtr, ttr = japi.build_trainer(jp, jspec), tapi.build_trainer(
        tp, tspec, device="cpu")
    _same_report(ttr.privacy_report(30), jtr.privacy_report(30))
    sched = np.random.default_rng(0).random((12, N)) < 0.5
    sched[:, 0] = True
    _same_report(ttr.effective_privacy_report(sched),
                 jtr.effective_privacy_report(sched))
    # a homogeneous spec with one q keeps the scalar report
    homogeneous = tapi.build_trainer(tp, _specs(dict(tau=0.05))[1],
                                     device="cpu")
    assert homogeneous.privacy_report(30).per_agent is None
