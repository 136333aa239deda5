"""Byzantine-robust, fault-screened Fed-PLT rounds of the port against the
reference.

Reduced gemma2-2b (fp32, 2 KV heads), N = 4 agents with 2 sequences of 32
tokens each, N_e = 2, gamma = 0.05, participation 1, 3 rounds; the same
parameters and numpy batches go into ``ModelTrainer.step(u=ones,
corrupt=, live=)`` of the port and ``ModelTrainer.step(key, corrupt=,
live=)`` of the reference.  One agent is sign-flipped in every round (an
``(N, 2)`` ``[mult, add]`` row realised from a seeded ``FaultPlan``), and
agent 3 is evicted from round 1 on (``live = [1, 1, 1, 0]``; round 0
passes an all-ones row, so that the reference compiles its round once).
Guards are on with a norm bound of 1e4, far above every row's norm, so
the guard's discrete decision cannot flip.  Cases: ``trimmed_mean``
(f = 1), ``coord_median`` and ``norm_clip_mean`` (radius 0.5), each in
the tree and the packed layout, under the torch and the fused backends
(the reference's xla and pallas; on the CPU the fused backend runs the
plain versions).  Both of the port's backends are held to the reference's
xla run of the same aggregator and layout: the reference holds its
pallas backend to its xla backend, and ``tests/test_torch_robust.py``
holds the port's plain sort to the reference's Pallas kernel in
interpret mode bit for bit, so one reference run per aggregator and
layout (its compile is most of this file's time) serves both.  After 3
rounds ``x`` and ``z`` agree to 1e-4 absolute and the losses to 1e-5
relative: trimmed means and medians are continuous in their inputs, so
no near-tie allowance is needed.

``test_defaults_are_the_fault_free_round`` holds the round with no fault
rows, guards off and ``mean`` (also ``trimmed_mean`` at f = 0, and guards
on with clean rows) bit for bit to the fault-free round body, rebuilt
from the engine's edges, on both layouts and backends.

``test_sign_flip_attack_in_both_packages`` measures the attack instead of
asserting the reference's survival claim: 4 rounds of the packed
layout (the port's fused backend, the reference's xla), clean, and with
one agent sign-flipped under ``mean`` and under ``trimmed_mean`` f = 1;
each package's coordinator model after the last round, ``y = agg(z)``,
against its clean run (all-zero corruption rows).  Both packages give
the same ``||y - y_clean||`` to 1e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.fed import engine as jengine
from repro.fed import robust as jrobust
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.solvers import SolverConfig
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.fed import engine as tengine
from repro_torch.fed import faults as tfaults
from repro_torch.fed import robust as trobust
from repro_torch.fed.solvers import (make_local_solver,
                                     make_packed_local_solver)
from repro_torch.models.model import build_model

N, ROUNDS = 4, 3
LIVE = ([1.0] * N, [1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 0.0])
AGGREGATORS = {"trimmed_mean": 1.0, "coord_median": 0.0,
               "norm_clip_mean": 0.5}
BACKENDS = {"torch": (dict(engine_backend="xla"),
                      dict(engine_backend="torch")),
            "fused": (dict(engine_backend="pallas", use_pallas=True),
                      dict(engine_backend="fused", use_fused_update=True))}
CASES = [(a, lay, b) for a in AGGREGATORS for lay in ("tree", "packed")
         for b in BACKENDS]


def _fault_rows(n_rounds, kind="sign_flip"):
    """The ``(N, 2)`` corruption rows of a seeded one-agent plan."""
    plan = tfaults.FaultPlan.generate(3, N, n_rounds, n_byzantine=1,
                                      byzantine_kind=kind)
    rows = []
    for r in range(n_rounds):
        row = np.zeros((N, 2), np.float32)
        for a in range(N):
            pair = plan.byzantine_at(a, r)
            if pair is not None:
                row[a] = pair
        rows.append(row)
    return plan, rows


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test workers on one machine, where oversubscribed OpenMP threads slow
    every torch op down manyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(4):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 32)).astype(np.int32)
        batches.append((tok, np.roll(tok, -1, axis=-1)))
    return dict(jmodel=jmodel, tmodel=build_model(tcfg),
                params=params_from_jax(tree, tcfg), batches=batches)


def _spec_kw(layout, **kw):
    out = dict(n_agents=N, n_epochs=2, gamma=0.05, **kw)
    if layout == "packed":
        out["state_layout"] = "packed"
    return out


def _reference_run(models, layout, n_rounds, rows, lives, **kw):
    """The reference's trainer (xla backend), ``ModelTrainer.step(key,
    corrupt=, live=)`` each round."""
    jtr = japi.build_trainer(models["jmodel"], japi.FedSpec(
        **_spec_kw(layout, **kw), **BACKENDS["torch"][0]))
    key = jax.random.PRNGKey(0)
    jstate, jm = jtr.init(key), []
    for r in range(n_rounds):
        tok, lab = models["batches"][r]
        row, live = rows[r], lives[r]
        jstate, m = jtr.step(
            jstate, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            jax.random.fold_in(key, r),
            corrupt=None if row is None else jnp.asarray(row),
            live=None if live is None else jnp.asarray(live, jnp.float32))
        jm.append({k: float(v) for k, v in m.items()})
    return dict(jtr=jtr, jstate=jstate, jm=jm)


def _port_run(models, layout, backend, n_rounds, rows, lives, **kw):
    """The port's trainer, ``ModelTrainer.step(u=ones, corrupt=, live=)``
    each round, with its kernel launch counts."""
    ttr = tapi.build_trainer(models["tmodel"], tapi.FedSpec(
        **_spec_kw(layout, **kw), **BACKENDS[backend][1]), device="cpu")
    tstate, _ = ttr.init(0, params=models["params"])
    kernels.reset_launch_counts()
    tm = []
    for r in range(n_rounds):
        tok, lab = models["batches"][r]
        tstate, m = ttr.step(
            tstate, {"tokens": torch.from_numpy(tok).long(),
                     "labels": torch.from_numpy(lab).long()},
            u=torch.ones(N), corrupt=rows[r], live=lives[r])
        tm.append({k: float(v) for k, v in m.items()})
    return dict(ttr=ttr, tstate=tstate, tm=tm,
                counts=kernels.launch_counts())


@pytest.fixture(scope="module")
def reference_runs():
    return {}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{lay}-{b}" for a, lay, b in CASES])
def rounds(request, models, reference_runs):
    name, layout, backend = request.param
    _, rows = _fault_rows(ROUNDS)
    kw = dict(aggregator=name, aggregator_param=AGGREGATORS[name],
              guard_increments=True, guard_norm_bound=1e4)
    if (name, layout) not in reference_runs:
        reference_runs[name, layout] = _reference_run(
            models, layout, ROUNDS, rows, LIVE, **kw)
    return {**reference_runs[name, layout],
            **_port_run(models, layout, backend, ROUNDS, rows, LIVE, **kw)}


def _jax_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = jcompress.unpack_leaves(x, trainer.packed_meta)
    return jax.tree_util.tree_map(np.asarray, x)


def _port_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = tcompress.unpack_leaves(x, trainer.packed_meta)
    return params_to_jax(x)


def test_fault_rows_come_from_the_plan():
    plan, rows = _fault_rows(ROUNDS)
    (bad,) = [a for a in range(N) if plan.byzantine_at(a, 0) is not None]
    for row in rows:
        np.testing.assert_array_equal(row[bad], [-1.0, 0.0])
        assert not np.delete(row, bad, axis=0).any()


def test_losses_and_participation_match(rounds):
    for jm, tm in zip(rounds["jm"], rounds["tm"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        assert tm["participation"] == jm["participation"]
    # the evicted agent leaves the participation row; the guard passes all
    assert [m["participation"] for m in rounds["tm"]] == [1.0, 0.75, 0.75]


@pytest.mark.parametrize("var", ["x", "z"])
def test_agent_states_match(rounds, var):
    want = _jax_tree(rounds["jtr"], getattr(rounds["jstate"], var))
    got = _port_tree(rounds["ttr"], getattr(rounds["tstate"], var))
    jax.tree_util.tree_map(
        lambda p, q: np.testing.assert_allclose(q, p, atol=1e-4, rtol=0),
        want, got)


def test_cpu_rounds_launch_no_kernel(rounds):
    assert set(rounds["counts"].values()) == {0}


# ---------------------------------------------------------------------------
# The fault-free round, bit for bit
# ---------------------------------------------------------------------------

def _fault_free_round(cfg, meta, x, z, solver, u):
    """The round body without fault hooks (exact exchange): uplink, local
    solvers, participation, downlink."""
    if meta is None:
        y, v = tengine.coordinator_edge(cfg, z, z)
        w, _ = tengine.run_solvers(solver, x, v, cfg.n_agents)
        return tengine.agent_edge(cfg, u, w, x, z, y, z)
    y, v = tengine.coordinator_edge_packed(cfg, z, z, meta)
    w, _ = tengine.run_solvers(solver, x, v, cfg.n_agents)
    return tengine.agent_edge_packed(cfg, u, w, x, z, y, z)


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("layout", ["tree", "packed"])
def test_defaults_are_the_fault_free_round(layout, backend):
    rng = np.random.default_rng(5)
    tree = {"a": torch.from_numpy(rng.normal(size=(N, 5)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(N, 3, 3)).astype(
                np.float32))}
    scfg = SolverConfig(name="gd", n_epochs=2, step_size=0.1)

    def fgrad(w, epoch):
        return tengine.tree_map(lambda l: 0.1 * l, w)

    meta = None
    if layout == "packed":
        state, meta = tcompress.pack_leaves(tree)
        solver = make_packed_local_solver(scfg, fgrad, 1.0, 0.1, 1.0,
                                          meta=meta)
    else:
        state = tree
        solver = make_local_solver(scfg, fgrad, 1.0, 0.1, 1.0)
    u = torch.tensor([1.0, 0.0, 1.0, 1.0])
    kw = dict(n_agents=N, engine_backend=backend, state_layout=layout)
    x = z = state
    want = []
    for _ in range(3):
        x, z = _fault_free_round(tengine.RoundConfig(**kw), meta, x, z,
                                 solver, u)
        want.append((x, z))
    assert tengine.robust_seen(tengine.RoundConfig(**kw), state, None,
                               meta) is state
    for extra in (dict(), dict(aggregator="trimmed_mean", aggregator_param=0),
                  dict(guard_increments=True)):
        cfg = tengine.RoundConfig(**kw, **extra)
        x = z = state
        for wx, wz in want:
            step = (tengine.round_step if meta is None else
                    lambda *a, **k: tengine.packed_round_step(cfg, meta,
                                                              *a[1:], **k))
            res = step(cfg, x, z, z, solver, u=u)
            x, z = res.x, res.z
            for got, exp in ((x, wx), (z, wz)):
                for g, e in zip(tengine.pytree.tree_leaves(got),
                                tengine.pytree.tree_leaves(exp)):
                    assert torch.equal(g, e), extra


# ---------------------------------------------------------------------------
# The sign-flip attack, measured in both packages
# ---------------------------------------------------------------------------

ATTACK_ROUNDS = 4


def _attack_run(models, rows, **kw):
    lives = [None] * ATTACK_ROUNDS
    return {**_reference_run(models, "packed", ATTACK_ROUNDS, rows, lives,
                             **kw),
            **_port_run(models, "packed", "fused", ATTACK_ROUNDS, rows,
                        lives, **kw)}


@pytest.fixture(scope="module")
def clean_run(models):
    """All-zero corruption rows flag no agent: the clean run, on the same
    compiled reference round as the attacked mean run."""
    return _attack_run(models, [np.zeros((N, 2), np.float32)]
                       * ATTACK_ROUNDS)


def _coordinator_model(res, name, param):
    """Each package's coordinator model ``agg(z)`` after the last round."""
    return (trobust.aggregate_rows(res["tstate"].z, None, name=name,
                                   param=param, backend="torch"),
            jrobust.aggregate_rows(res["jstate"].z, None, name=name,
                                   param=param, backend="xla"))


@pytest.mark.parametrize("name,param", [("mean", 0.0), ("trimmed_mean", 1.0)])
def test_sign_flip_attack_in_both_packages(models, clean_run, name, param):
    _, rows = _fault_rows(ATTACK_ROUNDS)
    res = _attack_run(models, rows, aggregator=name, aggregator_param=param)
    ty, jy = _coordinator_model(res, name, param)
    tc, jc = _coordinator_model(clean_run, name, param)
    segs = res["ttr"].packed_meta.segments
    t_err = float(trobust.row_sq_norms(ty - tc, segs)[0]) ** 0.5
    j_err = float(jengine._row_sq_norms(
        jy - jc, res["jtr"].packed_meta)[0]) ** 0.5
    scale = float(trobust.row_sq_norms(tc, segs)[0]) ** 0.5
    print(f"sign-flip attack, {name}: ||y - y_clean|| port {t_err:.6g}, "
          f"reference {j_err:.6g}; ||y_clean|| {scale:.6g}")
    assert t_err > 0.0
    np.testing.assert_allclose(t_err, j_err, rtol=1e-3)
