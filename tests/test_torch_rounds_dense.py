"""Dense Fed-PLT rounds of the port against the reference's, on the CPU.

``build_trainer(problem, spec)`` of both packages on the same problem
(the reference's arrays through ``convert.problem_from_arrays``): the
reduced problem (N 8, q 20, n 5), float32, 5 rounds.  The reference
draws from JAX's threefry; the port cannot reproduce those bits, so the
test replays the reference's own draws into the port round by round,
derived from the reference state's key as its round derives them: the
participation row ``bernoulli(split(key, 3)[1], p)``; per agent
``split(split(key, 3)[2], N)[i]``, split into one key per local epoch,
which draws the sgd minibatch rows ``randint(k, (batch,), 0, q)`` and
the noisy-GD noise ``normal(split(k)[1], (n,))``; under ``dp_init`` the
initial models ``std * normal(split(key)[0], (N, n))``.

Tolerance: the states ``x``, ``z`` (and ``t`` when compressed) agree to
1e-5 absolute after 5 rounds (the closed-form gradients round at other
places than ``jax.grad``).  Measured: at most 1.8e-7 on the clean
rounds; up to 5.7e-6 in the faulted robust rounds, where the
sign-flipped agent grows ``z`` to entries of about 23 (2.4e-7 relative).
The compressors' choices are discrete: on these inputs no top-k or int8
decision lies within that rounding of a tie.

Then the paper's problem (N 100, q 250, n 5, eps 0.5) over 200 rounds:
the same ``hitting_round`` of the criterion and a final criterion within
a factor 10 of the reference's (the long-horizon rule: trajectories that
agree to float32 rounding reach the 1e-5 threshold together, while the
criterion's floor, near 1e-10, is rounding noise).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import problem as jproblem
from repro.fed import api as japi
from repro_torch import kernels
from repro_torch.convert import problem_from_arrays
from repro_torch.core import metrics as tmetrics
from repro_torch.core.fedplt import FedPLT, FedPLTConfig
from repro_torch.fed import api as tapi

N, Q, DIM, ROUNDS = 8, 20, 5, 5
BACKENDS = {"torch": "xla", "fused": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The dense problems are tiny: one intra-op thread runs their many
    small ops faster than a thread pool does, above all beside other test
    workers on a loaded machine.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    jp = jproblem.make_logreg_problem(n_agents=N, q=Q, dim=DIM, seed=0)
    return jp, problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b))


def _specs(kw):
    """The reference's and the port's spec of one configuration, the
    backends named as the port names them."""
    kw = dict(kw)
    comp = kw.pop("compression", None)
    privacy = kw.pop("privacy", None)
    jkw, tkw = dict(kw), dict(kw)
    if "engine_backend" in jkw:
        jkw["engine_backend"] = BACKENDS[jkw["engine_backend"]]
    if privacy is not None:
        jkw["privacy"] = japi.PrivacySpec(**privacy)
        tkw["privacy"] = tapi.PrivacySpec(**privacy)
    if comp is not None:
        name, backend = comp
        jkw["compression"] = japi.CompressionSpec(name,
                                                  backend=BACKENDS[backend])
        tkw["compression"] = tapi.CompressionSpec(name, backend=backend)
    return japi.FedSpec(**jkw), tapi.FedSpec(**tkw)


def _round_draws(jtr, key, scfg, batch_size):
    """The draws of the reference round that starts from ``key``."""
    _, k_part, k_solve = jax.random.split(key, 3)
    p = jtr.algo._ecfg.participation
    u = np.asarray(jax.random.bernoulli(k_part, p, (N,)), np.float32)
    epochs = [jax.random.split(k, scfg.n_epochs)
              for k in jax.random.split(k_solve, N)]
    idx = noise = None
    if scfg.name == "sgd" and batch_size is not None:
        idx = np.array([[np.asarray(jax.random.randint(
            epochs[i][e], (batch_size,), 0, Q)) for i in range(N)]
            for e in range(scfg.n_epochs)])
    if scfg.name == "noisy_gd":
        noise = np.array([[np.asarray(jax.random.normal(
            jax.random.split(epochs[i][e])[1], (DIM,)))
            for i in range(N)] for e in range(scfg.n_epochs)])
    return u, idx, noise


def _compare(jstate, tstate, what, atol=1e-5):
    for var in ("x", "z", "t"):
        j, t = getattr(jstate, var), getattr(tstate, var)
        if j is None:
            assert t is None, var
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol, err_msg=f"{what}: {var}")


def _replay(problems, kw, rounds=ROUNDS, faults=None):
    """Both trainers, ``rounds`` rounds with the reference's draws replayed
    into the port; ``faults(r)`` gives a round's ``(corrupt, live)``."""
    jp, tp = problems
    jspec, tspec = _specs(kw)
    jtr = japi.build_trainer(jp, jspec)
    ttr = tapi.build_trainer(tp, tspec, device="cpu")
    key = jax.random.PRNGKey(3)
    jstate = jtr.init(key)
    x0 = np.asarray(jstate.x)
    tstate = ttr.init(0, x0=x0)
    scfg = jtr.algo.cfg.solver
    for r in range(rounds):
        u, idx, noise = _round_draws(jtr, jstate.key, scfg, jspec.batch_size)
        corrupt, live = faults(r) if faults else (None, None)
        if faults:
            jstate, ju = jtr.round_with_faults(jstate, None, corrupt, live)
            tstate, tu = ttr.round_with_faults(tstate, None, corrupt, live,
                                               u=u, batch_idx=idx,
                                               noise=noise)
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        else:
            jstate = jtr.step(jstate)
            tstate = ttr.step(tstate, u=u, batch_idx=idx, noise=noise)
    _compare(jstate, tstate, str(kw))
    np.testing.assert_allclose(ttr.consensus(tstate).numpy(),
                               np.asarray(jtr.consensus(jstate)), atol=1e-5)
    return jtr, ttr, jstate, tstate


GRID = {
    "gd": {},
    "gd-gamma": dict(gamma=0.2),
    "agd": dict(solver="agd"),
    "sgd": dict(solver="sgd", batch_size=5),
    "noisy_gd": dict(privacy=dict(tau=0.01)),
    "noisy_gd-clip-dp_init": dict(privacy=dict(tau=0.02, clip=0.5,
                                               dp_init=True)),
    "p0.5": dict(participation=0.5),
    "uncoordinated": dict(uncoordinated=True),
    "uncoordinated-noisy": dict(uncoordinated=True, privacy=dict(tau=0.01)),
    "weight_decay": dict(weight_decay=0.1),
    "damping0.5": dict(damping=0.5),
    "nonconvex-mu": dict(mu=0.0, L=4.0),
    "fused-packed": dict(engine_backend="fused", state_layout="packed"),
    "fused-tree": dict(engine_backend="fused"),
    "packed-p0.5": dict(state_layout="packed", participation=0.5),
}


@pytest.mark.parametrize("name", list(GRID))
def test_dense_rounds_match_reference(problems, name):
    _replay(problems, GRID[name])


COMPRESSED = [(c, b, layout) for c in ("topk", "int8", "adaptive_topk")
              for b in ("torch", "fused") for layout in ("tree", "packed")]


@pytest.mark.parametrize("comp,backend,layout", COMPRESSED,
                         ids=[f"{c}-{b}-{l}" for c, b, l in COMPRESSED])
def test_compressed_dense_rounds_match_reference(problems, comp, backend,
                                                  layout):
    kw = dict(compression=(comp, backend), state_layout=layout,
              engine_backend=backend, damping=0.5)
    _replay(problems, kw)


AGGREGATORS = [("mean", 0.0), ("trimmed_mean", 1.0), ("coord_median", 0.0),
               ("norm_clip_mean", 1.0)]


def _faults(r):
    """Clean first round; then agent 2 sign-flipped and agent 5 NaN-poisoned
    (the guard drops it); agent 7 evicted from round 3."""
    if r == 0:
        return None, None
    corrupt = np.zeros((N, 2), np.float32)
    corrupt[2] = (-1.0, 0.0)
    corrupt[5] = (np.nan, 0.0)
    live = np.ones(N, np.float32)
    if r >= 3:
        live[7] = 0.0
    return corrupt, live


@pytest.mark.parametrize("agg,param", AGGREGATORS)
@pytest.mark.parametrize("layout", ["tree", "packed"])
def test_robust_guarded_dense_rounds_match_reference(problems, agg, param,
                                                     layout):
    kw = dict(aggregator=agg, aggregator_param=param, guard_increments=True,
              state_layout=layout, engine_backend="fused")
    _, _, _, tstate = _replay(problems, kw, faults=_faults)
    assert torch.isfinite(tstate.x).all() and torch.isfinite(tstate.z).all()


def test_dense_path_never_launches_the_fused_update(problems):
    """The reference's dense solver never fuses its step; on the CPU no
    kernel launches at all, and the spec's use_fused_update changes
    nothing."""
    kernels.reset_launch_counts()
    _, tp = problems
    outs = []
    for fused in (False, True):
        tr = tapi.build_trainer(tp, tapi.FedSpec(
            use_fused_update=fused, engine_backend="fused",
            state_layout="packed"), device="cpu")
        outs.append(tr.run(0, 3)[0].x)
    assert torch.equal(outs[0], outs[1])
    assert set(kernels.launch_counts().values()) == {0}


def test_run_recorded_schedule_replays_bit_for_bit(problems):
    _, tp = problems
    tr = tapi.build_trainer(tp, tapi.FedSpec(participation=0.5),
                            device="cpu")
    state, crit, sched = tr.run_recorded(4, 6)
    assert sched.shape == (6, N) and set(sched.unique().tolist()) <= {0., 1.}
    again, crit2 = tr.run(123, 6, u=sched)
    assert torch.equal(again.x, state.x) and torch.equal(crit, crit2)
    assert crit.shape == (6,) and torch.isfinite(crit).all()


def test_fedplt_config_round_trips_through_the_spec(problems):
    _, tp = problems
    cfg = FedPLTConfig(rho=0.7, participation=0.5, damping=0.8)
    spec = cfg.to_spec()
    assert spec.to_dense_config() == cfg
    a = FedPLT(tp, cfg).run(1, 3)[0]
    b = tapi.build_trainer(tp, cfg, device="cpu").run(1, 3)[0]
    assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("kw,slice_name", [
    # a dense mesh runs since the model-axis slice, in either layout; a
    # 1x2 mesh in one process raises for its missing second rank, naming
    # torchrun (tests/test_torch_rounds_sharded.py runs it on two)
    pytest.param(dict(state_layout="tree", mesh_shape="1x2"),
                 "needs 2 devices.*torch.distributed.run",
                 id="kw0-dense mesh"),
])
def test_unported_dense_options_raise_naming_the_slice(problems, kw,
                                                       slice_name):
    """The dense trainer takes the tree layout under a model axis; built
    in one process, a 1x2 mesh raises for its missing rank, naming
    torchrun, not a slice still to port."""
    _, tp = problems
    with pytest.raises(ValueError, match=slice_name):
        tapi.build_trainer(tp, tapi.FedSpec(**kw), device="cpu")


def test_privacy_report_uses_the_problem_q_and_mu(problems):
    jp, tp = problems
    spec = dict(gamma=0.1, privacy=dict(tau=0.05))
    jspec, tspec = _specs(spec)
    jrep = japi.build_trainer(jp, jspec).privacy_report(50)
    trep = tapi.build_trainer(tp, tspec, device="cpu").privacy_report(50)
    assert trep.adp_eps == pytest.approx(jrep.adp_eps, rel=1e-12)
    assert trep.eps_ceiling == pytest.approx(jrep.eps_ceiling, rel=1e-12)


@pytest.fixture(scope="module")
def paper():
    jp = jproblem.make_logreg_problem(n_agents=100, q=250, dim=5, seed=0)
    return jp, problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b))


def test_paper_problem_200_rounds_reach_the_reference_hitting_round(paper):
    jp, tp = paper
    _, jcrit = japi.build_trainer(jp, japi.FedSpec(rho=1.0, n_epochs=5)).run(
        jax.random.PRNGKey(0), 200)
    tstate, tcrit = tapi.build_trainer(
        tp, tapi.FedSpec(rho=1.0, n_epochs=5), device="cpu").run(0, 200)
    jcrit, tcrit = np.asarray(jcrit), tcrit.numpy()
    assert tmetrics.hitting_round(tcrit) == jmetrics.hitting_round(jcrit)
    assert tmetrics.hitting_round(tcrit) is not None
    assert 0.1 <= tcrit[-1] / jcrit[-1] <= 10.0
    x_star = np.asarray(jp.solve())      # the reference's oracle x*
    assert np.linalg.norm(tstate.x.mean(0).numpy() - x_star) < 1e-4
