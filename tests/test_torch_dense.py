"""The port's dense problems, theory and metrics against the reference's.

The reference's problem arrays (drawn with its own generator) are handed
to the port through ``repro_torch.convert.problem_from_arrays`` /
``quadratic_from_arrays``, so both packages hold the same problem.
Tolerances, float32 throughout:

- losses, gradients and minibatch gradients: 1e-6 relative to the
  largest entry (closed-form gradients against ``jax.grad``: the same
  formula rounded at other places);
- the criterion: 1e-5 relative (a squared norm of a sum over 100 agents);
- the smoothness moduli: equal (both compute them with numpy on the
  float32 data);
- ``solve`` (300 GD steps here): 1e-5 absolute;
- ``QuadraticProblem``: gradients 1e-5 relative, the closed-form solve
  1e-5, the eigenvalue moduli 1e-5 relative;
- ``theory`` and ``metrics`` (numpy copies): equal floats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import problem as jproblem
from repro.core import solvers as jsolvers
from repro.core import theory as jtheory
from repro_torch.convert import problem_from_arrays, quadratic_from_arrays
from repro_torch.core import metrics as tmetrics
from repro_torch.core import problem as tproblem
from repro_torch.core import solvers as tsolvers
from repro_torch.core import theory as ttheory


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The dense problems are tiny: one intra-op thread runs their many
    small ops faster than a thread pool does, above all beside other test
    workers on a loaded machine.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(nonconvex, n_agents=8, q=20, dim=5, seed=0):
    jp = jproblem.make_logreg_problem(n_agents=n_agents, q=q, dim=dim,
                                      nonconvex=nonconvex, seed=seed)
    tp = problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b), eps=jp.eps,
                             nonconvex=nonconvex)
    return jp, tp


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("nonconvex", [False, True])
def test_logreg_losses_grads_and_criterion_match_reference(nonconvex):
    jp, tp = _pair(nonconvex)
    x = np.random.default_rng(1).normal(size=(8, 5)).astype(np.float32)
    _close(tp.losses(torch.from_numpy(x)), jp.losses(jnp.asarray(x)), 1e-6)
    _close(tp.grads(torch.from_numpy(x)), jp.grads(jnp.asarray(x)), 1e-6)
    _close(tp.grads(torch.from_numpy(x[0])), jp.grads(jnp.asarray(x[0])),
           1e-6)
    for i in (0, 5):
        _close(tp.local_loss((tp.A[i], tp.b[i]), torch.from_numpy(x[i])),
               jp.local_loss((jp.A[i], jp.b[i]), jnp.asarray(x[i])), 1e-6)
    got = float(tp.criterion(torch.from_numpy(x)))
    want = float(jp.criterion(jnp.asarray(x)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("nonconvex", [False, True])
def test_minibatch_grads_match_reference_per_agent(nonconvex):
    jp, tp = _pair(nonconvex)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    idx = rng.integers(0, 20, size=(8, 6))
    got = tp.minibatch_grads(torch.from_numpy(x), torch.from_numpy(idx))
    want = np.stack([np.asarray(jp.minibatch_grad(
        (jp.A[i], jp.b[i]), jnp.asarray(x[i]), jnp.asarray(idx[i])))
        for i in range(8)])
    _close(got, want, 1e-6)


@pytest.mark.parametrize("nonconvex", [False, True])
def test_moduli_equal_the_reference(nonconvex):
    jp, tp = _pair(nonconvex, n_agents=100, q=250)
    assert tp.smoothness() == jp.smoothness()
    assert tp.strong_convexity() == jp.strong_convexity()
    np.testing.assert_array_equal(tp.per_agent_smoothness().numpy(),
                                  np.asarray(jp.per_agent_smoothness()))
    np.testing.assert_array_equal(tp.per_agent_strong_convexity().numpy(),
                                  np.asarray(jp.per_agent_strong_convexity()))


def test_solve_matches_reference():
    jp, tp = _pair(False, n_agents=6, q=30)
    np.testing.assert_allclose(tp.solve(300).numpy(),
                               np.asarray(jp.solve(300)), atol=1e-5)


def test_problem_generator_and_device_move():
    p = tproblem.make_logreg_problem(n_agents=7, q=11, dim=3, seed=4,
                                     device="cpu")
    again = tproblem.make_logreg_problem(n_agents=7, q=11, dim=3, seed=4,
                                         device="cpu")
    assert p.A.shape == (7, 11, 3) and p.b.shape == (7, 11)
    assert torch.equal(p.A, again.A) and torch.equal(p.b, again.b)
    assert set(torch.unique(p.b).tolist()) <= {-1.0, 1.0}
    assert p.to("cpu").A is not None and p.device.type == "cpu"


@pytest.mark.parametrize("make", [tproblem.make_logreg_problem,
                                  tproblem.make_quadratic_problem])
def test_problem_generators_default_to_cuda(make):
    """Like every entry point of the port, the generators place the data
    on CUDA unless the caller asks for the CPU (and raise without a
    card)."""
    if torch.cuda.is_available():
        assert make(n_agents=3, dim=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(n_agents=3, dim=2)


def test_dirichlet_partition_equals_reference():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(400, 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=400)
    jf, jl = jproblem.dirichlet_partition(feats, labels, 5, 0.5, seed=3)
    tf, tl = tproblem.dirichlet_partition(feats, labels, 5, 0.5, seed=3)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)


def test_quadratic_problem_matches_reference():
    jq = jproblem.make_quadratic_problem(n_agents=6, dim=4, seed=1)
    tq = quadratic_from_arrays(np.asarray(jq.Q), np.asarray(jq.c))
    x = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32)
    _close(tq.grads(torch.from_numpy(x)), jq.grads(jnp.asarray(x)), 1e-5)
    _close(tq.losses(torch.from_numpy(x)), jq.losses(jnp.asarray(x)), 1e-5)
    _close(tq.minibatch_grads(torch.from_numpy(x), None),
           jq.grads(jnp.asarray(x)), 1e-5)
    _close(tq.solve(), jq.solve(), 1e-5)
    got, want = float(tq.criterion(torch.from_numpy(x))), float(
        jq.criterion(jnp.asarray(x)))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(tq.smoothness() - jq.smoothness()) <= 1e-5 * jq.smoothness()
    assert (abs(tq.strong_convexity() - jq.strong_convexity())
            <= 1e-5 * jq.strong_convexity())
    own = tproblem.make_quadratic_problem(n_agents=6, dim=4, cond=10.0,
                                          device="cpu")
    eig = torch.linalg.eigvalsh(own.Q)
    assert torch.allclose(eig[:, 0], torch.ones(6), atol=1e-4)
    assert torch.allclose(eig[:, -1], torch.full((6,), 10.0), atol=1e-3)


SOLVERS = [("gd", None), ("gd", 0.3), ("sgd", None), ("noisy_gd", 0.2),
           ("agd", None)]


@pytest.mark.parametrize("name,step", SOLVERS)
def test_solver_contraction_equals_reference(name, step):
    for mu, L, rho in ((0.5, 3.3, 1.0), (0.1, 10.0, 0.3)):
        j = jsolvers.solver_contraction(
            jsolvers.SolverConfig(name=name, n_epochs=5, step_size=step),
            mu, L, rho)
        t = tsolvers.solver_contraction(
            tsolvers.SolverConfig(name=name, n_epochs=5, step_size=step),
            mu, L, rho)
        assert t == j


def test_theory_equals_reference():
    mu, L = 0.5, 3.337
    for rho in (0.1, 1.0, 7.0):
        assert ttheory.zeta_prs(rho, mu, L) == jtheory.zeta_prs(rho, mu, L)
        assert ttheory.chi_gd(0.2, mu + 1 / rho, L + 1 / rho) == \
            jtheory.chi_gd(0.2, mu + 1 / rho, L + 1 / rho)
        np.testing.assert_array_equal(ttheory.s_matrix(0.3, 0.4, mu, rho),
                                      jtheory.s_matrix(0.3, 0.4, mu, rho))
        cfg_t = tsolvers.SolverConfig(n_epochs=5)
        cfg_j = jsolvers.SolverConfig(n_epochs=5)
        assert ttheory.s_norm(cfg_t, mu, L, rho) == \
            jtheory.s_norm(cfg_j, mu, L, rho)
        assert ttheory.s_norm(0.25, mu, L, rho) == \
            jtheory.s_norm(0.25, mu, L, rho)
        assert ttheory.is_stable(cfg_t, mu, L, rho) == \
            jtheory.is_stable(cfg_j, mu, L, rho)
    assert ttheory.sigma(0.5, 1.0, 0.9) == jtheory.sigma(0.5, 1.0, 0.9)
    st, sj = ttheory.stabilize(mu, L), jtheory.stabilize(mu, L)
    assert (st.rho, st.gamma, st.n_epochs, st.s_norm,
            st.spectral_radius) == (sj.rho, sj.gamma, sj.n_epochs,
                                    sj.s_norm, sj.spectral_radius)
    args = (300, mu, L, 1.0, 0.2, 5, 0.01, 5, 100, 2.0)
    assert ttheory.corollary1_bound(*args) == jtheory.corollary1_bound(*args)
    assert ttheory.asymptotic_error(*args[1:9]) == \
        jtheory.asymptotic_error(*args[1:9])


def test_metrics_equal_reference():
    crit = np.array([3.0, 1e-3, 2e-5, 9e-6, 1e-7])
    assert tmetrics.hitting_round(crit) == jmetrics.hitting_round(crit) == 4
    assert tmetrics.hitting_round(crit, 1e-9) is None
    tpr = lambda tG, tC: 5 * tG + tC
    assert tmetrics.time_to_converge(crit, tpr) == \
        jmetrics.time_to_converge(crit, tpr)
    rt, rj = tmetrics.evaluate("x", crit, tpr), jmetrics.evaluate("x", crit,
                                                                  tpr)
    assert rt.row() == rj.row()
    assert tmetrics.THRESHOLD == jmetrics.THRESHOLD

