"""The port's baseline algorithms (paper Table 2) against the reference's.

Each baseline of ``repro_torch.core.baselines`` runs on the reference's
problem (N 8, q 20, n 5, through ``convert.problem_from_arrays``) with the
reference's own coin flips and participation draws replayed: the
reference splits its key into one key per round (per step for ProxSkip
and TAMUNA) and draws ``bernoulli(k, p, (N,))`` rows (TAMUNA splits each
step's key into the communication coin and the sampled clients).

Tolerance: over 30 rounds the square root of the criterion, the norm of
the agents' gradient sum, agrees to 1e-4 relative plus 1e-5 absolute.
The closed-form gradients round at other places than ``jax.grad``
(float32), and near the optimum the sum cancels terms of order 1, so its
rounding error stays near 1e-6 absolute while the sum shrinks (LED, whose
duals scale every difference by beta / (gamma N_e) = 4 a round, ends at a
gradient sum of 5.5e-3 with 1.9e-6 between the packages).
``time_per_round`` and ``comms_per_round`` are equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import problem as jproblem
from repro_torch.convert import problem_from_arrays
from repro_torch.core import baselines as tbase

N, ROUNDS = 8, 30


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
    jp = jproblem.make_logreg_problem(n_agents=N, q=20, dim=5, seed=1)
    return jp, problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b))


def _bern(keys, p, shape=(N,)):
    return np.stack([np.asarray(jax.random.bernoulli(k, p, shape),
                                np.float32) for k in keys])


def _draws(name, key, kw):
    """The reference's draws of a run from ``key``, as the port takes them."""
    keys = jax.random.split(key, ROUNDS)
    if name in ("fedavg", "scaffold"):
        return dict(u=_bern(keys, kw.get("participation", 1.0)))
    if name == "5gcs":
        return dict(u=_bern(keys, kw.get("participation", 0.5)))
    if name == "proxskip":
        return dict(theta=_bern(keys, kw.get("p_comm", 0.2), ()))
    if name == "tamuna":
        pairs = [jax.random.split(k) for k in keys]
        return dict(theta=_bern([p[0] for p in pairs], kw.get("p_comm", 0.2),
                                ()),
                    u=_bern([p[1] for p in pairs],
                            kw.get("participation", 1.0)))
    return {}


CASES = [("fedavg", {}), ("fedavg", dict(participation=0.5)),
         ("fedsplit", {}), ("fedsplit", dict(gamma=0.1)), ("fedpd", {}),
         ("fedlin", {}), ("scaffold", {}),
         ("scaffold", dict(participation=0.5)), ("proxskip", {}),
         ("tamuna", dict(participation=0.5)), ("led", {}), ("5gcs", {}),
         ("5gcs", dict(solver="agd"))]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in CASES])
def test_baseline_matches_reference(problems, name, kw):
    jp, tp = problems
    jalgo = jbase.REGISTRY[name](jp, **kw)
    talgo = tbase.REGISTRY[name](tp, **kw)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jalgo.run(key, ROUNDS))
    got = talgo.run(0, ROUNDS, **_draws(name, key, kw)).numpy()
    np.testing.assert_allclose(np.sqrt(got), np.sqrt(want), rtol=1e-4,
                               atol=1e-5)
    assert talgo.name == jalgo.name
    assert talgo.time_per_round(1.0, 10.0) == jalgo.time_per_round(1.0, 10.0)
    assert talgo.comms_per_round == jalgo.comms_per_round


def test_registry_names_equal_reference():
    assert sorted(tbase.REGISTRY) == sorted(jbase.REGISTRY)


def test_draws_from_the_generator_are_seeded(problems):
    _, tp = problems
    algo = tbase.make_tamuna(tp, participation=0.5)
    a, b = algo.run(3, 12), algo.run(3, 12)
    assert np.array_equal(a.numpy(), b.numpy())
    assert np.isfinite(a.numpy()).all()
