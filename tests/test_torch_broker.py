"""The port's host broker (``repro_torch.fed.broker``) on the dense
quadratic problem, on the CPU.

A broker run decides only which agents arrive at each round gate (and
who is evicted or rejoins); every number goes through the round as its
arrival / corrupt / live rows.  So a run and the :func:`replay` of its
schedule (and fault record) from the same init are equal bit for bit,
which every case below asserts.  Timing varies under load, so the cases
assert only what the protocol guarantees: the staleness bound (the
schedule validates), replay equality, who was evicted or rejoined, a
straggler arriving less often than the others, the K = 0 barrier
(everyone arrives every round).  Latencies stay at 20 ms or below, runs
at 12 rounds or fewer, and the broker joins its worker threads with a
timeout.  The last cases write schedules, fault plans and fault records
in each package and load them in the other.
"""

import math

import numpy as np
import pytest
import torch

from repro.fed import broker as jbroker
from repro.fed import faults as jfaults
from repro_torch.core.fedplt import FedPLT, FedPLTConfig
from repro_torch.core.problem import make_quadratic_problem
from repro_torch.core.solvers import SolverConfig
from repro_torch.fed import broker as tbroker
from repro_torch.fed import faults as tfaults
from repro_torch.fed.broker import ArrivalSchedule, IncrementBroker, replay
from repro_torch.fed.faults import FaultEvent, FaultPlan, FaultRecord

N = 4


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quad():
    return make_quadratic_problem(torch.Generator().manual_seed(3),
                                  n_agents=N, dim=8, device="cpu")


def _algo(quad, **kw):
    return FedPLT(quad, FedPLTConfig(
        solver=SolverConfig(name="gd", n_epochs=2, step_size=0.05),
        damping=0.7, async_mode="stale", **kw))


def _step(algo):
    return lambda s, u: algo.round_with_arrival(s, u)[0]


def _fault_step(algo):
    return lambda s, u, c, l: algo.round_with_faults(s, u, c, l)[0]


def _same(a, b, fields=("x", "z", "y_tag", "staleness")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_broker_run_replays_bit_for_bit(quad):
    algo = _algo(quad, max_staleness=2)
    # agent 0 straggles: 20 ms against 2 ms, 3 ms of grace
    broker = IncrementBroker(
        N, max_staleness=2, grace=0.003,
        latency_fn=lambda a, r: 0.02 if a == 0 else 0.002)
    final, sched = broker.run(_step(algo), algo.init(0), 12)
    sched.validate()
    arr = sched.arrivals
    assert arr.shape == (12, N)
    assert arr[:, 0].sum() < arr[:, 1:].sum(axis=0).min()
    # the bound: agent 0 never holds work more than 2 rounds
    arrivals, released = sched.effective_counts()
    assert (released <= 3 * arrivals).all()
    _same(final, replay(_step(algo), algo.init(0), sched))
    back, _ = algo.replay(0, arr)       # the front end's replay agrees
    _same(final, back)


def test_k0_is_the_synchronous_barrier(quad):
    algo = _algo(quad, max_staleness=0)
    broker = IncrementBroker(N, max_staleness=0,
                             latency_fn=lambda a, r: 0.001 * (a + 1))
    final, sched = broker.run(_step(algo), algo.init(0), 5)
    np.testing.assert_array_equal(sched.arrivals, np.ones((5, N)))
    sync = FedPLT(quad, FedPLTConfig(
        solver=SolverConfig(name="gd", n_epochs=2, step_size=0.05),
        damping=0.7))
    state = sync.init(0)
    for _ in range(5):
        state = sync.round(state)
    _same(final, state, ("x", "z"))
    assert not final.staleness.any()


def test_crash_eviction_and_rejoin_replay(quad):
    algo = _algo(quad, max_staleness=0)
    plan = FaultPlan((FaultEvent("crash", 1, 1, until=3),))
    broker = IncrementBroker(N, max_staleness=0,
                             latency_fn=lambda a, r: 0.001,
                             gate_timeout=0.02, max_retries=1)
    final, sched = broker.run(_fault_step(algo), algo.init(1), 5,
                              faults=plan)
    rec = broker.record
    assert [a for a, _ in rec.evictions] == [1]
    assert rec.rejoins == [(1, 3)]
    assert rec.retries
    assert sched.live is not None
    dead = sched.live[:, 1] == 0
    assert dead[1:3].all() and not dead[[0, 3, 4]].any()
    assert (sched.arrivals[dead, 1] == 0).all()
    _same(final, replay(_fault_step(algo), algo.init(1), sched, record=rec))


def test_drop_is_recovered_by_redispatch(quad):
    algo = _algo(quad, max_staleness=0)
    plan = FaultPlan((FaultEvent("drop", 0, 1),))
    broker = IncrementBroker(N, max_staleness=0,
                             latency_fn=lambda a, r: 0.001,
                             gate_timeout=0.02, max_retries=2)
    final, sched = broker.run(_fault_step(algo), algo.init(2), 4,
                              faults=plan)
    rec = broker.record
    assert rec.drops == [(0, 1)]
    assert any(a == 0 and r == 1 for a, r, _ in rec.retries)
    assert not rec.evictions and sched.live is None
    np.testing.assert_array_equal(sched.arrivals, np.ones((4, N)))
    _same(final, replay(_fault_step(algo), algo.init(2), sched, record=rec))


def test_corrupt_plan_is_quarantined_and_replays(quad):
    algo = _algo(quad, max_staleness=1, guard_increments=True)
    plan = FaultPlan((FaultEvent("corrupt", 2, 1, value=float("nan")),))
    broker = IncrementBroker(N, max_staleness=1,
                             latency_fn=lambda a, r: 0.001, grace=0.01)
    final, sched = broker.run(_fault_step(algo), algo.init(3), 4,
                              faults=plan)
    rec = broker.record
    assert list(rec.corrupt_rows) == [1]
    assert math.isnan(rec.corrupt_rows[1][2])
    assert rec.has_faults and not rec.evictions
    assert torch.isfinite(final.x).all() and torch.isfinite(final.z).all()
    _same(final, replay(_fault_step(algo), algo.init(3), sched, record=rec))


def test_raising_latency_is_loud_without_a_timeout(quad):
    algo = _algo(quad, max_staleness=0)

    def bad(a, r):
        if a == 1 and r == 1:
            raise OSError("worker lost")
        return 0.001

    with pytest.raises(RuntimeError, match="agent 1 worker failed"):
        IncrementBroker(N, max_staleness=0, latency_fn=bad).run(
            _step(algo), algo.init(0), 3)
    broker = IncrementBroker(N, max_staleness=0, latency_fn=bad,
                             gate_timeout=0.05, max_retries=0)
    final, sched = broker.run(_fault_step(algo), algo.init(0), 3)
    rec = broker.record
    assert rec.evictions == [(1, 1)]
    assert rec.errors and rec.errors[0][:2] == (1, 1)
    assert "worker lost" in rec.errors[0][2]
    _same(final, replay(_fault_step(algo), algo.init(0), sched, record=rec))


def test_evicting_every_agent_raises(quad):
    algo = _algo(quad, max_staleness=0)
    plan = FaultPlan(tuple(FaultEvent("crash", a, 1) for a in range(N)))
    broker = IncrementBroker(N, max_staleness=0,
                             latency_fn=lambda a, r: 0.001,
                             gate_timeout=0.01, max_retries=0)
    with pytest.raises(RuntimeError, match="no survivors"):
        broker.run(_fault_step(algo), algo.init(0), 3, faults=plan)
    with pytest.raises(ValueError, match="needs a broker gate_timeout"):
        IncrementBroker(N, max_staleness=0).run(
            _fault_step(algo), algo.init(0), 1, faults=plan)


# ---------------------------------------------------------------------------
# Files across the packages
# ---------------------------------------------------------------------------

def _schedule(pkg):
    arr = np.array([[1, 0, 1, 1], [1, 0, 0, 1], [1, 1, 1, 1]], np.float32)
    live = np.array([[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 1]], np.float32)
    return pkg.ArrivalSchedule(arrivals=arr * live, max_staleness=2,
                               live=live)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_schedules_load_in_the_other_package(tmp_path, writer):
    w, r = (tbroker, jbroker) if writer == "port" else (jbroker, tbroker)
    sched = _schedule(w)
    path = str(tmp_path / "s.json")
    sched.save(path)
    back = r.ArrivalSchedule.load(path)
    np.testing.assert_array_equal(back.arrivals, sched.arrivals)
    np.testing.assert_array_equal(back.live, sched.live)
    assert back.max_staleness == 2
    for a, b in zip(back.effective_counts(), sched.effective_counts()):
        np.testing.assert_array_equal(a, b)
    with open(path, "w") as fh:
        fh.write('{"max_staleness": 1, "arrivals": [[0, 2]]}')
    with pytest.raises(ValueError, match="entries must be 0 or 1"):
        ArrivalSchedule.load(path)


def _plan(pkg):
    E = pkg.FaultEvent
    return pkg.FaultPlan((E("crash", 1, 2, until=4), E("drop", 0, 1),
                          E("corrupt", 2, 3, value=float("nan")),
                          E("stall", 3, 0, delay=0.01),
                          E("sign_flip", 0, 5)), n_agents=4, seed=7)


def _record(pkg):
    rec = pkg.FaultRecord(n_agents=4)
    rec.note_eviction(1, 2)
    rec.note_rejoin(1, 4)
    rec.note_retry(1, 2, 1)
    rec.note_drop(0, 1)
    rec.note_error(3, 0, OSError("lost"))
    rec.note_corrupt_row(3, np.array([0.0, 0.0, float("nan"), 0.0]))
    return rec


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plans_and_records_load_in_the_other_package(tmp_path, writer):
    w, r = (tfaults, jfaults) if writer == "port" else (jfaults, tfaults)
    plan = _plan(w)
    plan.save(str(tmp_path / "p.json"))
    back = r.FaultPlan.load(str(tmp_path / "p.json"))
    assert str(back.to_json()) == str(_plan(r).to_json())
    for a in range(4):
        for rnd in range(6):
            assert back.crashed(a, rnd) == plan.crashed(a, rnd)
            assert back.dropped(a, rnd, 0) == plan.dropped(a, rnd, 0)
            assert back.stall_delay(a, rnd) == plan.stall_delay(a, rnd)
            assert back.byzantine_at(a, rnd) == plan.byzantine_at(a, rnd)
    assert back.needs_timeout() and back.rejoins_at(4) == [1]
    assert back.wrap_latency(lambda a, rnd: 0.001)(3, 0) == pytest.approx(
        0.011)
    rec = _record(w)
    rec.save(str(tmp_path / "r.json"))
    rb = r.FaultRecord.load(str(tmp_path / "r.json"))
    assert rb.evictions == [(1, 2)] and rb.rejoins == [(1, 4)]
    assert rb.retries == [(1, 2, 1)] and rb.drops == [(0, 1)]
    assert rb.errors[0][:2] == (3, 0) and "lost" in rb.errors[0][2]
    assert rb.has_faults
    for rnd in range(6):
        a, b = rb.live_row(rnd), rec.live_row(rnd)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.isnan(rb.corrupt_row(3)),
                                  [False, False, True, False])
