"""The host broker of bounded-staleness async rounds (counterpart of
``repro/fed/broker.py``, which imports only numpy and threads; copied so
that the port imports nothing of the reference).

:mod:`repro_torch.fed.async_engine` computes an async round as a
deterministic function of its arrival row.  This module supplies the
SCHEDULER: agent workers on threads, a bounded-staleness increment buffer
between them and the coordinator, and a round loop that drains the
buffer, decides which agents arrive when, and feeds each realised arrival
row to the round.  The split is strict:

* the broker decides only TIMING and LIVENESS (who arrives at which
  round gate, who is evicted or rejoins, which recorded fault rows
  apply);
* every number goes through the round via its ``arrival`` / ``corrupt``
  / ``live`` rows -- the broker never touches the state.

So a broker run replays bit for bit: record its :class:`ArrivalSchedule`
(and, for a faulty run, the :class:`repro_torch.fed.faults.FaultRecord`
left on ``broker.record``) and push the same rows through the same round
from the same init (:func:`replay`).

On a CUDA card the worker threads never touch CUDA: they sleep their
latency and submit ``(agent, round, error)`` to the buffer.  The round
function (``round_fn``) always runs on the thread that called
:meth:`IncrementBroker.run`, so every kernel launches from the caller's
thread.

ROUND PROTOCOL (:meth:`IncrementBroker.run`):

0. REJOIN: an evicted agent whose :class:`~repro_torch.fed.faults.FaultPlan`
   crash window ends this round re-enters the fleet fresh (recorded in
   the FaultRecord); it is dispatched against the CURRENT reflection at
   step 1 like any fresh agent (its staleness counter was pinned at 0
   while it was dead).
1. DISPATCH: every live fresh agent (no pending work) is handed this
   round's assignment; its worker thread "trains" for its simulated
   latency and submits to the per-run buffer.  Work dispatched to a
   plan-crashed agent silently disappears -- that is the fault.
2. GATE: the coordinator blocks on must-arrive agents -- those whose
   pending work is ``max_staleness`` rounds old (``max_staleness = 0``:
   every dispatched agent; the synchronous barrier).  With a
   ``gate_timeout``, a gate that expires marks a RETRY for each missing
   agent: its original assignment is redispatched and the wait window
   grows by ``retry_backoff**attempt``.  An agent that exhausts
   ``max_retries`` is EVICTED: it leaves the arrival rows, the keep
   branch and the coordinator mean (the ``live`` row) until a plan
   rejoin.  Evicting the last live agent raises.  A worker whose
   ``latency_fn`` raises submits the error: without a ``gate_timeout``
   the run fails loudly with it; with one, the error burns a retry like
   a timeout.  A plan-dropped submission is discarded at the gate (lost
   in transit); the timeout machinery redispatches it.
3. GRACE-DRAIN: increments that happen to be ready arrive too; everyone
   else ages one round.  Only a submission matching the agent's current
   dispatch is accepted, so redispatch races cannot double-arrive.
4. REALIZE: the 0/1 arrival row (live agents only), this round's
   ``corrupt`` row (from plan ``corrupt`` and byzantine events, recorded
   in the FaultRecord) and the ``live`` row (None until the first
   eviction) are fed to ``round_fn(state, row[, corrupt, live])`` and
   recorded.

The recorded schedule satisfies the staleness bound by construction
(validated on exit by :func:`repro_torch.fed.async_engine.validate_schedule`,
the record's live matrix exempting evicted agents).  Schedules, plans and
records are saved as the reference saves them (JSON), so each package
loads the other's.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.fed import async_engine
from repro_torch.fed import faults as faults_lib


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """A realized async run: one 0/1 row per round, one column per
    agent, plus the staleness bound it was realized under.  Faulty runs
    additionally carry ``live``, the ``(n_rounds, n_agents)`` 0/1
    liveness matrix (None = no evictions)."""

    arrivals: np.ndarray        # (n_rounds, n_agents) float32 in {0, 1}
    max_staleness: int
    live: Optional[np.ndarray] = None   # (n_rounds, n_agents) or None

    def __post_init__(self):
        arr = np.asarray(self.arrivals, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"arrivals must be (n_rounds, n_agents), "
                             f"got shape {arr.shape}")
        object.__setattr__(self, "arrivals", arr)
        if self.live is not None:
            lv = np.asarray(self.live, np.float32)
            if lv.shape != arr.shape:
                raise ValueError(
                    f"live matrix shape {lv.shape} does not match "
                    f"arrivals shape {arr.shape}")
            object.__setattr__(self, "live", lv)

    @property
    def n_rounds(self) -> int:
        return self.arrivals.shape[0]

    @property
    def n_agents(self) -> int:
        return self.arrivals.shape[1]

    def validate(self) -> "ArrivalSchedule":
        """Raise ValueError if any agent's pending work outlives the
        bound (evicted agents exempt while dead); returns self for
        chaining."""
        async_engine.validate_schedule(self.arrivals, self.max_staleness,
                                       live=self.live)
        return self

    def effective_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-agent ``(arrivals, released_rounds)`` -- the composition
        inputs of the stale-aware privacy report (see
        :func:`repro_torch.fed.async_engine.effective_counts`).  An evicted
        agent keeps the charges for every round it RELEASED before the
        eviction -- that information left the agent."""
        return async_engine.effective_counts(self.arrivals,
                                             self.max_staleness,
                                             live=self.live)

    # -- persistence (json keeps schedules diffable and dependency-free)
    def save(self, path) -> None:
        d = {"max_staleness": int(self.max_staleness),
             "arrivals": self.arrivals.astype(int).tolist()}
        if self.live is not None:
            d["live"] = self.live.astype(int).tolist()
        with open(path, "w") as fh:
            json.dump(d, fh)

    @staticmethod
    def load(path) -> "ArrivalSchedule":
        """Load and VALIDATE a saved schedule: malformed JSON -- values
        outside {0, 1}, ragged/mis-shaped rows, a non-integer or
        negative ``max_staleness``, a bound the rows violate -- raises
        ValueError here instead of flowing into the round."""
        with open(path) as fh:
            d = json.load(fh)
        if not isinstance(d, dict) or "arrivals" not in d \
                or "max_staleness" not in d:
            raise ValueError(
                f"{path}: not an ArrivalSchedule (need 'arrivals' and "
                f"'max_staleness' keys)")
        k = d["max_staleness"]
        if isinstance(k, bool) or not isinstance(k, int) or k < 0:
            raise ValueError(
                f"{path}: max_staleness must be a non-negative integer "
                f"round count, got {k!r}")
        arr = _load_binary_matrix(path, "arrivals", d["arrivals"])
        lv = None
        if d.get("live") is not None:
            lv = _load_binary_matrix(path, "live", d["live"])
            if lv.shape != arr.shape:
                raise ValueError(
                    f"{path}: live matrix shape {lv.shape} does not "
                    f"match arrivals shape {arr.shape}")
        return ArrivalSchedule(arrivals=arr, max_staleness=k,
                               live=lv).validate()


def _load_binary_matrix(path, name: str, raw) -> np.ndarray:
    """Parse a JSON (n_rounds, n_agents) matrix of {0, 1} entries with
    clear errors (ragged rows, wrong rank, non-binary values)."""
    try:
        arr = np.asarray(raw, np.float32)
    except (TypeError, ValueError):
        raise ValueError(
            f"{path}: {name} must be a rectangular (n_rounds, n_agents) "
            f"matrix -- rows have inconsistent lengths or non-numeric "
            f"entries") from None
    if arr.ndim != 2:
        raise ValueError(
            f"{path}: {name} must be (n_rounds, n_agents), got shape "
            f"{arr.shape}")
    if not np.isin(arr, (0.0, 1.0)).all():
        bad = arr[~np.isin(arr, (0.0, 1.0))]
        raise ValueError(
            f"{path}: {name} entries must be 0 or 1, found "
            f"{bad.ravel()[:4].tolist()}")
    return arr


class AgentWorker(threading.Thread):
    """One agent's training loop on its own thread.

    The worker consumes round assignments from its inbox, simulates the
    local solve for ``latency_fn(agent, round) -> seconds`` of wall
    time, and submits ``(agent, round, error)`` to the broker's buffer
    (``error`` is None on success; a raising ``latency_fn`` is
    SUBMITTED, not swallowed, so the gate can surface it).  The actual
    solver runs inside the coordinator's round (the numerics
    split above) -- the thread realizes only the *duration*."""

    def __init__(self, agent: int,
                 latency_fn: Callable[[int, int], float],
                 buffer: "queue.Queue"):
        super().__init__(daemon=True, name=f"fed-agent-{agent}")
        self.agent = agent
        self._latency_fn = latency_fn
        self._buffer = buffer
        self.inbox: "queue.Queue" = queue.Queue()

    def run(self) -> None:
        while True:
            item = self.inbox.get()
            if item is None:            # shutdown sentinel
                return
            round_idx = item
            try:
                delay = float(self._latency_fn(self.agent, round_idx))
                if delay > 0.0:
                    time.sleep(delay)
            except Exception as err:    # surfaced at the round gate
                self._buffer.put((self.agent, round_idx, err))
                continue
            self._buffer.put((self.agent, round_idx, None))


def _accepts_faults(round_fn) -> bool:
    """Whether ``round_fn`` takes the ``(state, u, corrupt, live)``
    fault-capable signature (vs the legacy 2-arg ``(state, u)``)."""
    try:
        params = inspect.signature(round_fn).parameters.values()
    except (TypeError, ValueError):
        return False
    n = 0
    for p in params:
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return True
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            n += 1
    return n >= 4


class IncrementBroker:
    """Bounded-staleness buffer + round-gate coordinator loop.

    ``latency_fn(agent, round) -> seconds`` shapes the traffic (default:
    a deterministic pseudo-random few-millisecond jitter so runs finish
    fast but schedules are nontrivial).  Straggler fleets are one
    lambda away.

    Fault tolerance (the ROUND PROTOCOL above): ``gate_timeout`` bounds
    each round gate's wait (None -- the historical default -- blocks
    forever and is rejected when a :class:`~repro_torch.fed.faults.FaultPlan`
    can lose work); a missing agent is retried up to ``max_retries``
    times with the window growing by ``retry_backoff`` per attempt,
    then evicted.  After each :meth:`run` the realized
    :class:`~repro_torch.fed.faults.FaultRecord` is left on ``self.record``.
    """

    def __init__(self, n_agents: int, max_staleness: int,
                 latency_fn: Optional[Callable[[int, int], float]] = None,
                 grace: float = 0.0, seed: int = 0,
                 gate_timeout: Optional[float] = None,
                 max_retries: int = 2, retry_backoff: float = 2.0,
                 join_timeout: float = 5.0):
        if n_agents < 1:
            raise ValueError("n_agents must be >= 1")
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if gate_timeout is not None and not gate_timeout > 0:
            raise ValueError("gate_timeout must be positive seconds "
                             "(None = block forever)")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if retry_backoff < 1.0:
            raise ValueError("retry_backoff must be >= 1")
        self.n_agents = n_agents
        self.max_staleness = max_staleness
        self.grace = float(grace)
        self.gate_timeout = gate_timeout
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.join_timeout = float(join_timeout)
        self.record: Optional[faults_lib.FaultRecord] = None
        if latency_fn is None:
            rng = np.random.default_rng(seed)
            # pre-drawn jitter table keeps the default deterministic per
            # seed without sharing an rng across threads
            table = rng.uniform(0.0, 0.004, size=(n_agents, 64))
            latency_fn = lambda a, r: float(table[a, r % 64])  # noqa: E731
        self._latency_fn = latency_fn

    # ------------------------------------------------------------------
    def run(self, round_fn: Callable[..., Any], state: Any,
            n_rounds: int,
            faults: Optional[faults_lib.FaultPlan] = None
            ) -> Tuple[Any, ArrivalSchedule]:
        """Drive ``n_rounds`` async rounds; returns
        ``(final_state, schedule)``.

        ``round_fn(state, arrival_row) -> state`` is the round -- e.g.
        ``lambda s, u: algo.round_with_arrival(s, u)[0]`` on the dense
        front end, or a closure over ``trainer.step(..., arrival=u)`` at
        model scale; it runs on the calling thread.  For faulty runs pass the
        4-arg form ``round_fn(state, u, corrupt, live)`` (e.g. over
        ``algo.round_with_faults``); the realized
        :class:`~repro_torch.fed.faults.FaultRecord` is left on
        ``self.record``."""
        K = self.max_staleness
        N = self.n_agents
        plan = faults
        if plan is not None:
            plan.check_agents(N)
            if self.gate_timeout is None and plan.needs_timeout():
                raise ValueError(
                    "a FaultPlan with crash/drop events needs a broker "
                    "gate_timeout: without one the round gate would "
                    "block forever on work that never arrives")
        latency = self._latency_fn
        if plan is not None:
            latency = plan.wrap_latency(latency)
        # a FRESH buffer per run: a straggler worker from a previous
        # run() that outlived its join timeout can only submit into its
        # own (abandoned) queue, never into this one
        buffer: "queue.Queue" = queue.Queue()
        workers = [AgentWorker(a, latency, buffer) for a in range(N)]
        for w in workers:
            w.start()
        pending_age = np.full(N, -1, np.int64)      # -1 = fresh
        dispatch_round = np.full(N, -1, np.int64)   # round of pending work
        attempts = np.zeros(N, np.int64)            # failed deliveries
        ready = np.zeros(N, bool)     # submitted, not applied
        live = np.ones(N, bool)
        accepts_faults = _accepts_faults(round_fn)
        record = faults_lib.FaultRecord(n_agents=N)
        self.record = record
        rows: List[np.ndarray] = []
        live_rows: List[np.ndarray] = []

        def dispatch(a: int, assigned_round: int, now_round: int) -> None:
            # work sent to a plan-crashed agent vanishes: nothing enters
            # the worker inbox, so the gate timeout machinery engages
            if plan is None or not plan.crashed(a, now_round):
                workers[a].inbox.put(int(assigned_round))

        def retry_or_evict(a: int, r: int) -> None:
            attempts[a] += 1
            if attempts[a] > self.max_retries:
                live[a] = False
                ready[a] = False
                pending_age[a] = -1
                record.note_eviction(a, r)
            else:
                record.note_retry(a, int(dispatch_round[a]),
                                  int(attempts[a]))
                dispatch(a, int(dispatch_round[a]), r)

        def consume(item, r: int) -> None:
            a, rnd, err = item
            if (not live[a] or pending_age[a] < 0
                    or rnd != dispatch_round[a] or ready[a]):
                return   # stale duplicate / evicted straggler
            if err is not None:
                record.note_error(a, int(rnd), err)
                if self.gate_timeout is None:
                    raise RuntimeError(
                        f"agent {a} worker failed in round {int(rnd)}: "
                        f"{err!r}") from err
                retry_or_evict(a, r)
                return
            if plan is not None and plan.dropped(a, int(rnd),
                                                 int(attempts[a])):
                record.note_drop(a, int(rnd))
                return   # lost in transit; the gate redispatches
            ready[a] = True

        try:
            for r in range(n_rounds):
                # 0. rejoins: a revived agent re-enters the fleet fresh
                if plan is not None:
                    for a in plan.rejoins_at(r):
                        if not live[a]:
                            live[a] = True
                            pending_age[a] = -1
                            ready[a] = False
                            record.note_rejoin(a, r)

                # 1. dispatch this round's work to every live fresh agent
                for a in range(N):
                    if live[a] and pending_age[a] < 0:
                        pending_age[a] = 0
                        dispatch_round[a] = r
                        attempts[a] = 0
                        dispatch(a, r, r)

                # 2. gate on must-arrive agents (work K rounds old);
                # K = 0 blocks on every dispatched agent -- the
                # synchronous barrier.  With a gate_timeout, expiry
                # retries (backoff) then evicts the missing agents
                gate_start = time.monotonic()
                while True:
                    must = live & (pending_age >= K) & ~ready
                    if not must.any():
                        break
                    if self.gate_timeout is None:
                        consume(buffer.get(), r)
                        continue
                    window = self.gate_timeout * (
                        self.retry_backoff ** int(attempts[must].max()))
                    remain = gate_start + window - time.monotonic()
                    item = None
                    if remain > 0:
                        try:
                            item = buffer.get(timeout=remain)
                        except queue.Empty:
                            pass
                    if item is not None:
                        consume(item, r)
                        continue
                    for a in np.nonzero(must)[0]:
                        retry_or_evict(int(a), r)
                    if not live.any():
                        raise RuntimeError(
                            f"round {r}: every agent exceeded the retry "
                            f"budget and was evicted -- no survivors to "
                            f"average")
                    gate_start = time.monotonic()   # new attempt window

                # 3. grace-drain whatever else is already in the buffer
                deadline = time.monotonic() + self.grace
                while True:
                    try:
                        timeout = deadline - time.monotonic()
                        item = buffer.get(timeout=max(timeout, 0.0))
                    except queue.Empty:
                        break
                    consume(item, r)

                # 4. realize the rows, feed the round, age misses
                u = (ready & live).astype(np.float32)
                corrupt = None
                if plan is not None:
                    # plans with byzantine events realize (N, 2)
                    # [mult, add] pairs, other plans (N,) multiplicative
                    # rows (the reference's encoding of each)
                    byz = plan.has_byzantine
                    crow = (np.zeros((N, 2), np.float32) if byz
                            else np.zeros(N, np.float32))
                    hit = False
                    for a in np.nonzero(ready & live)[0]:
                        rnd = int(dispatch_round[a])
                        val = plan.corrupt_value(int(a), rnd)
                        if val is not None:
                            crow[a] = (val, 0.0) if byz else val
                            hit = True
                        if byz:
                            pair = plan.byzantine_at(int(a), rnd)
                            if pair is not None:
                                crow[a] = pair
                                hit = True
                    if hit:
                        corrupt = crow
                        record.note_corrupt_row(r, crow)
                live_arg = (live.astype(np.float32)
                            if record.evictions else None)
                if accepts_faults:
                    state = round_fn(state, u, corrupt, live_arg)
                elif corrupt is not None or live_arg is not None:
                    raise TypeError(
                        "this run produced fault rows (corrupt/evicted "
                        "agents) but round_fn only takes (state, u) -- "
                        "pass the 4-arg form, e.g. lambda s, u, c, l: "
                        "algo.round_with_faults(s, u, c, l)[0]")
                else:
                    state = round_fn(state, u)
                rows.append(u)
                live_rows.append(live.astype(np.float32))
                pending_age[ready] = -1
                pending_age[pending_age >= 0] += 1
                ready[:] = False
        finally:
            for w in workers:
                w.inbox.put(None)
            for w in workers:
                w.join(timeout=self.join_timeout)
        arrivals = (np.stack(rows) if rows
                    else np.zeros((0, N), np.float32))
        lv = None
        if record.evictions:
            lv = (np.stack(live_rows) if live_rows
                  else np.zeros((0, N), np.float32))
        schedule = ArrivalSchedule(arrivals=arrivals, max_staleness=K,
                                   live=lv).validate()
        return state, schedule


def replay(round_fn: Callable[..., Any], state: Any,
           schedule: ArrivalSchedule,
           record: Optional[faults_lib.FaultRecord] = None) -> Any:
    """Push a recorded schedule's rows through the round from ``state``;
    with the same init this reproduces the broker run bit for bit (the
    broker only ever chose the rows).

    For a faulty run pass the broker's :class:`FaultRecord` and the
    4-arg ``round_fn(state, u, corrupt, live)``: each round replays the
    exact ``corrupt`` and ``live`` rows the original run realized
    (``live`` stays None before the first eviction, as in the run)."""
    for r, row in enumerate(np.asarray(schedule.arrivals, np.float32)):
        if record is None:
            state = round_fn(state, row)
        else:
            state = round_fn(state, row, record.corrupt_row(r),
                             record.live_row(r))
    return state
