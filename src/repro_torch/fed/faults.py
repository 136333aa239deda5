"""Deterministic fault plans and fault records (counterpart of
``repro/fed/faults.py``, which imports only numpy; copied so that the
port imports nothing of the reference).

A seeded :class:`FaultPlan` decides ahead of time which agents crash,
stall, drop their uplink, corrupt their increment, or turn byzantine; a
:class:`FaultRecord` captures what a broker did about it (evictions,
rejoins, retries, the corruption rows a round consumed).  Plans and
records are plain host-side data, JSON round-trippable (NaN corrupt
values included) and saved in the reference's file format, so each
package loads the other's plans and records.  The host broker
(:class:`repro_torch.fed.broker.IncrementBroker`) consults a plan every
round -- crashes, rejoins, drop attempts, stall delays, whether it needs
a gate timeout -- and notes what it did in a record (evictions, rejoins,
retries, drops, worker errors, the corruption rows);
:func:`repro_torch.fed.broker.replay` replays a record bit for bit.
Without a broker a caller realises a plan into the rows that
:meth:`repro_torch.fed.api.ModelTrainer.step` takes itself:

    row = np.zeros((N, 2), np.float32)
    for a in range(N):
        pair = plan.byzantine_at(a, r)
        if pair is not None:
            row[a] = pair

Fault kinds
-----------
``crash``    agent is dead for rounds ``[round, until)`` (``until=None``
             = forever).
``drop``     the uplink for ``round`` is lost on its first attempt.
``corrupt``  the increment for ``round`` arrives multiplied by
             ``value`` per row (NaN/Inf poison it outright, a huge
             finite value trips the norm guard); applied in the round by
             :func:`repro_torch.fed.engine.apply_corruption`.
``stall``    ``delay`` seconds are added to the worker's latency for
             ``round``.

Byzantine kinds (finite and in-norm, so only a robust aggregator stops
them: :mod:`repro_torch.fed.robust`), windowed like ``crash``:
``sign_flip`` submits ``-w``; ``scale`` submits ``value * w``; ``drift``
submits ``w + value``.  They are realised as ``(N, 2)`` ``[mult, add]``
rows; plans without byzantine events realise ``(N,)`` rows.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BYZANTINE_KINDS = ("sign_flip", "scale", "drift")

FAULT_KINDS = ("crash", "drop", "corrupt", "stall") + BYZANTINE_KINDS

# THE no-value sentinel: every valueless event must carry this exact
# object so dataclass equality (which can only see NaN == NaN through
# the identity shortcut) treats regenerated / reloaded plans as equal
_NAN = float("nan")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` hitting ``agent`` at ``round``."""

    kind: str
    agent: int
    round: int
    until: Optional[int] = None    # crash/byzantine: first round clear
    value: float = _NAN            # corrupt/scale/drift parameter
    delay: float = 0.0             # stall only: extra latency (seconds)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if self.agent < 0:
            raise ValueError(f"agent must be >= 0, got {self.agent}")
        if self.round < 0:
            raise ValueError(f"round must be >= 0, got {self.round}")
        if self.until is not None and self.until <= self.round:
            raise ValueError(
                f"crash until={self.until} must exceed round={self.round}")
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")
        if self.kind in BYZANTINE_KINDS:
            if self.delay:
                raise ValueError(
                    f"{self.kind} events carry no delay (that is what "
                    f"'stall' models), got delay={self.delay}")
            if self.kind == "sign_flip":
                if not math.isnan(self.value):
                    raise ValueError(
                        f"sign_flip takes no value (the multiplier IS "
                        f"-1), got value={self.value}")
            elif self.kind == "scale":
                if not (math.isfinite(self.value) and self.value != 0.0):
                    raise ValueError(
                        f"scale needs a finite nonzero value (non-finite "
                        f"poison is the 'corrupt' kind), got "
                        f"value={self.value}")
            elif not math.isfinite(self.value):    # drift
                raise ValueError(
                    f"drift needs a finite value, got value={self.value}")

    @property
    def byzantine(self) -> bool:
        return self.kind in BYZANTINE_KINDS

    def byzantine_pair(self) -> Tuple[float, float]:
        """The ``(mult, add)`` row this event realizes
        (:func:`repro.fed.engine.apply_corruption` semantics)."""
        if self.kind == "sign_flip":
            return (-1.0, 0.0)
        if self.kind == "scale":
            return (float(self.value), 0.0)
        if self.kind == "drift":
            return (1.0, float(self.value))
        raise ValueError(f"{self.kind!r} is not a byzantine kind")

    def active_at(self, round: int) -> bool:
        """Whether this (windowed) event is live at ``round``."""
        return (self.round <= round
                and (self.until is None or round < self.until))

    def to_json(self) -> dict:
        d = {"kind": self.kind, "agent": int(self.agent),
             "round": int(self.round)}
        if self.until is not None:
            d["until"] = int(self.until)
        if self.kind in ("corrupt", "scale", "drift"):
            d["value"] = float(self.value)
        if self.kind == "stall":
            d["delay"] = float(self.delay)
        return d

    @staticmethod
    def from_json(d: dict) -> "FaultEvent":
        v = d.get("value")
        return FaultEvent(kind=d["kind"], agent=int(d["agent"]),
                          round=int(d["round"]),
                          until=(None if d.get("until") is None
                                 else int(d["until"])),
                          value=(_NAN if v is None or (
                              isinstance(v, float) and math.isnan(v))
                              else float(v)),
                          delay=float(d.get("delay", 0.0)))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic set of fault events.

    Like ``ArrivalSchedule`` this is an ARTIFACT: generate it once
    (:meth:`generate`), save it next to the run, and any later process
    can reload it and reproduce the exact same failure pattern.  The
    queries below are what the broker consults each round.
    """

    events: Tuple[FaultEvent, ...]
    n_agents: Optional[int] = None   # validated bound when given
    seed: Optional[int] = None       # provenance only

    def __post_init__(self):
        evs = tuple(e if isinstance(e, FaultEvent) else FaultEvent(**e)
                    for e in self.events)
        object.__setattr__(self, "events", evs)
        if self.n_agents is not None:
            self.check_agents(int(self.n_agents))
        # (agent, round) indexes, built once: the broker queries per
        # agent per round per attempt from its hot loop, and a linear
        # scan over a many-round generated plan is O(events) per query.
        # First matching event wins.
        corrupt_index: Dict[Tuple[int, int], float] = {}
        byz_index: Dict[int, List[FaultEvent]] = {}
        for e in evs:
            if e.kind == "corrupt":
                corrupt_index.setdefault((e.agent, e.round),
                                         float(e.value))
            elif e.kind in BYZANTINE_KINDS:
                byz_index.setdefault(e.agent, []).append(e)
        object.__setattr__(self, "_corrupt_index", corrupt_index)
        object.__setattr__(self, "_byz_index", byz_index)

    # -- broker-facing queries ------------------------------------------
    def check_agents(self, n_agents: int) -> None:
        bad = [e for e in self.events if e.agent >= n_agents]
        if bad:
            raise ValueError(
                f"fault plan targets agents {sorted({e.agent for e in bad})} "
                f"but the fleet has only {n_agents} agents")

    def needs_timeout(self) -> bool:
        """True when the plan can make dispatched work vanish: a broker
        then needs a ``gate_timeout``, or its round gate blocks forever."""
        return any(e.kind in ("crash", "drop") for e in self.events)

    def crashed(self, agent: int, round: int) -> bool:
        return any(e.kind == "crash" and e.agent == agent
                   and e.round <= round
                   and (e.until is None or round < e.until)
                   for e in self.events)

    def rejoins_at(self, round: int) -> List[int]:
        """Agents whose crash window ends exactly at ``round``."""
        return sorted({e.agent for e in self.events
                       if e.kind == "crash" and e.until == round})

    def dropped(self, agent: int, round: int, attempt: int) -> bool:
        """Whether delivery ``attempt`` (0-based) of this round's uplink
        is lost: each matching drop event eats one attempt, so the
        broker's redispatch gets through in the end."""
        n = sum(1 for e in self.events if e.kind == "drop"
                and e.agent == agent and e.round == round)
        return attempt < n

    def corrupt_value(self, agent: int, round: int) -> Optional[float]:
        return self._corrupt_index.get((agent, round))

    def byzantine_at(self, agent: int, round: int
                     ) -> Optional[Tuple[float, float]]:
        """The ``(mult, add)`` pair of the first byzantine event whose
        window covers ``(agent, round)``, or None -- the broker realizes
        this into the ``(N, 2)`` corruption row."""
        for e in self._byz_index.get(agent, ()):
            if e.active_at(round):
                return e.byzantine_pair()
        return None

    @property
    def has_byzantine(self) -> bool:
        """Whether any byzantine event is scheduled: gates the broker's
        corruption-row encoding -- plans without byzantine events keep
        the historical ``(N,)`` rows so old recordings replay bitwise."""
        return bool(self._byz_index)

    def stall_delay(self, agent: int, round: int) -> float:
        return sum(e.delay for e in self.events if e.kind == "stall"
                   and e.agent == agent and e.round == round)

    def wrap_latency(self, latency_fn: Callable[[int, int], float]
                     ) -> Callable[[int, int], float]:
        """A latency function with the plan's stalls added."""
        def fn(agent: int, round: int) -> float:
            return float(latency_fn(agent, round)) + self.stall_delay(
                agent, round)
        return fn

    # -- construction / persistence -------------------------------------
    @staticmethod
    def generate(seed: int, n_agents: int, n_rounds: int, *,
                 p_crash: float = 0.0, crash_length: Optional[int] = None,
                 p_drop: float = 0.0, p_corrupt: float = 0.0,
                 corrupt_value: float = _NAN,
                 p_stall: float = 0.0,
                 stall_delay: float = 0.05,
                 n_byzantine: int = 0,
                 byzantine_kind: str = "sign_flip",
                 byzantine_value: Optional[float] = None,
                 byzantine_start: int = 0) -> "FaultPlan":
        """Draw a plan from a seeded rng -- same (seed, shape, probs)
        always yields the same events.

        ``n_byzantine`` picks that many distinct agents (from the same
        rng, so the pick is seeded too) and schedules one PERSISTENT
        ``byzantine_kind`` event per agent starting at
        ``byzantine_start``; ``byzantine_value`` is required for
        ``scale``/``drift``.  ``n_byzantine=0`` (the default) draws
        nothing extra, keeping legacy plans bit-identical."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        if n_byzantine:
            if byzantine_kind not in BYZANTINE_KINDS:
                raise ValueError(
                    f"unknown byzantine kind {byzantine_kind!r} "
                    f"(one of {BYZANTINE_KINDS})")
            if byzantine_kind != "sign_flip" and byzantine_value is None:
                raise ValueError(
                    f"{byzantine_kind} needs a byzantine_value")
            if int(n_byzantine) > n_agents:
                raise ValueError(
                    f"n_byzantine={n_byzantine} exceeds "
                    f"n_agents={n_agents}")
            picked = rng.choice(n_agents, size=int(n_byzantine),
                                replace=False)
            for a in sorted(int(a) for a in picked):
                events.append(FaultEvent(
                    byzantine_kind, a, int(byzantine_start),
                    value=(_NAN if byzantine_value is None
                           else float(byzantine_value))))
        crashed_until = np.zeros(n_agents, np.int64)   # rounds < this: dead
        for r in range(n_rounds):
            for a in range(n_agents):
                if r < crashed_until[a]:
                    continue    # already down -- no new faults while dead
                if p_crash and rng.random() < p_crash:
                    until = (None if crash_length is None
                             else min(r + int(crash_length), n_rounds))
                    events.append(FaultEvent("crash", a, r, until=until))
                    crashed_until[a] = n_rounds if until is None else until
                    continue
                if p_drop and rng.random() < p_drop:
                    events.append(FaultEvent("drop", a, r))
                if p_corrupt and rng.random() < p_corrupt:
                    events.append(FaultEvent("corrupt", a, r,
                                             value=corrupt_value))
                if p_stall and rng.random() < p_stall:
                    events.append(FaultEvent("stall", a, r,
                                             delay=stall_delay))
        return FaultPlan(tuple(events), n_agents=n_agents, seed=seed)

    def to_json(self) -> dict:
        return {"events": [e.to_json() for e in self.events],
                "n_agents": self.n_agents, "seed": self.seed}

    @staticmethod
    def from_json(d: dict) -> "FaultPlan":
        return FaultPlan(tuple(FaultEvent.from_json(e)
                               for e in d["events"]),
                         n_agents=d.get("n_agents"), seed=d.get("seed"))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)   # allow_nan: corrupt values

    @staticmethod
    def load(path: str) -> "FaultPlan":
        with open(path) as fh:
            return FaultPlan.from_json(json.load(fh))

@dataclasses.dataclass
class FaultRecord:
    """What the broker actually DID during a faulty run.

    The record is the second half of the replay contract: the
    ``ArrivalSchedule`` pins the arrival rows, the record pins the
    per-round ``corrupt`` and ``live`` rows the round consumed
    (plus the retry/drop/error bookkeeping for inspection).  ``events``
    is one chronological list of ``(round, agent, "evict"|"rejoin")``
    entries so a rejoin-then-re-evict within one run stays ordered.
    """

    n_agents: int
    events: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list)
    retries: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)    # (agent, round, attempt)
    drops: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)    # (agent, round)
    errors: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list)    # (agent, round, repr(exc))
    corrupt_rows: dict = dataclasses.field(
        default_factory=dict)    # {round: [value] * n_agents}

    # -- broker hooks ----------------------------------------------------
    def note_eviction(self, agent: int, round: int) -> None:
        self.events.append((int(round), int(agent), "evict"))

    def note_rejoin(self, agent: int, round: int) -> None:
        self.events.append((int(round), int(agent), "rejoin"))

    def note_retry(self, agent: int, round: int, attempt: int) -> None:
        self.retries.append((int(agent), int(round), int(attempt)))

    def note_drop(self, agent: int, round: int) -> None:
        self.drops.append((int(agent), int(round)))

    def note_error(self, agent: int, round: int, err: BaseException) -> None:
        self.errors.append((int(agent), int(round), repr(err)))

    def note_corrupt_row(self, round: int, row: np.ndarray) -> None:
        row = np.asarray(row)
        if row.ndim == 2:      # byzantine (N, 2) [mult, add] pairs
            self.corrupt_rows[int(round)] = [
                [float(m), float(ad)] for m, ad in row]
        else:
            self.corrupt_rows[int(round)] = [float(v) for v in row]

    # -- replay queries --------------------------------------------------
    @property
    def evictions(self) -> List[Tuple[int, int]]:
        return [(a, r) for (r, a, k) in self.events if k == "evict"]

    @property
    def rejoins(self) -> List[Tuple[int, int]]:
        return [(a, r) for (r, a, k) in self.events if k == "rejoin"]

    @property
    def has_faults(self) -> bool:
        return bool(self.events or self.corrupt_rows)

    def first_eviction_round(self) -> Optional[int]:
        rounds = [r for (r, _a, k) in self.events if k == "evict"]
        return min(rounds) if rounds else None

    def live_row(self, round: int) -> Optional[np.ndarray]:
        """The (N,) live row the broker passed for ``round`` -- None
        before the first eviction (the broker passes None until then, so
        replay passes None too and runs the fault-free round).

        The rows are computed once as per-event snapshots (lazily,
        rebuilt whenever events grew) and answered by binary search;
        :meth:`_live_row_scan` is the exact form for out-of-order
        events."""
        rounds, snaps, first = self._live_index()
        if first is None or round < first:
            return None
        if rounds is None:            # out-of-order events: exact scan
            return self._live_row_scan(round)
        idx = bisect.bisect_right(rounds, round)
        return snaps[idx - 1].copy() if idx else None

    def _live_row_scan(self, round: int) -> Optional[np.ndarray]:
        """The linear scan of the events in list order."""
        first = self.first_eviction_round()
        if first is None or round < first:
            return None
        row = np.ones(self.n_agents, np.float32)
        for (r, a, kind) in self.events:
            if r <= round:
                row[a] = 0.0 if kind == "evict" else 1.0
        return row

    def _live_index(self):
        """Lazy ``(event rounds, cumulative row snapshots, first evict
        round)``, keyed on ``len(events)`` (the record only appends).
        ``rounds`` comes back None when events arrived out of round
        order (hand-built records) -- callers then fall back to the
        scan, which applies events in LIST order like the original."""
        cached = getattr(self, "_live_cache", None)
        if cached is not None and cached[0] == len(self.events):
            return cached[1], cached[2], cached[3]
        first = self.first_eviction_round()
        rounds: Optional[List[int]] = []
        snaps: List[np.ndarray] = []
        row = np.ones(self.n_agents, np.float32)
        prev = None
        for (r, a, kind) in self.events:
            if prev is not None and r < prev:
                rounds, snaps = None, []
                break
            prev = r
            row = row.copy()
            row[a] = 0.0 if kind == "evict" else 1.0
            rounds.append(r)
            snaps.append(row)
        self._live_cache = (len(self.events), rounds, snaps, first)
        return rounds, snaps, first

    def live_matrix(self, n_rounds: int) -> np.ndarray:
        """(n_rounds, N) 0/1 liveness, for schedule validation."""
        lm = np.ones((n_rounds, self.n_agents), np.float32)
        for (r, a, kind) in self.events:
            if r < n_rounds:
                lm[r:, a] = 0.0 if kind == "evict" else 1.0
        return lm

    def corrupt_row(self, round: int) -> Optional[np.ndarray]:
        row = self.corrupt_rows.get(int(round))
        return None if row is None else np.asarray(row, np.float32)

    # -- persistence -----------------------------------------------------
    def to_json(self) -> dict:
        return {"n_agents": int(self.n_agents),
                "events": [list(e) for e in self.events],
                "retries": [list(e) for e in self.retries],
                "drops": [list(e) for e in self.drops],
                "errors": [list(e) for e in self.errors],
                "corrupt_rows": {str(r): row for r, row
                                 in self.corrupt_rows.items()}}

    @staticmethod
    def from_json(d: dict) -> "FaultRecord":
        rec = FaultRecord(n_agents=int(d["n_agents"]))
        rec.events = [(int(r), int(a), str(k)) for r, a, k in d["events"]]
        rec.retries = [(int(a), int(r), int(n)) for a, r, n in d["retries"]]
        rec.drops = [(int(a), int(r)) for a, r in d["drops"]]
        rec.errors = [(int(a), int(r), str(m)) for a, r, m in d["errors"]]

        def parse_row(row):
            if row and isinstance(row[0], (list, tuple)):
                return [[float(m), float(ad)] for m, ad in row]
            return [float(v) for v in row]

        rec.corrupt_rows = {int(r): parse_row(row)
                            for r, row in d["corrupt_rows"].items()}
        return rec

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)

    @staticmethod
    def load(path: str) -> "FaultRecord":
        with open(path) as fh:
            return FaultRecord.from_json(json.load(fh))
