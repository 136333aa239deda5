"""Bounded-staleness async rounds (counterpart of
``repro/fed/async_engine.py``).

The synchronous round (:func:`repro_torch.fed.engine.packed_round_step`)
trains every agent against THIS round's reflection and averages the agents
the participation draw selected.  Here agents return their increments
late, and the coordinator applies them as they arrive.  The round stays a
deterministic function of its inputs: given the arrival rows it replays
bit for bit (WHEN an agent arrives is decided on the host by
:mod:`repro_torch.fed.broker`; this module owns the numbers).

THE STALENESS CONTRACT (the reference's)
========================================

Two per-agent carriers ride next to ``(x, z, t)``:

* ``y_tag`` -- the coordinator point agent i's current local work was
  computed against (the ``y`` it pulled; shaped like ``x``);
* ``staleness`` -- ``(N,)`` int32: how many rounds old that work is; 0
  means the agent starts fresh work this round.

One round (:func:`packed_async_round_step`, :func:`async_round_step`):

1. The coordinator edge of the synchronous round: ``y`` and the fresh
   reflection ``v`` from :func:`repro_torch.fed.engine.coordinator_edge`
   (the fused uplink kernel, unchanged).
2. Training targets: fresh agents take ``v`` and record ``y_tag <- y``;
   stale agents keep training against ``2 y_tag - z`` (``z_i`` does not
   move while an agent is stale, so this is the reflection it pulled).
   Every agent runs the local solver warm-started at its ``x``: a stale
   agent runs more local epochs against the same proximal target.  With
   agent groups (:func:`repro_torch.fed.engine.run_solvers`) each group's
   agents run their group's solver and epochs against their own targets,
   stale or fresh.
3. Arrivals: the participation draw (drawn from the generator AFTER the
   solver, as the synchronous round draws it, so a generator gives both
   rounds the same draws), or a given row (``arrival=``), OR-ed with the
   bound -- an agent whose work is ``max_staleness`` rounds old is forced
   to arrive -- and screened by the increment guard.
4. The synchronous downlink edge with the arrival row where the
   participation row was (the fused downlink kernel, unchanged); a stale
   arriving agent is then corrected to its tagged point:
   ``z_i <- z_i + 2 damping (w_i - y_tag_i)``.
5. A non-arriving agent below the bound keeps its local progress
   (``x <- w``) and ages (``staleness += 1``).  At ``max_staleness = 0``
   no stale work exists and a miss discards the round's work: the
   synchronous round.

PARITY: with ``max_staleness = 0`` the async round IS the synchronous
round bit for bit (both layouts, both backends, every compressor): the
forcing term is zero when every counter is zero, no row is stale, and
every select passes the synchronous values through.  The port holds this
contract in eager PyTorch, where the reference's XLA fuses the two rounds
differently (its own K = 0 assertions differ by float32 rounding).

MEMORY.  Where the reference forms ``2 y_tag - z`` and ``z + 2 damping
(w - y_tag)`` over every row and then selects, the port computes them on
the rows that need them only -- the stale rows; the stale rows that
arrived -- and copies ``w`` into the kept rows of ``x`` only, writing
each long row in place in the round's own buffers (no temporary: a bf16
row of the full-width gemma2-2b state is 1.49 GB) and short rows (the
dense state) gathered together (:func:`_apply_rows`).  Each row's
numbers are the reference's formulas, and a round whose agents are all
fresh and all arrive -- every K = 0 round -- adds only the ``y_tag``
copies to the synchronous round.  The rows are chosen on the host: the
counters are read at the start of the round and the arrival row after
the guard (two reads a round at K > 0, none at K = 0).  The round updates
the ``y_tag`` it is given IN PLACE (like the compressed exchange's
``t``).

Under a ``mesh`` (the engine's mesh contract) ``y_tag`` is this rank's
block of rows -- and of columns where the model axis splits them, like
``x`` -- and ``staleness`` its ``(N / S,)`` rows: the draw is global and
sliced, the forcing term and the guard are local, so the counters advance
locally.  The result's ``u`` is this rank's block; front ends gather the
``(N,)`` row for metrics and schedules (:func:`sharding.agent_gather`).

Privacy: staleness changes the composition, not the mechanism -- an
increment ``s`` rounds stale carries ``s + 1`` rounds of local epochs,
and work discarded at the bound was never sent.  :func:`effective_counts`
derives the per-agent counts from a recorded schedule;
:func:`repro_torch.fed.api.effective_privacy_report` composes over them.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.fed import compress as compress_lib
from repro_torch.fed import engine, sharding
from repro_torch.fed.engine import (ASYNC_MODES, ProxH,  # noqa: F401
                                    RoundConfig, SolverAssignment,
                                    StalenessConfig)
from repro_torch.kernels.robust_agg.ref import live_row

tree_map = pytree.tree_map

# a row of at least this many elements is written in place, one row at a
# time; shorter rows are handled together (the dense state's rows of n)
_LONG_ROW = 1 << 20


class AsyncRoundResult(NamedTuple):
    """:class:`repro_torch.fed.engine.RoundResult` plus the staleness
    carry."""

    x: Any               # tree / buffer, agent axis leading
    z: Any
    t: Any               # coordinator's copy (z_new when uncompressed)
    y: Any               # coordinator model of THIS round
    y_tag: Any           # per-agent pulled coordinator point
    staleness: torch.Tensor   # (N,) int32 age of each agent's work
    u: torch.Tensor      # (N,) float32 realised arrival row (rank's block)
    aux: Any


# ---------------------------------------------------------------------------
# State initialization
# ---------------------------------------------------------------------------

def init_staleness(n_agents: int, device=None) -> torch.Tensor:
    """Round-0 counters: every agent starts fresh."""
    return torch.zeros((n_agents,), dtype=torch.int32, device=device)


def init_y_tag(z: Any) -> Any:
    """Round-0 tags: zeros shaped like the agent-stacked state.  Never
    read: a fresh agent overwrites its tag with the round's ``y`` first."""
    return tree_map(torch.zeros_like, z)


# ---------------------------------------------------------------------------
# Round pieces
# ---------------------------------------------------------------------------

def _col(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """An ``(n,)`` mask shaped to broadcast against an agent-axis leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.ndim - 1))


def forced_arrivals(staleness: torch.Tensor, max_staleness: int) \
        -> torch.Tensor:
    """The bound: an agent holding work ``max_staleness`` rounds old must
    arrive.  Fresh agents are never forced, so at K = 0 the forcing term
    is all False and the arrival row is the participation draw."""
    return (staleness >= max_staleness) & (staleness > 0)


def arrival_mask(cfg: RoundConfig, staleness: torch.Tensor, *,
                 generator=None, arrival=None, live=None,
                 mesh=None) -> torch.Tensor:
    """The round's realised float32 arrival row, this rank's block: the
    participation draw over all N agents (or the given global row
    ``arrival``: broker runs and replays), sliced to the block, OR-ed with
    the forced arrivals of the local counters; an eviction ``live`` row
    (global) zeroes dead agents AFTER the forcing term."""
    device = staleness.device
    draw = engine.participation_mask(cfg, device, generator, arrival)
    draw = sharding.fed_row_spec(draw, mesh, cfg.n_agents)
    forced = forced_arrivals(staleness, cfg.staleness.max_staleness)
    u = torch.maximum(draw, forced.to(draw.dtype))
    if live is not None:
        u = u * sharding.fed_row_spec(live_row(live, cfg.n_agents, device),
                                      mesh, cfg.n_agents)
    return u


def _advance_staleness(staleness: torch.Tensor, u: torch.Tensor,
                       max_staleness: int, live=None) -> torch.Tensor:
    """Arrivals reset to 0; pending work below the bound ages by one; a
    miss AT the bound (only at K = 0) stays.  Evicted agents (``live`` 0,
    this rank's block) are pinned at 0: a rejoin starts them fresh."""
    aged = torch.where(staleness < max_staleness, staleness + 1, staleness)
    zero = torch.zeros_like(staleness)
    out = torch.where(u != 0, zero, aged)
    if live is not None:
        out = torch.where(live != 0, out, zero)
    return out


def _apply_rows(out: torch.Tensor, rows: List[int], op, *srcs) -> None:
    """``op(dst, *src_rows)`` writes rows ``rows`` of ``out`` from the same
    rows of ``srcs``.  Rows of ``_LONG_ROW`` elements or more are written
    in place through row views, one row at a time (no temporaries: one
    bf16 row of the full-width gemma2-2b state is 1.49 GB); shorter rows
    are gathered, computed together and scattered back once."""
    if not rows:
        return
    if out[0].numel() >= _LONG_ROW:
        for i in rows:
            op(out[i], *(s[i] for s in srcs))
        return
    idx = torch.tensor(rows, dtype=torch.long, device=out.device)
    dst = out.index_select(0, idx)
    op(dst, *(s.index_select(0, idx) for s in srcs))
    out.index_copy_(0, idx, dst)


# The row ops.  Each is the reference's formula, rounded after every
# operation as the out-of-place expression rounds it: ``2 y_tag - z``
# (2 y is exact) and ``z + (2 damping) (w - y_tag)`` (the last addition
# taken as ``d + z``, which is ``z + d`` bit for bit).

def _reflect(dst, y_tag, z):
    dst.copy_(y_tag).mul_(2.0).sub_(z)


def _tagged_increment(damping: float):
    def op(dst, z, w, y_tag):
        torch.sub(w, y_tag, out=dst)
        dst.mul_(2.0 * damping).add_(z)
    return op


def _copy(dst, src):
    dst.copy_(src)


def _row_sets(staleness: torch.Tensor, max_staleness: int):
    """``(fresh, stale, below)`` row lists of this rank's counters (one
    read of the ``(N,)`` counters on the host; none at K = 0, where every
    counter stays 0)."""
    s = [0] * staleness.numel() if max_staleness == 0 else staleness.tolist()
    fresh = [i for i, v in enumerate(s) if v == 0]
    stale = [i for i, v in enumerate(s) if v != 0]
    below = [i for i, v in enumerate(s) if v < max_staleness]
    return fresh, stale, below


def _arrival_rows(u: torch.Tensor, ok, live_block, stale: List[int],
                  below: List[int]):
    """``(stale_arrivals, kept)`` row lists after the guard (one read of
    the arrival row on the host): the stale rows that arrived, and the
    stragglers below the bound that keep their progress -- unless
    quarantined by the guard or evicted (a poisoned ``w`` must not be
    carried into the next round).  Nothing is read on the host when no
    row can need either (every K = 0 round)."""
    if not stale and not below:
        return [], []
    arrived = [v != 0 for v in u.tolist()]
    clean = [True] * len(arrived) if ok is None else ok.tolist()
    alive = ([True] * len(arrived) if live_block is None
             else [v != 0 for v in live_block.tolist()])
    return ([i for i in stale if arrived[i]],
            [i for i in below if not arrived[i] and clean[i] and alive[i]])


def _live_block(cfg: RoundConfig, live, device, mesh):
    if live is None:
        return None
    return sharding.fed_row_spec(live_row(live, cfg.n_agents, device), mesh,
                                 cfg.n_agents)


# ---------------------------------------------------------------------------
# One async round, packed layout
# ---------------------------------------------------------------------------

def packed_async_round_step(cfg: RoundConfig, meta, x: torch.Tensor,
                            z: torch.Tensor, t: torch.Tensor,
                            y_tag: torch.Tensor, staleness: torch.Tensor,
                            local_solver: SolverAssignment,
                            prox_h: ProxH = None, *, generator=None,
                            arrival=None, corrupt=None, live=None,
                            mesh=None) -> AsyncRoundResult:
    """One bounded-staleness round on the resident ``(N, width)`` buffers
    (module contract); mirrors :func:`repro_torch.fed.engine.packed_round_step`
    and its generator order.  ``arrival`` replaces the participation draw
    with a given global ``(N,)`` row; ``corrupt`` / ``live`` are the
    synchronous round's fault rows.  ``y_tag`` is updated in place."""
    if mesh is not None:
        engine.validate_mesh(cfg, mesh, local_solver=local_solver)
    K = cfg.staleness.max_staleness
    fresh, stale, below = _row_sets(staleness, K)
    z_seen = t if cfg.compressed else z
    z_seen = engine.robust_seen(cfg, z_seen, live, meta, mesh)
    y, v = engine.coordinator_edge_packed(cfg, z, z_seen, meta, prox_h, mesh)
    _apply_rows(v, stale, _reflect, y_tag, z)
    _apply_rows(y_tag, fresh, lambda dst: dst.copy_(y[0]))
    w, aux = engine.run_solvers(local_solver, x, v, cfg.n_agents, mesh)
    del v
    u = arrival_mask(cfg, staleness, generator=generator, arrival=arrival,
                     live=live, mesh=mesh)
    w = engine.apply_corruption(
        w, sharding.fed_row_spec(corrupt, mesh, cfg.n_agents))
    u, ok = engine.increment_guard(cfg, w, u, meta, mesh)
    x_new, z_new = engine.agent_edge_packed(cfg, u, w, x, z, y, z_seen,
                                            prox_h, mesh)
    live_block = _live_block(cfg, live, u.device, mesh)
    tagged, kept = _arrival_rows(u, ok, live_block, stale, below)
    _apply_rows(z_new, tagged, _tagged_increment(cfg.damping), z, w, y_tag)
    _apply_rows(x_new, kept, _copy, w)
    del w
    s_new = _advance_staleness(staleness, u, K, live_block)
    t_new = z_new
    if cfg.compressed:
        q = compress_lib.compress_increment_packed(z_new - t, meta, cfg,
                                                   mesh)
        t_new = t.addcmul_(u.to(q.dtype).reshape(-1, 1), q)
    return AsyncRoundResult(x=x_new, z=z_new, t=t_new, y=y, y_tag=y_tag,
                            staleness=s_new, u=u, aux=aux)


# ---------------------------------------------------------------------------
# One async round, tree layout
# ---------------------------------------------------------------------------

def async_round_step(cfg: RoundConfig, x: Any, z: Any, t: Any, y_tag: Any,
                     staleness: torch.Tensor, local_solver: SolverAssignment,
                     prox_h: ProxH = None, *, generator=None, arrival=None,
                     corrupt=None, live=None, mesh=None,
                     blocks=None) -> AsyncRoundResult:
    """:func:`packed_async_round_step` on agent-stacked trees (the rows
    of every leaf; each leaf's block under ``blocks``); mirrors
    :func:`repro_torch.fed.engine.round_step`."""
    if mesh is not None:
        engine.validate_mesh(cfg, mesh, local_solver=local_solver)
    K = cfg.staleness.max_staleness
    fresh, stale, below = _row_sets(staleness, K)
    z_seen = t if cfg.compressed else z
    z_seen = engine.robust_seen(cfg, z_seen, live, mesh=mesh, blocks=blocks)
    y, v = engine.coordinator_edge(cfg, z, z_seen, prox_h, mesh, blocks)
    leaves = pytree.tree_leaves
    for vl, ytl, zl, yl in zip(leaves(v), leaves(y_tag), leaves(z),
                               leaves(y)):
        _apply_rows(vl, stale, _reflect, ytl, zl)
        _apply_rows(ytl, fresh, lambda dst, yl=yl: dst.copy_(yl))
    w, aux = engine.run_solvers(local_solver, x, v, cfg.n_agents, mesh)
    del v
    u = arrival_mask(cfg, staleness, generator=generator, arrival=arrival,
                     live=live, mesh=mesh)
    w = engine.apply_corruption(
        w, sharding.fed_row_spec(corrupt, mesh, cfg.n_agents))
    u, ok = engine.increment_guard(cfg, w, u, blocks=blocks)
    x_new, z_new = engine.agent_edge(cfg, u, w, x, z, y, z_seen, prox_h,
                                     mesh)
    live_block = _live_block(cfg, live, u.device, mesh)
    tagged, kept = _arrival_rows(u, ok, live_block, stale, below)
    tag = _tagged_increment(cfg.damping)
    for zn, zl, wl, ytl, xn in zip(leaves(z_new), leaves(z), leaves(w),
                                   leaves(y_tag), leaves(x_new)):
        _apply_rows(zn, tagged, tag, zl, wl, ytl)
        _apply_rows(xn, kept, _copy, wl)
    del w
    s_new = _advance_staleness(staleness, u, K, live_block)
    t_new = z_new
    if cfg.compressed:
        q = compress_lib.compress_increment(tree_map(torch.sub, z_new, t),
                                            cfg, blocks)
        t_new = tree_map(
            lambda tl, ql: tl.addcmul_(_col(u.to(ql.dtype), ql), ql), t, q)
    return AsyncRoundResult(x=x_new, z=z_new, t=t_new, y=y, y_tag=y_tag,
                            staleness=s_new, u=u, aux=aux)


# ---------------------------------------------------------------------------
# Schedule analysis on the host (privacy composition, broker validation)
# ---------------------------------------------------------------------------

def effective_counts(schedule, max_staleness: int, live=None) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Per-agent effective composition of a realised ``(R, N)`` 0/1
    arrival schedule: int64 ``(arrivals, released_rounds)``, the
    increments agent i released and the rounds of local training they
    carried (an increment ``s`` rounds stale carries ``s + 1``; work
    discarded at the K = 0 bound charges nothing).  Replays
    :func:`_advance_staleness` on the host; ``live`` (an optional ``(R,
    N)`` 0/1 liveness matrix of a faulty run) pins evicted agents at 0 as
    the round does, keeping the charges released before an eviction."""
    sched = np.asarray(schedule)
    if sched.ndim != 2:
        raise ValueError(f"schedule must be (n_rounds, n_agents), got "
                         f"shape {sched.shape}")
    lv = _check_live(live, sched.shape)
    r_rounds, n = sched.shape
    s = np.zeros(n, np.int64)
    arrivals = np.zeros(n, np.int64)
    released = np.zeros(n, np.int64)
    for r in range(r_rounds):
        u = sched[r] != 0
        if lv is not None:
            u = u & (lv[r] != 0)
        arrivals += u
        released += np.where(u, s + 1, 0)
        s = np.where(u, 0, np.where(s < max_staleness, s + 1, s))
        if lv is not None:
            s = np.where(lv[r] != 0, s, 0)
    return arrivals, released


def _check_live(live, shape) -> Optional[np.ndarray]:
    if live is None:
        return None
    lv = np.asarray(live)
    if lv.shape != tuple(shape):
        raise ValueError(f"live matrix shape {lv.shape} does not match "
                         f"schedule shape {tuple(shape)}")
    return lv


def validate_schedule(schedule, max_staleness: int, live=None) -> None:
    """Raise ValueError when a schedule breaks the bound: no agent may
    miss a round while holding work ``max_staleness`` rounds old (the
    round would have forced it in).  With a ``live`` matrix evicted agents
    are exempt while dead, and an arrival of a dead agent is itself a
    violation."""
    sched = np.asarray(schedule)
    if sched.ndim != 2:
        raise ValueError(f"schedule must be (n_rounds, n_agents), got "
                         f"shape {sched.shape}")
    lv = _check_live(live, sched.shape)
    n = sched.shape[1]
    s = np.zeros(n, np.int64)
    for r, row in enumerate(sched):
        u = row != 0
        alive = np.ones(n, bool) if lv is None else (lv[r] != 0)
        ghost = u & ~alive
        if ghost.any():
            raise ValueError(
                f"schedule is inconsistent with the live matrix: agents "
                f"{np.nonzero(ghost)[0].tolist()} arrive in round {r} "
                f"while evicted")
        over = (~u) & (s >= max_staleness) & (s > 0) & alive
        if over.any():
            raise ValueError(
                f"schedule violates max_staleness={max_staleness}: "
                f"agents {np.nonzero(over)[0].tolist()} miss round {r} "
                f"while holding work {int(s[over].max())} rounds old")
        s = np.where(u, 0, np.where(s < max_staleness, s + 1, s))
        s = np.where(alive, s, 0)
