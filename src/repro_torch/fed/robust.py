"""Byzantine-robust coordinator aggregation (counterpart of
``repro/fed/robust.py``).

The coordinator step ``y = prox_{rho h/N}(mean_i z_i)`` is a mean, whose
breakdown point is zero: the increment guards
(:func:`repro_torch.fed.engine.increment_guard`) quarantine non-finite or
over-norm rows, but one agent submitting a finite, in-bound, sign-flipped
increment still steers the consensus.  This module is the registry of
robust aggregators that replace the agent mean at the uplink, selected by
``RoundConfig.aggregator`` / ``FedSpec.aggregator``.

An aggregator is ``fn(z, live, *, param, colmask=None, backend="torch",
model_mesh=None) -> (1, M)`` over the agent-stacked ``(N, M)`` buffer.
``live`` is the 0/1 eviction row (None = every agent live); dead rows are
left out of the order statistics.  ``colmask`` marks the real columns of
a packed buffer for aggregators whose arithmetic couples columns
(``norm_clip_mean``'s row norms); per-column order statistics ignore it.
``model_mesh`` is the mesh whose model axis splits the columns (None when
``z`` holds whole rows): a row norm then sums its partials over the model
group, as the reference's ``psum(partial, model_axis)``.

Built-ins: ``mean`` (the engine never routes it here: ``robust_seen``
keeps the survivor-mean path for ``mean`` and for ``trimmed_mean`` at
``f = 0``); ``trimmed_mean`` (drop the ``f = int(param)`` smallest and
largest live values per column, average the rest; ``2 f < N``);
``coord_median``; ``norm_clip_mean`` (recentre the rows at the coordinate
median, clip each residual to l2 radius ``param``, average).

The engine folds the aggregate in as a ``z_seen`` transform: the
``(1, M)`` statistic is broadcast back to ``(N, M)`` and handed to the
unchanged round edges, whose mean over N identical rows reproduces it (to
float32 rounding; exactly when N is a power of two).  The broadcast is
materialised, because the fused edges take contiguous operands: one more
state-sized buffer while the round runs.

Differences from the reference:

* ``colmask`` is the tuple of real column segments of the packing
  (:func:`_segment_colmask`), not a ``(1, width)`` boolean row: at the
  trainer's full width that row alone would be 745 MB.  The port's
  packing puts alignment gaps between segments (the reference pads only
  the tail), so the mask matters more here: ``norm_clip_mean`` zeroes the
  gap columns of its residual (a multiply by zero, as the reference's
  ``r * colmask``) and the guard's row norms sum over real columns only.
* Under ``engine_backend="fused"`` the coordinate median at the centre of
  ``norm_clip_mean`` goes through the ``sort_aggregate`` kernel on a CUDA
  tensor; the reference always takes its XLA oracle there.  The two are
  bit-equal, and the plain version would sort 3e9 int64 keys (24 GB) at
  the trainer's full width.
* The aggregate is cast to the buffer's dtype (``norm_clip_mean``
  computes in float32): the fused edges take operands of one dtype.
* Under a mesh the gather is :func:`repro_torch.fed.sharding.agent_gather`
  over the agent group (an ``all_reduce`` of the bits of one zero-filled
  ``(N, M)`` buffer, which gloo takes on the card too), and on a 1-rank
  agent group it is skipped (the gather of one block is the identity: no
  second ``(N, M)`` copy at full width).  Under a model axis each rank
  aggregates its column block: order statistics are per column.  The
  gathered block is aggregated with the configured backend -- on the card
  the ``sort_aggregate`` kernel, bit-equal to the oracle the reference
  takes there.
* Row norms are ``torch.linalg.vector_norm`` per segment and the live
  mean runs in column slabs of :data:`SLAB`, so that a bf16 state never
  gets a whole float32 copy; the float32 sums therefore associate
  differently from the reference's (tolerance, not bits).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.fed import compress as compress_lib
from repro_torch.fed import sharding
from repro_torch.kernels.robust_agg import ops as robust_ops
from repro_torch.kernels.robust_agg.ref import live_row, robust_aggregate_ref

# aggregators with the sort_aggregate kernel (the others always run the
# registry implementation, whatever the engine backend)
FUSED_AGGREGATORS = frozenset({"trimmed_mean", "coord_median"})

# columns per slab of the float32 live-mean pass
SLAB = 1 << 24

# fn(z, live, *, param, colmask=None, backend="torch") -> (1, M)
Aggregator = Callable[..., torch.Tensor]

_AGGREGATORS: Dict[str, Aggregator] = {}


def register_aggregator(name: str):
    """Register an aggregator under ``name`` (decorator), making it
    reachable from every front end via ``FedSpec.aggregator``."""

    def deco(fn: Aggregator) -> Aggregator:
        _AGGREGATORS[name] = fn
        return fn

    return deco


def get_aggregator(name: str) -> Aggregator:
    try:
        return _AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; registered: "
            f"{', '.join(sorted(_AGGREGATORS))}") from None


def available_aggregators():
    return sorted(_AGGREGATORS)


def validate_aggregator(name: str, param, n_agents: Optional[int] = None
                        ) -> float:
    """Construction-time screening of an (aggregator, param) pair;
    returns the normalized float param.  Called by ``FedSpec.validate()``
    and ``RoundConfig.__post_init__`` alike:

    * ``trimmed_mean``: ``param`` is the trim count ``f`` -- a
      non-negative integer with ``2 f < n_agents``.
    * ``norm_clip_mean``: ``param`` is the clip radius -- finite, > 0.
    * ``mean`` / ``coord_median``: no parameter (``param`` ignored).
    """
    get_aggregator(name)   # fail fast on unknown names
    try:
        p = float(param)
    except (TypeError, ValueError):
        raise ValueError(
            f"aggregator_param must be a number, got {param!r}") from None
    if name == "trimmed_mean":
        if not (math.isfinite(p) and p >= 0 and p == int(p)):
            raise ValueError(
                f"trimmed_mean takes a non-negative integer trim count "
                f"f as aggregator_param, got {param!r}")
        if n_agents is not None and 2 * int(p) >= n_agents:
            raise ValueError(
                f"trimmed_mean with f={int(p)} trims 2f={2 * int(p)} of "
                f"n_agents={n_agents} rows: need 2f < N so at least one "
                f"row survives the trim")
    elif name == "norm_clip_mean":
        if not (math.isfinite(p) and p > 0):
            raise ValueError(
                f"norm_clip_mean takes a finite positive clip radius as "
                f"aggregator_param, got {param!r}")
    return p


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _gaps(segments, width: int):
    """The column ranges outside every segment."""
    out, cursor = [], 0
    for a, b in segments:
        if cursor < a:
            out.append((cursor, a))
        cursor = b
    if cursor < width:
        out.append((cursor, width))
    return out


def row_sq_norms(buf: torch.Tensor, segments=None) -> torch.Tensor:
    """Per-row squared l2 norm of an ``(N, M)`` buffer over the columns
    of ``segments`` (None = every column), accumulated in float32 by
    ``torch.linalg.vector_norm`` per segment: on the card that reduction
    reads a bf16 buffer as it is, with no float32 copy.  NaN and inf rows
    stay non-finite, and squares overflow as in a float32 sum."""
    if segments is None:
        segments = ((0, buf.shape[1]),)
    total = torch.zeros((buf.shape[0],), dtype=torch.float32,
                        device=buf.device)
    for a, b in segments:
        total += torch.linalg.vector_norm(buf[:, a:b], dim=1,
                                          dtype=torch.float32).square()
    return total


def _mean_live(rows: torch.Tensor, lv: torch.Tensor) -> torch.Tensor:
    """Mean over live rows -> ``(1, M)`` float32 (``lv`` is ``(N,)``),
    column slab by column slab."""
    n_live = torch.clamp(lv.sum(), min=1.0)
    w = lv.reshape(-1, 1)
    out = torch.empty((1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    for c in range(0, rows.shape[1], SLAB):
        out[:, c:c + SLAB] = torch.sum(rows[:, c:c + SLAB] * w, dim=0,
                                       keepdim=True) / n_live
    return out


# ---------------------------------------------------------------------------
# Built-in aggregators
# ---------------------------------------------------------------------------

@register_aggregator("mean")
def _mean(z, live, *, param, colmask=None, backend="torch",
          model_mesh=None):
    """Survivor mean -- the registry form of the engine default (the
    engine itself short-circuits to ``survivor_mean_input``)."""
    return _mean_live(z, live_row(live, z.shape[0], z.device))


@register_aggregator("trimmed_mean")
def _trimmed_mean(z, live, *, param, colmask=None, backend="torch",
                  model_mesh=None):
    return robust_aggregate_ref(z, live, stat="trimmed_mean",
                                trim=int(param))


@register_aggregator("coord_median")
def _coord_median(z, live, *, param, colmask=None, backend="torch",
                  model_mesh=None):
    return robust_aggregate_ref(z, live, stat="coord_median")


@register_aggregator("norm_clip_mean")
def _norm_clip_mean(z, live, *, param, colmask=None, backend="torch",
                    model_mesh=None):
    """Centered clipping: recentre at the coordinate-wise median, clip
    each live row's residual to l2 radius ``param``, average.  The
    residual's gap columns are multiplied by zero first (``colmask``), so
    drifted padding does not perturb real-column results.  The residual
    is scaled in place; the live mean runs in slabs."""
    lv = live_row(live, z.shape[0], z.device)
    center = aggregate_rows(z, live, name="coord_median", param=0.0,
                            backend=backend)
    r = z - center
    if colmask is not None:
        for a, b in _gaps(colmask, r.shape[1]):
            r[:, a:b].mul_(0.0)
    norms = torch.sqrt(sharding.model_sum(row_sq_norms(r), model_mesh))
    radius = torch.tensor(param, dtype=torch.float32, device=z.device)
    scale = torch.clamp(radius / torch.clamp(norms, min=1e-12), max=1.0)
    r.mul_(scale.to(r.dtype).reshape(-1, 1))
    return _mean_live(r, lv).add_(center)


# ---------------------------------------------------------------------------
# Dispatch: one (N, M) buffer -> (1, M) aggregate
# ---------------------------------------------------------------------------

def aggregate_rows(z: torch.Tensor, live, *, name: str, param: float,
                   colmask=None, backend: str = "torch",
                   model_mesh=None) -> torch.Tensor:
    """Aggregate the agent-stacked ``(N, M)`` buffer to ``(1, M)``.

    ``backend="fused"`` routes :data:`FUSED_AGGREGATORS` through
    :func:`repro_torch.kernels.robust_agg.ops.robust_aggregate` (the
    kernel on a CUDA tensor, bit-equal to the plain version); everything
    else runs the registry entry."""
    if backend == "fused" and name in FUSED_AGGREGATORS:
        return robust_ops.robust_aggregate(
            z, live, stat=name,
            trim=int(param) if name == "trimmed_mean" else 0)
    return get_aggregator(name)(z, live, param=param, colmask=colmask,
                                backend=backend, model_mesh=model_mesh)


def _segment_colmask(meta, cols: Optional[slice] = None):
    """The real (in-segment) columns of a packing, or of its column
    block ``cols``, as a tuple of ``(start, stop)`` segments in the
    block's coordinates; None when no column there is padding."""
    cols = slice(0, meta.width) if cols is None else cols
    segs = sharding.block_segments(meta.segments, cols)
    covered = sum(b - a for a, b in segs)
    return None if covered == cols.stop - cols.start else segs


# ---------------------------------------------------------------------------
# Engine entry points: the z_seen input transforms
# ---------------------------------------------------------------------------

def robust_seen_packed(z_seen: torch.Tensor, live, *, name: str,
                       param: float, meta, backend: str, mesh=None,
                       whole_rows: bool = False) -> torch.Tensor:
    """Robust ``z_seen`` transform on the resident packed buffer:
    aggregate the live rows, broadcast back to a contiguous
    ``(N, width)`` buffer of ``z_seen``'s dtype.  With a ``mesh``
    ``z_seen`` is this rank's block: the row blocks are gathered on the
    agent axis, this rank's columns of the full agent column aggregated
    with the global ``live`` row, and this rank's block of the broadcast
    returned (``whole_rows``: the buffer holds whole rows, whatever the
    model axis)."""
    full = z_seen
    cols = slice(0, meta.width)
    model_mesh = None
    if mesh is not None:
        full = sharding.agent_gather(
            z_seen, mesh, sharding.mesh_agent_shards(mesh) * z_seen.shape[0])
        if not whole_rows:
            cols = sharding.model_cols(mesh, meta.width)
            if sharding.cols_split(mesh, meta.width):
                model_mesh = mesh
    agg = aggregate_rows(full, live, name=name, param=param,
                         colmask=_segment_colmask(meta, cols),
                         backend=backend, model_mesh=model_mesh)
    return agg.to(z_seen.dtype).expand_as(z_seen).contiguous()


def robust_seen_tree(z_seen, live, *, name: str, param: float,
                     backend: str, mesh=None, blocks=None):
    """Robust ``z_seen`` transform on agent-stacked trees: pack the
    leaves (a fresh pack: gap columns are exact zeros; whole rows, whatever
    the model axis), aggregate, broadcast, unpack (this rank's row block
    under a ``mesh``).  A tree of leaf ``blocks`` is gathered over the
    model group first (``norm_clip_mean``'s residual norms are over whole
    rows) and the result cut back to the blocks."""
    tree = z_seen if blocks is None else blocks.gather_tree(z_seen)
    buf, meta = compress_lib.pack_leaves(tree)
    out = compress_lib.unpack_leaves(
        robust_seen_packed(buf, live, name=name, param=param, meta=meta,
                           backend=backend, mesh=mesh, whole_rows=True),
        meta)
    if blocks is None:
        return out
    return {n: l.contiguous() for n, l in blocks.block_tree(out).items()}
