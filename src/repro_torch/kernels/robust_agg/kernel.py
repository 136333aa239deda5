"""Launcher of the robust-aggregation CUDA kernels (``csrc/robust_agg.cu``).

Replaces ``repro/kernels/robust_agg/kernel.py``'s ``sort_aggregate_2d``
(``_sort_agg_kernel``).  Every ``N >= 1`` is taken, as the reference
pads any N to a power of two ``P``; :func:`route_plan` picks one of four
routes by ``P`` (the source file's header says how each meets its bound):

- ``"register"`` (``P <= 32``): one thread sorts whole columns in its
  registers, over ``P`` of a template;
- ``"warp"`` (``64 <= P <= 1024``) and ``"block"`` (``2048 <= P <=
  16,384``): a group of ``G = P / 32`` threads holds a column, 32 keys a
  thread, sorted across the group by shuffles (inside a warp) or shared
  memory (between the warps of a block); bf16 keys two columns to a
  register.  A persistent grid of the blocks that fit the card walks
  tiles of neighbouring columns;
- ``"scratch"`` (``P > 16,384``): a block sorts 8 columns in a global
  scratch buffer of ``grid x P x 8`` keys (the grid is cut so the
  scratch stays under :data:`SCRATCH_BYTES`).

The C launcher tallies each route's launches (:func:`route_counts`).
The library is compiled on the first launch (:mod:`repro_torch.kernels.build`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (I64, INT, PTR, check_launch,
                                       check_operands, ptr, stream_of,
                                       vector_ok)

SOURCE = Path(__file__).parent / "csrc" / "robust_agg.cu"

REGISTER_ROWS = 32        # the largest P of the register route (kMaxRows)
KEYS = 32                 # keys a thread on the warp and block routes (kKeys)
WARP_ROWS = 32 * KEYS     # the largest P of the warp route: a whole warp
BLOCK_ROWS = 512 * KEYS   # the largest P of the block route
THREADS = 256             # a block of the register route (kThreads), and
#                           of the lane routes below G = 256 (kLaneThreads)
GLOBAL_TILE = 8           # columns a block on the scratch route (kGlobalTile)
SCRATCH_BYTES = 1 << 30   # the most scratch the scratch route allocates
VEC_KEYS = 64             # register keys a thread on the vector path (kVecKeys)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATS = {"trimmed_mean": 0, "coord_median": 1}
ROUTES = ("register", "warp", "block", "scratch")


class RoutePlan(NamedTuple):
    """How one call runs: ``route``, the padded rows ``pow2``, ``keys``
    a thread (a column's, on the scratch route), ``lanes`` (threads a
    column), ``tile`` (columns a block at a time), ``grid`` (blocks) and
    ``scratch_keys`` (int32 keys of the scratch route's buffer, else 0)."""
    route: str
    pow2: int
    keys: int
    lanes: int
    tile: int
    grid: int
    scratch_keys: int


def route_of(n: int) -> tuple[str, int]:
    """The route and padded power of two ``P >= n`` for ``n`` rows."""
    pow2 = 1 << max(0, (n - 1).bit_length())
    if pow2 <= REGISTER_ROWS:
        return "register", pow2
    if pow2 <= WARP_ROWS:
        return "warp", pow2
    if pow2 <= BLOCK_ROWS:
        return "block", pow2
    return "scratch", pow2


def route_plan(n: int, m: int, dtype=torch.bfloat16, vec: bool = True,
               sms: int = 132, blocks_per_sm: int = 2) -> RoutePlan:
    """The plan of a call on ``n`` rows and ``m`` columns of ``dtype``.
    ``vec``: 16-byte loads are legal (the register route's columns a
    thread); ``sms`` and ``blocks_per_sm`` (the lane kernel's occupancy,
    from :func:`_blocks_per_sm` on the card) size the persistent grid."""
    route, pow2 = route_of(n)
    if route == "register":
        per = 16 // (4 if dtype == torch.float32 else 2)
        v = per if vec and pow2 * per <= VEC_KEYS else 1
        tile = THREADS * v
        return RoutePlan(route, pow2, pow2, 1, tile, -(-m // tile), 0)
    if route == "scratch":
        tile = GLOBAL_TILE
        grid = max(1, min(-(-m // tile), SCRATCH_BYTES // (4 * pow2 * tile)))
        return RoutePlan(route, pow2, pow2, 1, tile, grid,
                         grid * pow2 * tile)
    lanes = pow2 // KEYS
    cols = 1 if dtype == torch.float32 else 2      # columns a 32-bit key
    tile = cols * max(THREADS, lanes) // lanes
    grid = max(1, min(-(-m // tile), sms * blocks_per_sm))
    return RoutePlan(route, pow2, KEYS, lanes, tile, grid, 0)


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_sort_aggregate.argtypes = [PTR, PTR, PTR, I64, I64, INT, INT,
                                         INT, INT, INT, PTR]
    lib.repro_sort_aggregate.restype = INT
    lib.repro_sort_aggregate_lanes.argtypes = [PTR, PTR, PTR, I64, I64, INT,
                                               INT, INT, INT, INT, INT, PTR]
    lib.repro_sort_aggregate_lanes.restype = INT
    lib.repro_sort_aggregate_lanes_occupancy.argtypes = [INT, INT, I64]
    lib.repro_sort_aggregate_lanes_occupancy.restype = INT
    lib.repro_sort_aggregate_tile.argtypes = [PTR, PTR, PTR, I64, I64, INT,
                                              I64, INT, INT, INT, PTR, PTR]
    lib.repro_sort_aggregate_tile.restype = INT
    lib.repro_sort_aggregate_routes.argtypes = [PTR]
    lib.repro_sort_aggregate_routes.restype = None
    return lib


def route_counts() -> dict[str, int]:
    """Launches so far of each route (:data:`ROUTES`), as the C launcher
    counts them where each launch succeeds."""
    out = (ctypes.c_int64 * len(ROUTES))()
    _lib().repro_sort_aggregate_routes(out)
    return dict(zip(ROUTES, out))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _blocks_per_sm(dtype_code: int, pow2: int, n: int) -> int:
    got = _lib().repro_sort_aggregate_lanes_occupancy(dtype_code, pow2, n)
    if got < 1:
        raise RuntimeError(f"sort_aggregate: no block of the lane kernel "
                           f"fits an SM at P={pow2}, N={n} (occupancy "
                           f"query returned {got})")
    return got


def sort_aggregate(x: torch.Tensor, live, stat: str,
                   trim: int) -> torch.Tensor:
    """The kernel on a CUDA ``(N, M)`` buffer; ``live`` is None or a
    float32 ``(N,)`` row on ``x``'s device.  Returns ``(1, M)``."""
    check_operands("sort_aggregate", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"sort_aggregate: the kernel takes float32 or "
                        f"bfloat16, not {x.dtype}")
    n, m = x.shape
    if n < 1:
        raise ValueError("sort_aggregate: no rows to aggregate")
    if live is not None and (live.device != x.device
                             or live.dtype != torch.float32
                             or tuple(live.shape) != (n,)
                             or not live.is_contiguous()):
        raise ValueError(f"sort_aggregate: live must be a contiguous "
                         f"float32 ({n},) row on {x.device}")
    out = torch.empty((1, m), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    code, vec = DTYPES[x.dtype], vector_ok(m, x, out)
    route, pow2 = route_of(n)
    lib = _lib()
    if route == "register":
        rc = lib.repro_sort_aggregate(
            ptr(x), ptr(live), ptr(out), n, m, code, pow2, int(vec),
            STATS[stat], int(trim), stream_of(x))
    elif route == "scratch":
        plan = route_plan(n, m, x.dtype)
        scratch = torch.empty(plan.scratch_keys, dtype=torch.int32,
                              device=x.device)
        rc = lib.repro_sort_aggregate_tile(
            ptr(x), ptr(live), ptr(out), n, m, code, pow2, plan.grid,
            STATS[stat], int(trim), ptr(scratch), stream_of(x))
    else:
        plan = route_plan(n, m, x.dtype, sms=_sms(x.device.index),
                          blocks_per_sm=_blocks_per_sm(code, pow2, n))
        rc = lib.repro_sort_aggregate_lanes(
            ptr(x), ptr(live), ptr(out), n, m, code, pow2,
            int(vector_ok(m, x)), plan.grid, STATS[stat], int(trim),
            stream_of(x))
    check_launch("sort_aggregate", rc)
    return out
