"""Launcher of the robust-aggregation CUDA kernels (``csrc/robust_agg.cu``).

Replaces ``repro/kernels/robust_agg/kernel.py``'s ``sort_aggregate_2d``
(``_sort_agg_kernel``).  Bound by bytes: one read of ``(N, M)`` and one
write of ``(1, M)``; the source file's header says how the design meets
that bound.  Every ``N >= 1`` is taken, as the reference pads any N to a
power of two ``P``: up to :data:`REGISTER_ROWS` the sort runs in
registers over ``P`` of a template; above, a block sorts a tile of
columns in shared memory (``P x tile`` int32 keys in
:data:`TILE_BYTES`), or, past that, in a global scratch buffer of
``grid x P x 8`` keys (the grid is cut so the scratch stays under
:data:`SCRATCH_BYTES`).

The library is compiled on the first launch (:mod:`repro_torch.kernels.build`).
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels._cuda import (I64, INT, PTR, check_launch,
                                       check_operands, ptr, stream_of,
                                       vector_ok)

SOURCE = Path(__file__).parent / "csrc" / "robust_agg.cu"

REGISTER_ROWS = 128       # the largest P of the register sort
TILE_BYTES = 64 * 1024    # a block's shared-memory key array (kTileBytes)
GLOBAL_TILE = 8           # columns a block on the scratch path (kGlobalTile)
SCRATCH_BYTES = 1 << 30   # the most scratch the scratch path allocates
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATS = {"trimmed_mean": 0, "coord_median": 1}


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_sort_aggregate.argtypes = [PTR, PTR, PTR, I64, I64, INT, INT,
                                         INT, INT, INT, PTR]
    lib.repro_sort_aggregate.restype = INT
    lib.repro_sort_aggregate_tile.argtypes = [PTR, PTR, PTR, I64, I64, INT,
                                              I64, INT, INT, INT, INT, PTR,
                                              PTR]
    lib.repro_sort_aggregate_tile.restype = INT
    return lib


def tile_plan(n: int, m: int):
    """``(pow2, tile, grid, scratch_keys)`` of the tile path for ``n``
    rows over ``m`` columns: the shared-memory array while ``pow2 x tile``
    keys fit :data:`TILE_BYTES` (``scratch_keys`` 0), else
    :data:`GLOBAL_TILE` columns a block over a global scratch buffer."""
    pow2 = 1 << max(0, (n - 1).bit_length())
    tile = min(64, TILE_BYTES // (4 * pow2))
    if tile >= 1:
        return pow2, tile, -(-m // tile), 0
    tile = GLOBAL_TILE
    grid = max(1, min(-(-m // tile), SCRATCH_BYTES // (4 * pow2 * tile)))
    return pow2, tile, grid, grid * pow2 * tile


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
    pow2 = 1 << max(0, (n - 1).bit_length())
    if pow2 <= REGISTER_ROWS:
        check_launch("sort_aggregate", _lib().repro_sort_aggregate(
            ptr(x), ptr(live), ptr(out), n, m, DTYPES[x.dtype], pow2,
            int(vector_ok(m, x, out)), STATS[stat], int(trim),
            stream_of(x)))
        return out
    pow2, tile, grid, keys = tile_plan(n, m)
    scratch = (torch.empty(keys, dtype=torch.int32, device=x.device)
               if keys else None)
    check_launch("sort_aggregate", _lib().repro_sort_aggregate_tile(
        ptr(x), ptr(live), ptr(out), n, m, DTYPES[x.dtype], pow2, tile,
        grid, STATS[stat], int(trim), ptr(scratch), stream_of(x)))
    return out
