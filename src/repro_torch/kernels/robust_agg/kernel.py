"""Launcher of the robust-aggregation CUDA kernel (``csrc/robust_agg.cu``).

Replaces ``repro/kernels/robust_agg/kernel.py``'s ``sort_aggregate_2d``
(``_sort_agg_kernel``).  Bound by bytes: one read of ``(N, M)`` and one
write of ``(1, M)``; the source file's header says how the design meets
that bound.  The sort runs in registers over the padded power of two
``P >= N`` of a template, so ``N`` is capped at :data:`MAX_ROWS`.

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

MAX_ROWS = 128            # the largest P the kernel's sort is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATS = {"trimmed_mean": 0, "coord_median": 1}


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    lib.repro_sort_aggregate.argtypes = [PTR, PTR, PTR, I64, I64, INT, INT,
                                         INT, INT, INT, PTR]
    lib.repro_sort_aggregate.restype = INT
    return lib


def sort_aggregate(x: torch.Tensor, live, stat: str,
                   trim: int) -> torch.Tensor:
    """The kernel on a CUDA ``(N, M)`` buffer; ``live`` is None or a
    float32 ``(N,)`` row on ``x``'s device.  Returns ``(1, M)``."""
    check_operands("sort_aggregate", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"sort_aggregate: the kernel takes float32 or "
                        f"bfloat16, not {x.dtype}")
    n, m = x.shape
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"sort_aggregate: {n} rows; the kernel sorts "
                         f"1 to {MAX_ROWS} agents per column in registers")
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
    check_launch("sort_aggregate", _lib().repro_sort_aggregate(
        ptr(x), ptr(live), ptr(out), n, m, DTYPES[x.dtype], pow2,
        int(vector_ok(m, x, out)), STATS[stat], int(trim), stream_of(x)))
    return out
