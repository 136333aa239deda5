"""Public robust-aggregation op (counterpart of
``repro/kernels/robust_agg/ops.py``).

A CUDA tensor goes to the CUDA kernel (:mod:`.kernel`, any number of
agents), a CPU tensor to the plain version (:mod:`.ref`); no fallback: a
kernel that fails to build or launch raises.  No column padding is
needed (the reference pads to its TPU column block).
``robust_aggregate.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.robust_agg import kernel
from repro_torch.kernels.robust_agg.ref import (ROBUST_STATS, live_row,
                                                robust_aggregate_ref)


def robust_aggregate(x: torch.Tensor, live=None, *, stat: str,
                     trim: int = 0) -> torch.Tensor:
    """Robust column aggregate of ``(N, M)`` -> ``(1, M)``.

    ``stat="trimmed_mean"`` drops the ``trim`` smallest and largest live
    values per column and averages the rest; ``stat="coord_median"``
    takes the per-column median of the live values.  ``live`` is an
    optional ``(N,)`` (or ``(1, N)``) 0/1 row; dead agents are left out
    of the order statistics (survivor semantics)."""
    if x.ndim != 2:
        raise ValueError(f"robust aggregates take (N, M) buffers, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype == torch.float64:
        raise ValueError("float64 buffers are not supported (the sort "
                         "key is the float32 total-order bit pattern)")
    if stat not in ROBUST_STATS:
        raise ValueError(f"unknown robust stat {stat!r} "
                         f"(known: {', '.join(ROBUST_STATS)})")
    if x.device.type == "cpu":
        return robust_aggregate_ref(x, live, stat=stat, trim=trim)
    lv = None if live is None else live_row(live, x.shape[0], x.device)
    out = kernel.sort_aggregate(x, lv, stat, int(trim))
    robust_aggregate.launches += 1
    costs.record("sort_aggregate", *costs.sort_aggregate(
        *x.shape, x.element_size(), x.dtype))
    return out


robust_aggregate.launches = 0
