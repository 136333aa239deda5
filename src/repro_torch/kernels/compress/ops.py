"""Public uplink-compression ops (counterpart of
``repro/kernels/compress/ops.py``).

``segments`` is the tuple of ``(start, stop)`` column ranges (one per
packed leaf; None means the whole buffer is one segment); columns outside
every segment are padding and come back zero from the compressors
(:func:`segment_ranks` ranks them within their gap, as the reference
does).  A CUDA tensor goes to the
CUDA kernel (:mod:`.kernel`), a CPU tensor to the plain version
(:mod:`.ref`); there is no fallback: a kernel that fails to build or
launch raises.  No agent-row padding is needed (the reference pads rows
to its TPU block).  Each wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.compress import kernel, ref

RANK_MODES = ("topk", "adaptive_topk")


def check_segments(segments, width: int) -> tuple:
    """Segments as a tuple of int pairs; raises unless they are in range,
    sorted and disjoint."""
    segs = tuple((int(a), int(b)) for a, b in segments)
    prev = 0
    for s0, s1 in segs:
        if not 0 <= s0 < s1 <= width:
            raise ValueError(f"segment ({s0}, {s1}) out of range for "
                             f"width {width}")
        if s0 < prev:
            raise ValueError(f"segments must be sorted and disjoint, got "
                             f"{segs}")
        prev = s1
    return segs


def _resolve(x: torch.Tensor, segments) -> tuple:
    if x.ndim != 2:
        raise ValueError(f"compression ops take (N, M) buffers, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype == torch.float64:
        raise ValueError("float64 buffers are not supported (the sort key "
                         "is the float32 magnitude bit pattern)")
    if segments is None:
        segments = ((0, x.shape[1]),)
    return check_segments(segments, x.shape[1])


def rank_select(x: torch.Tensor, *, segments=None, mode: str = "topk",
                ratio: float = 0.25, energy: float = 0.95) -> torch.Tensor:
    """Exact-k magnitude selection per (agent, segment): ``topk`` keeps
    ``max(1, int(ratio * m))`` entries, ``adaptive_topk`` the smallest
    per-agent k_i capturing an ``energy`` fraction of the segment's l2
    energy (floored at that k).  Ties break by position."""
    segments = _resolve(x, segments)
    if mode not in RANK_MODES:
        raise ValueError(f"unknown rank-select mode {mode!r}")
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"compress ratio must be in (0, 1], got {ratio}")
    if x.device.type == "cpu":
        return ref.rank_select_ref(x, segments, mode, ratio, energy)
    out = kernel.rank_select(x, segments, mode, ratio, energy)
    rank_select.launches += 1
    costs.record("rank_select", *costs.compress_rows(*x.shape,
                                                      x.element_size()))
    return out


def segment_ranks(x: torch.Tensor, *, segments=None) -> torch.Tensor:
    """Stable descending-``|x|`` rank of every entry within its column
    interval (int32 ``(N, M)``): each segment, and each gap before,
    between or after the segments, is ranked within itself; ties keep
    column order.  An introspection surface: no training path calls it."""
    segments = _resolve(x, segments)
    if x.device.type == "cpu":
        return ref.segment_ranks_ref(x, segments)
    out = kernel.segment_ranks(x, segments)
    segment_ranks.launches += 1
    costs.record("segment_ranks", *costs.segment_ranks(*x.shape,
                                                        x.element_size()))
    return out


def int8_quantize(x: torch.Tensor, *, segments=None) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize, one scale per (agent,
    segment)."""
    segments = _resolve(x, segments)
    if x.device.type == "cpu":
        return ref.int8_ref(x, segments)
    out = kernel.int8_quantize(x, segments)
    int8_quantize.launches += 1
    costs.record("int8_quantize", *costs.compress_rows(*x.shape,
                                                        x.element_size()))
    return out


rank_select.launches = 0
segment_ranks.launches = 0
int8_quantize.launches = 0
