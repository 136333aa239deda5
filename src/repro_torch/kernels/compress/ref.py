"""Plain PyTorch versions of the uplink-compression kernels (counterpart of
``repro/kernels/compress/ref.py``).

The functions the CUDA kernels of ``csrc/compress.cu`` and
``csrc/segment_ranks.cu`` compute, segment by segment; columns outside
every segment are padding and come back zero from the compressors, while
``segment_ranks`` ranks each gap within itself, as the reference does.
The CPU path of :mod:`repro_torch.kernels.compress.ops`, and what the
card's kernels are held against.

Ranking.  The key of an entry is the int32 bit pattern of the float32
``|x|`` (the reference's ``_magnitude_key``), so NaN ranks above inf.
Keys are ordered with ``torch.sort(..., stable=True)``, never
``torch.topk``, whose tie order is not defined: exactly ``k`` entries
survive, everything strictly above the k-th key plus the first
``k - #above`` entries tied with it in position order.

``adaptive_topk``.  The descending magnitudes are squared in the buffer
dtype (as ``jnp.square`` rounds a bf16 buffer to bf16) and accumulated in
float64; ``total = max(sum, 1e-30)`` and
``k_i = clip(1 + #(cum < energy * total), k_floor, m)``.  This is the
port's one deliberate departure from the reference, which accumulates in
the buffer dtype: over millions of bf16 terms that sum, and its bf16
``energy * total``, depend on XLA's summation order, which nothing on the
card can reproduce.  The two agree wherever the energy threshold is not
within the reference's rounding of a prefix sum.

``int8``.  One scale per (agent, segment), ``max|x| / 127``, computed as
XLA computes it: XLA rewrites a division by a constant as a multiply by
the constant's reciprocal, so the scale is ``max|x| * fl32(1/127)`` in
float32, rounded to the buffer dtype; then floored at 1e-12 (rounded to
the dtype), ``x / scale`` (a true division, rounded to the dtype),
rounded half to even, saturated to int8 (XLA's float-to-int8 conversion
saturates), back to the dtype and times the scale -- each operation
rounded to the buffer dtype.  The divisor of ``x / scale`` is a device
tensor: PyTorch divides a CUDA tensor by a Python scalar as a multiply by
the reciprocal.
"""

from __future__ import annotations

import torch

# fl32(1 / 127): the reciprocal XLA multiplies by for "/ 127"
INV_127 = (torch.ones((), dtype=torch.float32) / 127.0).item()


def segments_of(x: torch.Tensor, segments=None) -> tuple:
    """The ``(start, stop)`` column ranges (the whole width when None)."""
    return (((0, x.shape[1]),) if segments is None
            else tuple((int(a), int(b)) for a, b in segments))


def column_intervals(segments: tuple, width: int) -> list:
    """The segments and the gaps before, between and after them, in
    column order, as ``(start, stop, segment index or -1)``: every column
    of ``[0, width)`` lies in exactly one interval (the reference's
    ``_column_intervals``)."""
    intervals, cursor = [], 0
    for j, (s0, s1) in enumerate(segments):
        if cursor < s0:
            intervals.append((cursor, s0, -1))
        intervals.append((s0, s1, j))
        cursor = s1
    if cursor < width:
        intervals.append((cursor, width, -1))
    return intervals


def magnitude_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key monotone in ``|x|``: the bits of the float32 magnitude."""
    return torch.abs(x).to(torch.float32).view(torch.int32)


def seg_k(ratio: float, m: int) -> int:
    """The static keep-count ``max(1, int(ratio * m))``."""
    return max(1, int(ratio * m))


def _keep_count(desc: torch.Tensor, dtype, mode: str, ratio: float,
                energy: float) -> torch.Tensor:
    """``(n, 1)`` int64 keep-counts from the descending keys ``desc``."""
    n, m = desc.shape
    k_floor = seg_k(ratio, m)
    if mode == "topk":
        return torch.full((n, 1), k_floor, dtype=torch.int64,
                          device=desc.device)
    if mode != "adaptive_topk":
        raise ValueError(f"unknown rank-select mode {mode!r}")
    mag = desc.view(torch.float32).to(dtype)
    cum = torch.cumsum((mag * mag).double(), dim=1)
    total = cum[:, -1:].clamp_min(1e-30)
    k = (cum < energy * total).sum(dim=1, keepdim=True) + 1
    return k.clamp(k_floor, m)


def select_mask(seg: torch.Tensor, mode: str = "topk", ratio: float = 0.25,
                energy: float = 0.95) -> torch.Tensor:
    """The keep mask of one ``(n, m)`` segment."""
    key = magnitude_key(seg)
    desc = torch.sort(key, dim=1, descending=True, stable=True).values
    k = _keep_count(desc, seg.dtype, mode, ratio, energy)
    kth = desc.gather(1, k - 1)
    del desc
    above = key > kth
    tie = key == kth
    n_above = above.sum(dim=1, keepdim=True)
    tie_rank = torch.cumsum(tie, dim=1)
    return above | (tie & (tie_rank <= k - n_above))


def rank_select_ref(x: torch.Tensor, segments=None, mode: str = "topk",
                    ratio: float = 0.25, energy: float = 0.95) -> torch.Tensor:
    """Per-(agent, segment) exact-k magnitude selection (ties by
    position); ``mode`` is ``topk`` or ``adaptive_topk``."""
    out = torch.zeros_like(x)
    for s0, s1 in segments_of(x, segments):
        seg = x[:, s0:s1]
        out[:, s0:s1] = torch.where(select_mask(seg, mode, ratio, energy),
                                    seg, torch.zeros_like(seg))
    return out


def int8_ref(x: torch.Tensor, segments=None) -> torch.Tensor:
    """Per-(agent, segment) symmetric int8 quantize-dequantize."""
    out = torch.zeros_like(x)
    for s0, s1 in segments_of(x, segments):
        seg = x[:, s0:s1]
        amax = seg.abs().amax(dim=1, keepdim=True)
        scale = (amax.float() * INV_127).to(x.dtype)
        scale = torch.maximum(scale, torch.full_like(scale, 1e-12))
        q = torch.round(seg / scale).clamp(-128.0, 127.0).to(torch.int8)
        out[:, s0:s1] = q.to(x.dtype) * scale
    return out


def segment_ranks_ref(x: torch.Tensor, segments=None) -> torch.Tensor:
    """Stable descending-``|x|`` rank of every entry within its column
    interval (int32): each segment, and each gap between or after the
    segments, is ranked on its own, as the reference's
    ``_segment_ranks`` ranks the intervals of ``_column_intervals``."""
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for s0, s1, _ in column_intervals(segments_of(x, segments), x.shape[1]):
        order = torch.sort(magnitude_key(x[:, s0:s1]), dim=1,
                           descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(
            s1 - s0, device=x.device).expand_as(order).contiguous())
        out[:, s0:s1] = rank.to(torch.int32)
    return out
