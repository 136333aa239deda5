"""Plain PyTorch version of the robust-aggregation kernel (counterpart of
``repro/kernels/robust_agg/ref.py``).

Order-statistic aggregates over an agent-stacked ``(N, M)`` buffer: per
column, sort the N values by ``(dead, total-order key)`` and reduce the
sorted values to ``trimmed_mean`` or ``coord_median``, with the
reference's post-sort arithmetic operation for operation (the masked
pairwise sum over a zero-padded power of two, the reciprocal of the
survivor count times the sum, ``0.5 (v_lo + v_hi)``).  The CPU path of
:mod:`repro_torch.kernels.robust_agg.ops`, and what the card's kernel
(``csrc/robust_agg.cu``) is held against, bit for bit.

The sort key is the int32 IEEE total-order key of the float32 value
(:func:`_order_key`): the order is total (NaN included, -0.0 before
+0.0), and the sorted values come back exactly from the sorted keys
(:func:`_order_val` is the same involution), so no permutation is
carried and the sort need not be stable.  Dead agents (``live == 0``)
sort after every live one: the composite key is one int64,
``(dead << 32) + (key + 2^31)``.  That is ``N x M`` int64 keys: at the
trainer's full width (4 x 745,549,056) ~24 GB, so a caller on the card
runs this version in column slabs (the card's path is the kernel).
"""

from __future__ import annotations

import torch

ROBUST_STATS = ("trimmed_mean", "coord_median")

_SIGN_MASK = 0x7FFFFFFF


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose signed order is the IEEE total order of ``x``
    (widened to float32 exactly): flip the low 31 bits of negative
    floats.  An involution (:func:`_order_val` inverts it)."""
    b = x.float().view(torch.int32)
    return b ^ ((b >> 31) & _SIGN_MASK)


def _order_val(key: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`_order_key` (the same involution)."""
    b = key ^ ((key >> 31) & _SIGN_MASK)
    return b.view(torch.float32)


def _pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Balanced pairwise sum along dim 0 -> ``(1, ...)``: zero-pad to a
    power of two, then halve with ``v[i] + v[i + k]``.  The tree is
    explicit, so the kernel reproduces the sum bit for bit."""
    n = v.shape[0]
    pow2 = 1 << max(0, (n - 1).bit_length())
    if pow2 != n:
        v = torch.cat([v, v.new_zeros((pow2 - n,) + tuple(v.shape[1:]))])
    while v.shape[0] > 1:
        k = v.shape[0] // 2
        v = v[:k] + v[k:]
    return v


def _post_sort(val_s: torch.Tensor, pos: torch.Tensor, n_live: torch.Tensor,
               *, stat: str, trim: int) -> torch.Tensor:
    """Order-statistic reduction of per-column ascending values.

    ``val_s`` is ``(n, M)`` float32 (ascending down each column, dead
    rows last), ``pos`` the ``(n, 1)`` positions, ``n_live`` an int32
    scalar tensor.  Returns ``(1, M)`` float32.  Selection is a masked
    sum over positions, as in the reference."""
    zero = val_s.new_zeros(())
    if stat == "trimmed_mean":
        keep = (pos >= trim) & (pos < n_live - trim)
        denom = torch.clamp(n_live - 2 * trim, min=1).to(torch.float32)
        return _pairwise_sum(torch.where(keep, val_s, zero)) * (1.0 / denom)
    if stat == "coord_median":
        lo = torch.div(n_live - 1, 2, rounding_mode="floor")
        hi = torch.div(n_live, 2, rounding_mode="floor")
        v_lo = _pairwise_sum(torch.where(pos == lo, val_s, zero))
        v_hi = _pairwise_sum(torch.where(pos == hi, val_s, zero))
        return 0.5 * (v_lo + v_hi)
    raise ValueError(f"unknown robust stat {stat!r} "
                     f"(known: {', '.join(ROBUST_STATS)})")


def live_row(live, n: int, device) -> torch.Tensor:
    """The ``(N,)`` float32 0/1 live row (None = every agent live)."""
    if live is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    lv = torch.as_tensor(live, dtype=torch.float32).to(device)
    lv = lv.reshape(-1).contiguous()
    if lv.numel() != n:
        raise ValueError(f"live row has {lv.numel()} entries for {n} rows")
    return lv


def robust_aggregate_ref(x: torch.Tensor, live=None, *, stat: str,
                         trim: int = 0) -> torch.Tensor:
    """Robust column aggregate of ``(N, M)`` -> ``(1, M)`` in ``x``'s
    dtype.  ``stat`` is ``"trimmed_mean"`` (drop the ``trim`` smallest
    and largest live values per column, average the rest) or
    ``"coord_median"``; ``live`` an optional ``(N,)`` 0/1 row (dead
    agents sort after every live value, and the trim window and median
    index are taken against ``n_live``)."""
    if stat not in ROBUST_STATS:
        raise ValueError(f"unknown robust stat {stat!r} "
                         f"(known: {', '.join(ROBUST_STATS)})")
    if x.ndim != 2:
        raise ValueError(f"robust aggregates take (N, M) buffers, got "
                         f"shape {tuple(x.shape)}")
    n = x.shape[0]
    lv = live_row(live, n, x.device)
    dead = (lv == 0.0).to(torch.int64).reshape(n, 1)
    comp = (dead << 32) + (_order_key(x).to(torch.int64) + (1 << 31))
    comp_s = torch.sort(comp, dim=0).values
    del comp
    key_s = ((comp_s & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    del comp_s
    val_s = _order_val(key_s)
    n_live = lv.to(torch.int32).sum()
    pos = torch.arange(n, dtype=torch.int32, device=x.device).reshape(n, 1)
    out = _post_sort(val_s, pos, n_live, stat=stat, trim=int(trim))
    return out.to(x.dtype)
