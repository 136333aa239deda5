"""Public lru_scan op (counterpart of ``repro/kernels/lru_scan/ops.py``).

``lru_scan(a, b)`` computes ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``)
over ``(B, S, W)``, or ``(B, S, W, N)`` with Mamba's state dim folded
into ``W N`` channels, as the reference folds it.  A CUDA tensor goes
through :class:`LruScan`, whose forward launches the forward kernel and
whose backward launches the backward kernel (:mod:`.kernel`); a CPU
tensor goes to the plain version (:mod:`.ref`), differentiated by plain
autograd.  No fallback: a kernel that fails to build or launch raises.

``lru_scan_fwd.launches`` and ``lru_scan_bwd.launches`` count launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lru_scan import kernel
from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref, lru_scan_ref


def lru_scan_fwd(a, b):
    """``h`` (B, S, W) in a's dtype."""
    if a.device.type == "cpu":
        return lru_scan_ref(a, b)
    out = kernel.lru_fwd(a, b)
    lru_scan_fwd.launches += 1
    return out


def lru_scan_bwd(a, h, g):
    """``(da, db)`` in a's dtype, given the forward's output ``h`` and the
    upstream gradient ``g`` of ``h``."""
    if a.device.type == "cpu":
        return lru_scan_bwd_ref(a, h, g)
    out = kernel.lru_bwd(a, h, g)
    lru_scan_bwd.launches += 1
    return out


lru_scan_fwd.launches = 0
lru_scan_bwd.launches = 0


class LruScan(torch.autograd.Function):
    """The forward kernel, saving ``a`` and ``h``; the backward kernel for
    ``da, db``."""

    @staticmethod
    def forward(ctx, a, b):
        h = lru_scan_fwd(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return lru_scan_bwd(a, h, g.contiguous())


def lru_scan(a, b):
    """a, b: (B, S, W) or (B, S, W, N) -> h of the same shape."""
    if a.ndim == 4:
        B, S, W, N = a.shape
        return lru_scan(a.reshape(B, S, W * N),
                        b.reshape(B, S, W * N)).reshape(B, S, W, N)
    if a.device.type == "cpu":
        return lru_scan_ref(a, b)
    return LruScan.apply(a.contiguous(), b.contiguous())
