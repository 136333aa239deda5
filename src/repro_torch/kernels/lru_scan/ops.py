"""Public lru_scan op (counterpart of ``repro/kernels/lru_scan/ops.py``).

``lru_scan(a, b)`` computes ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``)
over ``(B, S, W)``, or ``(B, S, W, N)`` with Mamba's state dim folded
into ``W N`` channels, as the reference folds it.  A CUDA tensor goes
through :class:`LruScan`, whose forward launches the forward kernel and
whose backward launches the backward kernel (:mod:`.kernel`); a CPU
tensor goes to the plain version (:mod:`.ref`), differentiated by plain
autograd.  No fallback: a kernel that fails to build or launch raises.

``lru_scan_fwd.launches`` and ``lru_scan_bwd.launches`` count launches.

``ssm_scan(dt, u, B, C, A, D, scan_dtype)`` is the Mamba block's
time mixing with its output contraction, ``y_t = <h_t, C_t> + D u_t``
(``ref.ssm_scan_ref``), through :class:`SsmScan`: on CUDA tensors its
forward and backward launch the selective-scan kernels, on CPU tensors
they run the plain versions.  ``ssm_scan_fwd.launches`` and
``ssm_scan_bwd.launches`` count launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.lru_scan import kernel
from repro_torch.kernels.lru_scan.ref import (lru_scan_bwd_ref, lru_scan_ref,
                                              ssm_scan_bwd_ref, ssm_scan_ref)


def _record_lru(name, a):
    c = costs.lru(*a.shape[:2], a[0, 0].numel(), a.element_size())[name]
    costs.record(f"lru_scan_{name}", c["flops"], c["bytes"])


def _record_ssm(name, dt, u, Bm):
    c = costs.ssm(*dt.shape, Bm.shape[-1], u.element_size())[name]
    costs.record(f"ssm_scan_{name}", c["flops"], c["bytes"])


def lru_scan_fwd(a, b):
    """``h`` (B, S, W) in a's dtype."""
    if a.device.type == "cpu":
        return lru_scan_ref(a, b)
    out = kernel.lru_fwd(a, b)
    lru_scan_fwd.launches += 1
    _record_lru("fwd", a)
    return out


def lru_scan_bwd(a, h, g):
    """``(da, db)`` in a's dtype, given the forward's output ``h`` and the
    upstream gradient ``g`` of ``h``."""
    if a.device.type == "cpu":
        return lru_scan_bwd_ref(a, h, g)
    out = kernel.lru_bwd(a, h, g)
    lru_scan_bwd.launches += 1
    _record_lru("bwd", a)
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


def ssm_scan_fwd(dt, u, Bm, Cm, A, D, scan_dtype=torch.float32):
    """``(y, ckpt)``: y (B, S, d_in) float32 and, from the kernel, the
    backward's float32 state checkpoints (None on the CPU)."""
    if dt.device.type == "cpu":
        return ssm_scan_ref(dt, u, Bm, Cm, A, D, scan_dtype), None
    out = kernel.ssm_fwd(dt, u, Bm, Cm, A, D, scan_dtype)
    ssm_scan_fwd.launches += 1
    _record_ssm("fwd", dt, u, Bm)
    return out


def ssm_scan_bwd(dt, u, Bm, Cm, A, D, ckpt, gy, scan_dtype=torch.float32):
    """``(ddt, du, dB, dC, dA, dD)``, float32, given the forward's
    checkpoints and the upstream gradient ``gy`` of y."""
    if dt.device.type == "cpu":
        return ssm_scan_bwd_ref(dt, u, Bm, Cm, A, D, gy, scan_dtype)
    out = kernel.ssm_bwd(dt, u, Bm, Cm, A, D, ckpt, gy, scan_dtype)
    ssm_scan_bwd.launches += 1
    _record_ssm("bwd", dt, u, Bm)
    return out


ssm_scan_fwd.launches = 0
ssm_scan_bwd.launches = 0


class SsmScan(torch.autograd.Function):
    """The forward kernel, saving its inputs and the state checkpoints;
    the backward kernel for the gradients of all six (u's in u's dtype)."""

    @staticmethod
    def forward(ctx, dt, u, Bm, Cm, A, D, scan_dtype):
        y, ckpt = ssm_scan_fwd(dt, u, Bm, Cm, A, D, scan_dtype)
        ctx.save_for_backward(dt, u, Bm, Cm, A, D, ckpt)
        ctx.scan_dtype = scan_dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        dt, u, Bm, Cm, A, D, ckpt = ctx.saved_tensors
        ddt, du, dB, dC, dA, dD = ssm_scan_bwd(
            dt, u, Bm, Cm, A, D, ckpt, gy.contiguous(), ctx.scan_dtype)
        return ddt, du.to(u.dtype), dB, dC, dA, dD, None


def ssm_scan(dt, u, Bm, Cm, A, D, scan_dtype=torch.float32):
    """dt (B, S, d_in) float32, u (B, S, d_in), B and C (B, S, n) float32,
    A (d_in, n), D (d_in,) -> y (B, S, d_in) float32, through
    :class:`SsmScan` (the kernels checkpoint every
    ``kernel.SSM_CKPT_STEPS`` steps)."""
    return SsmScan.apply(dt.contiguous(), u.contiguous(), Bm.contiguous(),
                         Cm.contiguous(), A.contiguous(), D.contiguous(),
                         scan_dtype)
