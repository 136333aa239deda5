"""Public flash-attention op (counterpart of
``repro/kernels/flash_attention/ops.py``).

``flash_attention(q, k, v)`` on the ``(B, S, H, D)`` layout with GQA k, v
``(B, T, Hkv, D)``.  A CUDA tensor goes through :class:`FlashAttention`,
whose forward launches the forward kernel and whose backward launches
the backward kernels (:mod:`.kernel`); a CPU tensor goes to the plain
version (:mod:`.ref`), differentiated by plain autograd.  No fallback: a
kernel that fails to build or launch raises.  The reference folds
``(B, H)`` and repeats the kv heads before its kernel; here the kernels
read the layout as it is and map query head ``h`` to kv head ``h // G``.

``flash_attention_fwd.launches`` counts forward launches and
``flash_attention_bwd.launches`` backward calls (three kernels each, a
fourth -- the head-order sum of dK, dV -- in bfloat16 with GQA).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)


def _record(name, q, k, causal, window):
    B, S, H, D = q.shape
    c = costs.flash(B, S, H, k.shape[2], D, causal, window, T=k.shape[1],
                    bf16=q.dtype == torch.bfloat16)[name]
    costs.record(f"flash_attention_{name}", c["flops"], c["bytes"])


def flash_attention_fwd(q, k, v, *, causal=True, window=None, cap=None):
    """``(o, lse)``: the output ``(B, S, H, D)`` in q's dtype and the
    float32 log-sum-exp ``(B, H, S)``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap)
    out = kernel.flash_fwd(q, k, v, causal=causal, window=window, cap=cap)
    flash_attention_fwd.launches += 1
    _record("fwd", q, k, causal, window)
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        cap=None):
    """``(dq, dk, dv)`` in the inputs' dtypes, given the forward's ``o``
    and ``lse`` and the upstream gradient ``do`` of ``o``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, cap=cap)
    out = kernel.flash_bwd(q, k, v, o, lse, do, causal=causal,
                           window=window, cap=cap)
    flash_attention_bwd.launches += 1
    _record("bwd", q, k, causal, window)
    return out


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The forward kernel, saving ``q, k, v, o, lse``; the backward
    kernels for ``dq, dk, dv``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     cap=cap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, cap=cap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, cap=None):
    """q: (B, S, H, D); k, v: (B, T, Hkv, D).  Returns (B, S, H, D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap)[0]
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window, cap)
