"""RG-LRU recurrent block, recurrentgemma / Griffin (counterpart of
``repro/models/rglru.py``; arXiv:2402.19427).

Real-Gated Linear Recurrent Unit::

    r_t = sigmoid(W_a x_t)          (recurrence gate)
    i_t = sigmoid(W_x x_t)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . x_t)

wrapped in the Griffin recurrent block::

    branch1 = conv1d(W_1 x) -> RG-LRU
    branch2 = gelu(W_2 x)
    out     = W_o (branch1 . branch2)

The scan over ``lru_width`` channels is
:func:`repro_torch.models.ssm.scan_from_zero`:
the ``lru_scan`` kernels on a CUDA tensor, the reference's chunked scan
on the CPU.  ``lam`` is float32 whatever the model's dtype.  The decode
step (:func:`rglru_step`) advances the cache ``(conv, h)`` by one token,
``h`` float32.
"""

from __future__ import annotations

import torch

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import _gelu_tanh, causal_conv1d, conv1d_step

_C = 8.0  # Griffin's constant


def rglru_shapes(cfg, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one block's parameters, in the
    reference's order; ``lam`` is float32."""
    d, w = cfg.d_model, cfg.resolved_lru_width
    return {"w_branch1": ((d, w), dtype), "w_branch2": ((d, w), dtype),
            "conv_w": ((cfg.conv_width, w), dtype), "conv_b": ((w,), dtype),
            "w_a": ((w, w), dtype), "w_x": ((w, w), dtype),
            "lam": ((w,), torch.float32), "w_out": ((w, d), dtype)}


def init_rglru_block(generator, cfg, dtype, device=None, lead=()) -> dict:
    """The reference's init: the random leaves from ``generator`` (so their
    bits differ); ``lam`` so that a ~ Uniform(0.9, 0.999)^c at r = 1
    (Griffin A.2); ``lead`` prepends the stacked-unit axis."""
    lead = tuple(lead)
    d, w = cfg.d_model, cfg.resolved_lru_width

    def normal(scale, shape):
        return (scale * torch.randn(lead + shape, generator=generator,
                                    device=device)).to(dtype)

    lam = torch.log(torch.expm1(-torch.log(torch.linspace(0.9, 0.999, w))
                                / _C))
    return {
        "w_branch1": normal(d ** -0.5, (d, w)),
        "w_branch2": normal(d ** -0.5, (d, w)),
        "conv_w": normal(0.5, (cfg.conv_width, w)),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=device),
        "w_a": normal(w ** -0.5, (w, w)),
        "w_x": normal(w ** -0.5, (w, w)),
        "lam": lam.to(device).expand(lead + (w,)).clone(),
        "w_out": normal(w ** -0.5, (w, d)),
    }


def _gates(params, u):
    """u: (..., w) -> (a, gated_input) in fp32."""
    r = torch.sigmoid((u @ params["w_a"]).float())
    i = torch.sigmoid((u @ params["w_x"]).float())
    log_a = -_C * ssm_lib.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * u.float()


def rglru_forward(params, x, cfg, chunk: int = 256):
    """Full-sequence Griffin recurrent block. x: (B, S, d)."""
    u = x @ params["w_branch1"]                                 # (B,S,w)
    u = causal_conv1d(u, params["conv_w"], params["conv_b"])
    a, bx = _gates(params, u)
    # the diagonal scan with a trailing singleton state dim
    h = ssm_lib.scan_from_zero(a[..., None], bx[..., None], chunk)[..., 0]
    h = h.to(x.dtype)                                           # (B,S,w)
    gate = _gelu_tanh(x @ params["w_branch2"])
    return (h * gate) @ params["w_out"]


def init_rglru_cache(batch, cfg, dtype, device=None) -> dict:
    w = cfg.resolved_lru_width
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_step(params, x_t, cache, cfg):
    """One decode step. x_t: (B, d)."""
    u = x_t @ params["w_branch1"]
    u, conv_state = conv1d_step(cache["conv"], u, params["conv_w"],
                                params["conv_b"])
    a, bx = _gates(params, u)
    h = a * cache["h"] + bx
    gate = _gelu_tanh(x_t @ params["w_branch2"])
    out = (h.to(x_t.dtype) * gate) @ params["w_out"]
    return out, {"conv": conv_state, "h": h}
