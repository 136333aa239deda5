"""Elementary layers (counterpart of ``repro/models/layers.py``).

Plain functions on tensors.  Two details follow the reference exactly:
RMSNorm scales by ``(1 + w)`` in float32, and the gated ``geglu`` uses
the tanh-approximate GELU (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs           # (S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLPs
# ---------------------------------------------------------------------------

def squared_relu(x):
    r = F.relu(x)
    return r * r


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


_GATED = {"swiglu": F.silu, "geglu": _gelu_tanh}
_PLAIN = {"relu2": squared_relu, "gelu": _gelu_tanh}


def mlp_shapes(d_model: int, d_ff: int, activation: str) -> dict:
    width = 2 * d_ff if activation in _GATED else d_ff
    return {"wi": (d_model, width), "wo": (d_ff, d_model)}


def init_mlp(generator, d_model: int, d_ff: int, activation: str, dtype,
             device=None, lead=()) -> dict:
    """Random init with the reference's scales (``lead`` prepends the
    stacked-unit axis)."""
    shapes = mlp_shapes(d_model, d_ff, activation)
    scales = {"wi": d_model ** -0.5, "wo": d_ff ** -0.5}
    return {k: (scales[k] * torch.randn(tuple(lead) + s, generator=generator,
                                        device=device)).to(dtype)
            for k, s in shapes.items()}


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ params["wi"]
    if activation in _GATED:
        gate, up = torch.chunk(h, 2, dim=-1)
        h = _GATED[activation](gate) * up
    else:
        h = _PLAIN[activation](h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b=None) -> torch.Tensor:
    """Depthwise causal temporal conv. x: (B, S, C); w: (K, C).  The K
    taps unrolled and summed in the reference's order (no conv
    primitive)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k:k + S, :] * w[k]
    if b is not None:
        out = out + b
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean token cross-entropy; logits promoted to float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def embed_scale(d_model: int, dtype) -> float:
    """``sqrt(d)`` rounded to the parameter dtype, as the reference
    scales the embedding."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))
