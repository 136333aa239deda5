"""Elementary layers (counterpart of ``repro/models/layers.py``).

Plain functions on tensors.  Two details follow the reference exactly:
RMSNorm scales by ``(1 + w)`` in float32, and the gated ``geglu`` uses
the tanh-approximate GELU (``jax.nn.gelu``'s default).  The vocab-chunked
loss (:func:`chunked_cross_entropy`) is an ``autograd.Function`` that
keeps no ``(B, S, V)`` logits for its backward.
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


def conv1d_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
                b=None):
    """Single decode step of :func:`causal_conv1d`.

    conv_state: (B, K-1, C) past inputs; x_t: (B, C).  Returns (y_t,
    new_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        y = y + b
    return y, window[:, 1:, :]


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


def vocab_chunk(V: int, chunk: int) -> int:
    """The reference's rule: a chunk that does not divide the vocab
    becomes one chunk of the whole vocab."""
    return V if V % chunk else chunk


class ChunkedCrossEntropy(torch.autograd.Function):
    """Mean token cross-entropy of ``softcap(x @ head)`` over vocab chunks.

    The forward is the reference's online log-sum-exp: each chunk's
    product in the parameter dtype, cast to float32, softcapped in
    float32.  It saves ``x``, ``head``, the labels and the per-token
    log-sum-exp only; the backward recomputes each chunk's logits and
    takes ``(softmax - onehot) / (B S)``, times ``1 - tanh^2(z / cap)``
    under a softcap, cast to the head's dtype (the cotangent through the
    reference's ``astype``) before the two products.  ``dhead`` is
    written chunk by chunk (each chunk's own product, as the reference's
    scan writes its per-chunk cotangent); ``dx`` is summed in ``x``'s
    dtype from the last chunk to the first, the order of the reference's
    scan transpose."""

    @staticmethod
    def forward(ctx, x, head, labels, chunk, cap):
        V = head.shape[1]
        chunk = vocab_chunk(V, chunk)
        m = torch.full(labels.shape, -1e30, dtype=torch.float32,
                       device=x.device)
        l = torch.zeros(labels.shape, dtype=torch.float32, device=x.device)
        gold = torch.zeros(labels.shape, dtype=torch.float32,
                           device=x.device)
        labels = labels.long()
        for c0 in range(0, V, chunk):
            z = softcap(torch.matmul(x, head[:, c0:c0 + chunk]).float(), cap)
            m_new = torch.maximum(m, z.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(
                z - m_new[..., None]).sum(dim=-1)
            m = m_new
            local = labels - c0
            valid = (local >= 0) & (local < chunk)
            picked = torch.gather(z, -1, local.clamp(0, chunk - 1)[..., None])
            gold = torch.where(valid, picked[..., 0], gold)
        lse = m + torch.log(l)
        ctx.save_for_backward(x, head, labels, lse)
        ctx.chunk, ctx.cap = chunk, cap
        return torch.mean(lse - gold)

    @staticmethod
    def backward(ctx, g):
        x, head, labels, lse = ctx.saved_tensors
        chunk, cap = ctx.chunk, ctx.cap
        V = head.shape[1]
        scale = g / labels.numel()
        x2 = x.reshape(-1, x.shape[-1])
        # dhead is built as (V, d) rows, each chunk's product written in
        # place: a tied head's gradient in its embedding's layout, an
        # untied head's as a transposed view
        dhead_rows = torch.empty((V, x.shape[-1]), dtype=head.dtype,
                                 device=head.device)
        dx = torch.zeros_like(x)
        for c0 in reversed(range(0, V, chunk)):
            h = head[:, c0:c0 + chunk]
            z = torch.matmul(x, h).float()
            if cap is not None:
                t = torch.tanh(z / cap)
                s = cap * t
            else:
                s = z
            p = torch.exp(s - lse[..., None])
            local = labels - c0
            valid = (local >= 0) & (local < chunk)
            p.scatter_add_(-1, local.clamp(0, chunk - 1)[..., None],
                           -valid[..., None].float())
            dz = p * scale
            if cap is not None:
                dz = dz * (1.0 - t * t)
            dz = dz.to(head.dtype)
            dx = dx + torch.matmul(dz, h.t())
            torch.matmul(dz.reshape(-1, dz.shape[-1]).t(), x2,
                         out=dhead_rows[c0:c0 + chunk])
        return dx, dhead_rows.t(), None, None, None


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          cap=None) -> torch.Tensor:
    """Token cross-entropy without the ``(B, S, V)`` logits (the
    reference's ``chunked_cross_entropy``): ``x`` ``(B, S, d)``, ``head``
    ``(d, V)``; a ``chunk`` that does not divide ``V`` becomes one chunk.
    """
    return ChunkedCrossEntropy.apply(x, head, labels, chunk, cap)


def embed_scale(d_model: int, dtype) -> float:
    """``sqrt(d)`` rounded to the parameter dtype, as the reference
    scales the embedding."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))
