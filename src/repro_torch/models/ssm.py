"""Mamba-1 selective SSM block, falcon-mamba (counterpart of
``repro/models/ssm.py``).

Diagonal selective state space::

    dt_t  = softplus(dt_proj(x_proj_dt(u_t)))                (B, S, d_in)
    B_t,C_t = x_proj(u_t)                                    (B, S, n)
    A     = -exp(A_log)                                      (d_in, n)
    h_t   = exp(dt_t A) h_{t-1} + dt_t B_t u_t
    y_t   = <h_t, C_t> + D u_t

The time scan runs from ``h_{-1} = 0``.  On a CUDA tensor it is the
hand-written ``lru_scan`` kernel (forward and backward,
:mod:`repro_torch.kernels.lru_scan`) over the ``d_in n`` channels; on the
CPU it is the reference's chunked scan (:func:`ssm_scan_chunked`: an
associative scan within a chunk, in the order ``jax.lax.associative_scan``
takes, and a carry across chunks), differentiated by autograd.

``cfg.ssm_fused_output`` (the reference's XLA stand-ins ``ssm_mix_fused``
/ ``ssm_mix_seq``, the only readers of ``ssm_inner`` and
``ssm_scan_dtype``) is not ported and raises.  ``dt_bias``, ``A_log`` and
``D`` are float32 whatever the model's dtype, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models.layers import causal_conv1d


def mamba_shapes(cfg, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one block's parameters, in the
    reference's order; ``dt_bias``, ``A_log`` and ``D`` are float32."""
    d, d_in, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r, f32 = cfg.resolved_dt_rank, torch.float32
    return {"in_proj": ((d, 2 * d_in), dtype),
            "conv_w": ((cfg.conv_width, d_in), dtype),
            "conv_b": ((d_in,), dtype),
            "x_proj": ((d_in, r + 2 * n), dtype),
            "dt_proj": ((r, d_in), dtype),
            "dt_bias": ((d_in,), f32),
            "A_log": ((d_in, n), f32),
            "D": ((d_in,), f32),
            "out_proj": ((d_in, d), dtype)}


def init_mamba(generator, cfg, dtype, device=None, lead=()) -> dict:
    """The reference's init: the random leaves from ``generator`` (so their
    bits differ), the float32 leaves by its formulas; ``lead`` prepends
    the stacked-unit axis."""
    lead = tuple(lead)
    d, d_in, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r = cfg.resolved_dt_rank

    def normal(scale, shape):
        return (scale * torch.randn(lead + shape, generator=generator,
                                    device=device)).to(dtype)

    def fixed(t):
        return t.to(device).expand(lead + tuple(t.shape)).clone()

    return {
        "in_proj": normal(d ** -0.5, (d, 2 * d_in)),
        "conv_w": normal(0.5, (cfg.conv_width, d_in)),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=device),
        "x_proj": normal(d_in ** -0.5, (d_in, r + 2 * n)),
        "dt_proj": normal(r ** -0.5, (r, d_in)),
        "dt_bias": fixed(torch.log(torch.exp(
            torch.linspace(1e-3, 0.1, d_in)) - 1.0)),
        "A_log": fixed(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32)).expand(d_in, n)),
        "D": fixed(torch.ones((d_in,))),
        "out_proj": normal(d_in ** -0.5, (d_in, d)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    ``x`` above a threshold, a different function)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_coeffs(params, u):
    """u: (B, S, d_in) post-conv activations -> (a, bx, C) scan coeffs,
    float32."""
    n = params["A_log"].shape[1]
    dt_rank = params["dt_proj"].shape[0]
    proj = u @ params["x_proj"]                                # (B,S,r+2n)
    dt_in, Bc, Cc = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = softplus((dt_in @ params["dt_proj"]).float()
                  + params["dt_bias"])                         # (B,S,d_in)
    A = -torch.exp(params["A_log"])                            # (d_in, n)
    a = torch.exp(dt[..., None] * A)                           # (B,S,d_in,n)
    bx = (dt * u.float())[..., None] * Bc.float()[..., None, :]
    return a, bx, Cc.float()


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs ``(a_t, b_t)`` under :func:`_combine`
    along dim 1, in ``jax.lax.associative_scan``'s order (pairs combined,
    the half-length scan recursively, then the even positions)."""
    S = a.shape[1]
    if S < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:S - 1:2], b[:, 0:S - 1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    heads = odd if S % 2 else tuple(o[:, :-1] for o in odd)
    even = _combine(heads, (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, e, o in zip((a, b), even, odd):
        e = torch.cat([first[:, :1], e], dim=1)          # ceil(S / 2)
        pairs = torch.stack([e[:, :o.shape[1]], o], dim=2)
        pairs = pairs.reshape(e.shape[:1] + (2 * o.shape[1],) + e.shape[2:])
        out.append(torch.cat([pairs, e[:, o.shape[1]:]], dim=1))
    return tuple(out)


def ssm_scan_chunked(a, bx, h0, chunk: int = 128):
    """Sequence scan of ``h_t = a_t h_{t-1} + bx_t``, chunked over time.

    a, bx: (B, S, d_in, n); h0: (B, d_in, n).  Returns ``(h_all (B, S,
    d_in, n), h_last)``.  Within a chunk: :func:`associative_scan`;
    across chunks: a loop carrying ``h``.
    """
    S = a.shape[1]
    if S % chunk:
        chunk = S
    h, outs = h0, []
    for c in range(0, S, chunk):
        a_cum, b_cum = associative_scan(a[:, c:c + chunk], bx[:, c:c + chunk])
        h_all = a_cum * h[:, None] + b_cum
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def scan_from_zero(a, bx, chunk: int):
    """``h_t = a_t h_{t-1} + bx_t`` from ``h_{-1} = 0`` over (B, S, d_in, n):
    the ``lru_scan`` kernels on a CUDA tensor, :func:`ssm_scan_chunked` on
    the CPU."""
    if a.is_cuda:
        return lru_ops.lru_scan(a, bx)
    h0 = torch.zeros(a.shape[:1] + a.shape[2:], dtype=torch.float32,
                     device=a.device)
    return ssm_scan_chunked(a, bx, h0, chunk)[0]


def mamba_forward(params, x, cfg, chunk: int | None = None):
    """Full-sequence mamba block. x: (B, S, d) -> (B, S, d)."""
    if cfg.ssm_fused_output:
        raise NotImplementedError(
            "ssm_fused_output (the reference's ssm_mix_fused / ssm_mix_seq "
            "XLA stand-ins) is not ported yet")
    chunk = chunk or cfg.ssm_chunk
    u, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)       # (B,S,d_in)
    u = causal_conv1d(u, params["conv_w"], params["conv_b"])
    u = F.silu(u)
    a, bx, Cc = _ssm_coeffs(params, u)
    h_all = scan_from_zero(a, bx, chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, Cc)
    y = y + params["D"] * u.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"]
