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

``cfg.ssm_fused_output`` takes the reference's fused output instead
(``ssm_mix_seq`` when ``cfg.ssm_inner == "seq"``, else ``ssm_mix_fused``,
both with the scan coefficients cast to ``cfg.ssm_scan_dtype``), which
never holds the ``(B, S, d_in, n)`` state.  On the CPU the two mirror the
reference's arithmetic: ``ssm_mix_seq`` a loop over time folding ``y_t =
<h_t, C_t>`` into each step, ``ssm_mix_fused`` the coefficients, an
associative scan (in the scan dtype) and the C contraction chunk by chunk
with a float32 carry; autograd differentiates both.  On a CUDA tensor
both go to one hand-written kernel, the selective scan with its output
contraction (:func:`ssm_mix_kernel`, ``kernels/lru_scan/csrc/ssm_scan.cu``,
forward and backward), fed ``dt``, ``u``, ``B``, ``C``, ``A`` and ``D``; the
projections, ``softplus`` and ``A = -exp(A_log)`` stay in PyTorch.  The
kernel walks time in order, ``ssm_mix_seq``'s order, so on the card the
``assoc`` mode gives seq's numbers: in float32 they agree with the
reference's associative path to 1e-5 relative, as ``lru_scan`` does; with
a bfloat16 scan dtype the reference's associative scan multiplies in
bfloat16 where the kernel carries h in float32 from the same bfloat16
coefficients: up to 1.2e-2 of the largest output and 2.0e-2 of the
largest gradient entry apart at the CPU tests' shapes, which hold them to
4e-2 and 6e-2 (``tests/test_torch_ssm_fused.py``).  No fallback: a CUDA
tensor launches the kernel or raises.

``dt_bias``, ``A_log`` and ``D`` are float32 whatever the model's dtype, as
in the reference.  The decode step (:func:`mamba_step`) advances the
recurrent cache ``(conv, h)`` by one token in plain tensor code, ``h``
float32, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models.layers import causal_conv1d, conv1d_step


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


def _projections(params, u):
    """u: (B, S, d_in) post-conv activations -> (dt float32, B, C, A): the
    inputs of the scan coefficients (B and C in u's dtype)."""
    n = params["A_log"].shape[1]
    dt_rank = params["dt_proj"].shape[0]
    proj = u @ params["x_proj"]                                # (B,S,r+2n)
    dt_in, Bc, Cc = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = softplus((dt_in @ params["dt_proj"]).float()
                  + params["dt_bias"])                         # (B,S,d_in)
    A = -torch.exp(params["A_log"])                            # (d_in, n)
    return dt, Bc, Cc, A


def _ssm_coeffs(params, u):
    """u: (B, S, d_in) post-conv activations -> (a, bx, C) scan coeffs,
    float32."""
    dt, Bc, Cc, A = _projections(params, u)
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


def ssm_mix_kernel(params, u, scan_dtype):
    """The fused output through the selective-scan kernel
    (``lru_ops.ssm_scan``; the kernels checkpoint every 8 steps):
    ``dt``, ``B``, ``C`` and ``A`` made as ``_ssm_coeffs`` makes them, the
    coefficients ``a`` and ``bx`` inside the kernel."""
    dt, Bc, Cc, A = _projections(params, u)
    return lru_ops.ssm_scan(dt, u, Bc.float(), Cc.float(), A, params["D"],
                            scan_dtype)


def ssm_mix_seq(params, u, scan_dtype) -> torch.Tensor:
    """Sequential time scan with the C contraction folded into the step
    (the reference's ``ssm_mix_seq``); the kernel on a CUDA tensor."""
    if u.is_cuda:
        return ssm_mix_kernel(params, u, scan_dtype)
    a, bx, Cc = _ssm_coeffs(params, u)
    a = a.to(scan_dtype)
    bx = bx.to(scan_dtype)
    h = torch.zeros(a.shape[:1] + a.shape[2:], dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + bx[:, t].float()
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    return torch.stack(ys, dim=1) + params["D"] * u.float()


def ssm_mix_fused(params, u, chunk: int, scan_dtype) -> torch.Tensor:
    """Coefficients, associative scan (in ``scan_dtype``) and C contraction
    chunk by chunk, with a float32 carry across chunks (the reference's
    ``ssm_mix_fused``); the kernel on a CUDA tensor."""
    if u.is_cuda:
        return ssm_mix_kernel(params, u, scan_dtype)
    S = u.shape[1]
    if S % chunk:
        chunk = S
    h = torch.zeros(u.shape[:1] + params["A_log"].shape, dtype=torch.float32,
                    device=u.device)
    ys = []
    for c in range(0, S, chunk):
        u_i = u[:, c:c + chunk]
        a, bx, Cc = _ssm_coeffs(params, u_i)
        a_cum, b_cum = associative_scan(a.to(scan_dtype), bx.to(scan_dtype))
        h_all = a_cum.float() * h[:, None] + b_cum.float()
        y_i = torch.einsum("bsdn,bsn->bsd", h_all, Cc)
        ys.append(y_i + params["D"] * u_i.float())
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)


def mamba_forward(params, x, cfg, chunk: int | None = None):
    """Full-sequence mamba block. x: (B, S, d) -> (B, S, d)."""
    chunk = chunk or cfg.ssm_chunk
    u, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)       # (B,S,d_in)
    u = causal_conv1d(u, params["conv_w"], params["conv_b"])
    u = F.silu(u)
    if cfg.ssm_fused_output and cfg.ssm_inner == "seq":
        y = ssm_mix_seq(params, u, getattr(torch, cfg.ssm_scan_dtype))
    elif cfg.ssm_fused_output:
        y = ssm_mix_fused(params, u, chunk, getattr(torch, cfg.ssm_scan_dtype))
    else:
        a, bx, Cc = _ssm_coeffs(params, u)
        h_all = scan_from_zero(a, bx, chunk)
        y = torch.einsum("bsdn,bsn->bsd", h_all, Cc)
        y = y + params["D"] * u.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"]


def init_mamba_cache(batch, cfg, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def mamba_step(params, x_t, cache, cfg):
    """One decode step. x_t: (B, d) -> (y (B, d), new_cache)."""
    u, z = torch.chunk(x_t @ params["in_proj"], 2, dim=-1)    # (B, d_in)
    u, conv_state = conv1d_step(cache["conv"], u, params["conv_w"],
                                params["conv_b"])
    u = F.silu(u)
    a, bx, Cc = _ssm_coeffs(params, u[:, None, :])
    h = a[:, 0] * cache["h"] + bx[:, 0]                        # (B,d_in,n)
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])
    y = y + params["D"] * u.float()
    y = y.to(x_t.dtype) * F.silu(z)
    return y @ params["out_proj"], {"conv": conv_state, "h": h}
