"""Attention: GQA, sliding window, logit softcap (counterpart of
``repro/models/attention.py``).

Plain tensor code, as in the reference, which computes attention
outside any Pallas kernel:

* ``attn_reference`` -- materializes (B, Hkv, G, S, T) scores.
* ``attn_chunked``   -- online softmax over KV chunks (the reference's
  production path; a Python loop where JAX scans).
* ``attn_block_local`` -- exact sliding-window attention block by block
  (each block of W queries sees itself and the previous block); falls
  back to ``attn_reference`` with the window mask when ``S % W or
  S == W``.

GQA groups query heads as ``(Hkv, G)``: head ``h = kv * G + g``.  Scores
are float32; probabilities are cast to v's dtype before the PV product.

``init_kv_cache`` / ``decode_attn`` are the decode path: one token a
sequence against a KV cache with per-slot positions (a ring buffer for
windowed layers), plain tensor code on every device, as in the
reference (its decode attention is an einsum, no Pallas kernel).

The full-sequence functions are the CPU path of the transformer's
layers.  On the card every layer (local and global) runs
``repro_torch.kernels.flash_attention.ops.flash_attention`` instead:
the hand-written forward and backward kernels, which keep ``p`` in
float32 for the PV product (so in bfloat16 the two paths differ by the
rounding of ``p``; in float32 they agree to rounding).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, softcap

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def attn_shapes(d_model: int, n_heads: int, n_kv_heads: int,
                head_dim: int) -> dict:
    return {"wq": (d_model, n_heads * head_dim),
            "wk": (d_model, n_kv_heads * head_dim),
            "wv": (d_model, n_kv_heads * head_dim),
            "wo": (n_heads * head_dim, d_model)}


def init_attn(generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, device=None, lead=()) -> dict:
    shapes = attn_shapes(d_model, n_heads, n_kv_heads, head_dim)
    s = d_model ** -0.5
    so = (n_heads * head_dim) ** -0.5
    scales = {"wq": s, "wk": s, "wv": s, "wo": so}
    return {k: (scales[k] * torch.randn(tuple(lead) + shp,
                                        generator=generator,
                                        device=device)).to(dtype)
            for k, shp in shapes.items()}


def qkv(params, x, *, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence attention
# ---------------------------------------------------------------------------

def _gqa_scores(q, k, scale, cap):
    """q: (B,S,Hkv,G,D), k: (B,T,Hkv,D) -> (B,Hkv,G,S,T) fp32 scores."""
    s = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float()) * scale
    return softcap(s, cap)


def _gqa_out(probs, v):
    """probs: (B,Hkv,G,S,T), v: (B,T,Hkv,D) -> (B,S,Hkv*G*D)."""
    o = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)
    B, S = o.shape[:2]
    return o.reshape(B, S, -1)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attn_reference(q, k, v, *, causal=True, window=None, cap=None,
                   q_offset=0):
    """Oracle attention. q: (B,S,H,D); k,v: (B,T,Hkv,D)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    s = _gqa_scores(qg, k, D ** -0.5, cap)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    s = torch.where(_mask(qpos, kpos, causal, window), s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v)


def attn_chunked(q, k, v, *, causal=True, window=None, cap=None,
                 q_offset=0, chunk=1024):
    """Online-softmax attention over KV chunks (a loop where the
    reference scans)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if T % chunk:
        chunk = T  # degenerate: single chunk
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scale = D ** -0.5
    qpos = torch.arange(S, device=q.device) + q_offset
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, T, chunk):
        k_c, v_c = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _gqa_scores(qg, k_c, scale, cap)             # (B,Hkv,G,S,chunk)
        kpos = c0 + torch.arange(chunk, device=q.device)
        s = torch.where(_mask(qpos, kpos, causal, window), s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgst,bthd->bhgsd", p.to(v_c.dtype), v_c).float()
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * D)
    return o.to(q.dtype)


def attn_block_local(q, k, v, *, window, cap=None):
    """Exact causal sliding-window attention in O(S * 2W); each query
    block of W attends to itself and the previous block."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    W = window
    if S % W or S == W:
        return attn_reference(q, k, v, causal=True, window=window, cap=cap)
    nb = S // W
    G = H // Hkv
    qb = q.reshape(B, nb, W, Hkv, G, D)
    kb = k.reshape(B, nb, W, Hkv, D)
    vb = v.reshape(B, nb, W, Hkv, D)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)          # (B,nb,2W,Hkv,D)
    v2 = torch.cat([v_prev, vb], dim=2)
    s = torch.einsum("bnshgd,bnthd->bnhgst", qb.float(),
                     k2.float()) * (D ** -0.5)
    s = softcap(s, cap)
    qpos = torch.arange(W, device=q.device)[:, None]          # in block
    kpos = torch.arange(2 * W, device=q.device)[None, :] - W  # rel. start
    mask = (kpos <= qpos) & (kpos > qpos - W)                 # (W, 2W)
    first = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    prev_valid = torch.where(first, (kpos >= 0)[None], True)  # (nb,1,2W)
    mask = mask[None] & prev_valid                            # (nb,W,2W)
    s = torch.where(mask[None, :, None, None], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhgst,bnthd->bnshgd", p.to(v2.dtype), v2)
    return o.reshape(B, S, H * D)


# ---------------------------------------------------------------------------
# Decode-step attention over a cache
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
                  dtype, device=None) -> dict:
    return {
        "k": torch.zeros((batch, cache_len, n_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, n_kv_heads, head_dim),
                         dtype=dtype, device=device),
        # absolute position held in each slot, PER SEQUENCE; -1 = empty
        # (per-sequence positions enable continuous batching)
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def decode_attn(params, x_t, cache, *, n_heads, n_kv_heads, head_dim,
                rope_theta, pos, window=None, cap=None, ring=False,
                rope=True):
    """One-token attention against a KV cache.

    x_t: (B, d); pos: (B,) int32 per-sequence positions (sequences may be
    at different depths -- continuous batching).  ``ring=True`` means the
    cache is a ring buffer of size ``cache_len`` (windowed layers): the
    token goes to slot ``pos mod C``, else to ``clip(pos, 0, C - 1)``.
    Returns (out (B, d_attn), new_cache); ``cache`` is not modified.
    """
    B = x_t.shape[0]
    pos = torch.as_tensor(pos, device=x_t.device).expand(B)
    q = (x_t @ params["wq"]).reshape(B, 1, n_heads, head_dim)
    k_t = (x_t @ params["wk"]).reshape(B, 1, n_kv_heads, head_dim)
    v_t = (x_t @ params["wv"]).reshape(B, 1, n_kv_heads, head_dim)
    if rope:
        posv = pos[:, None]                     # (B, 1)
        q = apply_rope(q, posv, rope_theta)
        k_t = apply_rope(k_t, posv, rope_theta)

    C = cache["k"].shape[1]
    slot = (torch.remainder(pos, C) if ring
            else torch.clamp(pos, 0, C - 1)).long()          # (B,)
    rows = torch.arange(B, device=x_t.device)
    k, v, posarr = (cache["k"].clone(), cache["v"].clone(),
                    cache["pos"].clone())
    k[rows, slot] = k_t[:, 0]
    v[rows, slot] = v_t[:, 0]
    posarr[rows, slot] = pos.to(posarr.dtype)

    G = n_heads // n_kv_heads
    qg = q.reshape(B, 1, n_kv_heads, G, head_dim)
    s = _gqa_scores(qg, k, head_dim ** -0.5, cap)            # (B,Hkv,G,1,C)
    valid = (posarr >= 0) & (posarr <= pos[:, None])
    if window is not None:
        valid &= posarr > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = _gqa_out(p, v)[:, 0, :]
    return o, {"k": k, "v": v, "pos": posarr}
