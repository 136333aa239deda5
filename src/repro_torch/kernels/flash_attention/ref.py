"""Plain PyTorch version of the flash-attention kernels (counterpart of
``repro/kernels/flash_attention/ref.py``).

Full-softmax attention with GQA (query head ``h`` reads kv head
``h // G``), a causal mask, a sliding window and a logit softcap
``cap tanh(s / cap)``, in float32 throughout with the output cast once
to q's dtype -- the reference's oracle line for line.  Masked scores are
filled with the finite ``NEG_INF = -1e30``, so a row with no visible key
gives the mean of v (the reference's value, not NaN).

:func:`flash_attention_ref` also returns the float32 log-sum-exp
``lse = m + log l`` of shape ``(B, H, S)``, which the backward reads.
:func:`flash_attention_bwd_ref` is the closed-form gradient of the same
function in float32 (``delta = rowsum(dO * O)`` from the output as
stored, ``ds = p (dp - delta)`` on visible entries, times
``1 - (s / cap)^2`` under a softcap); the card's backward kernels are
held against it, and the CPU tests hold it against ``jax.grad`` of the
reference.  Both are the CPU path of
:mod:`repro_torch.kernels.flash_attention.ops`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(S: int, T: int, causal: bool, window, device=None):
    """``(S, T)`` bool: query ``s`` sees key ``t``."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, cap):
    """q: (B, S, H, D), k: (B, T, Hkv, D) -> the float32 (softcapped)
    scores ``(B, Hkv, G, S, T)`` and the grouped float32 q."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    s = s * (D ** -0.5)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    return s, qg


def flash_attention_ref(q, k, v, *, causal=True, window=None, cap=None):
    """q: (B, S, H, D); k, v: (B, T, Hkv, D) -> ``(o (B, S, H, D) in q's
    dtype, lse (B, H, S) float32)``."""
    B, S, H, D = q.shape
    T = k.shape[1]
    s, _ = _scores(q, k, cap)
    mask = visible_mask(S, T, causal, window, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                          device=s.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / l
    o = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(B, H, S).contiguous()
    return o.reshape(B, S, H, D).to(q.dtype).contiguous(), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            window=None, cap=None):
    """``(dq, dk, dv)`` in the inputs' dtypes: the float32 gradient of
    :func:`flash_attention_ref`'s ``o`` against the upstream ``do``
    ``(B, S, H, D)``, given the forward's ``o`` and ``lse``.

    A row with no visible key has ``p = 1 / T`` on every key (the mean of
    v) and no score gradient, as the reference's masked fill gives."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    s, qg = _scores(q, k, cap)
    mask = visible_mask(S, T, causal, window, q.device)
    dead = ~mask.any(dim=-1)[:, None]                       # (S, 1)
    lse_g = lse.float().reshape(B, Hkv, G, S)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    p = torch.where(dead, 1.0 / T, p)
    dog = do.reshape(B, S, Hkv, G, D).float()
    delta = (dog * o.reshape(B, S, Hkv, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]            # (B,Hkv,G,S,1)
    kf, vf = k.float(), v.float()
    dv = torch.einsum("bhgst,bshgd->bthd", p, dog)
    dp = torch.einsum("bshgd,bthd->bhgst", dog, vf)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    if cap is not None:
        ds = ds * (1.0 - (s / cap) ** 2)
    scale = D ** -0.5
    dq = torch.einsum("bhgst,bthd->bshgd", ds, kf) * scale
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qg) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype).contiguous(),
            dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous())
