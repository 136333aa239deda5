"""Plain PyTorch version of the fused Fed-PLT local step (counterpart of
``repro/kernels/fedplt_update/ref.py``): the CPU path of
:mod:`repro_torch.kernels.fedplt_update.ops` and what the card's kernel
is held against.  ``g``, ``v`` and ``t`` are cast to ``w``'s dtype first,
as the reference's ``ops.py`` casts them before its kernel."""

from __future__ import annotations


def fedplt_update_ref(w, g, v, t=None, *, gamma: float, inv_rho: float):
    w32 = w.float()
    out = w32 - gamma * (g.to(w.dtype).float()
                         + inv_rho * (w32 - v.to(w.dtype).float()))
    if t is not None:
        out = out + t.to(w.dtype).float()
    return out.to(w.dtype)
