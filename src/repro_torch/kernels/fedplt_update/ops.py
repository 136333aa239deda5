"""Public fused Fed-PLT update op (counterpart of
``repro/kernels/fedplt_update/ops.py``).

A CUDA tensor goes to the CUDA kernel (:mod:`.kernel`), a CPU tensor to
the plain version (:mod:`.ref`); no fallback.  ``g``, ``v`` and ``t``
are cast to ``w``'s dtype first, as the reference's wrapper casts them,
and made contiguous: in the tree layout a leaf of ``v`` is a view into
the fused uplink's packed buffer (a column block of its rows).
``fedplt_update.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.fedplt_update import kernel
from repro_torch.kernels.fedplt_update.ref import fedplt_update_ref


def fedplt_update(w, g, v, t=None, *, gamma: float, inv_rho: float,
                  out=None) -> torch.Tensor:
    """Fused ``w - gamma (g + inv_rho (w - v)) [+ t]`` for one buffer or
    leaf; ``out=w`` updates in place (``out`` None allocates)."""
    if out is None:
        out = torch.empty_like(w)
    if w.device.type == "cpu":
        return out.copy_(fedplt_update_ref(w, g, v, t, gamma=gamma,
                                           inv_rho=inv_rho))
    g, v = g.to(w.dtype).contiguous(), v.to(w.dtype).contiguous()
    t = None if t is None else t.to(w.dtype).contiguous()
    kernel.fedplt_update(w, g, v, t, out, gamma, inv_rho)
    fedplt_update.launches += 1
    costs.record("fedplt_update", *costs.fedplt_update(
        w.numel(), w.element_size(), t is not None))
    return out


fedplt_update.launches = 0
