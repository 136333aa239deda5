"""Plain PyTorch versions of the round-edge kernels (counterpart of
``repro/kernels/round_edge/ref.py``).

The same function the CUDA kernels compute: the agent-axis mean as a
float32 sum in row order 0..N-1 times the float32 reciprocal ``1/N``
(written as a product because PyTorch divides by a scalar on the GPU as
a multiply by its reciprocal), the prox in float32, ``y`` rounded once
to the buffer dtype, and every consumer (the reflection, the z-update)
reading that stored ``y``.  In float32 this is the
reference's ``mean -> prox -> reflect`` chain.  The CPU path of
:mod:`repro_torch.kernels.round_edge.ops`, and what the card's kernels
are held against.
"""

from __future__ import annotations

import torch


def coordinator_ref(seen: torch.Tensor, prox=None,
                    rho_eff: float = 1.0) -> torch.Tensor:
    """``y = prox(mean_i seen_i)`` as a ``(1, M)`` row in seen's dtype."""
    acc = seen[0].float()
    for i in range(1, seen.shape[0]):
        acc = acc + seen[i].float()
    zbar = acc * (1.0 / seen.shape[0])
    y = zbar if prox is None else prox(zbar, rho_eff)
    return y.to(seen.dtype)[None]


def round_uplink_ref(z, t=None, prox=None, rho_eff=1.0):
    """``y = prox(mean_i seen_i)``, ``v = 2 y - z`` on (N, M), where
    ``seen`` is ``t`` (lagged copy) or ``z`` itself."""
    y = coordinator_ref(z if t is None else t, prox, rho_eff)
    v = 2.0 * y.float() - z.float()
    return y, v.to(z.dtype)


def round_downlink_ref(x, w, z, u, t=None, prox=None, rho_eff=1.0,
                       damping=1.0):
    """Krasnosel'skii ``z + 2 damping (w - y)`` and the participation
    selects (``torch.where``: an inactive agent's state stays untouched
    even by a NaN local solve).  ``y`` is recomputed from ``t`` / ``z``."""
    y = coordinator_ref(z if t is None else t, prox, rho_eff).float()
    mask = (u != 0).reshape(-1, 1)
    z_upd = (z.float() + (2.0 * damping) * (w.float() - y)).to(z.dtype)
    return torch.where(mask, w, x), torch.where(mask, z_upd, z)
