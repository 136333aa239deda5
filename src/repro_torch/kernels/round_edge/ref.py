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

The sharded halves (a rank owns a contiguous row block of the agent
axis): :func:`round_uplink_partial_ref` is the block's float32 row-order
column sum stored in the buffer dtype (the reference's
``.astype(s_ref.dtype)``, so a bf16 partial is rounded before the
division); :func:`finish_coordinator` turns the cross-rank sum into
``y`` with the same float32 reciprocal ``1/N`` multiply and prox as
:func:`coordinator_ref`, so on one rank in float32 the sharded ``y``
equals the unsharded one bit for bit; :func:`round_downlink_presummed_ref`
is the downlink consuming that stored ``y``.
"""

from __future__ import annotations

import torch

# columns per slab of the float32 coordinator chain (bounds its float32
# temporaries at the trainer's full width)
SLAB = 1 << 26


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


def round_uplink_partial_ref(seen: torch.Tensor) -> torch.Tensor:
    """The ``(1, M)`` column sums of one rank's ``(N_local, M)`` rows:
    float32 in row order, stored in ``seen``'s dtype (a fresh tensor: the
    caller all-reduces it in place)."""
    acc = seen[0].to(torch.float32, copy=True)
    for i in range(1, seen.shape[0]):
        acc = acc + seen[i].float()
    return acc.to(seen.dtype)[None]


def finish_coordinator(part: torch.Tensor, n_total: int, prox=None,
                       rho_eff: float = 1.0) -> torch.Tensor:
    """``y = prox(sum * fl32(1/n_total))`` from the all-reduced ``(1, M)``
    partial sums, rounded once to the buffer dtype; in column slabs of
    :data:`SLAB`."""
    y = torch.empty_like(part)
    inv_n = 1.0 / n_total
    for c in range(0, part.shape[1], SLAB):
        zbar = part[:, c:c + SLAB].float() * inv_n
        y[:, c:c + SLAB] = zbar if prox is None else prox(zbar, rho_eff)
    return y


def reflect_ref(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``v = 2 y - z`` in the buffer dtype with one rounding (``2 y`` is
    exact), as the uplink kernel stores it; no float32 copy of ``z``."""
    return torch.sub(2.0 * y, z)


def round_uplink_sharded_ref(z, t=None, prox=None, rho_eff=1.0,
                             n_total=None):
    """The sharded uplink on one whole ``(N, M)`` buffer: the partial sum,
    ``/ n_total -> prox`` (:func:`finish_coordinator`), and the
    reflection from the stored ``y``.  ``n_total`` defaults to N."""
    seen = z if t is None else t
    n = seen.shape[0] if n_total is None else n_total
    y = finish_coordinator(round_uplink_partial_ref(seen), n, prox, rho_eff)
    return y, reflect_ref(y, z)


def round_downlink_presummed_ref(x, w, z, u, y, damping=1.0):
    """The downlink of one rank's rows consuming the replicated ``(1, M)``
    coordinator point ``y``: ``z + 2 damping (w - y)`` in float32, one
    rounding, and the participation selects (``u`` the ``(N_local,)``
    row; ``torch.where``, NaN-safe)."""
    mask = (u != 0).reshape(-1, 1)
    z_upd = (z.float() + (2.0 * damping) * (w.float() - y.float())
             ).to(z.dtype)
    return torch.where(mask, w, x), torch.where(mask, z_upd, z)
