"""Public round-edge ops (counterpart of ``repro/kernels/round_edge/ops.py``,
unsharded half).

A CUDA tensor goes to the CUDA kernel (:mod:`.kernel`); a CPU tensor to
the plain version (:mod:`.ref`).  There is no fallback: a kernel that
fails to build or launch raises.  The prox is one of
:func:`repro_torch.core.prox.make_prox`'s table entries (or None); the
kernel receives its ``(code, a, b)`` form.  Each wrapper counts its
kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.prox import prox_kernel_params
from repro_torch.kernels.round_edge import kernel, ref


def _on_cpu(x: torch.Tensor) -> bool:
    if x.ndim != 2:
        raise ValueError(f"round-edge ops take (N, M) buffers, got shape "
                         f"{tuple(x.shape)}")
    return x.device.type == "cpu"


def round_uplink(z, t=None, *, prox=None, rho_eff=1.0):
    """``y = prox(mean_i seen_i, rho_eff)`` and ``v = 2 y - z``; ``seen``
    is ``t`` under a compressed exchange, ``z`` otherwise.  Returns
    ``(y (1, M), v (N, M))``."""
    if _on_cpu(z):
        return ref.round_uplink_ref(z, t, prox, rho_eff)
    out = kernel.round_uplink(z, t, *prox_kernel_params(prox, rho_eff))
    round_uplink.launches += 1
    return out


def round_downlink(x, w, z, u, t=None, *, prox=None, rho_eff=1.0,
                   damping=1.0):
    """``z + 2 damping (w - prox(mean seen, rho_eff))`` and the
    participation selects of x and z (``u`` the ``(N,)`` draw, nonzero =
    active).  Returns ``(x_new, z_new)``."""
    if _on_cpu(x):
        return ref.round_downlink_ref(x, w, z, u, t, prox, rho_eff, damping)
    out = kernel.round_downlink(x, w, z, u, t,
                                *prox_kernel_params(prox, rho_eff),
                                2.0 * damping)
    round_downlink.launches += 1
    return out


round_uplink.launches = 0
round_downlink.launches = 0
