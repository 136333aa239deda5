"""Public round-edge ops (counterpart of ``repro/kernels/round_edge/ops.py``).

A CUDA tensor goes to the CUDA kernel (:mod:`.kernel`); a CPU tensor to
the plain version (:mod:`.ref`).  There is no fallback: a kernel that
fails to build or launch raises.  The prox is one of
:func:`repro_torch.core.prox.make_prox`'s table entries (or None); the
kernel receives its ``(code, a, b)`` form.  Each wrapper counts its
kernel launches in ``.launches``.

MESH-AWARE REALIZATIONS.  When each rank of an ``("agent", "model")``
device mesh holds a contiguous row block of the agent axis, the uplink is
:func:`round_uplink_sharded`: one :func:`round_uplink_partial` launch on
the rank's rows, ONE all-reduce of the ``(1, M)`` partials over the
mesh's ``agent`` group (:func:`repro_torch.collectives.all_reduce`),
then ``/ N -> prox -> reflection`` in PyTorch at coordinator size (the
reference does that part in XLA).  The downlink
needs no collective: it is one :func:`round_downlink_presummed` launch on
the rank's rows consuming the replicated ``y`` (the reference's
``round_downlink_sharded`` is that launch under ``shard_map``).  A
sharded round still launches exactly two edge kernels per rank.  On one
rank the float32 results equal the unsharded ops bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch import collectives
from repro_torch.core.prox import prox_kernel_params
from repro_torch.kernels import costs
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
    costs.record("round_uplink", *costs.round_uplink(
        *z.shape, z.element_size(), t is not None))
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
    costs.record("round_downlink", *costs.round_downlink(
        *x.shape, x.element_size(), t is not None))
    return out


def round_uplink_partial(seen):
    """The ``(1, M)`` column sums of one rank's ``(N_local, M)`` rows, in
    ``seen``'s dtype (float32 row-order accumulation)."""
    if _on_cpu(seen):
        return ref.round_uplink_partial_ref(seen)
    out = kernel.round_uplink_partial(seen)
    round_uplink_partial.launches += 1
    costs.record("round_uplink_partial", *costs.round_uplink_partial(
        *seen.shape, seen.element_size()))
    return out


def round_downlink_presummed(x, w, z, y, u, *, damping=1.0):
    """``z + 2 damping (w - y)`` and the participation selects of one
    rank's rows, consuming the replicated ``(1, M)`` coordinator row
    ``y``; ``u`` is the rank's ``(N_local,)`` participation row.  Returns
    ``(x_new, z_new)``."""
    if _on_cpu(x):
        return ref.round_downlink_presummed_ref(x, w, z, u, y, damping)
    out = kernel.round_downlink_presummed(x, w, z, y, u, 2.0 * damping)
    round_downlink_presummed.launches += 1
    costs.record("round_downlink_presummed",
                 *costs.round_downlink_presummed(*x.shape, x.element_size()))
    return out


def round_uplink_sharded(z, t=None, *, mesh, n_total, prox=None,
                         rho_eff=1.0):
    """The uplink on this rank's row block: one partial-sum launch, one
    all-reduce of the ``(1, M)`` partials over ``mesh``'s agent group,
    ``y = prox(sum * fl32(1/n_total))`` and ``v = 2 y - z``.  ``n_total``
    is the GLOBAL agent count.  Returns ``(y, v)``, ``y`` the same on
    every rank."""
    part = round_uplink_partial(z if t is None else t)
    collectives.all_reduce(part, mesh.get_group("agent"),
                           "round_uplink_sharded")
    y = ref.finish_coordinator(part, n_total, prox, rho_eff)
    return y, ref.reflect_ref(y, z)


round_uplink.launches = 0
round_downlink.launches = 0
round_uplink_partial.launches = 0
round_downlink_presummed.launches = 0
