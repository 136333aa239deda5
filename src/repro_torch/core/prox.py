"""Proximal operators (counterpart of ``repro/core/prox.py``, the
``make_prox`` table).

Every operator is ``(y, rho) -> x`` with
``prox_{rho f}(y) = argmin_x f(x) + ||x - y||^2 / (2 rho)``.  All table
entries are elementwise and carry the ``elementwise`` tag the round
engine reads (:func:`repro_torch.fed.engine.fusible_prox`).

A Python callable cannot reach a GPU kernel, so each entry also carries
``kernel_params(rho) -> (code, a, b)``: the same operator as one integer
code and two float parameters, which the round-edge kernels evaluate in
float32 (:mod:`repro_torch.kernels.round_edge`):

  PROX_NONE    identity
  PROX_SHRINK  ``sign(y) * max(|y| - a, 0) * b``  (soft threshold a, then
               scale b; a = 0 is a pure scale, b = 1 a pure threshold)
  PROX_CLIP    ``clip(y, a, b)``

The shrink factors are computed in Python double and rounded once to
float32, as the reference pins them; ``_pin_scale`` itself exists there
only to defeat XLA constant folding and is not carried over.
"""

from __future__ import annotations

from typing import Callable

import torch

ProxFn = Callable[[torch.Tensor, float], torch.Tensor]

PROX_NONE, PROX_SHRINK, PROX_CLIP = 0, 1, 2


def _elementwise(kernel_params):
    """Tag a prox as elementwise and attach its kernel form."""
    def deco(fn):
        fn.elementwise = True
        fn.kernel_params = kernel_params
        return fn
    return deco


def _soft(y, a):
    return torch.sign(y) * torch.clamp(torch.abs(y) - a, min=0.0)


# ---------------------------------------------------------------------------
# Elementary proximal operators
# ---------------------------------------------------------------------------

@_elementwise(lambda rho: (PROX_NONE, 0.0, 0.0))
def prox_zero(y: torch.Tensor, rho: float) -> torch.Tensor:
    """prox of h = 0: identity."""
    del rho
    return y


@_elementwise(lambda rho: (PROX_SHRINK, rho, 1.0))
def prox_l1(y: torch.Tensor, rho: float) -> torch.Tensor:
    """Soft-thresholding: prox of h(x) = ||x||_1."""
    return _soft(y, rho)


@_elementwise(lambda rho: (PROX_SHRINK, 0.0, 1.0 / (1.0 + rho)))
def prox_l2sq(y: torch.Tensor, rho: float) -> torch.Tensor:
    """prox of h(x) = ||x||^2 / 2: shrinkage by 1/(1 + rho)."""
    return y * (1.0 / (1.0 + rho))


@_elementwise(lambda rho, weight=0.0: (PROX_SHRINK, 0.0,
                                       1.0 / (1.0 + weight * rho)))
def prox_weight_decay(y: torch.Tensor, rho: float,
                      weight: float = 0.0) -> torch.Tensor:
    """prox of h(x) = (weight/2) ||x||^2: shrinkage by 1/(1 + weight rho)."""
    return y * (1.0 / (1.0 + weight * rho))


@_elementwise(lambda rho, l1=1.0, l2=1.0: (PROX_SHRINK, rho * l1,
                                           1.0 / (1.0 + rho * l2)))
def prox_elastic_net(y: torch.Tensor, rho: float, l1: float = 1.0,
                     l2: float = 1.0) -> torch.Tensor:
    """prox of h(x) = l1 ||x||_1 + (l2/2) ||x||^2."""
    return _soft(y, rho * l1) * (1.0 / (1.0 + rho * l2))


@_elementwise(lambda rho, lo=-1.0, hi=1.0: (PROX_CLIP, lo, hi))
def prox_box(y: torch.Tensor, rho: float, lo: float = -1.0,
             hi: float = 1.0) -> torch.Tensor:
    """Projection onto a box (rho-independent)."""
    del rho
    return torch.clamp(y, lo, hi)


@_elementwise(lambda rho, radius=1.0: (PROX_CLIP, -radius, radius))
def prox_linf_ball(y: torch.Tensor, rho: float,
                   radius: float = 1.0) -> torch.Tensor:
    """Projection onto the l-inf ball."""
    del rho
    return torch.clamp(y, -radius, radius)


PROX_TABLE = {
    "zero": prox_zero,
    "l1": prox_l1,
    "l2sq": prox_l2sq,
    "weight_decay": prox_weight_decay,
    "elastic_net": prox_elastic_net,
    "box": prox_box,
    "linf_ball": prox_linf_ball,
}


def make_prox(name: str, **kw) -> ProxFn:
    fn = PROX_TABLE.get(name)
    if fn is None:
        raise ValueError(f"unknown prox {name!r}; registered: "
                         f"{', '.join(sorted(PROX_TABLE))}")
    if not kw:
        return fn

    def bound(y, rho):
        return fn(y, rho, **kw)

    # binding static kwargs keeps the elementwise tag and the kernel form
    bound.elementwise = fn.elementwise
    bound.kernel_params = lambda rho: fn.kernel_params(rho, **kw)
    return bound


def prox_kernel_params(prox_h, rho_eff: float) -> tuple:
    """``(code, a, b)`` of a fusible prox (None = h = 0)."""
    if prox_h is None:
        return (PROX_NONE, 0.0, 0.0)
    return prox_h.kernel_params(rho_eff)


def apply_prox_code(y: torch.Tensor, code: int, a: float,
                    b: float) -> torch.Tensor:
    """The kernels' coded prox in plain PyTorch (float32 ``y``)."""
    if code == PROX_NONE:
        return y
    if code == PROX_SHRINK:
        return _soft(y, a) * b
    if code == PROX_CLIP:
        return torch.clamp(y, a, b)
    raise ValueError(f"unknown prox code {code}")
