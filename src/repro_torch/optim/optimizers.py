"""Minimal optimizer library for standard (non-federated) training mode
(counterpart of ``repro/optim/optimizers.py``).

Optax-style pairs on ``{name: tensor}`` dicts: ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)``, plus
:func:`apply_updates`.  States and updates are float32 whatever the
parameters' dtype; :func:`apply_updates` adds in float32 and casts back.
AdamW's step count ``t`` is a 0-d int32 tensor and its bias corrections
``1 - b ** t`` are float32, the power by square-and-multiply as XLA
takes a float to an integer power (``torch.pow`` rounds otherwise).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple]


def _zeros(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def apply_updates(params: dict, updates: dict) -> dict:
    return {n: (p.float() + updates[n]).to(p.dtype)
            for n, p in params.items()}


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return {n: -lr * g.float() for n, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, m, params=None):
        m = {n: beta * m[n] + g.float() for n, g in grads.items()}
        return {n: -lr * mm for n, mm in m.items()}, m

    return Optimizer(init, update)


def _int_pow(b: float, n: int) -> np.float32:
    """``b ** n`` in float32 by square-and-multiply (XLA's ``pow`` with an
    integer exponent)."""
    base, acc = np.float32(b), np.float32(1.0)
    while n:
        if n & 1:
            acc = np.float32(acc * base)
        base = np.float32(base * base)
        n >>= 1
    return acc


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    t: torch.Tensor          # () int32


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device
        return AdamWState(mu=_zeros(params), nu=_zeros(params),
                          t=torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params):
        t = state.t + 1
        n = int(t)
        c1, c2 = (torch.tensor(np.float32(1.0) - _int_pow(b, n),
                               device=t.device) for b in (b1, b2))
        mu = {n: b1 * state.mu[n] + (1 - b1) * g.float()
              for n, g in grads.items()}
        nu = {n: b2 * state.nu[n] + (1 - b2) * torch.square(g.float())
              for n, g in grads.items()}
        upd = {n: -lr * ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
                         + weight_decay * params[n].float())
               for n in grads}
        return upd, AdamWState(mu=mu, nu=nu, t=t)

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw}
