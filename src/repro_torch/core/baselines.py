"""Baseline federated algorithms compared against Fed-PLT (counterpart of
``repro/core/baselines.py``, paper Sec. I-A and Table 2).

All baselines share the interface

    algo = make_<name>(problem, **hyperparams)
    crit_history = algo.run(seed, n_rounds)        # (n_rounds,) criterion

with the paper's criterion ``|| sum_i grad f_i(x_bar) ||^2`` recorded after
every communication round (a tensor on the problem's device), and a
``time_per_round(t_G, t_C)`` implementing the Table-II accounting.  Plain
PyTorch, batched over agents, on the problem's device.

The coin flips and participation draws are explicit: ``run`` takes them as
keyword arguments -- ``u`` ``(n_rounds, N)`` participation (or client
sampling) rows, ``theta`` ``(n_steps,)`` communication coins -- and draws
what is not given from a ``torch.Generator`` seeded with ``seed`` (the
reference draws with JAX's threefry; the bits differ).

Implementation provenance (the reference's, documented deviations):
  * FedAvg        -- McMahan et al. (reference point, not in the tables).
  * FedSplit [34] -- PRS without warm start (inner GD initialized at the
                     reflected point, *not* at the previous local model).
  * FedPD  [35]   -- augmented-Lagrangian form, warm-started inner GD.
  * FedLin [36]   -- two communications per round (gradient sync + model).
  * SCAFFOLD      -- option-II control variates.
  * ProxSkip [19] -- a.k.a. Scaffnew; probabilistic communication.
  * TAMUNA [37]   -- its LT+PP form without compression.
  * LED    [38]   -- its equivalent control-variate server form.
  * 5GCS   [14]   -- RandProx/Point-SAGA form: sampled clients approximate
                     prox_{alpha f_i} with any local solver, dual table on
                     the server.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _local_gd(problem, w0, n_epochs, gamma, grad_mod=None):
    """``n_epochs`` of ``w -= gamma * grad_mod(grad f_i(w), w)`` for every
    agent at once (``w0`` ``(N, n)``; ``grad_mod`` None is the plain
    gradient)."""
    w = w0
    for _ in range(n_epochs):
        g = problem.grads(w)
        w = w - gamma * (g if grad_mod is None else grad_mod(g, w))
    return w


def _masked_mean(w, u, fallback):
    """Mean over active agents (u in {0,1}); falls back when none active."""
    cnt = torch.sum(u)
    m = torch.sum(w * u[:, None], dim=0) / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, m, fallback)


def _rows(draws, gen, p, shape, device):
    """Given Bernoulli draws as a float32 tensor, or ``shape`` fresh ones
    of rate ``p`` from ``gen``."""
    if draws is not None:
        return torch.as_tensor(draws, dtype=torch.float32).to(device)
    return (torch.rand(shape, generator=gen, device=device) < p).float()


def _generator(problem, seed):
    return torch.Generator(device=problem.device).manual_seed(seed)


@dataclasses.dataclass
class Algorithm:
    name: str
    run: Callable  # (seed, n_rounds, **draws) -> (n_rounds,) criterion
    time_per_round: Callable  # (t_G, t_C) -> float
    comms_per_round: float = 1.0


def _history(problem, n):
    return torch.empty(n, device=problem.device)


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------

def make_fedavg(problem, gamma=0.1, n_epochs=5, participation=1.0):
    N = problem.n_agents

    @torch.no_grad()
    def run(seed, n_rounds, u=None):
        u = _rows(u, _generator(problem, seed), participation,
                  (n_rounds, N), problem.device)
        x_bar = torch.zeros(problem.dim, device=problem.device)
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            w = _local_gd(problem, x_bar.expand(N, -1), n_epochs, gamma)
            x_bar = _masked_mean(w, u[k], x_bar)
            crit[k] = problem.criterion(x_bar)
        return crit

    return Algorithm(
        "fedavg", run,
        lambda tG, tC, N_=N: (n_epochs * tG + tC) * N_ * participation)


# ---------------------------------------------------------------------------
# FedSplit [34] -- PRS without the warm-start initialization
# ---------------------------------------------------------------------------

def make_fedsplit(problem, rho=1.0, gamma=None, n_epochs=5):
    N = problem.n_agents
    mu, L = problem.strong_convexity(), problem.smoothness()
    if gamma is None:
        gamma = 2.0 / (mu + L + 2.0 / rho)
    inv_rho = 1.0 / rho

    @torch.no_grad()
    def run(seed, n_rounds):
        del seed
        z = torch.zeros((N, problem.dim), device=problem.device)
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            x_bar = torch.mean(z, dim=0)
            v = 2.0 * x_bar[None, :] - z
            # cold start at the reflected point (FedSplit's choice)
            w = _local_gd(problem, v, n_epochs, gamma,
                          lambda g, w: g + inv_rho * (w - v))
            z = z + 2.0 * (w - x_bar[None, :])
            crit[k] = problem.criterion(w)
        return crit

    return Algorithm(
        "fedsplit", run, lambda tG, tC, N_=N: (n_epochs * tG + tC) * N_)


# ---------------------------------------------------------------------------
# FedPD [35]
# ---------------------------------------------------------------------------

def make_fedpd(problem, eta=1.0, gamma=0.05, n_epochs=5):
    N = problem.n_agents
    inv_eta = 1.0 / eta

    @torch.no_grad()
    def run(seed, n_rounds):
        del seed
        x = torch.zeros((N, problem.dim), device=problem.device)
        lam = torch.zeros_like(x)
        x_bar = torch.zeros(problem.dim, device=problem.device)
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            x = _local_gd(problem, x, n_epochs, gamma,
                          lambda g, w: g + lam + inv_eta * (w - x_bar))
            lam = lam + inv_eta * (x - x_bar[None, :])
            x_bar = torch.mean(x + eta * lam, dim=0)
            crit[k] = problem.criterion(x)
        return crit

    return Algorithm(
        "fedpd", run, lambda tG, tC, N_=N: (n_epochs * tG + tC) * N_)


# ---------------------------------------------------------------------------
# FedLin [36]
# ---------------------------------------------------------------------------

def make_fedlin(problem, gamma=0.05, n_epochs=5):
    N = problem.n_agents

    @torch.no_grad()
    def run(seed, n_rounds):
        del seed
        x_bar = torch.zeros(problem.dim, device=problem.device)
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            # communication 1: gradient sync
            g_at_xbar = problem.grads(x_bar.expand(N, -1))
            g_mean = torch.mean(g_at_xbar, dim=0)
            w = _local_gd(problem, x_bar.expand(N, -1), n_epochs, gamma,
                          lambda g, w: g - g_at_xbar + g_mean)
            # communication 2: model sync
            x_bar = torch.mean(w, dim=0)
            crit[k] = problem.criterion(x_bar)
        return crit

    return Algorithm(
        "fedlin", run,
        lambda tG, tC, N_=N: ((n_epochs + 1) * tG + 2 * tC) * N_,
        comms_per_round=2.0)


# ---------------------------------------------------------------------------
# SCAFFOLD
# ---------------------------------------------------------------------------

def make_scaffold(problem, gamma_l=0.05, gamma_g=1.0, n_epochs=5,
                  participation=1.0):
    N = problem.n_agents

    @torch.no_grad()
    def run(seed, n_rounds, u=None):
        dev = problem.device
        u = _rows(u, _generator(problem, seed), participation,
                  (n_rounds, N), dev)
        x_bar = torch.zeros(problem.dim, device=dev)
        c = torch.zeros(problem.dim, device=dev)
        c_i = torch.zeros((N, problem.dim), device=dev)
        zero = torch.zeros(problem.dim, device=dev)
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            w = _local_gd(problem, x_bar.expand(N, -1), n_epochs, gamma_l,
                          lambda g, w: g - c_i + c)
            c_i_plus = c_i - c + (x_bar[None, :] - w) / (n_epochs * gamma_l)
            uk = u[k]
            dx = _masked_mean(w - x_bar[None, :], uk, zero)
            dc = _masked_mean(c_i_plus - c_i, uk, zero)
            frac = torch.sum(uk) / N
            x_bar = x_bar + gamma_g * dx
            c = c + frac * dc
            c_i = uk[:, None] * c_i_plus + (1 - uk[:, None]) * c_i
            crit[k] = problem.criterion(x_bar)
        return crit

    return Algorithm(
        "scaffold", run,
        lambda tG, tC, N_=N: (n_epochs * tG + tC) * N_ * participation)


# ---------------------------------------------------------------------------
# ProxSkip / Scaffnew [19]
# ---------------------------------------------------------------------------

def make_proxskip(problem, gamma=0.05, p_comm=0.2):
    """One *gradient step* per iteration; communication w.p. p_comm.

    ``run(seed, n_steps, theta=None)`` records the criterion after every
    step (the caller scales steps to rounds)."""
    N = problem.n_agents

    @torch.no_grad()
    def run(seed, n_steps, theta=None):
        dev = problem.device
        theta = _rows(theta, _generator(problem, seed), p_comm, (n_steps,),
                      dev)
        x = torch.zeros((N, problem.dim), device=dev)
        h = torch.zeros_like(x)
        crit = _history(problem, n_steps)
        for k in range(n_steps):
            x_hat = x - gamma * (problem.grads(x) - h)
            comm = theta[k] != 0
            x_comm = torch.mean(x_hat, dim=0).expand_as(x_hat)
            x = torch.where(comm, x_comm, x_hat)
            h = torch.where(comm, h + (p_comm / gamma) * (x - x_hat), h)
            crit[k] = problem.criterion(x)
        return crit

    return Algorithm(
        "proxskip", run, lambda tG, tC, N_=N: (tG + p_comm * tC) * N_)


# ---------------------------------------------------------------------------
# TAMUNA [37] -- LT + PP form (no compression)
# ---------------------------------------------------------------------------

def make_tamuna(problem, gamma=0.05, p_comm=0.2, participation=1.0):
    """Scaffnew-style probabilistic communication + client sampling
    (``run(seed, n_steps, theta=None, u=None)``: the coin ``(n_steps,)``
    and the sampled clients ``(n_steps, N)`` of every step)."""
    N = problem.n_agents

    @torch.no_grad()
    def run(seed, n_steps, theta=None, u=None):
        dev = problem.device
        gen = _generator(problem, seed)
        theta = _rows(theta, gen, p_comm, (n_steps,), dev)
        u = _rows(u, gen, participation, (n_steps, N), dev)
        x = torch.zeros((N, problem.dim), device=dev)
        h = torch.zeros_like(x)
        crit = _history(problem, n_steps)
        for k in range(n_steps):
            x_hat = x - gamma * (problem.grads(x) - h)
            x_mean = _masked_mean(x_hat, u[k], torch.mean(x_hat, dim=0))
            x_comm = torch.where(u[k][:, None] > 0, x_mean.expand_as(x_hat),
                                 x_hat)
            comm = theta[k] != 0
            x = torch.where(comm, x_comm, x_hat)
            # inactive agents have x == x_hat, so their h is unchanged
            h = torch.where(comm, h + (p_comm / gamma) * (x - x_hat), h)
            crit[k] = problem.criterion(x)
        return crit

    return Algorithm(
        "tamuna", run,
        lambda tG, tC, N_=N: (tG + p_comm * tC) * N_ * participation)


# ---------------------------------------------------------------------------
# LED [38] -- control-variate server form
# ---------------------------------------------------------------------------

def make_led(problem, gamma=0.05, n_epochs=5, beta=1.0):
    """Local Exact-Diffusion in its control-variate server form: agents
    run ``w <- w - gamma (grad f_i(w) - y_i)`` from ``x_bar`` and the
    zero-mean duals track ``y_i -> grad f_i(x*)`` by
    ``y_i <- y_i + beta/(gamma N_e) (x_bar_new - w_i)``."""
    N = problem.n_agents

    @torch.no_grad()
    def run(seed, n_rounds):
        del seed
        x_bar = torch.zeros(problem.dim, device=problem.device)
        y = torch.zeros((N, problem.dim), device=problem.device)
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            w = _local_gd(problem, x_bar.expand(N, -1), n_epochs, gamma,
                          lambda g, w: g - y)
            x_bar = torch.mean(w, dim=0)
            y = y + beta / (gamma * n_epochs) * (x_bar[None, :] - w)
            crit[k] = problem.criterion(x_bar)
        return crit

    return Algorithm(
        "led", run, lambda tG, tC, N_=N: (n_epochs * tG + tC) * N_)


# ---------------------------------------------------------------------------
# 5GCS [14] -- RandProx / Point-SAGA form with client sampling
# ---------------------------------------------------------------------------

def make_5gcs(problem, alpha=1.0, eta=0.5, n_epochs=5, participation=0.5,
              solver: str = "gd"):
    """Sampled clients approximately solve ``prox_{alpha f_i}(x + alpha
    u_i)`` with N_e local epochs of GD or AGD; the server keeps a dual
    table u_i (``run(seed, n_rounds, u=None)``: the sampled clients
    ``(n_rounds, N)``)."""
    N = problem.n_agents
    mu, L = problem.strong_convexity(), problem.smoothness()
    mu_d, L_d = mu + 1.0 / alpha, L + 1.0 / alpha
    gamma = 2.0 / (mu_d + L_d)
    inv_alpha = 1.0 / alpha
    beta = ((math.sqrt(L_d) - math.sqrt(mu_d))
            / (math.sqrt(L_d) + math.sqrt(mu_d)))

    def solve(w0, v):
        if solver == "agd":
            w, up = w0, w0
            for _ in range(n_epochs):
                grd = problem.grads(w) + inv_alpha * (w - v)
                un = w - grd / L_d
                w, up = un + beta * (un - up), un
            return w
        return _local_gd(problem, w0, n_epochs, gamma,
                         lambda g, w: g + inv_alpha * (w - v))

    @torch.no_grad()
    def run(seed, n_rounds, u=None):
        dev = problem.device
        sel = _rows(u, _generator(problem, seed), participation,
                    (n_rounds, N), dev)
        x = torch.zeros(problem.dim, device=dev)
        du = torch.zeros((N, problem.dim), device=dev)
        w_prev = torch.zeros_like(du)      # client-side warm starts
        crit = _history(problem, n_rounds)
        for k in range(n_rounds):
            s = sel[k][:, None]
            w_hat = solve(w_prev, x[None, :] + alpha * du)
            g_new = inv_alpha * (x[None, :] + alpha * du - w_hat)
            du = s * g_new + (1 - s) * du
            w_prev = s * w_hat + (1 - s) * w_prev
            x = x - eta * alpha * torch.mean(du, dim=0)
            crit[k] = problem.criterion(x)
        return crit

    return Algorithm(
        "5gcs", run,
        lambda tG, tC, N_=N: (n_epochs * tG + tC) * N_ * participation)


REGISTRY = {
    "fedavg": make_fedavg,
    "fedsplit": make_fedsplit,
    "fedpd": make_fedpd,
    "fedlin": make_fedlin,
    "scaffold": make_scaffold,
    "proxskip": make_proxskip,
    "tamuna": make_tamuna,
    "led": make_led,
    "5gcs": make_5gcs,
}
