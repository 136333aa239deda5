"""Differential-privacy accountant for Fed-PLT (paper Section VI): a copy
of the reference's numpy-only ``repro/core/privacy.py`` (the port imports
nothing of ``repro``).

Implements:
  * Proposition 4: (lambda, eps)-RDP of Fed-PLT with noisy GD local
    training,

        eps_i <= lambda L^2 / (mu tau^2 q_i^2) * (1 - exp(-mu gamma K N_e / 2))

    -- crucially *bounded* as K N_e -> inf (local training does not blow up
    the privacy budget).
  * Lemma 5: RDP -> approximate DP conversion, with optimization over the
    Renyi order lambda.
  * Noise calibration: smallest tau meeting a target (eps, delta)-ADP.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def rdp_epsilon(lam: float, sensitivity: float, mu: float, tau: float,
                q: int, gamma: float, K: int, n_epochs: int) -> float:
    """Proposition 4 worst-case RDP bound (lam = Renyi order > 1).

    ``sensitivity`` is L of Assumption 3 (gradient sensitivity * q_i),
    ``mu`` the strong-convexity modulus (lambda underbar), ``q`` the
    smallest local dataset size.
    """
    if lam <= 1.0:
        raise ValueError("Renyi order must be > 1")
    if tau <= 0.0:
        return float("inf")
    cap = lam * sensitivity ** 2 / (mu * tau ** 2 * q ** 2)
    return float(cap * (1.0 - math.exp(-mu * gamma * K * n_epochs / 2.0)))


def rdp_epsilon_limit(lam: float, sensitivity: float, mu: float, tau: float,
                      q: int) -> float:
    """K N_e -> infinity privacy ceiling (the paper's headline bound)."""
    if tau <= 0.0:
        return float("inf")
    return float(lam * sensitivity ** 2 / (mu * tau ** 2 * q ** 2))


def rdp_to_adp(eps_rdp: float, lam: float, delta: float) -> float:
    """Lemma 5: (lam, eps)-RDP  =>  (eps + log(1/delta)/(lam-1), delta)-ADP."""
    return float(eps_rdp + math.log(1.0 / delta) / (lam - 1.0))


def adp_epsilon(sensitivity: float, mu: float, tau: float, q: int,
                gamma: float, K: int, n_epochs: int, delta: float,
                lam_grid=None) -> tuple[float, float]:
    """Best ADP epsilon over a grid of Renyi orders; returns (eps, lam*)."""
    if lam_grid is None:
        lam_grid = np.concatenate([np.linspace(1.01, 2, 25),
                                   np.linspace(2, 64, 200),
                                   np.geomspace(64, 4096, 60)])
    best_eps, best_lam = float("inf"), None
    for lam in lam_grid:
        e = rdp_to_adp(
            rdp_epsilon(lam, sensitivity, mu, tau, q, gamma, K, n_epochs),
            lam, delta)
        if e < best_eps:
            best_eps, best_lam = e, float(lam)
    return best_eps, best_lam


def calibrate_noise(target_eps: float, delta: float, sensitivity: float,
                    mu: float, q: int, gamma: float, K: int,
                    n_epochs: int, tol: float = 1e-6) -> float:
    """Smallest tau such that Fed-PLT is (target_eps, delta)-ADP
    (bisection; eps is monotone decreasing in tau).

    Raises ValueError when the target is unreachable by noise alone:
    the Lemma-5 RDP->ADP conversion floors the ADP eps at
    ``log(1/delta) / (lam_max - 1)`` over the searched Renyi orders, so
    a target below that floor cannot be met no matter how large tau is
    -- returning the bracket top silently would hand the caller a tau
    that does NOT meet the budget it asked for.
    """
    lo, hi = 1e-8, 1e6
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        eps, _ = adp_epsilon(sensitivity, mu, mid, q, gamma, K, n_epochs,
                             delta)
        if eps > target_eps:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1.0 + tol:
            break
    achieved, _ = adp_epsilon(sensitivity, mu, hi, q, gamma, K, n_epochs,
                              delta)
    if not achieved <= target_eps * (1.0 + 10.0 * tol):
        raise ValueError(
            f"target eps={target_eps:.4g} is unreachable by noise "
            f"calibration: best achievable eps={achieved:.4g} at "
            f"tau={hi:.3g} (Lemma 5 floors ADP eps at "
            f"log(1/delta)/(lambda-1) over the searched Renyi orders)")
    return hi


@dataclasses.dataclass(frozen=True)
class AgentPrivacy:
    """One agent's row of the per-agent (eps_i, delta) table (Prop. 4 is
    a per-agent bound: eps_i depends on q_i, gamma_i, and N_e,i)."""
    agent: int
    q: int
    n_epochs: int
    gamma: float
    adp_eps: float
    rdp_order: float
    eps_ceiling: float
    # Async (bounded-staleness) runs compose over the agent's REALIZED
    # schedule: K is its effective round count (rounds of local epochs
    # actually released; None = the report's nominal K) and arrivals how
    # many increments it transmitted.  Synchronous reports leave both
    # None.
    K: int = None
    arrivals: int = None


@dataclasses.dataclass(frozen=True)
class PrivacyReport:
    """Summary of the privacy position of one Fed-PLT configuration.

    ``per_agent`` is None for a homogeneous run (every agent shares the
    scalar fields); for heterogeneous runs it carries one
    :class:`AgentPrivacy` row per agent and the scalar ``adp_eps`` /
    ``eps_ceiling`` are the MAX over agents (the budget the deployment
    as a whole must honor), with ``n_epochs`` / ``rdp_*`` taken from
    that worst-off agent.
    """
    tau: float
    K: int
    n_epochs: int
    rdp_eps: float
    rdp_order: float
    adp_eps: float
    adp_delta: float
    eps_ceiling: float       # K*Ne -> inf limit at the same order
    per_agent: tuple = None  # tuple[AgentPrivacy, ...] | None

    @staticmethod
    def build(sensitivity, mu, tau, q, gamma, K, n_epochs,
              delta=1e-5) -> "PrivacyReport":
        eps, lam = adp_epsilon(sensitivity, mu, tau, q, gamma, K, n_epochs,
                               delta)
        return PrivacyReport(
            tau=tau, K=K, n_epochs=n_epochs,
            rdp_eps=rdp_epsilon(lam, sensitivity, mu, tau, q, gamma, K,
                                n_epochs),
            rdp_order=lam,
            adp_eps=eps, adp_delta=delta,
            eps_ceiling=rdp_to_adp(
                rdp_epsilon_limit(lam, sensitivity, mu, tau, q), lam, delta),
        )

    @staticmethod
    def build_per_agent(sensitivities, mu, tau, qs, gammas, K,
                        n_epochs_seq, delta=1e-5, Ks=None,
                        arrivals=None) -> "PrivacyReport":
        """Per-agent Prop. 4 accounting: one (eps_i, delta) row per
        agent, each with its own sensitivity / q_i / gamma_i / N_e,i and
        its own optimized Renyi order.  The headline eps is the max over
        agents.

        ``Ks`` (optional) gives each agent its own EFFECTIVE round count
        -- under bounded-staleness async rounds, the rounds of local
        epochs agent i actually released (derived from the realized
        arrival schedule by
        :func:`repro_torch.fed.async_engine.effective_counts`;
        the K * N_e product of Prop. 4 then reflects released
        information only).  ``arrivals`` (optional) annotates each row
        with the agent's increment count; both default to the
        synchronous reading where every agent composes over the nominal
        ``K`` rounds."""
        effective = Ks is not None
        if Ks is None:
            Ks = [K] * len(qs)
        if arrivals is None:
            arrivals = [None] * len(qs)
        rows = []
        for i, (s, q, gamma, ne, ki, ai) in enumerate(
                zip(sensitivities, qs, gammas, n_epochs_seq, Ks,
                    arrivals)):
            eps, lam = adp_epsilon(s, mu, tau, q, gamma, ki, ne, delta)
            rows.append(AgentPrivacy(
                agent=i, q=q, n_epochs=ne, gamma=gamma, adp_eps=eps,
                rdp_order=lam,
                eps_ceiling=rdp_to_adp(
                    rdp_epsilon_limit(lam, s, mu, tau, q), lam, delta),
                K=ki if effective else None, arrivals=ai))
        worst = max(rows, key=lambda r: r.adp_eps)
        worst_K = worst.K if worst.K is not None else K
        return PrivacyReport(
            tau=tau, K=K, n_epochs=worst.n_epochs,
            rdp_eps=rdp_epsilon(worst.rdp_order,
                                sensitivities[worst.agent], mu, tau,
                                worst.q, worst.gamma, worst_K,
                                worst.n_epochs),
            rdp_order=worst.rdp_order,
            adp_eps=worst.adp_eps, adp_delta=delta,
            eps_ceiling=max(r.eps_ceiling for r in rows),
            per_agent=tuple(rows))
