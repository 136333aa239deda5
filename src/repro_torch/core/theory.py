"""Convergence theory of Fed-PLT (paper Section V); a copy of
``repro/core/theory.py`` (numpy only).

Implements:
  * chi (Lemma 2) and zeta (Lemma 3) contraction factors,
  * the 2x2 matrix S of Proposition 1 (and S' of Proposition 3),
  * sigma = sqrt(1 - p + p ||S||^2) of Proposition 2,
  * the Lemma-7 stabilizing parameter search (cheap 2x2 grid search),
  * the Corollary-1 privacy/accuracy bound.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.solvers import SolverConfig, solver_contraction


# ---------------------------------------------------------------------------
# Elementary contraction factors
# ---------------------------------------------------------------------------

def chi_gd(gamma: float, mu_d: float, L_d: float) -> float:
    """GD contraction factor (Lemma 2) on a mu_d-s.c., L_d-smooth function."""
    return max(abs(1.0 - gamma * mu_d), abs(1.0 - gamma * L_d))


def zeta_prs(rho: float, mu: float, L: float) -> float:
    """PRS contraction factor (Lemma 3)."""
    return max(abs((1.0 - rho * L) / (1.0 + rho * L)),
               abs((1.0 - rho * mu) / (1.0 + rho * mu)))


# ---------------------------------------------------------------------------
# Proposition 1 machinery
# ---------------------------------------------------------------------------

def s_matrix(chi_total: float, zeta: float, mu: float, rho: float) -> np.ndarray:
    """The matrix S of Proposition 1.

    ``chi_total`` is the contraction of the *whole* local-training map
    (chi^{N_e} for GD, chi(N_e) for AGD -- Proposition 3 uses the same
    template).
    """
    mu_d = mu + 1.0 / rho
    return np.array([
        [chi_total, (1.0 + chi_total) / mu_d],
        [2.0 * chi_total, zeta + 2.0 * chi_total / mu_d],
    ])


def s_norm(cfg_or_chi, mu: float, L: float, rho: float,
           solver: SolverConfig | None = None) -> float:
    """Spectral norm ||S|| -- upper bound on Fed-PLT's contraction rate."""
    if isinstance(cfg_or_chi, (int, float)):
        chi_total = float(cfg_or_chi)
    else:
        solver = cfg_or_chi
        chi_total = solver_contraction(solver, mu, L, rho)
    zeta = zeta_prs(rho, mu, L)
    S = s_matrix(chi_total, zeta, mu, rho)
    return float(np.linalg.norm(S, 2))


def sigma(p_min: float, p_max: float, s_nrm: float) -> float:
    """Stochastic rate of Proposition 2 (partial participation)."""
    del p_max
    return float(np.sqrt(max(0.0, 1.0 - p_min + p_min * s_nrm ** 2)))


def is_stable(cfg: SolverConfig, mu: float, L: float, rho: float) -> bool:
    """Spectral-radius stability of S (Prop. 1 requires a stable S)."""
    chi_total = solver_contraction(cfg, mu, L, rho)
    S = s_matrix(chi_total, zeta_prs(rho, mu, L), mu, rho)
    return bool(np.max(np.abs(np.linalg.eigvals(S))) < 1.0)


# ---------------------------------------------------------------------------
# Lemma 7: a stabilizing choice of parameters always exists -- find one
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StabilizeResult:
    rho: float
    gamma: float
    n_epochs: int
    s_norm: float
    spectral_radius: float


def stabilize(mu: float, L: float, solver_name: str = "gd",
              n_epochs_grid=(1, 2, 5, 8, 10, 20),
              rho_grid=None, gamma_grid=None) -> StabilizeResult:
    """Grid search over (rho, gamma, N_e) minimizing spectral radius of S.

    S is 2x2 regardless of problem size (paper Section V-A), so this is
    computationally trivial -- exactly the tuning loop the paper suggests.
    """
    if rho_grid is None:
        rho_grid = np.geomspace(0.01, 100.0, 25)
    best = None
    for rho, ne in itertools.product(rho_grid, n_epochs_grid):
        mu_d, L_d = mu + 1.0 / rho, L + 1.0 / rho
        gammas = (gamma_grid if gamma_grid is not None
                  else [2.0 / (mu_d + L_d), 1.0 / L_d, 0.5 / L_d])
        for gamma in gammas:
            cfg = SolverConfig(name=solver_name, n_epochs=ne, step_size=gamma)
            chi_total = solver_contraction(cfg, mu, L, rho)
            S = s_matrix(chi_total, zeta_prs(rho, mu, L), mu, rho)
            sr = float(np.max(np.abs(np.linalg.eigvals(S))))
            nrm = float(np.linalg.norm(S, 2))
            if best is None or sr < best.spectral_radius:
                best = StabilizeResult(rho=float(rho), gamma=float(gamma),
                                       n_epochs=int(ne), s_norm=nrm,
                                       spectral_radius=sr)
    return best


# ---------------------------------------------------------------------------
# Corollary 1: accuracy under DP noise
# ---------------------------------------------------------------------------

def corollary1_bound(K: int, mu: float, L: float, rho: float, gamma: float,
                     n_epochs: int, tau: float, dim: int, n_agents: int,
                     r0: float) -> float:
    """Expected distance bound of Corollary 1 after K rounds.

    r0 = || [x_0 - x_bar; z_0 - z_bar] ||.
    """
    mu_d, L_d = mu + 1.0 / rho, L + 1.0 / rho
    chi = chi_gd(gamma, mu_d, L_d)
    chi_total = chi ** n_epochs
    S = s_matrix(chi_total, zeta_prs(rho, mu, L), mu, rho)
    nrm = float(np.linalg.norm(S, 2))
    geo = (1.0 - chi_total) / (1.0 - chi) if chi < 1.0 else float(n_epochs)
    noise = tau * np.sqrt(10.0 * dim * n_agents * gamma) * geo
    if nrm >= 1.0:
        return float("inf")
    return float(nrm ** K * r0 + (1.0 - nrm ** K) / (1.0 - nrm) * noise)


def asymptotic_error(mu: float, L: float, rho: float, gamma: float,
                     n_epochs: int, tau: float, dim: int,
                     n_agents: int) -> float:
    """K -> inf limit of Corollary 1 (the asymptotic error neighbourhood)."""
    return corollary1_bound(10 ** 9, mu, L, rho, gamma, n_epochs, tau,
                            dim, n_agents, r0=0.0)
