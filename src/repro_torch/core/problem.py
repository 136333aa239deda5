"""Federated empirical-risk-minimization problems (counterpart of
``repro/core/problem.py``, paper Section VII).

A problem bundles per-agent datasets and exposes batched local losses
and gradients.  Data layout: leading axis = agent, i.e. features ``A``
of shape ``(N, q, n)`` and labels ``b`` of shape ``(N, q)``; stacked
models are ``(N, n)``.  Every gradient is computed for all agents at
once, in closed form (the reference differentiates per agent with
``jax.grad`` under ``vmap``; the formulas are the same, rounded at other
places).

The paper's experiment: logistic regression with N=100 agents, n=5
features, q_i=250 samples, regularization ``eps * r(x)`` with
``r(x) = ||x||^2/2`` (convex) or ``r(x) = sum_j x_j^2/(1+x_j^2)``
(nonconvex), eps = 0.5.

The curvature moduli are computed as the reference computes them: with
numpy on the host, from the data in its own dtype, returned as Python
floats.  They set the solver's step size 2/(L_d + mu_d), and through it
every trajectory.

The problem generators draw from a CPU ``torch.Generator`` (the reference
draws with JAX's threefry; the bits differ) and then move the data to
``device``, so one seed gives the same problem on the card and on the
CPU; like every entry point of the port they place it on CUDA unless
the caller asks for the CPU.
:func:`repro_torch.convert.problem_from_arrays` builds a problem from the
reference's own arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------

def reg_l2sq(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(x * x, dim=-1)


def reg_nonconvex(x: torch.Tensor) -> torch.Tensor:
    """The paper's nonconvex regularizer: sum_j x_j^2 / (1 + x_j^2)."""
    return torch.sum(x * x / (1.0 + x * x), dim=-1)


def _reg_grad(x: torch.Tensor, nonconvex: bool) -> torch.Tensor:
    if nonconvex:
        s = 1.0 + x * x
        return 2.0 * x / (s * s)
    return x


# ---------------------------------------------------------------------------
# Logistic regression
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LogRegProblem:
    """l2/nonconvex-regularized logistic regression, one dataset per agent.

    ``f_i(x) = (1/q_i) sum_h log(1 + exp(-b_ih <a_ih, x>)) + eps * r(x)``
    """

    A: torch.Tensor          # (N, q, n)
    b: torch.Tensor          # (N, q) in {-1, +1}
    eps: float = 0.5
    nonconvex: bool = False

    # -- basic shapes ------------------------------------------------------
    @property
    def n_agents(self) -> int:
        return self.A.shape[0]

    @property
    def q(self) -> int:
        return self.A.shape[1]

    @property
    def dim(self) -> int:
        return self.A.shape[2]

    @property
    def device(self) -> torch.device:
        return self.A.device

    def to(self, device) -> "LogRegProblem":
        return dataclasses.replace(self, A=self.A.to(device),
                                   b=self.b.to(device))

    def agent_data(self) -> tuple:
        return (self.A, self.b)

    def agent_block(self, rows: slice) -> "LogRegProblem":
        """The agents ``rows`` alone (one rank's block of a sharded
        run): views of their data."""
        return dataclasses.replace(self, A=self.A[rows], b=self.b[rows])

    # -- losses ------------------------------------------------------------
    def _reg(self, x: torch.Tensor) -> torch.Tensor:
        return reg_nonconvex(x) if self.nonconvex else reg_l2sq(x)

    def local_loss(self, i_data, x: torch.Tensor) -> torch.Tensor:
        """Loss of one agent given its ``(A_i, b_i)``; ``x`` is ``(n,)``."""
        A_i, b_i = i_data
        logits = A_i @ x * b_i
        return (torch.mean(torch.log1p(torch.exp(-logits)))
                + self.eps * self._reg(x))

    def losses(self, x_stack: torch.Tensor) -> torch.Tensor:
        """Per-agent losses ``(N,)`` for stacked models ``(N, n)``."""
        logits = torch.einsum("nqd,nd->nq", self.A, x_stack) * self.b
        return (torch.mean(torch.log1p(torch.exp(-logits)), dim=1)
                + self.eps * self._reg(x_stack))

    def _grads_on(self, A, b, x_stack):
        """Gradients of the per-agent losses on rows ``(A, b)`` (``(N, k,
        n)``, ``(N, k)``), as reverse-mode differentiation of
        ``mean(log1p(exp(-b <a, x>)))`` gives them."""
        logits = torch.einsum("nqd,nd->nq", A, x_stack) * b
        u = torch.exp(-logits)
        g_logit = -((1.0 / A.shape[1]) / (u + 1.0) * u)
        g = torch.einsum("nq,nqd->nd", g_logit * b, A)
        return g + self.eps * _reg_grad(x_stack, self.nonconvex)

    def grads(self, x_stack: torch.Tensor) -> torch.Tensor:
        """Per-agent gradients, stacked ``(N, n)``; ``x_stack`` may be
        ``(N, n)`` or ``(n,)``."""
        if x_stack.ndim == 1:
            x_stack = x_stack.expand(self.n_agents, -1)
        return self._grads_on(self.A, self.b, x_stack)

    def minibatch_grads(self, x_stack: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
        """Stochastic gradients, stacked ``(N, n)``: agent ``i``'s on its
        rows ``idx[i]`` (``idx`` an ``(N, batch)`` integer tensor; the
        reference's ``minibatch_grad`` per agent)."""
        idx = idx.to(self.device, torch.int64)
        A = torch.gather(self.A, 1,
                         idx[:, :, None].expand(-1, -1, self.dim))
        b = torch.gather(self.b, 1, idx)
        return self._grads_on(A, b, x_stack)

    # -- the paper's convergence criterion ----------------------------------
    def criterion(self, x_stack: torch.Tensor) -> torch.Tensor:
        """``|| sum_i grad f_i(x_bar) ||^2`` with ``x_bar = mean_i x_i``,
        a 0-d tensor on the problem's device (no host sync)."""
        x_bar = torch.mean(x_stack, dim=0) if x_stack.ndim > 1 else x_stack
        g = self.grads(x_bar)
        return torch.sum(torch.sum(g, dim=0) ** 2)

    # -- curvature estimates -------------------------------------------------
    def _logistic_moduli(self) -> np.ndarray:
        """``||A_i||_2^2 / (4 q)`` per agent (the logistic Hessian is at
        most ``A_i^T A_i / (4 q)``), in the data's dtype as numpy gives it."""
        A = self.A.cpu().numpy()
        return np.array([np.linalg.norm(A[i], ord=2) ** 2 / (4.0 * self.q)
                         for i in range(self.n_agents)])

    def _reg_smoothness(self) -> float:
        return 2.0 * self.eps if self.nonconvex else self.eps

    def smoothness(self) -> float:
        """Upper bound on the smoothness modulus of every f_i."""
        return float(np.max(self._logistic_moduli()) + self._reg_smoothness())

    def strong_convexity(self) -> float:
        """Strong-convexity modulus (convex case: eps from the l2 reg)."""
        if self.nonconvex:
            return 0.0
        return float(self.eps)

    # -- Remark 1: per-agent moduli for uncoordinated local solvers -------
    def per_agent_smoothness(self) -> torch.Tensor:
        return torch.from_numpy(
            self._logistic_moduli() + self._reg_smoothness()).to(self.device)

    def per_agent_strong_convexity(self) -> torch.Tensor:
        mu = 0.0 if self.nonconvex else self.eps
        return torch.full((self.n_agents,), mu, device=self.device)

    # -- oracle solution -----------------------------------------------------
    def solve(self, iters: int = 20_000) -> torch.Tensor:
        """High-accuracy solution of ``min_x sum_i f_i(x)`` by full GD
        (the oracle x-bar of the tests): a device loop with no host sync."""
        step = 1.0 / (self.smoothness() * self.n_agents)
        x = torch.zeros(self.dim, device=self.device)
        for _ in range(iters):
            x = x - step * torch.sum(self.grads(x), dim=0)
        return x


def make_logreg_problem(generator=None, n_agents: int = 100, q: int = 250,
                        dim: int = 5, eps: float = 0.5,
                        nonconvex: bool = False,
                        heterogeneity: float = 1.0, seed: int = 0,
                        device=None) -> LogRegProblem:
    """Random logistic-regression federation (paper Section VII set-up),
    drawn from ``generator`` (a CPU ``torch.Generator``; seeded with
    ``seed`` when None) and placed on ``device`` (CUDA unless ``device``
    names the CPU: :func:`repro_torch.resolve_device`).

    ``heterogeneity`` shifts each agent's feature distribution by an
    agent-specific offset, producing non-IID local data.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    ground_truth = torch.randn(dim, generator=generator)
    offsets = heterogeneity * torch.randn((n_agents, 1, dim),
                                          generator=generator)
    A = torch.randn((n_agents, q, dim), generator=generator) + offsets
    logits = torch.einsum("nqd,d->nq", A, ground_truth)
    noise = 0.5 * torch.randn((n_agents, q), generator=generator)
    b = torch.where(logits + noise > 0, 1.0, -1.0)
    device = resolve_device(device)
    return LogRegProblem(A=A.to(device), b=b.to(device), eps=eps,
                         nonconvex=nonconvex)


def dirichlet_partition(features: np.ndarray, labels: np.ndarray,
                        n_agents: int, alpha: float = 0.5,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Non-IID label-skew partitioner (Dirichlet over label proportions).

    Returns per-agent stacked arrays trimmed to equal size
    ``(N, q_min, n)`` / ``(N, q_min)`` so they vectorize.  numpy only: the
    same rows as the reference's for the same seed.
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    agent_rows: list[list[int]] = [[] for _ in range(n_agents)]
    for c in classes:
        rows = np.flatnonzero(labels == c)
        rng.shuffle(rows)
        props = rng.dirichlet(alpha * np.ones(n_agents))
        counts = np.floor(props * len(rows)).astype(int)
        counts[-1] = len(rows) - counts[:-1].sum()
        start = 0
        for i, cnt in enumerate(counts):
            agent_rows[i].extend(rows[start:start + cnt])
            start += cnt
    q_min = max(1, min(len(r) for r in agent_rows))
    feats = np.stack([features[r[:q_min]] for r in agent_rows])
    labs = np.stack([labels[r[:q_min]] for r in agent_rows])
    return feats, labs


# ---------------------------------------------------------------------------
# Quadratic problems (closed-form optimum; used by tests/property checks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuadraticProblem:
    """``f_i(x) = x^T Q_i x / 2 + c_i^T x`` with SPD ``Q_i``; the federated
    optimum is available in closed form."""

    Q: torch.Tensor    # (N, n, n), SPD
    c: torch.Tensor    # (N, n)

    @property
    def n_agents(self) -> int:
        return self.Q.shape[0]

    @property
    def dim(self) -> int:
        return self.Q.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.Q.device

    def to(self, device) -> "QuadraticProblem":
        return dataclasses.replace(self, Q=self.Q.to(device),
                                   c=self.c.to(device))

    def agent_data(self) -> tuple:
        return (self.Q, self.c)

    def agent_block(self, rows: slice) -> "QuadraticProblem":
        """The agents ``rows`` alone (views of their data)."""
        return dataclasses.replace(self, Q=self.Q[rows], c=self.c[rows])

    def local_loss(self, i_data, x):
        Q_i, c_i = i_data
        return 0.5 * x @ Q_i @ x + c_i @ x

    def losses(self, x_stack):
        return (0.5 * torch.einsum("ni,nij,nj->n", x_stack, self.Q, x_stack)
                + torch.sum(self.c * x_stack, dim=-1))

    def grads(self, x_stack):
        if x_stack.ndim == 1:
            x_stack = x_stack.expand(self.n_agents, -1)
        return torch.einsum("nij,nj->ni", self.Q, x_stack) + self.c

    def minibatch_grads(self, x_stack, idx):
        """The full gradient: a quadratic has no rows to sample."""
        del idx
        return self.grads(x_stack)

    def criterion(self, x_stack):
        x_bar = torch.mean(x_stack, dim=0) if x_stack.ndim > 1 else x_stack
        g = torch.sum(self.grads(x_bar), dim=0)
        return torch.sum(g ** 2)

    def solve(self):
        return torch.linalg.solve(torch.sum(self.Q, dim=0),
                                  -torch.sum(self.c, dim=0))

    def smoothness(self) -> float:
        return float(np.max(np.linalg.eigvalsh(self.Q.cpu().numpy())[:, -1]))

    def strong_convexity(self) -> float:
        return float(np.min(np.linalg.eigvalsh(self.Q.cpu().numpy())[:, 0]))


def make_quadratic_problem(generator=None, n_agents: int = 10, dim: int = 8,
                           cond: float = 10.0, seed: int = 0,
                           device=None) -> QuadraticProblem:
    """Random strongly convex quadratic federation with eigenvalues in
    ``[1, cond]``, drawn like :func:`make_logreg_problem` and placed on
    ``device`` (CUDA unless ``device`` names the CPU)."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    eigs = torch.linspace(1.0, cond, dim)
    H = torch.randn((n_agents, dim, dim), generator=generator)
    Qmat, _ = torch.linalg.qr(H)
    Q = (Qmat * eigs) @ Qmat.transpose(-1, -2)
    c = torch.randn((n_agents, dim), generator=generator)
    device = resolve_device(device)
    return QuadraticProblem(Q=Q.to(device), c=c.to(device))
