"""Quickstart, in PyTorch: Fed-PLT on the paper's logistic-regression
federation (the twin of ``examples/quickstart.py`` on ``repro_torch``).

Reproduces the core claims:
  1. exact convergence with local training (no client drift),
  2. partial participation,
  3. comparison against FedAvg's drift plateau.

Everything goes through the front door: a :class:`repro_torch.fed.api.FedSpec`
plus :func:`repro_torch.fed.api.build_trainer`.  Runs on the card unless
``--device cpu``.  The 50% run's participation rows are drawn from a CPU
``torch.Generator`` seeded 0 (where the reference draws from
``PRNGKey(0)``), so the card and the CPU see the same rows.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.baselines import make_fedavg
from repro_torch.core.metrics import hitting_round
from repro_torch.core.problem import make_logreg_problem
from repro_torch.fed.api import FedSpec, build_trainer

ROUNDS = (200, 400, 400)     # Fed-PLT, Fed-PLT at 50%, FedAvg


def participation_rows(n_rounds: int, n_agents: int, p: float = 0.5,
                       seed: int = 0) -> torch.Tensor:
    """``(n_rounds, n_agents)`` Bernoulli(p) rows from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n_rounds, n_agents), generator=gen) < p).float()


def run(problem, device, rounds=ROUNDS, u=None, x_star=None,
        log=print) -> dict:
    """The three runs on ``problem`` (moved to ``device``); ``u`` the 50%
    run's ``(rounds[1], N)`` participation rows (drawn when None),
    ``x_star`` the solution (``problem.solve()`` when None).  Returns the
    criterion histories, the hitting rounds and ``||x_bar - x*||``."""
    k_full, k_pp, k_avg = rounds
    trainer = build_trainer(problem, FedSpec(rho=1.0, n_epochs=5),
                            device=device)
    state, crit = trainer.run(0, k_full)
    crit = crit.cpu().numpy()
    log(f"\nFed-PLT     : criterion {crit[-1]:.2e} after {k_full} rounds "
        f"(threshold hit at round {hitting_round(crit)})")

    if u is None:
        u = participation_rows(k_pp, problem.n_agents)
    trainer_pp = build_trainer(
        problem, FedSpec(rho=1.0, n_epochs=5, participation=0.5),
        device=device)
    _, crit_pp = trainer_pp.run(0, k_pp, u=u)
    crit_pp = crit_pp.cpu().numpy()
    log(f"Fed-PLT 50% : criterion {crit_pp[-1]:.2e} after {k_pp} rounds "
        f"(hit at {hitting_round(crit_pp)})")

    fedavg = make_fedavg(trainer.problem, gamma=0.1, n_epochs=5)
    crit_avg = fedavg.run(0, k_avg).cpu().numpy()
    log(f"FedAvg      : plateaus at {crit_avg[-1]:.2e} (client drift; "
        f"never reaches 1e-5)")

    x_bar = trainer.consensus(state)
    if x_star is None:
        x_star = trainer.problem.solve()
    x_star = torch.as_tensor(x_star, dtype=torch.float32).to(x_bar.device)
    dist = float(torch.linalg.norm(x_bar - x_star))
    log(f"\n||x_bar - x*|| = {dist:.2e} (exact convergence, Prop. 2)")
    return dict(crit=crit, crit_pp=crit_pp, crit_avg=crit_avg,
                hit=hitting_round(crit), hit_pp=hitting_round(crit_pp),
                x_bar_err=dist)


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-agents", type=int, default=100)
    ap.add_argument("--rounds", type=int, nargs=3, default=list(ROUNDS),
                    metavar=("FEDPLT", "PARTIAL", "FEDAVG"))
    ap.add_argument("--solve-iters", type=int, default=20_000,
                    help="full-GD steps of the oracle x*")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    problem = make_logreg_problem(n_agents=args.n_agents, q=250, dim=5,
                                  seed=0, device=device)
    log(f"problem: N={problem.n_agents} agents, n={problem.dim}, "
        f"mu={problem.strong_convexity():.2f}, "
        f"L={problem.smoothness():.2f}")
    return run(problem, device, tuple(args.rounds),
               x_star=problem.solve(args.solve_iters), log=log)


if __name__ == "__main__":
    main()
