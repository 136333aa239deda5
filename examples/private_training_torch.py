"""Differentially-private federated training with Fed-PLT, in PyTorch (the
twin of ``examples/private_training.py`` on ``repro_torch``).

Walks the paper's privacy pipeline end to end:
  1. pick a target (eps, delta)-ADP budget,
  2. calibrate the noise variance tau (Prop. 4 inverted),
  3. train with noisy local GD,
  4. report the achieved accuracy and the privacy ceiling.

Runs on the card unless ``--device cpu``.  The initial models (``dp_init``)
and the local steps' noise are standard normals drawn from a CPU
``torch.Generator`` seeded 0 (where the reference draws from
``PRNGKey(0)``) and scaled by the trainer, so the card and the CPU train
on the same draws.

Run:  PYTHONPATH=src python examples/private_training_torch.py [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import privacy, theory
from repro_torch.core.problem import make_logreg_problem
from repro_torch.fed.api import FedSpec, PrivacySpec, build_trainer

K, DELTA, TARGET_EPS = 300, 1e-5, 2.0


def draws(n_rounds: int, n_epochs: int, n_agents: int, dim: int,
          seed: int = 0):
    """``(z0, noise)``: the ``(N, n)`` standard normals of the initial
    models and the ``(n_rounds, N_e, N, n)`` ones of the local steps."""
    gen = torch.Generator().manual_seed(seed)
    z0 = torch.randn((n_agents, dim), generator=gen)
    return z0, torch.randn((n_rounds, n_epochs, n_agents, dim),
                           generator=gen)


def run(problem, device, n_rounds=K, x0=None, noise=None,
        log=print) -> dict:
    """The pipeline on ``problem`` (moved to ``device``).  ``x0`` (the
    initial models) and ``noise`` (``(n_rounds, N_e, N, n)`` standard
    normals) replay given draws; drawn by :func:`draws` when None."""
    mu, L = problem.strong_convexity(), problem.smoothness()
    # pick (rho, gamma, N_e) that make S contractive (Lemma 7 grid)
    stab = theory.stabilize(mu, L, n_epochs_grid=(5,))
    rho, gamma, n_epochs = stab.rho, stab.gamma, stab.n_epochs
    log(f"Lemma-7 stabilizer: rho={rho:.3f} gamma={gamma:.3f} "
        f"N_e={n_epochs} ||S||={stab.s_norm:.3f}")

    tau = privacy.calibrate_noise(TARGET_EPS, DELTA, sensitivity=1.0,
                                  mu=mu, q=problem.q, gamma=gamma,
                                  K=n_rounds, n_epochs=n_epochs)
    log(f"target ({TARGET_EPS}, {DELTA})-ADP  =>  tau = {tau:.4f}")

    # the front door: tau > 0 upgrades the gd solver to DP noisy GD, and
    # the trainer reports its own (eps, delta) position
    trainer = build_trainer(problem, FedSpec(
        rho=rho, gamma=gamma, n_epochs=n_epochs,
        privacy=PrivacySpec(tau=tau, dp_init=True, delta=DELTA)),
        device=device)
    rep = trainer.privacy_report(n_rounds)
    log(f"achieved eps = {rep.adp_eps:.3f} at Renyi order "
        f"{rep.rdp_order:.1f}; ceiling as K*Ne->inf: "
        f"{rep.eps_ceiling:.3f}")

    # Prop. 4 is per-agent: with unequal local datasets the accountant
    # returns one (eps_i, delta) row per agent and the headline eps is
    # the max -- the small-data agents are the binding constraint
    qs = [50] * 5 + [problem.q] * (problem.n_agents - 5)
    rep_i = trainer.privacy_report(n_rounds, local_dataset_size=qs)
    log(f"heterogeneous q_i: worst-agent eps = {rep_i.adp_eps:.3f} "
        f"(q_i=50) vs {rep_i.per_agent[-1].adp_eps:.3f} "
        f"(q_i={problem.q})")

    if x0 is None or noise is None:
        z0, drawn = draws(n_rounds, n_epochs, problem.n_agents, problem.dim)
        # the dp_init draw N(0, 2 tau^2 / mu I) of the reference's init
        x0 = math.sqrt(2.0 * tau ** 2 / trainer.algo.mu) * z0 \
            if x0 is None else x0
        noise = drawn if noise is None else noise
    noise = torch.as_tensor(noise, dtype=torch.float32).to(trainer.device)
    state, crit = trainer.run(0, n_rounds, x0=x0, noise=noise)
    crit = crit.cpu().numpy()

    bound = theory.corollary1_bound(
        n_rounds, mu, L, rho, gamma, n_epochs, tau, problem.dim,
        problem.n_agents, r0=float(np.linalg.norm(state.x.cpu().numpy())))
    log(f"\nafter K={n_rounds} rounds: criterion = {crit[-1]:.3e}")
    log(f"asymptotic error bound (Cor. 1): {bound:.3e}")
    log(f"privacy does NOT degrade with more local epochs: the ceiling "
        f"above holds for ANY N_e (Prop. 4).")
    return dict(stabilizer=stab, tau=tau, report=rep, report_per_agent=rep_i,
                crit=crit, bound=bound, state=state)


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-agents", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=K)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    problem = make_logreg_problem(n_agents=args.n_agents, q=250, dim=5,
                                  seed=0, device=device)
    return run(problem, device, args.rounds, log=log)


if __name__ == "__main__":
    main()
