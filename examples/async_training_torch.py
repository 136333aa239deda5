"""Asynchronous Fed-PLT with a straggler fleet, in PyTorch (the twin of
``examples/async_training.py`` on ``repro_torch``).

Fed-PLT's convergence machinery never needs every agent at every round
(partial participation is already a Bernoulli mask); the async subsystem
generalizes that mask to a bounded-staleness ARRIVAL mask.  Slow agents
keep refining their local solve against the coordinator point they last
pulled and deliver the increment up to ``max_staleness`` rounds late --
the coordinator averages whatever has arrived and moves on.

This example drives the full stack:
  1. a host-side :class:`~repro_torch.fed.broker.IncrementBroker` with a
     straggler group (5x the latency of the fast fleet),
  2. the realized arrival schedule and its bounded staleness,
  3. bit-for-bit replay of the recorded schedule (the broker decides
     only timing; every number comes from the round on the device),
  4. the stale-aware per-agent privacy table: each agent is composed
     over the rounds of local work it actually RELEASED, not the
     nominal round count.

Runs on the card unless ``--device cpu``; the noise of the local steps
comes from the trainer's generator (seeded 0) unless given.

Run:  PYTHONPATH=src python examples/async_training_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.problem import make_logreg_problem
from repro_torch.fed.api import FedSpec, PrivacySpec, build_trainer
from repro_torch.fed.broker import ArrivalSchedule, IncrementBroker, replay

N_AGENTS = 8
STRAGGLERS = (0, 1)          # agents with 5x the fleet's latency
ROUNDS = 40
MAX_STALENESS = 3
SPEC = FedSpec(rho=5.0, gamma=0.05, n_epochs=5, damping=0.5,
               participation=0.8, async_mode="stale",
               max_staleness=MAX_STALENESS,
               privacy=PrivacySpec(tau=0.3, clip=1.0, delta=1e-5))


def straggler_latency(agent: int, round_idx: int) -> float:
    """Simulated local-solve wall time (seconds)."""
    base = 0.002
    return base * (5.0 if agent in STRAGGLERS else 1.0)


def round_fn(trainer, noise=None):
    """The broker's round: one async round on the given arrival row;
    ``noise`` ``(n_rounds, N_e, N, n)`` replays given standard normals
    (round ``state.k``'s), else the trainer's generator draws."""
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32).to(
            trainer.device)

    def step(state, u):
        rows = None if noise is None else noise[state.k]
        return trainer.algo.round_with_arrival(
            state, torch.as_tensor(u), noise=rows)[0]

    return step


def replay_run(trainer, schedule, noise=None):
    """Replay a recorded schedule (an :class:`ArrivalSchedule`, or its
    ``(n_rounds, N)`` arrival rows) from a fresh init."""
    if not isinstance(schedule, ArrivalSchedule):
        schedule = ArrivalSchedule(np.asarray(schedule), MAX_STALENESS)
    return replay(round_fn(trainer, noise), trainer.init(0), schedule)


def same_bits(a, b) -> bool:
    """Every tensor of two states equal bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b)
               if isinstance(x, torch.Tensor))


def run(problem, device, n_rounds=ROUNDS, log=print) -> dict:
    trainer = build_trainer(problem, SPEC, device=device)

    log(f"fleet: {N_AGENTS} agents, stragglers {STRAGGLERS} at 5x "
        f"latency, max_staleness={MAX_STALENESS}")

    # --- 1. broker run: threads supply the timing, the device the numerics
    broker = IncrementBroker(N_AGENTS, MAX_STALENESS,
                             latency_fn=straggler_latency, grace=0.003)
    state, sched = broker.run(round_fn(trainer), trainer.init(0), n_rounds)

    # --- 2. the realized schedule ---------------------------------------
    arrivals, released = sched.effective_counts()
    log(f"\nrealized schedule over {sched.n_rounds} rounds "
        f"(bounded staleness verified):")
    for a in range(N_AGENTS):
        tag = " <- straggler" if a in STRAGGLERS else ""
        log(f"  agent {a}: arrivals={int(arrivals[a]):3d} "
            f"released_rounds={int(released[a]):3d}/{n_rounds}{tag}")

    # --- 3. deterministic replay ----------------------------------------
    state2 = replay_run(trainer, sched)
    bitwise = same_bits(state, state2)
    log(f"\nreplay of the recorded schedule is bit-identical: {bitwise}")
    assert bitwise

    # --- 4. stale-aware privacy -----------------------------------------
    nominal = trainer.privacy_report(n_rounds)
    rep = trainer.effective_privacy_report(sched.arrivals)
    log(f"\nnominal privacy (every agent charged all {n_rounds} "
        f"rounds): ({nominal.adp_eps:.3f}, {nominal.adp_delta:.0e})-ADP")
    log(f"effective privacy (realized arrival schedule): "
        f"({rep.adp_eps:.3f}, {rep.adp_delta:.0e})-ADP")
    for a in rep.per_agent:
        tag = " <- straggler" if a.agent in STRAGGLERS else ""
        log(f"  agent {a.agent}: arrivals={a.arrivals:3d} "
            f"released_rounds={a.K:3d}/{n_rounds} "
            f"eps_i={a.adp_eps:.3f} (ceiling {a.eps_ceiling:.3f}){tag}")
    log("\nnote: a stale arrival still carries every round of local "
        "work it accumulated, so only work discarded at the bound or "
        "still in flight at the end shrinks an agent's composition.")

    # --- 5. ...which is visible the moment a run stops mid-flight -------
    # compose over the first `cut` rounds only: whatever the stragglers
    # were still refining at that point was never transmitted, so it
    # charges nothing -- their effective eps drops below the fleet's
    cut = n_rounds - 2
    rep_cut = trainer.effective_privacy_report(sched.arrivals[:cut])
    log(f"\nsame run audited at round {cut} (straggler work still "
        f"in flight charges nothing):")
    for a in rep_cut.per_agent:
        tag = " <- straggler" if a.agent in STRAGGLERS else ""
        log(f"  agent {a.agent}: released_rounds={a.K:3d}/{cut} "
            f"eps_i={a.adp_eps:.3f}{tag}")

    x_bar = trainer.consensus(state)
    norm = float(torch.linalg.norm(x_bar))
    log(f"\nconsensus reached: ||x_bar|| = {norm:.4f}")
    return dict(trainer=trainer, state=state, schedule=sched,
                replay_state=state2, bitwise=bitwise, nominal=nominal,
                effective=rep, cut=rep_cut, x_bar_norm=norm)


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    problem = make_logreg_problem(n_agents=N_AGENTS, q=200, dim=5, seed=0,
                                  device=device)
    return run(problem, device, args.rounds, log=log)


if __name__ == "__main__":
    main()
