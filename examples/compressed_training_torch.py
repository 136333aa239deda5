"""Compressed federated training, in PyTorch (the twin of
``examples/compressed_training.py`` on ``repro_torch``).

Fed-PLT already saves communication via local training (N_e) and partial
participation; this example stacks a third axis: compressing the z
uplink (int8 / top-k / per-agent adaptive top-k with lag-based error
feedback) while keeping EXACT convergence.  Compressors are named
entries of the :mod:`repro_torch.fed.compress` registry, so the sweep is
driven entirely through :class:`repro_torch.fed.api.CompressionSpec`.
The reference's ``adaptive/pallas`` row is ``adaptive/fused`` here: the
same compressor through the fused packed-kernel backend
(``backend="fused"``), the whole uplink's selection in one
``rank_select`` launch a round on the card; the other rows take the
per-leaf registry path (``backend="torch"``, the reference's ``xla``).
Runs on the card unless ``--device cpu``; full participation and plain
gd draw nothing.

Run:  PYTHONPATH=src python examples/compressed_training_torch.py [--device cpu]
"""

import argparse

from repro_torch import resolve_device
from repro_torch.core.metrics import hitting_round
from repro_torch.core.problem import make_logreg_problem
from repro_torch.fed.api import CompressionSpec, FedSpec, build_trainer

ROUNDS = 600
# the first five rows on the per-leaf registry path (backend "torch"), the
# last through the kernels; both give the same bits
ROWS = (
    ("exact", CompressionSpec(), 32.0),
    ("int8", CompressionSpec(name="int8", backend="torch"), 8.0),
    ("topk 25%", CompressionSpec(name="topk", ratio=0.25, backend="torch"),
     8.0),
    ("topk 10%", CompressionSpec(name="topk", ratio=0.1, backend="torch"),
     3.2),
    ("adaptive", CompressionSpec(name="adaptive_topk", ratio=0.1,
                                 energy=0.9, backend="torch"), 3.2),
    # same compressor through the fused packed-kernel backend: the whole
    # pytree's uplink selection in one kernel launch
    ("adaptive/fused", CompressionSpec(name="adaptive_topk", ratio=0.1,
                                       energy=0.9, backend="fused"), 3.2),
)


def run_row(problem, device, comp, n_rounds=ROUNDS):
    """One row's criterion history (a numpy array)."""
    spec = FedSpec(rho=1.0, n_epochs=5, compression=comp)
    _, crit = build_trainer(problem, spec, device=device).run(0, n_rounds)
    return crit.cpu().numpy()


def run(problem, device, n_rounds=ROUNDS, rows=ROWS, log=print) -> dict:
    """Every row on ``problem``; returns ``{name: {"rounds", "crit",
    "rel"}}`` (``rounds`` the hitting round, ``rel`` the uplink bits to
    the threshold against the exact exchange's)."""
    log(f"{'compressor':15s} {'rounds':>7s} {'final crit':>11s} "
        f"{'uplink vs exact':>16s}")
    k_exact, out = None, {}
    for name, comp, bits in rows:
        crit = run_row(problem, device, comp, n_rounds)
        k = hitting_round(crit)
        if k_exact is None:
            k_exact = k
        rel = (k * bits) / (k_exact * 32.0) if k else float("nan")
        log(f"{name:15s} {k!s:>7s} {crit[-1]:11.2e} {rel:15.2f}x")
        out[name] = dict(rounds=k, crit=crit, rel=rel)
    log("\nall compressors converge EXACTLY (error feedback via the "
        "lagged coordinator copy); top-k 10% cuts uplink ~5x net, and "
        "adaptive top-k lets each agent pick its own k (the bits "
        "column shows its floor -- concentrated increments transmit "
        "less).")
    return out


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-agents", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    problem = make_logreg_problem(n_agents=args.n_agents, q=250, dim=20,
                                  seed=0, device=device)
    return run(problem, device, args.rounds, log=log)


if __name__ == "__main__":
    main()
