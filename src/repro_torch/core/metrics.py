"""Convergence metrics and the paper's (t_G, t_C) time model (Sec. VII); a
copy of ``repro/core/metrics.py`` (numpy only).

The paper measures "computational time to reach
|| sum_i grad f_i(x_bar) ||^2 <= 1e-5" with per-round costs from Table II,
e.g. Fed-PLT costs ``(N_e t_G + t_C) N`` per round.
"""

from __future__ import annotations

import dataclasses

import numpy as np

THRESHOLD = 1e-5


def hitting_round(crit_history: np.ndarray,
                  threshold: float = THRESHOLD) -> int | None:
    """First round index (1-based) whose criterion is below threshold."""
    hit = np.flatnonzero(np.asarray(crit_history) <= threshold)
    return int(hit[0]) + 1 if hit.size else None


def time_to_converge(crit_history, time_per_round, t_G=1.0, t_C=10.0,
                     threshold: float = THRESHOLD,
                     steps_per_round: int = 1) -> float | None:
    """Paper metric: rounds-to-threshold x per-round cost.

    ``steps_per_round`` converts per-*step* histories (ProxSkip/TAMUNA
    record every gradient step) into nominal rounds.
    """
    k = hitting_round(crit_history, threshold)
    if k is None:
        return None
    return (k / steps_per_round) * time_per_round(t_G, t_C) * steps_per_round


@dataclasses.dataclass
class RunResult:
    name: str
    rounds: int | None
    comp_time: float | None
    final_crit: float

    def row(self):
        return (self.name,
                "-" if self.rounds is None else self.rounds,
                "-" if self.comp_time is None else f"{self.comp_time:.4g}",
                f"{self.final_crit:.3e}")


def evaluate(name, crit_history, time_per_round, t_G=1.0, t_C=10.0,
             threshold=THRESHOLD) -> RunResult:
    crit = np.asarray(crit_history)
    k = hitting_round(crit, threshold)
    t = None if k is None else k * time_per_round(t_G, t_C)
    return RunResult(name=name, rounds=k, comp_time=t,
                     final_crit=float(crit[-1]))
