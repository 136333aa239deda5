"""The paper's own experimental set-up (Section VII): logistic regression,
N=100 agents, n=5 features, q_i=250 samples, eps=0.5 (counterpart of
``repro/configs/fedplt_logreg.py``).  ``LARGE`` is Table 5's n=100."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    n_agents: int = 100
    dim: int = 5
    q: int = 250
    eps: float = 0.5
    nonconvex: bool = False
    rho: float = 1.0
    n_epochs: int = 5
    t_G: float = 1.0
    t_C: float = 10.0
    n_rounds: int = 3000
    seed: int = 0


CONFIG = LogRegConfig()
LARGE = LogRegConfig(dim=100, t_G=20.0, t_C=200.0)
