"""Optimizers for standard (non-federated) training mode."""

from repro_torch.optim.optimizers import (  # noqa: F401
    OPTIMIZERS, Optimizer, adamw, apply_updates, momentum, sgd)
