"""Fed-PLT's federated runtime in PyTorch (counterpart of ``repro/fed``).

The front door is :mod:`repro_torch.fed.api`:

    from repro_torch.fed import FedSpec, build_trainer
    trainer = build_trainer(problem_or_model, FedSpec(...))

re-exported here; the round engine, compressor registry, runtime and
sharding rules live in the submodules.
"""

from repro_torch.fed.api import (CompressionSpec, FedSpec, FedTrainer,
                                 PrivacySpec, build_trainer, spec_from_args)

__all__ = ["CompressionSpec", "FedSpec", "FedTrainer", "PrivacySpec",
           "build_trainer", "spec_from_args"]
