"""Architecture config registry: ``get_config("<arch-id>")``.

Holds the architectures the port runs so far (gemma2-2b, falcon-mamba-7b,
recurrentgemma-2b); the others of the reference's registry join with the
model kinds they need.
"""

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig  # noqa: F401
from repro_torch.configs import (falcon_mamba_7b, gemma2_2b,  # noqa: E402
                                 recurrentgemma_2b)

REGISTRY = {
    "gemma2-2b": gemma2_2b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")


def get_shape(shape_id: str) -> InputShape:
    return SHAPES[shape_id]
