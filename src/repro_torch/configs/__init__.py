"""Architecture config registry: ``get_config("<arch-id>")``.

The reference's ten architectures: the dense gemma2-2b, phi4-mini-3.8b,
gemma3-12b and nemotron-4-340b (untied LM head), the SSM falcon-mamba-7b,
the hybrid recurrentgemma-2b, the MoE qwen2-moe-a2.7b and grok-1-314b,
the encoder-decoder whisper-small and the vision-prefixed internvl2-26b.
"""

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig  # noqa: F401
from repro_torch.configs import (falcon_mamba_7b, fedplt_logreg,  # noqa: E402,F401
                                 gemma2_2b, gemma3_12b, grok_1_314b,
                                 internvl2_26b, nemotron_4_340b,
                                 phi4_mini_3_8b, qwen2_moe_a2_7b,
                                 recurrentgemma_2b, whisper_small)

REGISTRY = {
    "phi4-mini-3.8b": phi4_mini_3_8b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "gemma3-12b": gemma3_12b.CONFIG,
    "nemotron-4-340b": nemotron_4_340b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
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
