"""Modality frontend stubs (counterpart of ``repro/models/frontends.py``).

The audio conv / mel feature extractor (whisper) and the ViT + projector
(internvl2) are stubs in the reference too: these helpers draw
embeddings of the shape the backbone takes, so that the transformer runs
end to end.  The draws come from a ``torch.Generator`` (the bits differ
from JAX's threefry; the parity tests hand both packages one numpy
array instead).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def fake_audio_frames(generator: torch.Generator, cfg: ModelConfig,
                      batch: int, device=None) -> torch.Tensor:
    """Stub of the log-mel + conv frontend's output: ``(B, n_enc_tokens,
    d)`` in the config's dtype."""
    return (0.02 * torch.randn((batch, cfg.n_enc_tokens, cfg.d_model),
                               generator=generator, device=device)
            ).to(getattr(torch, cfg.dtype))


def fake_patch_embeds(generator: torch.Generator, cfg: ModelConfig,
                      batch: int, device=None) -> torch.Tensor:
    """Stub of the ViT + MLP projector's output: ``(B, n_frontend_tokens,
    d)`` in the config's dtype."""
    return (0.02 * torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                               generator=generator, device=device)
            ).to(getattr(torch, cfg.dtype))
