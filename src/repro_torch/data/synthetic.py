"""Synthetic batches (counterpart of ``repro/data/synthetic.py``).

The same Zipf-flavoured token stream as the reference, drawn from a
``torch.Generator`` (the bits differ from JAX's threefry; the parity
tests hand both packages one numpy batch instead).  In federated mode
agent ``i`` draws with ``skew = i`` -- non-IID local data.  An
encoder-decoder config's batch also holds the encoder's frame
embeddings ``enc_embeds`` and a vision config's the patch embeddings
``patch_embeds`` (:mod:`repro_torch.models.frontends`), its text cut to
``seq_len - n_frontend_tokens``; a batch of a non-train shape has no
``labels``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import frontends


def synthetic_lm_batch(generator: torch.Generator, vocab: int, batch: int,
                       seq_len: int, skew: float = 0.0,
                       device=None) -> dict:
    """Frequent head tokens (shifted by ``skew``) mixed with a uniform
    tail; labels are the tokens shifted left by one."""
    shape = (batch, seq_len)
    head = torch.randint(0, max(2, int(vocab * 0.1)), shape,
                         generator=generator, device=device)
    tail = torch.randint(0, vocab, shape, generator=generator,
                         device=device)
    coin = torch.rand(shape, generator=generator,
                      device=device) < 0.7 + 0.2 * math.tanh(skew)
    tokens = torch.where(coin, (head + int(skew * 100)) % vocab, tail)
    labels = torch.roll(tokens, -1, dims=-1)
    return {"tokens": tokens, "labels": labels}


def make_batch_for(cfg: ModelConfig, shape: InputShape,
                   generator: torch.Generator, n_agents=None,
                   device=None) -> dict:
    """A batch of ``shape`` (its keys as the reference's ``input_specs``);
    with ``n_agents`` set, a leading agent axis with ``global_batch //
    n_agents`` rows per agent."""
    B, S = shape.global_batch, shape.seq_len

    def one(b, skew):
        s_text = S - (cfg.n_frontend_tokens if cfg.frontend == "vision"
                      else 0)
        out = synthetic_lm_batch(generator, cfg.vocab, b, s_text, skew,
                                 device)
        if cfg.n_enc_layers:
            out["enc_embeds"] = frontends.fake_audio_frames(
                generator, cfg, b, device)
        if cfg.frontend == "vision":
            out["patch_embeds"] = frontends.fake_patch_embeds(
                generator, cfg, b, device)
        if shape.kind != "train":
            out.pop("labels")
        return out

    if n_agents is None:
        return one(B, 0.0)
    per = [one(B // n_agents, float(i)) for i in range(n_agents)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}
