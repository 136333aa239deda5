"""Synthetic token batches (counterpart of ``repro/data/synthetic.py``).

The same Zipf-flavoured stream as the reference, drawn from a
``torch.Generator`` (the bits differ from JAX's threefry; the parity
tests hand both packages one numpy batch instead).  In federated mode
agent ``i`` draws with ``skew = i`` -- non-IID local data.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import InputShape, ModelConfig


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
    """A training batch of ``shape``; with ``n_agents`` set, a leading
    agent axis with ``global_batch // n_agents`` rows per agent."""
    if cfg.frontend or cfg.n_enc_layers:
        raise NotImplementedError(
            "frontend / encoder inputs are not ported yet (later slice)")
    B, S = shape.global_batch, shape.seq_len
    if n_agents is None:
        return synthetic_lm_batch(generator, cfg.vocab, B, S, 0.0, device)
    per = [synthetic_lm_batch(generator, cfg.vocab, B // n_agents, S,
                              float(i), device) for i in range(n_agents)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}
