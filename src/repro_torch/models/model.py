"""The public Model bundle (counterpart of ``repro/models/model.py``).

``loss_fn(params, batch)`` and ``forward(params, batch)`` run the meta
:class:`~repro_torch.models.transformer.Transformer` through
``torch.func.functional_call`` with ``params`` -- a ``{name: tensor}``
mapping, typically views into a packed agent buffer row.
``init_cache(batch, cache_len, long_ctx=False, device=None)`` and
``decode_step(params, cache, tokens, long_ctx=False)`` are the serving
path (:mod:`repro_torch.models.decode`); for an encoder-decoder model
``encode(params, enc_embeds)`` is the encoder's normed output, which
:func:`repro_torch.models.decode.fill_cross_cache` takes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as decode_lib
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class Model:
    config: ModelConfig
    module: torch.nn.Module                       # on the meta device
    init: Callable[..., dict]                     # (generator, device)
    loss_fn: Callable[..., torch.Tensor]          # (params, batch)
    forward: Callable[..., torch.Tensor]          # (params, batch) -> logits
    init_cache: Callable[..., dict]               # (batch, cache_len, ...)
    decode_step: Callable[..., tuple]             # (params, cache, tokens)
    encode: Callable[..., torch.Tensor]           # (params, enc_embeds)

    def param_shapes(self) -> dict:
        """``{name: (shape, dtype)}`` in the module's parameter order."""
        return {n: (tuple(p.shape), p.dtype)
                for n, p in self.module.named_parameters()}

    def param_count(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


def build_model(cfg: ModelConfig) -> Model:
    with torch.device("meta"):
        module = tfm.Transformer(cfg)

    def init(generator: torch.Generator, device) -> dict:
        return tfm.init_params(cfg, generator, device)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        return functional_call(module, params, (batch,))

    def forward(params: dict, batch: dict) -> torch.Tensor:
        return functional_call(module, params, (batch,), {"logits": True})

    def encode(params: dict, enc_embeds: torch.Tensor) -> torch.Tensor:
        return functional_call(module, params, ({"enc_embeds": enc_embeds},),
                               {"encode": True})

    def init_cache(batch: int, cache_len: int, long_ctx: bool = False,
                   device=None) -> dict:
        return decode_lib.init_cache(cfg, batch, cache_len, long_ctx, device)

    def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                    long_ctx: bool = False):
        return decode_lib.decode_step(params, cfg, cache, tokens, long_ctx)

    return Model(config=cfg, module=module, init=init, loss_fn=loss_fn,
                 forward=forward, init_cache=init_cache,
                 decode_step=decode_step, encode=encode)
