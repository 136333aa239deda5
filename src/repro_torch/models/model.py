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

:func:`batch_specs`, :func:`cache_specs` and :func:`input_specs` describe
every model input of an ``(arch, shape)`` pair as meta-device tensors
(shapes and dtypes, nothing allocated), with the reference's keys and
shapes; :func:`shape_supported` records the reference's skips.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import functional_call

from repro_torch.configs.base import InputShape, ModelConfig
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


# ---------------------------------------------------------------------------
# input_specs: meta-device stand-ins for every model input
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape,
                with_labels: bool) -> dict:
    """The data batch of the train and prefill modes."""
    B, S = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.n_enc_layers:                     # enc-dec (whisper)
        specs["enc_embeds"] = _meta((B, cfg.n_enc_tokens, cfg.d_model),
                                    cfg.dtype)
        specs["tokens"] = _meta((B, S), torch.int32)
    elif cfg.frontend == "vision":
        n_front = cfg.n_frontend_tokens
        specs["patch_embeds"] = _meta((B, n_front, cfg.d_model), cfg.dtype)
        specs["tokens"] = _meta((B, S - n_front), torch.int32)
    else:
        specs["tokens"] = _meta((B, S), torch.int32)
    if with_labels:
        specs["labels"] = _meta((B, specs["tokens"].shape[1]), torch.int32)
    return specs


def cache_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The decode cache (:func:`repro_torch.models.decode.init_cache` on
    the meta device)."""
    return decode_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 shape.name == "long_500k", device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """All inputs of the step for this shape (parameters excluded)."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    return {"cache": cache_specs(cfg, shape),
            "tokens": _meta((shape.global_batch,), torch.int32)}


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple:
    """Whether (arch, shape) is runnable; ``(False, reason)`` records the
    skip."""
    if shape.name == "long_500k" and not cfg.supports_long_ctx:
        return False, ("pure full-attention architecture: long_500k "
                       "requires sub-quadratic attention (DESIGN.md skip)")
    return True, ""
