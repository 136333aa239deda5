"""Stage-based transformer (counterpart of
``repro/models/transformer.py``).

A model is a list of *stages*; each stage is a repeating unit of layer
kinds (gemma2's ``('local', 'global')``) run ``n_units`` times with
parameters stacked on a leading ``n_units`` axis, exactly as the
reference stacks them (a Python loop over units where JAX scans).  An
encoder-decoder config (``n_enc_layers > 0``, whisper-small) has two
stages: ``("enc",)`` over ``n_enc_layers`` units, then ``("xdec",)``
over ``n_layers``.

The module is an ``nn.Module`` whose parameter names mirror the
reference's pytree paths (``stages.0.1.attn.wq`` is
``params["stages"][0]["1"]["attn"]["wq"]``).  It is built on the meta
device and driven through ``torch.func.functional_call`` with the
parameters passed in -- views of a packed state buffer in the federated
trainer -- so the module itself holds no weights.

Layer kinds (all of the reference's): ``global`` / ``local`` attention
(+ FFN, or the MoE FFN -- ``moe`` in place of ``mlp`` -- in a config with
``n_experts``; the loss is then ``ce + router_aux_weight * aux``, ``aux``
summed over the layers), ``ssm`` (Mamba-1, no FFN: ``ln1`` and ``mamba``
only), ``rec`` (RG-LRU + FFN), ``enc`` (non-causal self-attention + FFN,
the encoder) and ``xdec`` (causal self-attention, then ``ln_x`` and the
cross-attention ``xattn`` over the encoder's output, + FFN).  The
encoder runs on ``batch["enc_embeds"]`` at its own positions
``0 .. n_enc_tokens - 1`` (RoPE as the reference applies it), and its
output is RMS-normed with a zero weight; the cross-attention has no
RoPE.  A vision config (``frontend="vision"``) puts
``batch["patch_embeds"]`` before the text embeddings, and the loss drops
those positions before the head.  Also ported: the untied LM head
(``lm_head``, ``(d_model, vocab)``) and the vocab-chunked loss
(``chunked_loss > 0``).  On a CUDA tensor every attention (self, the
encoder's and the cross-attention) runs the hand-written flash-attention
kernels and the ``ssm`` / ``rec`` kinds the hand-written ``lru_scan``
kernels (forward and backward); on the CPU they run the reference's
plain paths (``attn_block_local`` / ``attn_chunked``, the chunked
associative scan).  An ``ssm`` layer's ``dt_bias``, ``A_log`` and ``D``
and an RG-LRU's ``lam`` are float32 whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, chunked_cross_entropy,
                                       cross_entropy, embed_scale, init_mlp,
                                       mlp, mlp_shapes, rms_norm, softcap)

# ---------------------------------------------------------------------------
# Stage structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageSpec:
    unit: tuple            # layer kinds within the repeating unit
    n_units: int
    cross: bool = False


def build_stages(cfg: ModelConfig) -> list[StageSpec]:
    if cfg.n_enc_layers:
        return [StageSpec(unit=("enc",), n_units=cfg.n_enc_layers),
                StageSpec(unit=("xdec",), n_units=cfg.n_layers, cross=True)]
    unit = tuple(cfg.pattern)
    stages = []
    n_full, rem = divmod(cfg.n_layers, len(unit))
    if n_full:
        stages.append(StageSpec(unit=unit, n_units=n_full))
    if rem:
        stages.append(StageSpec(unit=unit[:rem], n_units=1))
    return stages


# ---------------------------------------------------------------------------
# Modules (parameters on the meta device; real tensors come in through
# functional_call)
# ---------------------------------------------------------------------------

def _param(shape, dtype):
    return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)


class Params(nn.Module):
    """A block's parameters stacked over units; ``shapes`` maps each name
    to its ``(shape, dtype)``."""

    def __init__(self, shapes: dict, n_units: int):
        super().__init__()
        self.names = tuple(shapes)
        for k, (s, dtype) in shapes.items():
            setattr(self, k, _param((n_units,) + s, dtype))

    def unit(self, u: int) -> dict:
        return {k: getattr(self, k)[u] for k in self.names}


def _params_tree(shapes: dict, n_units: int) -> nn.Module:
    """A nested ``{name: (shape, dtype) | {...}}`` as modules: each dict
    of leaves a :class:`Params`, each nested dict a submodule (the MoE's
    ``router``, ``experts.wi``, ...)."""
    leaves = {k: v for k, v in shapes.items() if not isinstance(v, dict)}
    node = Params(leaves, n_units)
    for k, v in shapes.items():
        if isinstance(v, dict):
            setattr(node, k, _params_tree(v, n_units))
    return node


def _unit_tree(node: nn.Module, u: int) -> dict:
    out = node.unit(u)
    for k, child in node.named_children():
        out[k] = _unit_tree(child, u)
    return out


class Layer(nn.Module):
    """One layer of a kind, parameters stacked over units: attention (or
    an RG-LRU block; in an ``xdec`` layer, self-attention then the
    cross-attention) + FFN (the MoE in an attention layer of an MoE
    config), or a Mamba block alone."""

    def __init__(self, kind: str, cfg: ModelConfig, n_units: int, dtype):
        super().__init__()
        self.kind = kind
        self.cfg = cfg
        self.ln1 = _param((n_units, cfg.d_model), dtype)
        if kind == "ssm":
            self.mamba = Params(ssm_lib.mamba_shapes(cfg, dtype), n_units)
            return
        if kind == "rec":
            self.rec = Params(rglru_lib.rglru_shapes(cfg, dtype), n_units)
        else:
            shapes = attn_lib.attn_shapes(cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads,
                                          cfg.resolved_head_dim)
            self.attn = Params({k: (s, dtype) for k, s in shapes.items()},
                               n_units)
            if kind == "xdec":
                self.ln_x = _param((n_units, cfg.d_model), dtype)
                self.xattn = Params({k: (s, dtype)
                                     for k, s in shapes.items()}, n_units)
        self.ln2 = _param((n_units, cfg.d_model), dtype)
        if cfg.n_experts and kind in ("global", "local"):
            self.moe = _params_tree(moe_lib.moe_shapes(cfg, dtype), n_units)
            return
        shapes = mlp_shapes(cfg.d_model, cfg.d_ff, cfg.activation)
        self.mlp = Params({k: (s, dtype) for k, s in shapes.items()}, n_units)

    def _attention(self, p, x, positions):
        cfg = self.cfg
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q, k, v = attn_lib.qkv(p, x, n_heads=H, n_kv_heads=Hkv, head_dim=D)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        # the encoder is non-causal; global and xdec self-attention take
        # the config's flag
        causal = self.kind != "enc" and cfg.causal
        if q.is_cuda:
            # every kind through the hand-written kernel, with the
            # reference's own arguments (p kept in float32)
            local = self.kind == "local"
            o = flash_ops.flash_attention(
                q, k, v, causal=local or causal,
                window=cfg.window if local else None,
                cap=cfg.attn_softcap)
            o = o.reshape(q.shape[0], q.shape[1], H * D)
        elif self.kind == "local":
            o = attn_lib.attn_block_local(q, k, v, window=cfg.window,
                                          cap=cfg.attn_softcap)
        else:
            o = attn_lib.attn_chunked(q, k, v, causal=causal,
                                      cap=cfg.attn_softcap,
                                      chunk=cfg.attn_chunk)
        return o @ p["wo"]

    def _cross_attention(self, p, x, enc_out):
        """Queries from the decoder's ``x`` (B, S, d), keys and values from
        the encoder's output (B, T, d): no RoPE, no mask."""
        cfg = self.cfg
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        B, S, _ = x.shape
        T = enc_out.shape[1]
        q = (x @ p["wq"]).reshape(B, S, H, D)
        k = (enc_out @ p["wk"]).reshape(B, T, Hkv, D)
        v = (enc_out @ p["wv"]).reshape(B, T, Hkv, D)
        if q.is_cuda:
            o = flash_ops.flash_attention(q, k, v, causal=False, window=None,
                                          cap=cfg.attn_softcap)
            o = o.reshape(B, S, H * D)
        else:
            o = attn_lib.attn_chunked(q, k, v, causal=False,
                                      cap=cfg.attn_softcap)
        return o @ p["wo"]

    def forward(self, x, u: int, positions, enc_out=None):
        """``(x, aux)``: the layer's output and its MoE aux loss (0.0
        without an MoE); ``enc_out`` is the encoder's output, which an
        ``xdec`` layer attends to."""
        eps = self.cfg.norm_eps
        h = rms_norm(x, self.ln1[u], eps)
        if self.kind == "ssm":
            return x + ssm_lib.mamba_forward(self.mamba.unit(u), h,
                                             self.cfg), 0.0
        if self.kind == "rec":
            x = x + rglru_lib.rglru_forward(self.rec.unit(u), h, self.cfg)
        else:
            x = x + self._attention(self.attn.unit(u), h, positions)
            if self.kind == "xdec":
                x = x + self._cross_attention(
                    self.xattn.unit(u), rms_norm(x, self.ln_x[u], eps),
                    enc_out)
        h = rms_norm(x, self.ln2[u], eps)
        if hasattr(self, "moe"):
            out, aux = moe_lib.moe_ffn(_unit_tree(self.moe, u), h, self.cfg)
            return x + out, aux
        return x + mlp(self.mlp.unit(u), h, self.cfg.activation), 0.0


class Stage(nn.ModuleDict):
    """The repeating unit of a stage: layer ``str(i)`` of kind
    ``unit[i]``, each with ``n_units`` stacked parameter sets."""

    def __init__(self, spec: StageSpec, cfg: ModelConfig, dtype):
        super().__init__({str(i): Layer(kind, cfg, spec.n_units, dtype)
                          for i, kind in enumerate(spec.unit)})
        self.spec = spec

    def forward(self, x, aux, positions, enc_out=None):
        """``(x, aux)`` after every unit, the layers' aux losses added to
        ``aux`` in order."""
        for u in range(self.spec.n_units):
            for i in range(len(self.spec.unit)):
                x, a = self[str(i)](x, u, positions, enc_out)
                aux = aux + a
        return x, aux


class Transformer(nn.Module):
    """``forward(batch)`` is the mean token cross-entropy (over vocab
    chunks when ``cfg.chunked_loss > 0``), plus ``router_aux_weight``
    times the summed aux loss of an MoE model; ``forward(batch,
    logits=True)`` the softcapped logits (of every position, the vision
    prefix's too); ``forward(batch, encode=True)`` the encoder's normed
    output of an encoder-decoder model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.stages = nn.ModuleList(
            [Stage(s, cfg, dtype) for s in build_stages(cfg)])
        self.embed = _param((cfg.vocab, cfg.d_model), dtype)
        self.final_norm = _param((cfg.d_model,), dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), dtype)

    def encode(self, enc_embeds, aux=0.0):
        """The encoder stage on ``enc_embeds`` (B, T, d) at positions
        ``0 .. T - 1``, RMS-normed with a zero weight: ``(enc_out,
        aux)``."""
        cfg = self.cfg
        x = enc_embeds.to(self.embed.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self.stages[0](x, aux, positions)
        return rms_norm(x, torch.zeros_like(x[0, 0]), cfg.norm_eps), aux

    def forward_hidden(self, batch: dict):
        """Embedding (scaled by sqrt(d) in the param dtype; a vision
        prefix before it) -> the encoder, when there is one -> stages ->
        final norm: ``(hidden, aux)``, ``aux`` the float32 sum of the MoE
        layers' aux losses (0.0 without an MoE)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"]] * embed_scale(cfg.d_model,
                                                      self.embed.dtype)
        if cfg.frontend and cfg.frontend != "audio":
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        aux, enc_out, stages = 0.0, None, list(self.stages)
        if cfg.n_enc_layers:
            enc_out, aux = self.encode(batch["enc_embeds"], aux)
            stages = stages[1:]
        for stage in stages:
            x, aux = stage(x, aux, positions, enc_out)
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux

    def _head(self):
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def forward(self, batch: dict, logits: bool = False,
                encode: bool = False):
        cfg = self.cfg
        if encode:
            return self.encode(batch["enc_embeds"])[0]
        x, aux = self.forward_hidden(batch)
        if logits:
            return softcap(x @ self._head(), cfg.final_softcap)
        if cfg.frontend and cfg.frontend != "audio":
            # the loss is over the text positions
            x = x[:, batch["patch_embeds"].shape[1]:, :]
        if cfg.chunked_loss:
            # the softcap in float32, after the cast (the reference's
            # order on this path; the full logits take the param dtype's)
            loss = chunked_cross_entropy(x, self._head(), batch["labels"],
                                         cfg.chunked_loss,
                                         cap=cfg.final_softcap)
        else:
            loss = cross_entropy(softcap(x @ self._head(), cfg.final_softcap),
                                 batch["labels"])
        if cfg.n_experts:
            loss = loss + cfg.router_aux_weight * aux
        return loss


# ---------------------------------------------------------------------------
# Parameter init (the reference's distributions; the bits differ, since
# the port draws from a torch.Generator)
# ---------------------------------------------------------------------------

def _init_layer(generator, kind: str, cfg: ModelConfig, dtype, device,
                n_units: int) -> dict:
    d = cfg.d_model
    lead = (n_units,)
    p = {"ln1": torch.zeros(lead + (d,), dtype=dtype, device=device)}
    if kind == "ssm":
        p["mamba"] = ssm_lib.init_mamba(generator, cfg, dtype, device, lead)
        return p
    if kind == "rec":
        p["rec"] = rglru_lib.init_rglru_block(generator, cfg, dtype, device,
                                              lead)
    else:
        p["attn"] = attn_lib.init_attn(generator, d, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.resolved_head_dim,
                                       dtype, device=device, lead=lead)
        if kind == "xdec":
            p["ln_x"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
            p["xattn"] = attn_lib.init_attn(
                generator, d, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, dtype, device=device, lead=lead)
    p["ln2"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    if cfg.n_experts and kind in ("global", "local"):
        p["moe"] = moe_lib.init_moe(generator, cfg, dtype, device, lead)
    else:
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.activation, dtype,
                            device=device, lead=lead)
    return p


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters as ``{name: tensor}`` (names of
    :class:`Transformer`'s ``named_parameters``)."""
    dtype = getattr(torch, cfg.dtype)
    tree = {"stages": {
        str(si): {str(i): _init_layer(generator, kind, cfg, dtype, device,
                                      s.n_units)
                  for i, kind in enumerate(s.unit)}
        for si, s in enumerate(build_stages(cfg))}}
    tree["embed"] = (cfg.d_model ** -0.5 * torch.randn(
        (cfg.vocab, cfg.d_model), generator=generator,
        device=device)).to(dtype)
    tree["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=device)
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model ** -0.5 * torch.randn(
            (cfg.d_model, cfg.vocab), generator=generator,
            device=device)).to(dtype)
    return _flatten(tree)
