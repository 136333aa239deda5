"""Stage-based transformer, dense path (counterpart of
``repro/models/transformer.py``).

A model is a list of *stages*; each stage is a repeating unit of layer
kinds (gemma2's ``('local', 'global')``) run ``n_units`` times with
parameters stacked on a leading ``n_units`` axis, exactly as the
reference stacks them (a Python loop over units where JAX scans).

The module is an ``nn.Module`` whose parameter names mirror the
reference's pytree paths (``stages.0.1.attn.wq`` is
``params["stages"][0]["1"]["attn"]["wq"]``).  It is built on the meta
device and driven through ``torch.func.functional_call`` with the
parameters passed in -- views of a packed state buffer in the federated
trainer -- so the module itself holds no weights.

The ``global`` / ``local`` attention kinds, the ``ssm`` (Mamba-1) and
``rec`` (RG-LRU) kinds, the MoE FFN (``moe`` in place of ``mlp`` in a
``global`` / ``local`` layer of a config with ``n_experts``; the loss is
``ce + router_aux_weight * aux``, ``aux`` summed over the layers), the
untied LM head (``lm_head``, ``(d_model, vocab)``) and the vocab-chunked
loss (``chunked_loss > 0``) are ported; enc-dec and multimodal frontends
raise.  On a CUDA tensor the
attention kinds run the hand-written flash-attention kernels and the
``ssm`` / ``rec`` kinds the hand-written ``lru_scan`` kernels (forward
and backward); on the CPU they run the reference's plain paths (``attn_block_local`` / ``attn_chunked``, the
chunked associative scan).  An ``ssm`` layer has no FFN (``ln1`` and
``mamba`` only), as in the reference; its ``dt_bias``, ``A_log`` and
``D`` and an RG-LRU's ``lam`` are float32 whatever the model's dtype.
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

_PORTED_KINDS = ("global", "local", "ssm", "rec")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: repro_torch runs the global, local, "
        f"ssm and rec layer kinds and the MoE FFN only (later slice of the "
        f"port)")


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
        raise _not_ported("the encoder-decoder model")
    unit = tuple(cfg.pattern)
    stages = []
    n_full, rem = divmod(cfg.n_layers, len(unit))
    if n_full:
        stages.append(StageSpec(unit=unit, n_units=n_full))
    if rem:
        stages.append(StageSpec(unit=unit[:rem], n_units=1))
    return stages


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.frontend:
        raise _not_ported(f"the {cfg.frontend} frontend")
    for kind in cfg.layer_kinds():
        if kind not in _PORTED_KINDS:
            raise _not_ported(f"the {kind!r} layer kind")


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
    an RG-LRU block) + FFN (the MoE in an attention layer of an MoE
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
        if q.is_cuda:
            # both kinds through the hand-written kernel, with the
            # reference's own arguments (p kept in float32)
            local = self.kind == "local"
            o = flash_ops.flash_attention(
                q, k, v, causal=local or cfg.causal,
                window=cfg.window if local else None,
                cap=cfg.attn_softcap)
            o = o.reshape(q.shape[0], q.shape[1], H * D)
        elif self.kind == "local":
            o = attn_lib.attn_block_local(q, k, v, window=cfg.window,
                                          cap=cfg.attn_softcap)
        else:
            o = attn_lib.attn_chunked(q, k, v, causal=cfg.causal,
                                      cap=cfg.attn_softcap,
                                      chunk=cfg.attn_chunk)
        return o @ p["wo"]

    def forward(self, x, u: int, positions):
        """``(x, aux)``: the layer's output and its MoE aux loss (0.0
        without an MoE)."""
        eps = self.cfg.norm_eps
        h = rms_norm(x, self.ln1[u], eps)
        if self.kind == "ssm":
            return x + ssm_lib.mamba_forward(self.mamba.unit(u), h,
                                             self.cfg), 0.0
        if self.kind == "rec":
            x = x + rglru_lib.rglru_forward(self.rec.unit(u), h, self.cfg)
        else:
            x = x + self._attention(self.attn.unit(u), h, positions)
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

    def forward(self, x, aux, positions):
        """``(x, aux)`` after every unit, the layers' aux losses added to
        ``aux`` in order."""
        for u in range(self.spec.n_units):
            for i in range(len(self.spec.unit)):
                x, a = self[str(i)](x, u, positions)
                aux = aux + a
        return x, aux


class Transformer(nn.Module):
    """``forward(batch)`` is the mean token cross-entropy (over vocab
    chunks when ``cfg.chunked_loss > 0``), plus ``router_aux_weight``
    times the summed aux loss of an MoE model; ``forward(batch,
    logits=True)`` the softcapped logits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_ported(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.stages = nn.ModuleList(
            [Stage(s, cfg, dtype) for s in build_stages(cfg)])
        self.embed = _param((cfg.vocab, cfg.d_model), dtype)
        self.final_norm = _param((cfg.d_model,), dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), dtype)

    def forward_hidden(self, tokens):
        """Embedding (scaled by sqrt(d) in the param dtype) -> stages ->
        final norm: ``(hidden, aux)``, ``aux`` the float32 sum of the MoE
        layers' aux losses (0.0 without an MoE)."""
        cfg = self.cfg
        x = self.embed[tokens] * embed_scale(cfg.d_model, self.embed.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = 0.0
        for stage in self.stages:
            x, aux = stage(x, aux, positions)
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux

    def _head(self):
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def forward(self, batch: dict, logits: bool = False):
        cfg = self.cfg
        x, aux = self.forward_hidden(batch["tokens"])
        if logits:
            return softcap(x @ self._head(), cfg.final_softcap)
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
    _check_ported(cfg)
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
