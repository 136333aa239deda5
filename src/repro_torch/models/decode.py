"""Single-token decode path with KV / recurrent caches (counterpart of
``repro/models/decode.py``).

``init_cache`` builds the cache for a (config, batch, cache_len) triple;
``decode_step`` consumes one token a sequence and returns the next
logits and the updated cache.  Layer caches, stacked over a stage's
units on a leading axis as the parameters are:

  'global' -- KV cache of length cache_len (or a ring buffer of
              ``cfg.long_ctx_global_window`` in long-context mode)
  'local'  -- ring-buffer KV cache of length min(window, cache_len)
  'ssm'    -- (conv, h) Mamba recurrent state
  'rec'    -- (conv, h) RG-LRU recurrent state

The cache is ``{"stages": [{str(i): layer cache}], "pos": (B,) int32}``:
positions are per sequence, so batched requests may sit at different
depths (continuous batching), and :func:`reset_slots` frees finished
ones.  Plain tensor code on every device, as in the reference (no
Pallas kernel on its decode path); ``decode_step`` leaves its input
cache unmodified.  An MoE layer runs the flat route on ``(B, 1, d)``, so
its capacity is ``int(cf * B * K / E) + 1`` (1 for qwen2-moe at batch 4)
and decode drops contributions that the full forward keeps, as the
reference's does.  The enc-dec ``xdec`` kind (``fill_cross_cache``) is
not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import embed_scale, mlp, rms_norm, softcap
from repro_torch.models.transformer import (_check_ported, _not_ported,
                                            build_stages)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _layer_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                 long_ctx: bool, dtype, device) -> dict:
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    if kind == "ssm":
        return ssm_lib.init_mamba_cache(batch, cfg, dtype, device)
    if kind == "rec":
        return rglru_lib.init_rglru_cache(batch, cfg, dtype, device)
    if kind == "local":
        length = min(cfg.window, cache_len)
    else:
        length = (min(cfg.long_ctx_global_window, cache_len) if long_ctx
                  else cache_len)
    return attn_lib.init_kv_cache(batch, length, Hkv, D, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               long_ctx: bool = False, device=None) -> dict:
    """The empty cache on ``device`` (CUDA unless the CPU is asked
    for)."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    caches = []
    for stage in build_stages(cfg):
        units = [{str(i): _layer_cache(kind, cfg, batch, cache_len,
                                       long_ctx, dtype, device)
                  for i, kind in enumerate(stage.unit)}
                 for _ in range(stage.n_units)]
        caches.append(_stack(units))
    return {"stages": caches,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _stack(units: list) -> dict:
    """Per-unit ``{layer: {name: tensor}}`` caches stacked on axis 0."""
    return {i: {k: torch.stack([u[i][k] for u in units])
                for k in units[0][i]}
            for i in units[0]}


def fill_cross_cache(params, cfg: ModelConfig, cache, enc_out):
    raise _not_ported("the encoder-decoder model's cross-attention cache")


def reset_slots(cache: dict, done_mask: torch.Tensor) -> dict:
    """Free finished sequences' slots (continuous batching): zero their
    positions, invalidate their KV rows and zero their recurrent state.
    done_mask: (B,) bool.  Returns a new cache."""
    done = done_mask.to(torch.bool)

    def layer(c: dict) -> dict:
        out = {}
        for name, leaf in c.items():
            if name == "pos":                             # (U, B, C)
                leaf = torch.where(done[None, :, None],
                                   torch.full_like(leaf, -1), leaf)
            elif name in ("h", "conv"):                   # recurrent state
                mask = done.reshape((1, -1) + (1,) * (leaf.ndim - 2))
                leaf = torch.where(mask, torch.zeros_like(leaf), leaf)
            out[name] = leaf
        return out

    return {"stages": [{i: layer(c) for i, c in sc.items()}
                       for sc in cache["stages"]],
            "pos": torch.where(done, torch.zeros_like(cache["pos"]),
                               cache["pos"])}


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _nest(flat: dict) -> dict:
    """``{"attn.wq": t, "ln1": t}`` -> ``{"attn": {"wq": t}, "ln1": t}``."""
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def _layer_params(params: dict, si: int, i: int) -> dict:
    """Layer ``i`` of stage ``si``: nested ``{block: {name: (U, ...)}}``."""
    prefix = f"stages.{si}.{i}."
    return _nest({n[len(prefix):]: t for n, t in params.items()
                  if n.startswith(prefix)})


def _unit(tree, u: int):
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def _layer_decode(p, c, kind, cfg: ModelConfig, x_t, pos, long_ctx):
    eps = cfg.norm_eps
    if kind == "ssm":
        out, c_new = ssm_lib.mamba_step(p["mamba"],
                                        rms_norm(x_t, p["ln1"], eps), c, cfg)
        return x_t + out, c_new
    if kind == "rec":
        out, c_new = rglru_lib.rglru_step(p["rec"],
                                          rms_norm(x_t, p["ln1"], eps), c,
                                          cfg)
        x_t = x_t + out
    else:
        if kind == "local":
            window, ring = cfg.window, True
        elif long_ctx:
            window, ring = cfg.long_ctx_global_window, True
        else:
            window, ring = None, False
        out, c_new = attn_lib.decode_attn(
            p["attn"], rms_norm(x_t, p["ln1"], eps), c,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            pos=pos, window=window, cap=cfg.attn_softcap, ring=ring)
        x_t = x_t + out @ p["attn"]["wo"]
    h = rms_norm(x_t, p["ln2"], eps)
    if "moe" in p:
        out, _ = moe_lib.moe_ffn(p["moe"], h[:, None, :], cfg)
        return x_t + out[:, 0, :], c_new
    return x_t + mlp(p["mlp"], h, cfg.activation), c_new


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, long_ctx: bool = False):
    """tokens: (B,) -> (logits (B, V), new cache).

    ``cache["pos"]`` is per sequence (B,), so batched requests may sit at
    different depths (continuous batching)."""
    pos = cache["pos"]
    embed = params["embed"]
    x_t = embed[tokens.long()] * embed_scale(cfg.d_model, embed.dtype)
    new_stage_caches = []
    for si, (stage, sc) in enumerate(zip(build_stages(cfg),
                                         cache["stages"])):
        layers = [_layer_params(params, si, i)
                  for i in range(len(stage.unit))]
        units = []
        for u in range(stage.n_units):
            uc_new = {}
            for i, kind in enumerate(stage.unit):
                x_t, uc_new[str(i)] = _layer_decode(
                    _unit(layers[i], u), _unit(sc[str(i)], u), kind, cfg,
                    x_t, pos, long_ctx)
            units.append(uc_new)
        new_stage_caches.append(_stack(units))
    x_t = rms_norm(x_t, params["final_norm"], cfg.norm_eps)
    head = embed.t() if cfg.tie_embeddings else params["lm_head"]
    logits = softcap(x_t @ head, cfg.final_softcap)
    return logits, {"stages": new_stage_caches, "pos": pos + 1}
