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
  'xdec'   -- self-attention KV cache + the cross-attention's K / V
              ``xk``, ``xv`` (B, n_enc_tokens, Hkv, D), which
              :func:`fill_cross_cache` fills from the encoder's output

The cache is ``{"stages": [{str(i): layer cache}], "pos": (B,) int32}``:
positions are per sequence, so batched requests may sit at different
depths (continuous batching), and :func:`reset_slots` frees finished
ones.  Plain tensor code on every device, as in the reference (no
Pallas kernel on its decode path); ``decode_step`` leaves its input
cache unmodified.  An MoE layer runs the flat route on ``(B, 1, d)``, so
its capacity is ``int(cf * B * K / E) + 1`` (1 for qwen2-moe at batch 4)
and decode drops contributions that the full forward keeps, as the
reference's does.  The encoder stage has no decode-time state: the
cache holds the stages after it, and ``decode_step`` runs them.
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
from repro_torch.models.transformer import build_stages


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
    else:       # global / xdec self-attention
        length = (min(cfg.long_ctx_global_window, cache_len) if long_ctx
                  else cache_len)
    c = attn_lib.init_kv_cache(batch, length, Hkv, D, dtype, device)
    if kind == "xdec":
        for name in ("xk", "xv"):
            c[name] = torch.zeros((batch, cfg.n_enc_tokens, Hkv, D),
                                  dtype=dtype, device=device)
    return c


def _decoder_stages(cfg: ModelConfig) -> list:
    """``(index, stage)`` of the stages that decode (all but the
    encoder)."""
    return [(si, s) for si, s in enumerate(build_stages(cfg))
            if s.unit != ("enc",)]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               long_ctx: bool = False, device=None) -> dict:
    """The empty cache on ``device`` (CUDA unless the CPU is asked
    for).  An enc-dec model's cross K / V are zeros until
    :func:`fill_cross_cache`."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    caches = []
    for _, stage in _decoder_stages(cfg):
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


def fill_cross_cache(params: dict, cfg: ModelConfig, cache: dict,
                     enc_out: torch.Tensor) -> dict:
    """The decoder's cross-attention K / V from the encoder's output
    ``enc_out`` (B, T, d) (once a request, before decoding; enc-dec
    models only).  Returns a new cache."""
    if not cfg.n_enc_layers:
        raise ValueError("the cross cache exists for enc-dec models only")
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    B, T, _ = enc_out.shape
    xa = _layer_params(params, 1, 0)["xattn"]       # the ('xdec',) stage
    xk = torch.stack([(enc_out @ w).reshape(B, T, Hkv, D)
                      for w in xa["wk"]])             # (U, B, T, Hkv, D)
    xv = torch.stack([(enc_out @ w).reshape(B, T, Hkv, D)
                      for w in xa["wv"]])
    stage = dict(cache["stages"][0])
    stage["0"] = dict(stage["0"], xk=xk, xv=xv)
    return {"stages": [stage] + cache["stages"][1:], "pos": cache["pos"]}


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


def _decode_cross_attn(p, x_t, xk, xv, cfg: ModelConfig):
    """One token's cross-attention over the filled ``xk``, ``xv`` (B, T,
    Hkv, D): float32 scores, the softcap, probabilities cast to v's
    dtype."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B = x_t.shape[0]
    q = (x_t @ p["wq"]).reshape(B, 1, Hkv, H // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", q.float(), xk.float()) * (
        D ** -0.5)
    pr = torch.softmax(softcap(s, cfg.attn_softcap), dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", pr.to(xv.dtype), xv)
    return o.reshape(B, -1) @ p["wo"]


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
            p["attn"], rms_norm(x_t, p["ln1"], eps),
            {k: c[k] for k in ("k", "v", "pos")},
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            pos=pos, window=window, cap=cfg.attn_softcap, ring=ring)
        x_t = x_t + out @ p["attn"]["wo"]
        if kind == "xdec":
            x_t = x_t + _decode_cross_attn(
                p["xattn"], rms_norm(x_t, p["ln_x"], eps), c["xk"], c["xv"],
                cfg)
            c_new.update(xk=c["xk"], xv=c["xv"])
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
    for (si, stage), sc in zip(_decoder_stages(cfg), cache["stages"]):
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
