"""Model/run configuration: ``ModelConfig`` and ``InputShape``.

A copy of the reference's ``repro/configs/base.py`` fields (the port
keeps every field so one config reads the same in both packages, the
GSPMD-only knobs included, which change no number).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- attention structure -------------------------------------------
    # pattern is cycled over layers; entries: 'global' | 'local' | 'rec' | 'ssm'
    pattern: Tuple[str, ...] = ("global",)
    window: int = 4096              # sliding window for 'local' layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    causal: bool = True             # False for pure encoders

    # --- FFN -------------------------------------------------------------
    activation: str = "swiglu"      # swiglu | geglu | relu2 | gelu

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba1) ------------------------------------------------------
    ssm_state: int = 16
    ssm_expand: int = 2
    conv_width: int = 4
    dt_rank: int = 0

    # --- RG-LRU ------------------------------------------------------------
    lru_width: Optional[int] = None

    # --- encoder-decoder --------------------------------------------------
    n_enc_layers: int = 0
    n_enc_tokens: int = 1500

    # --- multimodal frontend stub ----------------------------------------
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0

    # --- long-context decode -----------------------------------------------
    long_ctx_global_window: int = 32_768
    supports_long_ctx: bool = False

    # --- misc ---------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""

    # --- performance knobs kept for config parity --------------------------
    ssm_fused_output: bool = False
    ssm_scan_dtype: str = "float32"
    ssm_chunk: int = 128
    ssm_inner: str = "assoc"
    chunked_loss: int = 0
    attn_seq_shard: bool = False
    shard_residual: bool = False
    attn_chunk: int = 1024           # KV-chunk span of online-softmax attn
    moe_buffer_shard: bool = False
    moe_grouped: bool = False
    activation_batch_axes: tuple = ("data",)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(1, -(-self.d_model // 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixing kind, cycling ``pattern``."""
        reps = -(-self.n_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512, n_experts: Optional[int] = None):
        """Smoke-test variant of the same family (<=2 layers, <=512 width);
        the reference's ``ModelConfig.reduced`` field for field."""
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        kw = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=2 * d_model if self.d_ff else 0,
            vocab=vocab,
            window=16,
            long_ctx_global_window=32,
            lru_width=d_model if self.lru_width else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_enc_tokens=24 if self.n_enc_layers else self.n_enc_tokens,
            n_frontend_tokens=16 if self.frontend else 0,
            dtype="float32",
        )
        if self.n_experts:
            ne = n_experts if n_experts is not None else min(4, self.n_experts)
            kw.update(n_experts=ne, top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_d_ff=d_model)
        if len(self.pattern) > 1:
            kw["pattern"] = self.pattern[: max(2, len(self.pattern))]
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
