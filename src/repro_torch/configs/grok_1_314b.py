"""grok-1-314b [moe] -- 8 experts, top-2 routing. [hf:xai-org/grok-1]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,           # per expert
    vocab=131_072,
    pattern=("global",),
    n_experts=8,
    top_k=2,
    n_shared_experts=0,
    moe_d_ff=32768,
    attn_softcap=30.0,    # grok uses attention logit capping
    final_softcap=30.0,
    activation="geglu",
    supports_long_ctx=False,
    source="hf:xai-org/grok-1",
)
