"""qwen2-moe-a2.7b [moe] -- 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,            # per routed expert
    vocab=151_936,
    pattern=("global",),
    n_experts=60,
    top_k=4,
    n_shared_experts=4,   # shared-expert hidden = 4 * 1408 = 5632
    moe_d_ff=1408,
    activation="swiglu",
    supports_long_ctx=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
