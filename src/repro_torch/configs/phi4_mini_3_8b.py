"""phi4-mini-3.8b [dense] -- RoPE, SwiGLU, GQA. [arXiv:2412.08905]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200_064,
    pattern=("global",),
    activation="swiglu",
    rope_theta=10_000.0,
    supports_long_ctx=False,    # pure full attention -> long_500k skipped
    source="arXiv:2412.08905",
)
