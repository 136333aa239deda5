"""internvl2-26b [vlm] -- InternLM2-20B language backbone; the InternViT
vision encoder + MLP projector are a stub
(:mod:`repro_torch.models.frontends` draws the projected patch
embeddings).  [arXiv:2404.16821]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92_553,
    pattern=("global",),
    activation="swiglu",
    frontend="vision",
    n_frontend_tokens=256,   # one image tile -> 256 projected patch tokens
    supports_long_ctx=False,
    source="arXiv:2404.16821",
)
