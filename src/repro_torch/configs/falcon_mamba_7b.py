"""falcon-mamba-7b [ssm] -- attention-free Mamba-1. [arXiv:2410.05355]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,             # mamba block subsumes the FFN
    vocab=65_024,
    pattern=("ssm",),
    ssm_state=16,
    ssm_expand=2,
    conv_width=4,
    supports_long_ctx=True,   # O(1) state
    source="arXiv:2410.05355",
)
