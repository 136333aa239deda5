"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, 2:1 pattern
(two recurrent blocks then one local-attention block). [arXiv:2402.19427]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,         # MQA in the attention blocks
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    pattern=("rec", "rec", "local"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    activation="geglu",
    supports_long_ctx=True,   # recurrent state + local attention
    source="arXiv:2402.19427",
)
