"""gemma2-2b [dense] -- local+global alternating attention, logit softcaps.
[arXiv:2408.00118]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    pattern=("local", "global"),   # alternating
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    activation="geglu",
    supports_long_ctx=True,
    long_ctx_global_window=32_768,
    source="arXiv:2408.00118",
)
