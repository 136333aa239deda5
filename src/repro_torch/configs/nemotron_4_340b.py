"""nemotron-4-340b [dense] -- GQA, squared-ReLU MLP. [arXiv:2402.16819]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256_000,
    pattern=("global",),
    activation="relu2",
    tie_embeddings=False,
    supports_long_ctx=False,
    source="arXiv:2402.16819",
)
