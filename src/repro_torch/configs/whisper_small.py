"""whisper-small [audio] -- encoder-decoder transformer backbone; the
mel-spectrogram + conv feature extractor is a stub
(:mod:`repro_torch.models.frontends` draws the frame embeddings).
[arXiv:2212.04356]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,          # decoder layers
    n_enc_layers=12,      # encoder layers
    n_enc_tokens=1500,    # 30 s of audio at 50 Hz after the conv stub
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51_865,
    pattern=("global",),
    activation="gelu",
    frontend="audio",
    supports_long_ctx=False,
    source="arXiv:2212.04356",
)
