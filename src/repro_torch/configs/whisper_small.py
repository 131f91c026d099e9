"""Whisper-small — enc-dec, conv frontend stubbed (precomputed frame embeds)
[arXiv:2212.04356]. 12 encoder + 12 decoder layers."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, enc_dec=True, n_enc_layers=12,
    # SAC applies to cross-attention KV (encoder side is the long side)
    sac=SACConfig(enabled=True),
)
