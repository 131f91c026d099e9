"""Qwen2-1.5B — GQA kv=2, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, qkv_bias=True,
    sac=SACConfig(enabled=True),
)
