"""MiniCPM-2B — llama-like, WSD schedule [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753,
    sac=SACConfig(enabled=True),
)
