"""Gemma3-12B — 5:1 local:global attention, 128k ctx [hf:google/gemma-3]."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, local_global_ratio=5, local_window=1024,
    sac=SACConfig(enabled=True),
)
