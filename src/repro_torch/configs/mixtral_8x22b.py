"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attn [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, n_experts=8, topk_experts=2, sliding_window=4096,
    sac=SACConfig(enabled=True),
)
