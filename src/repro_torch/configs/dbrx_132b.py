"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, n_experts=16, topk_experts=4,
    sac=SACConfig(enabled=True),
)
