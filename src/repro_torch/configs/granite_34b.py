"""Granite-34B-code — llama-arch, MQA kv=1 [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
    sac=SACConfig(enabled=True),
)
