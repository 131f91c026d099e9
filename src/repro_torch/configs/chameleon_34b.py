"""Chameleon-34B — early-fusion VLM, VQ image tokens in vocab [arXiv:2405.09818].
Modality frontend is a stub: input_specs provides token ids (text+image tokens
share the embedding table, as in early fusion)."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, vlm=True,
    sac=SACConfig(enabled=True),
)
