"""xLSTM-125M — sLSTM + mLSTM blocks, attention-free [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, SACConfig
import dataclasses

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    xlstm=True,
    # SAC inapplicable: attention-free (DESIGN.md §Arch-applicability)
    sac=SACConfig(enabled=False),
)
