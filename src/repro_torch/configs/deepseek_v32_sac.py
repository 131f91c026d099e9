"""DeepSeek-V3.2 (the paper's own model) — MLA + DeepSeek Sparse Attention.
61 layers, d=7168, 128 heads, latent KV 512 + 64 RoPE dims, indexer top-k 2048.
MoE reduced bookkeeping: V3.2 has 256 experts top-8 (first 3 layers dense)."""
from repro_torch.configs.base import ModelConfig, SACConfig

CONFIG = ModelConfig(
    name="deepseek-v32", family="mla",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, head_dim=128,
    mla=True, kv_lora_rank=512, qk_rope_dim=64, q_lora_rank=1536,
    n_experts=256, topk_experts=8,
    sac=SACConfig(enabled=True, topk=2048, d_idx=128, n_idx_heads=64,
                  device_buffer_size=6144),
)
