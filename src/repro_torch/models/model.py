"""build_model(cfg) -> the model facade (``repro/models/model.py``).

The port builds every family of the registry: the decoder-only
attention families (``dense``, ``moe``, ``mla_dense``, ``mla_moe`` and
``lg_super`` segments: DeepSeek-V3.2, Qwen2, MiniCPM, Granite,
Chameleon, Mixtral, DBRX, Gemma3), Zamba2's Mamba2 hybrid
(``zamba_super``, ``mamba_tail``) and xLSTM (``xlstm_super``) as a
``TransformerLM``, and the encoder-decoder (Whisper) as an ``EncDecLM``.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pool import FetchFn, local_fetch
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, fetch_fn: FetchFn = local_fetch,
                mode: str = "sac", topk_fn: Optional[Callable] = None,
                remat: bool = True, opts: Optional[dict] = None,
                device="cuda"):
    """mode: "sac" (top-k fetch decode) | "dense" (full-prefetch decode);
    ``remat``: activation checkpointing of each layer in ``forward``."""
    if cfg.enc_dec:
        return EncDecLM(cfg, fetch_fn=fetch_fn, mode=mode, topk_fn=topk_fn,
                        remat=remat, device=device)
    return TransformerLM(cfg, fetch_fn=fetch_fn, mode=mode, topk_fn=topk_fn,
                         remat=remat, opts=opts, device=device)
