"""build_model(cfg) -> the model facade (``repro/models/model.py``).

The port builds every decoder-only family of the registry: the
attention families (``dense``, ``moe``, ``mla_dense``, ``mla_moe`` and
``lg_super`` segments: DeepSeek-V3.2, Qwen2, MiniCPM, Granite,
Chameleon, Mixtral, DBRX, Gemma3), Zamba2's Mamba2 hybrid
(``zamba_super``, ``mamba_tail``) and xLSTM (``xlstm_super``).  The
encoder-decoder family (Whisper) raises until its slice lands (ROADMAP:
module item ``models/encdec.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pool import FetchFn, local_fetch
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, fetch_fn: FetchFn = local_fetch,
                mode: str = "sac", topk_fn: Optional[Callable] = None,
                opts: Optional[dict] = None, device="cuda"):
    """mode: "sac" (top-k fetch decode) | "dense" (full-prefetch decode)."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            "(ROADMAP: module item 'models/encdec.py')")
    return TransformerLM(cfg, fetch_fn=fetch_fn, mode=mode, topk_fn=topk_fn,
                         opts=opts, device=device)
