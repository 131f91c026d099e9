"""build_model(cfg) -> the model facade (``repro/models/model.py``).

The port builds the decoder-only MLA families (DeepSeek-V3.2); every
other family raises until its slice lands (ROADMAP).
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
    if cfg.enc_dec or not cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: only the decoder-only MLA family is ported "
            "(ROADMAP: module item 'The other model families')")
    return TransformerLM(cfg, fetch_fn=fetch_fn, mode=mode, topk_fn=topk_fn,
                         opts=opts, device=device)
