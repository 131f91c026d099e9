"""build_model(cfg) -> the model facade (``repro/models/model.py``).

The port builds the decoder-only attention families whose layers are
all ``dense``, ``moe``, ``mla_dense``, ``mla_moe`` or ``lg_super``
segments (DeepSeek-V3.2, Qwen2, MiniCPM, Granite, Chameleon, Mixtral,
DBRX, Gemma3); every other family raises until its slice lands
(ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pool import FetchFn, local_fetch
from repro_torch.models.transformer import TransformerLM


def _unported_family(cfg: ModelConfig) -> Optional[str]:
    if cfg.enc_dec:
        return "encoder-decoder (models/encdec.py)"
    if cfg.xlstm:
        return "xLSTM (xlstm_super)"
    if cfg.ssm_state:
        return "zamba/mamba hybrid (zamba_super, mamba_tail, models/ssm.py)"
    return None


def build_model(cfg: ModelConfig, fetch_fn: FetchFn = local_fetch,
                mode: str = "sac", topk_fn: Optional[Callable] = None,
                opts: Optional[dict] = None, device="cuda"):
    """mode: "sac" (top-k fetch decode) | "dense" (full-prefetch decode)."""
    family = _unported_family(cfg)
    if family:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet (ROADMAP: "
            "module item 'The other model families')")
    return TransformerLM(cfg, fetch_fn=fetch_fn, mode=mode, topk_fn=topk_fn,
                         opts=opts, device=device)
