"""build_model(cfg) -> the model facade, and the input specs of every
cell (``repro/models/model.py``).

The port builds every family of the registry: the decoder-only
attention families (``dense``, ``moe``, ``mla_dense``, ``mla_moe`` and
``lg_super`` segments: DeepSeek-V3.2, Qwen2, MiniCPM, Granite,
Chameleon, Mixtral, DBRX, Gemma3), Zamba2's Mamba2 hybrid
(``zamba_super``, ``mamba_tail``) and xLSTM (``xlstm_super``) as a
``TransformerLM``, and the encoder-decoder (Whisper) as an ``EncDecLM``.

``input_specs(cfg, shape)`` returns empty ``meta`` tensors for every
model input of the (architecture x shape) cell, where the reference
returns ``ShapeDtypeStruct``s: the dry-run (``launch/dryrun.py``) runs
its step on them with nothing allocated.  Modality frontends are stubs,
as there: Whisper takes precomputed frame embeddings.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.pool import FetchFn, local_fetch
from repro_torch.models.encdec import MAX_DEC, EncDecLM
from repro_torch.models.layers import DTYPE
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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.enc_dec:
        return {"frames": _meta((B, S, cfg.d_model), DTYPE),
                "tokens": _meta((B, MAX_DEC), torch.int32),
                "labels": _meta((B, MAX_DEC), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.enc_dec:
        return {"frames": _meta((B, S, cfg.d_model), DTYPE)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_input_specs(model, shape: ShapeConfig,
                       device_buffer: int = 0) -> Dict[str, Any]:
    """``device_buffer`` > 0 adds the HiSparse hot-tier state (per-layer
    ``hot_buf`` + measured ``buf_hits``/``buf_misses``) to the decode
    specs: the serve state the engine runs with."""
    B, S = shape.global_batch, shape.seq_len
    return {"state": model.serve_state_shapes(B, S,
                                              device_buffer=device_buffer),
            "tokens": _meta((B,), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model=None
                ) -> Dict[str, Any]:
    """All inputs for the cell's step (excluding params)."""
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    if shape.kind == "decode":
        assert model is not None, "decode specs need the built model"
        return decode_input_specs(model, shape)
    raise ValueError(shape.kind)


def cell_is_supported(cfg: ModelConfig, shape: ShapeConfig, mode: str = "sac"
                      ) -> Optional[str]:
    """None if the (arch, shape, mode) cell runs; else the reference's
    skip reason:
      - whisper long_500k: the 500K-frame *encode* is quadratic prefill;
      - pure full-attention archs run long_500k only in SAC mode (dense
        decode over 524288 entries is the O(L) full-attention read the
        paper's technique removes)."""
    if shape.name == "long_500k":
        if cfg.enc_dec:
            return "500K-frame encoder prefill is quadratic (DESIGN.md §5)"
        if mode == "dense" and cfg.has_attention and not cfg.ssm_state:
            return "dense 500k decode excluded: full-attention baseline is " \
                   "what SAC replaces (DESIGN.md §5)"
    return None
