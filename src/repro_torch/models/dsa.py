"""DeepSeek Sparse Attention building blocks and the MLA decode paths
(``repro/models/dsa.py``, its MLA and selection parts).

- **Lightning indexer**: per-token keys of ``d_idx`` dims; at decode the
  query scores every cached position, ``I[s] = sum_h w[h] *
  ReLU(q[h] . k[s]) / sqrt(d_idx)``, through ``kernels/ops.py`` (the
  indexer kernel on the card).  The q and w projections stay matmuls.
- **Selection**: masked top-k in ``jax.lax.top_k`` order (ties to the
  lower index), then position-sorted.
- **MLA**: prefill runs the non-absorbed form and emits the latent entry
  (c_kv, k_rope); decode runs the absorbed form over fetched entries,
  its softmax core through ``ops.batched_sparse_mla`` (the sparse
  attention kernel on the card).

The GQA decode forms and the speculation helpers of the reference wait
for later slices (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, apply_rope,
                                       blocked_causal_attention, rms_norm,
                                       top_k)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# lightning indexer
# ---------------------------------------------------------------------------


def indexer_param_specs(cfg) -> Dict[str, ParamSpec]:
    d, ni, di = cfg.d_model, cfg.sac.n_idx_heads, cfg.sac.d_idx
    return {
        "wq_idx": ParamSpec((d, ni * di), ("D", "H")),
        "wk_idx": ParamSpec((d, di), ("D", "C")),
        "w_w": ParamSpec((d, ni), ("D", "C"), scale=0.1),
    }


def indexer_keys(p, x) -> torch.Tensor:
    """Per-token indexer keys. x: [..., D] -> [..., d_idx]."""
    return x @ p["wk_idx"]


def indexer_scores(p, xq, idx_keys, cfg) -> torch.Tensor:
    """Score all cached positions against the current query token.

    xq: [B, D]; idx_keys: [B, S, d_idx] -> scores [B, S] (f32).
    """
    B = xq.shape[0]
    ni, di = cfg.sac.n_idx_heads, cfg.sac.d_idx
    q = (xq @ p["wq_idx"]).reshape(B, ni, di).float()
    w = (xq @ p["w_w"]).float()                                  # [B, ni]
    return ops.batched_indexer_scores(q, w, idx_keys)


def topk_select(scores: torch.Tensor, cache_len: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask positions >= cache_len, take top-k.

    scores: [B, S]; cache_len: [B] -> (idx [B, k] int32, valid [B, k]).
    """
    S = scores.shape[-1]
    pos = torch.arange(S, dtype=torch.int32, device=scores.device)
    masked = torch.where(pos[None, :] < cache_len[:, None], scores, NEG_INF)
    top_scores, idx = top_k(masked, min(k, S))
    valid = top_scores > NEG_INF / 2
    # position-sort the selected set (invalid lanes pushed last): with
    # k >= context the sparse decode is then bit-exact vs dense
    return _position_sort(idx.to(torch.int32), valid, S)


def _position_sort(idx: torch.Tensor, valid: torch.Tensor, S: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort a selected set by position (invalid lanes pushed last)."""
    order = torch.argsort(torch.where(valid, idx, S), dim=-1, stable=True)
    return idx.gather(-1, order), valid.gather(-1, order)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def mla_param_specs(cfg) -> Dict[str, ParamSpec]:
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dc, dr, qr = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.q_lora_rank
    return {
        "w_dq": ParamSpec((d, qr), ("D", "C")),
        "q_norm_g": ParamSpec((qr,), ("C",), init="ones"),
        "w_uq": ParamSpec((qr, nh * (hd + dr)), ("C", "H")),
        "w_dkv": ParamSpec((d, dc + dr), ("D", "C")),
        "kv_norm_g": ParamSpec((dc,), ("C",), init="ones"),
        "w_uk": ParamSpec((dc, nh * hd), ("C", "H")),
        "w_uv": ParamSpec((dc, nh * hd), ("C", "H")),
        "wo": ParamSpec((nh * hd, d), ("H", "D")),
    }


def mla_q_proj(p, x, cfg, positions):
    """x: [B(, S), D] -> q_nope [B(,S),nh,hd], q_pe [B(,S),nh,dr] (roped)."""
    nh, hd, dr = cfg.n_heads, cfg.hd, cfg.qk_rope_dim
    lead = x.shape[:-1]
    q = rms_norm(x @ p["w_dq"], p["q_norm_g"]) @ p["w_uq"]
    q = q.reshape(*lead, nh, hd + dr)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def mla_kv_entry(p, x, cfg, positions):
    """Latent cache entry per token: [.., dc+dr] (c_kv normed, k_pe roped)."""
    dc = cfg.kv_lora_rank
    kv = x @ p["w_dkv"]
    c = rms_norm(kv[..., :dc], p["kv_norm_g"])
    k_pe = apply_rope(kv[..., dc:], positions, cfg.rope_theta)
    return torch.cat([c, k_pe], dim=-1)


def mla_prefill_attention(p, x, cfg, positions, *, chunk: int = 1024):
    """Non-absorbed MLA over a full sequence (prefill).

    x: [B, S, D] -> (out [B, S, D], cache_entries [B, S, dc+dr]).
    """
    B, S, _ = x.shape
    nh, hd, dr, dc = cfg.n_heads, cfg.hd, cfg.qk_rope_dim, cfg.kv_lora_rank
    q_nope, q_pe = mla_q_proj(p, x, cfg, positions)
    entry = mla_kv_entry(p, x, cfg, positions)
    c, k_pe = entry[..., :dc], entry[..., dc:]
    k_nope = (c @ p["w_uk"]).reshape(B, S, nh, hd)
    v = (c @ p["w_uv"]).reshape(B, S, nh, hd)
    k_pe_b = k_pe[:, :, None, :].expand(B, S, nh, dr)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe_b], dim=-1)
    # pad v with zeros so q/k/v share the last dim for the blocked loop
    v_pad = torch.cat([v, v.new_zeros(B, S, nh, dr)], dim=-1)
    out = blocked_causal_attention(q, k, v_pad, chunk=chunk)[..., :hd]
    return out.reshape(B, S, nh * hd) @ p["wo"], entry


def mla_absorbed_decode(p, xq, cfg, fetched, valid, positions):
    """Absorbed MLA decode over fetched latent entries.

    xq: [B, D]; fetched: [B, k, dc+dr]; valid: [B, k] bool;
    positions: [B] -> out [B, D].  The softmax core runs in
    ``ops.batched_sparse_mla``; the absorption, the ``w_uv``
    up-projection and ``wo`` are f32/bf16 matmuls as in the reference.
    """
    B = xq.shape[0]
    nh, hd, dr, dc = cfg.n_heads, cfg.hd, cfg.qk_rope_dim, cfg.kv_lora_rank
    q_nope, q_pe = mla_q_proj(p, xq, cfg, positions)          # [B,nh,hd|dr]
    w_uk = p["w_uk"].reshape(dc, nh, hd)
    # absorb: q_lat[b,h,c] = sum_d q_nope[b,h,d] * w_uk[c,h,d]
    q_lat = torch.einsum("bhd,chd->bhc", q_nope.float(), w_uk.float())
    o_lat = ops.batched_sparse_mla(q_lat, q_pe.float(), fetched, valid,
                                   dc=dc, scale=1.0 / math.sqrt(hd + dr))
    w_uv = p["w_uv"].reshape(dc, nh, hd)
    out = torch.einsum("bhc,chd->bhd", o_lat, w_uv.float())
    return out.reshape(B, nh * hd).to(xq.dtype) @ p["wo"]


def mla_dense_decode(p, xq, cfg, pool_layer, cache_len, positions):
    """Dense absorbed-MLA decode over the full latent pool slice."""
    S = pool_layer.shape[1]
    valid = (torch.arange(S, dtype=torch.int32, device=pool_layer.device)
             [None, :] < cache_len[:, None])
    return mla_absorbed_decode(p, xq, cfg, pool_layer, valid, positions)
