"""DeepSeek Sparse Attention building blocks and the MLA and GQA decode
paths (``repro/models/dsa.py``).

- **Lightning indexer**: per-token keys of ``d_idx`` dims; at decode the
  query scores every cached position, ``I[s] = sum_h w[h] *
  ReLU(q[h] . k[s]) / sqrt(d_idx)``, through ``kernels/ops.py`` (the
  indexer kernel on the card).  The q and w projections stay matmuls.
- **Selection**: masked top-k in ``jax.lax.top_k`` order (ties to the
  lower index), then position-sorted.  With speculation one top-(k+w)
  yields the demand set (bit-identical to the unfused one) and the
  tail of ranks [k, k+w) that the fetch pipeline warm-inserts.
- **MLA**: prefill runs the non-absorbed form and emits the latent entry
  (c_kv, k_rope); decode runs the absorbed form over fetched entries,
  its softmax core through ``ops.batched_sparse_mla`` (the sparse
  attention kernel on the card).
- **GQA**: a pool entry is the token's stacked (roped k, v), laid out
  ``[2, n_kv, hd]``; decode attends over fetched entries through
  ``ops.batched_sparse_gqa`` (the GQA sparse attention kernel on the
  card).  The reference's einsum form is only the tests' oracle.

Over a tensor-parallel rank (a config view with ``tp``,
``distributed/tp.py``) each function runs on the rank's weight blocks:
the indexer's q columns are all-gathered (its keys and weights are
whole, so every rank scores its pool rows with every head); MLA absorbs
and attends with the rank's whole heads over the whole latent entries
(``w_dq``, ``w_dkv`` and the norms are whole); GQA's pool entry is
whole (k / v columns all-gathered) and the rank attends with its heads
over their KV heads, or with every head where its q columns are not
whole heads (``tp.gqa_layout``).  ``wo`` is then a row block, and one
all-reduce sums the ranks' outputs.  Every product with a weight whose
d_model rows may be split (``w_dq``, ``w_dkv``, the indexer's, q / k /
v, ``wo``) goes through ``tp.matmul``.

With the residual split over the sequence (``tp.seq``, prefill and the
training forward) MLA's down-projections, its norms and the indexer's
keys run on the rank's block: its latent entries and keys are its slice
of the pool.  The latent entries (576 wide, not the d_model-wide
residual) and ``mla_q_proj``'s low-rank ``cq`` are all-gathered for the
up-projections, and ``wo`` reduce-scatters back to the block.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.tp import mla_heads, tp_of
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, apply_rope, attn_out,
                                       blocked_causal_attention,
                                       gather_kv_cols, gather_q_cols,
                                       rank_kv_heads, rms_norm, top_k)

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


def indexer_keys(p, x, cfg=None) -> torch.Tensor:
    """Per-token indexer keys. x: [..., D] -> [..., d_idx] (the rank's
    block of the sequence where the residual is split)."""
    if cfg is None:
        return x @ p["wk_idx"]
    tp = tp_of(cfg)
    return tp.matmul(x, tp.on_slice(p["wk_idx"]), ("D", "C"),
                     (cfg.d_model, cfg.sac.d_idx))


def indexer_scores(p, xq, idx_keys, cfg) -> torch.Tensor:
    """Score all cached positions against the current query token.

    xq: [B, D]; idx_keys: [B, S, d_idx] -> scores [B, S] (f32).
    """
    B = xq.shape[0]
    d, ni, di = cfg.d_model, cfg.sac.n_idx_heads, cfg.sac.d_idx
    tp = tp_of(cfg)
    q = tp.all_gather(tp.matmul(xq, p["wq_idx"], ("D", "H"), (d, ni * di)),
                      tp.split(("D", "H"), (d, ni * di), 1).axes)
    q = q.reshape(B, ni, di).float()
    w = tp.matmul(xq, p["w_w"], ("D", "C"), (d, ni)).float()    # [B, ni]
    return ops.batched_indexer_scores(q, w, idx_keys)


def _masked(scores: torch.Tensor, cache_len: torch.Tensor) -> torch.Tensor:
    """Scores with positions >= cache_len set to NEG_INF."""
    pos = torch.arange(scores.shape[-1], dtype=torch.int32,
                       device=scores.device)
    return torch.where(pos[None, :] < cache_len[:, None], scores, NEG_INF)


def topk_select(scores: torch.Tensor, cache_len: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask positions >= cache_len, take top-k.

    scores: [B, S]; cache_len: [B] -> (idx [B, k] int32, valid [B, k]).
    """
    S = scores.shape[-1]
    top_scores, idx = top_k(_masked(scores, cache_len), min(k, S))
    valid = top_scores > NEG_INF / 2
    # position-sort the selected set (invalid lanes pushed last): with
    # k >= context the sparse decode is then bit-exact vs dense
    return _position_sort(idx.to(torch.int32), valid, S)


def _position_sort(idx: torch.Tensor, valid: torch.Tensor, S: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort a selected set by position (invalid lanes pushed last)."""
    order = torch.argsort(torch.where(valid, idx, S), dim=-1, stable=True)
    return idx.gather(-1, order), valid.gather(-1, order)


def _spec_tail(top_scores, idx, k: int, width: int,
               score_margin: float = -1.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranks [k, k+width) of a top-(k+width) result, padded to width.

    ``score_margin >= 0`` switches the tail from a pure rank window to
    score-threshold selection: a tail entry qualifies while its score
    is within ``margin * (s_max - s_k)`` of the k-th demand score
    ``s_k``.  A negative margin keeps the rank window.
    """
    lo = min(k, idx.shape[-1])
    tail_idx = idx[..., lo:].to(torch.int32)
    tail_scores = top_scores[..., lo:]
    tail_valid = tail_scores > NEG_INF / 2
    if score_margin >= 0 and lo > 0:
        s_max = top_scores[..., :1]
        s_k = top_scores[..., lo - 1:lo]
        thr = s_k - score_margin * (s_max - s_k)
        tail_valid = tail_valid & (tail_scores >= thr)
    pad = width - tail_idx.shape[-1]
    if pad > 0:
        tail_idx = F.pad(tail_idx, (0, pad))
        tail_valid = F.pad(tail_valid, (0, pad))
    return tail_idx, tail_valid


def speculate_next_topk(scores: torch.Tensor, cache_len: torch.Tensor,
                        k: int, width: int, score_margin: float = -1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative next-step candidates: ranks [k, k+width) of this
    step's indexer scores (the likeliest entrants of the next step's
    top-k).  scores: [B, S] -> (idx [B, width] int32, valid [B, width]).
    Used when the demand selection is injected (``topk_fn``); the decode
    path otherwise fuses both into :func:`topk_select_with_tail`."""
    S = scores.shape[-1]
    top_scores, idx = top_k(_masked(scores, cache_len), min(k + width, S))
    return _spec_tail(top_scores, idx, k, width, score_margin)


def topk_select_with_tail(scores: torch.Tensor, cache_len: torch.Tensor,
                          k: int, width: int, score_margin: float = -1.0):
    """Fused demand top-k + speculation tail: one ``top_k(k+width)``.

    ``top_k`` orders by (score desc, index asc), so the first ``min(k,
    S)`` lanes are exactly :func:`topk_select`'s set; position-sorted
    the same way, the demand half is bit-identical to the unfused path.
    ``score_margin`` applies to the tail only.  Returns ``(idx [B,
    min(k,S)], valid, tail_idx [B, width], tail_valid)``.
    """
    S = scores.shape[-1]
    kk = min(k + width, S)
    top_scores, idx = top_k(_masked(scores, cache_len), kk)
    lo = min(k, kk)
    d_idx, d_valid = _position_sort(idx[..., :lo].to(torch.int32),
                                    top_scores[..., :lo] > NEG_INF / 2, S)
    return d_idx, d_valid, *_spec_tail(top_scores, idx, k, width,
                                       score_margin)


def budget_mask(valid: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """Cap a best-first speculation candidate set to a per-request
    granted budget: valid [B, w], budget [B] (the arbiter's widths) ->
    only the first ``budget[b]`` lanes survive.  Demand selection never
    flows through this mask."""
    lanes = torch.arange(valid.shape[-1], dtype=torch.int32,
                         device=valid.device)
    return valid & (lanes[None, :] < budget[:, None].to(torch.int32))


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
    """x: [B(, S), D] -> q_nope [B(,S),nh,hd], q_pe [B(,S),nh,dr] (roped);
    nh the rank's heads (``mla_heads``).  With the residual split over
    the sequence ``x`` is the rank's block: ``cq`` is made and normed on
    it, then gathered whole (``positions``: the whole sequence's)."""
    split, nh = mla_heads(cfg)
    hd, dr = cfg.hd, cfg.qk_rope_dim
    tp = tp_of(cfg)
    cq = tp.matmul(x, tp.on_slice(p["w_dq"]), ("D", "C"),
                   (cfg.d_model, cfg.q_lora_rank))
    cq = tp.gather_seq(rms_norm(cq, tp.on_slice(p["q_norm_g"])), split.axes)
    lead = cq.shape[:-1]
    q = (cq @ p["w_uq"]).reshape(*lead, nh, hd + dr)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def mla_kv_entry(p, x, cfg, positions):
    """Latent cache entry per token: [.., dc+dr] (c_kv normed, k_pe roped);
    on the rank's block of the sequence where the residual is split."""
    dc = cfg.kv_lora_rank
    tp = tp_of(cfg)
    kv = tp.matmul(x, tp.on_slice(p["w_dkv"]), ("D", "C"),
                   (cfg.d_model, dc + cfg.qk_rope_dim))
    c = rms_norm(kv[..., :dc], tp.on_slice(p["kv_norm_g"]))
    k_pe = apply_rope(kv[..., dc:], positions, cfg.rope_theta)
    return torch.cat([c, k_pe], dim=-1)


def mla_prefill_attention(p, x, cfg, positions, *, chunk: int = 1024):
    """Non-absorbed MLA over a full sequence (prefill).

    x: [B, S, D] -> (out [B, S, D], cache_entries [B, S, dc+dr]); with the
    residual split over the sequence, ``x``, ``out`` and the entries are
    the rank's block (``positions``: the whole sequence's).
    """
    split, nh = mla_heads(cfg)
    hd, dr, dc = cfg.hd, cfg.qk_rope_dim, cfg.kv_lora_rank
    tp = tp_of(cfg)
    q_nope, q_pe = mla_q_proj(p, x, cfg, positions)
    entry = mla_kv_entry(p, x, cfg, tp.own_seq(positions))
    ranked = tp.gather_seq(entry, split.axes)    # used by the rank's heads
    B, S = ranked.shape[:2]
    c, k_pe = ranked[..., :dc], ranked[..., dc:]
    k_nope = (c @ p["w_uk"]).reshape(B, S, nh, hd)
    v = (c @ p["w_uv"]).reshape(B, S, nh, hd)
    k_pe_b = k_pe[:, :, None, :].expand(B, S, nh, dr)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe_b], dim=-1)
    # pad v with zeros so q/k/v share the last dim for the blocked loop
    v_pad = torch.cat([v, v.new_zeros(B, S, nh, dr)], dim=-1)
    out = blocked_causal_attention(q, k, v_pad, chunk=chunk)[..., :hd]
    return tp.matmul(out.reshape(B, S, nh * hd), p["wo"], ("H", "D"),
                     (cfg.n_heads * hd, cfg.d_model), split.axes,
                     scatter=True), entry


def mla_absorbed_decode(p, xq, cfg, fetched, valid, positions):
    """Absorbed MLA decode over fetched latent entries.

    xq: [B, D]; fetched: [B, k, dc+dr]; valid: [B, k] bool;
    positions: [B] -> out [B, D].  The softmax core runs in
    ``ops.batched_sparse_mla``; the absorption, the ``w_uv``
    up-projection and ``wo`` are f32/bf16 matmuls as in the reference.
    """
    B = xq.shape[0]
    split, nh = mla_heads(cfg)
    hd, dr, dc = cfg.hd, cfg.qk_rope_dim, cfg.kv_lora_rank
    q_nope, q_pe = mla_q_proj(p, xq, cfg, positions)          # [B,nh,hd|dr]
    w_uk = p["w_uk"].reshape(dc, nh, hd)
    # absorb: q_lat[b,h,c] = sum_d q_nope[b,h,d] * w_uk[c,h,d]
    q_lat = torch.einsum("bhd,chd->bhc", q_nope.float(), w_uk.float())
    o_lat = ops.batched_sparse_mla(q_lat, q_pe.float(), fetched, valid,
                                   dc=dc, scale=1.0 / math.sqrt(hd + dr))
    w_uv = p["w_uv"].reshape(dc, nh, hd)
    out = torch.einsum("bhc,chd->bhd", o_lat, w_uv.float())
    return tp_of(cfg).matmul(out.reshape(B, nh * hd).to(xq.dtype), p["wo"],
                             ("H", "D"), (cfg.n_heads * hd, cfg.d_model),
                             split.axes)


# ---------------------------------------------------------------------------
# GQA sparse / dense decode over pool entries
# ---------------------------------------------------------------------------


def gqa_entry_dim(cfg) -> int:
    return 2 * cfg.n_kv_heads * cfg.hd


def gqa_kv_entry(p, x, cfg, positions):
    """Pool entry for GQA archs: stacked (roped k, v) [.., 2*nkv*hd],
    laid out as the decode side's ``reshape(B, k, 2, nkv, hd)``; whole
    on a tensor-parallel rank (its k / v columns all-gathered)."""
    lead = x.shape[:-1]
    nkv, hd = cfg.n_kv_heads, cfg.hd
    tp, shape = tp_of(cfg), (cfg.d_model, nkv * hd)
    k = tp.matmul(x, p["wk"], ("D", "KV"), shape)
    v = tp.matmul(x, p["wv"], ("D", "KV"), shape)
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k, v = gather_kv_cols(cfg, k, v)
    k, v = k.reshape(*lead, nkv, hd), v.reshape(*lead, nkv, hd)
    return pack_kv_entry(apply_rope(k, positions, cfg.rope_theta), v)


def pack_kv_entry(k, v):
    """[.., S, nkv, hd] k/v (k already roped) -> [.., S, 2*nkv*hd]."""
    lead = k.shape[:-2]
    nkv, hd = k.shape[-2:]
    return torch.stack([k, v], dim=-3).reshape(*lead, 2 * nkv * hd)


def gqa_q_proj(p, x, cfg, positions):
    """x: [.., D] -> the rank's roped q heads [.., heads, hd]."""
    lead = x.shape[:-1]
    q = tp_of(cfg).matmul(x, p["wq"], ("D", "H"),
                          (cfg.d_model, cfg.n_heads * cfg.hd))
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = gather_q_cols(cfg, q)
    q = q.reshape(*lead, q.shape[-1] // cfg.hd, cfg.hd)
    return apply_rope(q, positions, cfg.rope_theta)


def gqa_sparse_decode(p, xq, cfg, fetched, valid, positions):
    """GQA attention over fetched top-k entries.

    xq: [B, D]; fetched: [B, k, 2*nkv*hd]; valid: [B, k] -> [B, D].  The
    softmax core runs in ``ops.batched_sparse_gqa``; q and ``wo`` are
    bf16 matmuls as in the reference.  A tensor-parallel rank attends
    with its heads over the entries cut to their KV heads."""
    B, k = fetched.shape[:2]
    nkv, hd = cfg.n_kv_heads, cfg.hd
    q = gqa_q_proj(p, xq, cfg, positions)                      # [B,nh,hd]
    ent = rank_kv_heads(cfg, fetched.reshape(B, k, 2, nkv, hd), 3)
    n_kv = ent.shape[3]
    if n_kv != nkv:
        fetched = ent.reshape(B, k, 2 * n_kv * hd)
    out = ops.batched_sparse_gqa(q, fetched, valid, n_kv=n_kv)
    return attn_out(p, out.reshape(B, q.shape[1] * hd).to(xq.dtype), cfg)


def gqa_dense_decode(p, xq, cfg, pool_layer, cache_len, positions):
    """Dense GQA decode over the full pool slice (the full-prefetch
    baseline).  pool_layer: [B, S, 2*nkv*hd]."""
    S = pool_layer.shape[1]
    valid = (torch.arange(S, dtype=torch.int32, device=pool_layer.device)
             [None, :] < cache_len[:, None])
    return gqa_sparse_decode(p, xq, cfg, pool_layer, valid, positions)


def mla_dense_decode(p, xq, cfg, pool_layer, cache_len, positions):
    """Dense absorbed-MLA decode over the full latent pool slice."""
    S = pool_layer.shape[1]
    valid = (torch.arange(S, dtype=torch.int32, device=pool_layer.device)
             [None, :] < cache_len[:, None])
    return mla_absorbed_decode(p, xq, cfg, pool_layer, valid, positions)
