"""Whisper-style encoder-decoder with SAC on the cross-attention KV
(``repro/models/encdec.py``).

The conv frontend is a stub: the model takes precomputed frame
embeddings [B, S_enc, D].  The encoder is full bidirectional attention;
the decoder is causal self-attention (at most ``MAX_DEC`` = 448
positions) plus cross-attention over the encoder output.

SAC applies to the cross-attention KV, the long side (32K frames):
``prefill`` encodes and writes each decoder layer's cross-KV entries
(stacked k, v; no RoPE: positions 0 make the rotation the identity) and
indexer keys into the pool; each ``decode`` step, per decoder layer:

  self-attention over the decoder's own cache ``self_kv`` [L, B, 448, d]
  plus the token's entry (``core/sac.py::dense_attend``: the GQA kernel
  over 449 lanes), then, in ``sac`` mode, indexer scores over the
  encoder pool (the indexer kernel) -> masked top-k (or ``topk_fn``) ->
  ``fetch_fn`` (the gather kernel) -> GQA attention over the k fetched
  entries, with no own lane (the GQA kernel); in ``dense`` mode the GQA
  attention over the whole pool; then the MLP.

After the last layer one ``core/pool.py::pool_write`` puts every layer's
self entry into ``self_kv`` at ``dec_len`` (one decode-write launch on
the card), and ``dec_len`` grows by one.  As in the reference there is
no hot tier, no prefetch and no new encoder entry at decode (the
reference also builds a zero ``cross_own`` entry it never uses; the port
does not build it).  Unlike the reference, which stores ``topk_fn`` and
never calls it, the port calls ``topk_fn(scores, cache_len) -> (idx,
valid)`` in place of the top-k when one is given, the hook the tests
use to hold both packages to one selection.

Over a pool sharded over ranks (``fetch_fn`` from ``make_pooled_fetch``)
the cross-KV pools are each rank's slice of the encoder positions (cut
by ``distributed/sharding.py::shard_serve_state``) and ``self_kv`` is
whole on every rank, as the reference's ``P(None, b, None, None)``.

``prefill`` and ``decode`` update nothing of the caller's and run under
``torch.no_grad``; ``forward`` (training) runs under autograd, each
layer under ``torch.utils.checkpoint`` when ``remat`` is on.

Under ``sharding.use_rules(rules, mesh)`` ``forward``, ``prefill`` and
``decode`` run on this rank's block of every weight through a
``distributed/tp.py::RankView`` of the config (``rank_cfg``), as the
decoder-only models do: a vocab-parallel embedding and column-parallel
logits, the encoder's and the cross-attention's ``bidir_attention`` in
f32 on the rank's heads (q all-gathered where its block is not whole
heads, k and v whole), ``wo`` and the MLP's ``w_down`` row blocks summed
over their axes, and the decoder's self-attention and SAC
cross-attention through the GQA decode of ``models/dsa.py`` on the
rank's heads.  ``self_kv`` stays whole on every rank of ``model``, as
the reference keeps it; each rank writes its lanes' new entries.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sac as sac_core
from repro_torch.core.pool import FetchFn, local_fetch, pool_write
from repro_torch.models import dsa
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.tp import gqa_layout, rank_view, tp_of
from repro_torch.models.layers import (DTYPE, ParamSpec, attn_out,
                                       attn_param_specs,
                                       dense_attention_block, gather_kv_cols,
                                       gather_q_cols, init_params, mlp_block,
                                       mlp_param_specs, rank_kv_heads,
                                       repeat_kv, rms_norm)
from repro_torch.models.transformer import (_span, embed_of, logits_of,
                                            run_layer)

MAX_DEC = 448  # whisper decoder context

# the largest [B, H, rows, c] f32 score block ``bidir_attention`` makes
_SCORE_BLOCK_BYTES = 2 << 30


def bidir_attention(q, k, v, *, chunk: int = 1024) -> torch.Tensor:
    """Non-causal attention (encoder / cross) with an online softmax over
    KV chunks, in f32.  q: [B, Sq, H, hd]; k, v: [B, Sk, H, hd] (k/v
    already head-repeated; Sq may differ from Sk) -> [B, Sq, H, hd].

    Sk is cut into ``max(Sk // chunk, 1)`` equal chunks, as the
    reference cuts it, so Sk must divide into them.  The query axis is
    cut into blocks whose [B, H, rows, c] score block stays within
    ``_SCORE_BLOCK_BYTES``; each query row sees the same chunks in the
    same order, so its sums are the reference's."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n_chunks = max(Sk // chunk, 1)
    c = Sk // n_chunks
    if c * n_chunks != Sk:
        raise ValueError(f"bidir_attention: {Sk} key positions do not "
                         f"divide into {n_chunks} chunks of {c} "
                         f"(max(Sk // {chunk}, 1) equal chunks)")
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).transpose(1, 2)                   # [B,H,Sq,hd]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    rows = max(1, _SCORE_BLOCK_BYTES // (B * H * c * 4))
    outs = []
    for q0 in range(0, Sq, rows):
        qb = qf[:, :, q0:q0 + rows]
        n = qb.shape[2]
        m = torch.full((B, H, n), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, n, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(n_chunks):
            kj, vj = kf[:, :, j * c:(j + 1) * c], vf[:, :, j * c:(j + 1) * c]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kj)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                       p, vj)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 2)
    return out.transpose(1, 2).to(q.dtype)


def _norm(cfg):
    return ParamSpec((cfg.d_model,), ("G",), init="ones")


def encdec_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's specs with each stacked layer axis a list: ``enc``
    (``n_enc_layers`` dicts) and ``dec`` (``n_layers`` dicts; ``idx``
    when SAC is on)."""
    def enc_layer():
        return {"ln1": _norm(cfg), "ln2": _norm(cfg),
                "attn": attn_param_specs(cfg), "mlp": mlp_param_specs(cfg)}

    def dec_layer():
        p = {"ln1": _norm(cfg), "ln2": _norm(cfg), "ln3": _norm(cfg),
             "self_attn": attn_param_specs(cfg),
             "cross_attn": attn_param_specs(cfg),
             "mlp": mlp_param_specs(cfg)}
        if cfg.sac.enabled:
            p["idx"] = dsa.indexer_param_specs(cfg)
        return p

    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("V", "D")),
        "enc": [enc_layer() for _ in range(cfg.n_enc_layers)],
        "dec": [dec_layer() for _ in range(cfg.n_layers)],
        "final_norm": _norm(cfg),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("D", "V")),
    }


def _attend(p, xq, xkv, cfg):
    """Non-causal attention of ``xq``'s positions over ``xkv``'s (the
    encoder's self-attention, the training forward's cross-attention),
    no RoPE -> [B, Sq, D].  Over a tensor-parallel rank: its q heads (all
    heads where its q block is not whole heads), k and v whole, ``wo``'s
    row block summed (``layers.attn_out``)."""
    B, Sq, d = xq.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tp, lay = tp_of(cfg), gqa_layout(cfg)
    xq_r = tp.enter(xq, lay.q.axes)
    xkv_r = (xq_r if xkv is xq and lay.kv.axes == lay.q.axes
             else tp.enter(xkv, lay.kv.axes))
    q = tp.matmul(xq_r, p["wq"], ("D", "H"), (d, nh * hd))
    k = tp.matmul(xkv_r, p["wk"], ("D", "KV"), (d, nkv * hd))
    v = tp.matmul(xkv_r, p["wv"], ("D", "KV"), (d, nkv * hd))
    q = gather_q_cols(cfg, q)
    k, v = gather_kv_cols(cfg, k, v)
    q = q.reshape(B, Sq, q.shape[-1] // hd, hd)
    k = rank_kv_heads(cfg, k.reshape(B, -1, nkv, hd))
    v = rank_kv_heads(cfg, v.reshape(B, -1, nkv, hd))
    n_rep = q.shape[2] // k.shape[2]
    out = bidir_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))
    return attn_out(p, out.reshape(B, Sq, q.shape[2] * hd), cfg)


def _enc_layer(p, x, cfg):
    xn = rms_norm(x, p["ln1"])
    x = x + _attend(p["attn"], xn, xn, cfg)
    return x + mlp_block(p["mlp"], rms_norm(x, p["ln2"]), cfg)


def _dec_layer(p, x, enc_out, cfg, positions):
    """One decoder layer of the training forward: causal self-attention,
    full cross-attention over ``enc_out``, MLP."""
    h, _ = dense_attention_block(p["self_attn"], rms_norm(x, p["ln1"]), cfg,
                                 positions)
    x = x + h
    x = x + _attend(p["cross_attn"], rms_norm(x, p["ln2"]), enc_out, cfg)
    return x + mlp_block(p["mlp"], rms_norm(x, p["ln3"]), cfg)


class EncDecLM:
    """Whisper-small.  Modality frontend stubbed to frame embeddings."""

    def __init__(self, cfg: ModelConfig, fetch_fn: FetchFn = local_fetch,
                 mode: str = "sac", topk_fn: Optional[Callable] = None,
                 remat: bool = True, opts: Optional[Dict] = None,
                 device="cuda"):
        self.cfg = cfg
        self.opts = dict(opts or {})
        self._views: Dict[Any, Any] = {}   # tensor parallelism
        self.device = torch.device(device)
        self.fetch_fn = fetch_fn
        # a cross-KV pool sharded over ranks (core/pool.py::
        # make_pooled_fetch): ``kv_pool`` / ``idx_pool`` hold the rank's
        # slice of the encoder positions, ``self_kv`` stays whole
        self.shard = getattr(fetch_fn, "shard", None)
        self.mode = mode if cfg.sac.enabled else "dense"
        self.topk_fn = topk_fn
        self.remat = remat
        self.n_kv = cfg.n_layers          # cross-KV pool layers
        self.kv_dim = dsa.gqa_entry_dim(cfg)
        self.specs = encdec_param_specs(cfg)

    def rank_cfg(self):
        """The config this rank runs (``TransformerLM.rank_cfg``)."""
        return rank_view(self.cfg, self._views, self.opts.get("batch_axes"))

    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters drawn from ``generator`` on the model's
        device, one tensor at a time in its own dtype."""
        return init_params(self.specs, generator, self.device)

    def param_shapes(self) -> Dict:
        """The parameters as empty ``meta`` tensors (the dry-run's); under
        ``use_rules(rules, mesh)`` this rank's blocks."""
        return shd.map_specs(lambda _, s: torch.empty(
            shd.block_shape(s) if shd._mesh() is not None else s.shape,
            dtype=s.dtype, device="meta"), self.specs, self.specs)

    # -- encoder -------------------------------------------------------------
    def encode(self, params, frames, cfg=None) -> torch.Tensor:
        """frames [B, S_enc, D] (stubbed frontend output) -> [B, S_enc, D]."""
        cfg = cfg or self.rank_cfg()
        x = frames.to(DTYPE)
        for p in params["enc"]:
            x = run_layer(self.remat, _enc_layer, p, x, cfg)
        return x

    def _cross_entry(self, p_dec, enc_out, cfg):
        """A decoder layer's cross-KV entries of the encoder output (no
        RoPE: positions 0)."""
        zero_pos = torch.zeros(enc_out.shape[:-1], dtype=torch.int32,
                               device=enc_out.device)
        return dsa.gqa_kv_entry(p_dec["cross_attn"], enc_out, cfg, zero_pos)

    # -- training forward ------------------------------------------------------
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch {frames [B,S,D], tokens [B,S_dec]} -> (logits [B, S_dec,
        V] f32, aux f32 0)."""
        cfg = self.rank_cfg()
        enc_out = self.encode(params, batch["frames"], cfg)
        tokens = batch["tokens"]
        B, Sd = tokens.shape
        x = embed_of(params, tokens, cfg)
        positions = torch.arange(Sd, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(B, Sd)
        for p in params["dec"]:
            x = run_layer(self.remat, _dec_layer, p, x, enc_out, cfg,
                          positions)
        return logits_of(params, x, cfg), torch.zeros((), device=x.device)

    # -- prefill: encode + populate the cross-KV pool ----------------------------
    @torch.no_grad()
    def prefill(self, params, frames, lengths=None):
        """frames [B, S_enc, D] -> (serve_state, logits [B, V] zeros): the
        encoder's cross-KV entries of every decoder layer in ``kv_pool``
        and, in SAC mode, their indexer keys in ``idx_pool``; the
        decoder starts empty (``dec_len`` 0)."""
        cfg = self.rank_cfg()
        B, S_enc, _ = frames.shape
        dev = frames.device
        if lengths is None:
            lengths = torch.full((B,), S_enc, dtype=torch.int32, device=dev)
        enc_out = self.encode(params, frames, cfg)
        state = self._empty_state(B, S_enc, dev)
        for layer, p in enumerate(params["dec"]):
            state["kv_pool"][layer] = self._cross_entry(p, enc_out, cfg)
            if "idx_pool" in state:
                state["idx_pool"][layer] = dsa.indexer_keys(p["idx"],
                                                            enc_out, cfg)
        state["cache_len"] = lengths.to(torch.int32)
        return state, torch.zeros((B, cfg.vocab), dtype=torch.float32,
                                  device=dev)

    # -- decode: self-attn (local dense) + SAC cross-attn ------------------------
    def _layer_decode(self, p, x, kv_l, ik_l, skv_l, dec_len, cache_len,
                      bufs=None, cfg=None):
        """One decoder layer's step: (x', the token's self entry).

        Over a sharded pool the indexer scores the rank's slice; the
        scores are all-gathered before the selection (a ``topk_fn`` with
        ``local_scores`` takes the slice's instead), the chosen entries
        come through the pooled fetch, and ``dense`` mode all-gathers the
        layer (``PoolShard.gather_pool`` into ``bufs``)."""
        cfg = cfg or self.cfg
        # 1) causal self-attention over the decoder cache
        xn = rms_norm(x, p["ln1"])
        own = dsa.gqa_kv_entry(p["self_attn"], xn, cfg, dec_len)
        x = x + sac_core.dense_attend(p["self_attn"], xn, cfg, skv_l,
                                      dec_len, dec_len, own)
        # 2) SAC cross-attention over the encoder pool (positions 0)
        xn = rms_norm(x, p["ln2"])
        zero_pos = torch.zeros_like(dec_len)
        shard = self.shard
        if self.mode == "sac":
            scores = dsa.indexer_scores(p["idx"], xn, ik_l, cfg)
            local_sel = getattr(self.topk_fn, "local_scores", False)
            if local_sel and shard is None:
                raise ValueError("a top-k over local scores needs the "
                                 "pooled fetch")
            if shard is not None and not local_sel:
                scores = shard.all_gather(scores)
            if self.topk_fn is not None:
                idx, valid = self.topk_fn(scores, cache_len)
            else:
                idx, valid = dsa.topk_select(scores, cache_len, cfg.sac.topk)
            entries = self.fetch_fn(kv_l, idx)
        else:
            if shard is not None:
                kv_l = shard.gather_pool(kv_l, bufs)
            pos = torch.arange(kv_l.shape[1], dtype=torch.int32,
                               device=x.device)
            valid = pos[None, :] < cache_len[:, None]
            entries = kv_l
        x = x + dsa.gqa_sparse_decode(p["cross_attn"], xn, cfg, entries,
                                      valid, zero_pos)
        # 3) MLP
        h = rms_norm(x, p["ln3"])[:, None, :]
        return x + mlp_block(p["mlp"], h, cfg)[:, 0], own

    @torch.no_grad()
    def decode(self, params, state, tokens):
        """One decoder step.  tokens [B] -> (state, logits [B, V]); the
        state dict is updated IN PLACE (``self_kv``, ``dec_len``).  Each
        decoder layer is a ``pool_layer`` profiler range while a
        profiler records (``transformer.DECODE_SPANS``)."""
        cfg = self.rank_cfg()
        x = embed_of(params, tokens, cfg)
        dec_len = state["dec_len"]
        kv_pool, idx_pool = state["kv_pool"], state.get("idx_pool")
        self_kv = state["self_kv"]               # [L, B, MAX_DEC, d]
        owns, bufs = [], {}
        for layer, p in enumerate(params["dec"]):
            with _span("pool_layer"):
                x, own = self._layer_decode(
                    p, x, kv_pool[layer],
                    idx_pool[layer] if idx_pool is not None else None,
                    self_kv[layer], dec_len, state["cache_len"], bufs, cfg)
            owns.append(own)
        pool_write(self_kv, torch.stack(owns), dec_len)
        state["dec_len"] = dec_len + 1
        return state, logits_of(params, x, cfg)

    # -- state ---------------------------------------------------------------------
    def _empty_state(self, batch: int, seq_len: int, device) -> Dict:
        cfg = self.cfg
        i32 = dict(dtype=torch.int32, device=device)
        state: Dict[str, Any] = {
            "cache_len": torch.zeros((batch,), **i32),
            "dec_len": torch.zeros((batch,), **i32),
            "self_kv": torch.zeros((cfg.n_layers, batch, MAX_DEC,
                                    self.kv_dim), dtype=DTYPE, device=device),
            "kv_pool": torch.zeros((self.n_kv, batch, seq_len, self.kv_dim),
                                   dtype=DTYPE, device=device),
        }
        if cfg.sac.enabled and self.mode == "sac":
            state["idx_pool"] = torch.zeros(
                (self.n_kv, batch, seq_len, cfg.sac.d_idx), dtype=DTYPE,
                device=device)
        return state

    def init_serve_state(self, batch: int, seq_len: int,
                         device_buffer: int = 0) -> Dict:
        """Zero serve state on the model's device (``device_buffer`` is
        ignored: the decoder's cross-attention has no hot tier)."""
        return self._empty_state(batch, seq_len, self.device)

    def serve_state_shapes(self, batch: int, seq_len: int,
                           device_buffer: int = 0) -> Dict:
        """The zero serve state's tree on ``meta`` (nothing allocated;
        ``device_buffer`` ignored, as in ``init_serve_state``)."""
        return self._empty_state(batch, seq_len, torch.device("meta"))
