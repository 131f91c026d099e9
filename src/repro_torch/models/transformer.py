"""Decoder-only LM assembly (``repro/models/transformer.py``): the MLA
segments (``mla_dense``, ``mla_moe``: DeepSeek-V3.2), the GQA segments
(``dense``, ``moe``: Qwen2, MiniCPM, Granite, Chameleon, Mixtral, DBRX;
sliding window where the config has one) and Gemma3's ``lg_super``
(super-blocks of ``local_global_ratio`` local layers with the window
``local_window``, then one global layer).

A model is a list of segments; where the reference scans stacked
parameters with ``lax.scan``, the port loops over a list of per-layer
parameter dicts in pool-layer order (an ``lg_super`` segment's list is
super-block i's local layers 0..r-1 then its global layer, for each i:
layer ``(r + 1) i + j``), and each layer takes its window from
``kv_layer_windows``.  Entry points:

  ``prefill`` -- the prompt forward, emitting the SAC pool (latent
                 entries + indexer keys) and, with the ``warmup_w`` opt,
                 each layer's warm-up candidates (``warm_idx``);
  ``decode``  -- one token per request over the pool: indexer -> top-k
                 -> fetch (the gather kernel, or ``fetch_fn``) -> sparse
                 attention -> MLP or MoE, then the write-back of the new
                 entries (the scatter kernel); with the ``prefetch_width``
                 opt and a hot tier, the speculated entrants are fetched
                 and warm-inserted too.

``decode`` updates the serve state IN PLACE (pools, hot tier) and
returns the same dict.  With ``kv_quant="fp8"`` the pool and the hot
tier hold ``float8_e4m3fn`` entries (cast by ``core/pool.py::
to_kv_dtype``) and the indexer pool stays bf16, as in the reference.
Other segment kinds raise ``NotImplementedError`` naming their ROADMAP
item.  f32 products assume ``torch.backends.cuda.matmul.allow_tf32 =
False`` (PyTorch's default, set by the engine).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hisparse
from repro_torch.core import sac as sac_core
from repro_torch.core.pool import (E4M3, FetchFn, local_fetch,
                                   pool_write_step, to_kv_dtype)
from repro_torch.models import dsa, moe
from repro_torch.models.layers import (DTYPE, ParamSpec, attn_param_specs,
                                       dense_attention_block, init_params,
                                       mlp_block, mlp_param_specs, rms_norm,
                                       top_k)

_PORTED_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "lg_super")
_OTHER_FAMILIES = ("segment kind {!r} waits for its slice (ROADMAP: module "
                   "item 'The other model families')")


# ---------------------------------------------------------------------------
# segment descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    n: int                 # layers (the reference's scan length)
    kv_per_iter: int       # pool (attention) layers per iteration
    window: int = 0        # sliding window for this segment's attn layers


def build_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.xlstm:
        assert cfg.n_layers % 4 == 0, "xlstm stacks groups of 3 mLSTM + 1 sLSTM"
        return [Segment("xlstm_super", cfg.n_layers // 4, 0)]
    if cfg.ssm_state:  # zamba2 hybrid
        period = cfg.shared_attn_every
        n_super = cfg.n_layers // period
        tail = cfg.n_layers - n_super * period
        segs = [Segment("zamba_super", n_super, 1)]
        if tail:
            segs.append(Segment("mamba_tail", tail, 0))
        return segs
    if cfg.local_global_ratio:  # gemma3
        period = cfg.local_global_ratio + 1
        assert cfg.n_layers % period == 0
        return [Segment("lg_super", cfg.n_layers // period, period,
                        window=cfg.local_window)]
    if cfg.mla:
        return [Segment("mla_moe" if cfg.n_experts else "mla_dense",
                        cfg.n_layers, 1)]
    if cfg.n_experts:
        return [Segment("moe", cfg.n_layers, 1, window=cfg.sliding_window)]
    return [Segment("dense", cfg.n_layers, 1, window=cfg.sliding_window)]


def n_kv_layers(cfg: ModelConfig) -> int:
    return sum(s.n * s.kv_per_iter for s in build_segments(cfg))


def kv_layer_windows(cfg: ModelConfig) -> List[int]:
    """Sliding window per pool (attention) layer, in pool-layer order
    (0 = full attention).  Length == n_kv_layers(cfg)."""
    wins: List[int] = []
    for seg in build_segments(cfg):
        if not seg.kv_per_iter:
            continue
        if seg.kind == "lg_super":
            per_iter = [cfg.local_window] * cfg.local_global_ratio + [0]
        else:
            per_iter = [seg.window] * seg.kv_per_iter
        wins.extend(per_iter * seg.n)
    return wins


def kv_entry_dim(cfg: ModelConfig) -> int:
    if not cfg.has_attention:
        return 0
    if cfg.mla:
        return cfg.kv_lora_rank + cfg.qk_rope_dim
    return dsa.gqa_entry_dim(cfg)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _norm(cfg):
    return ParamSpec((cfg.d_model,), ("G",), init="ones")


def _attn_layer_specs(cfg) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": _norm(cfg), "ln2": _norm(cfg)}
    p["attn"] = (dsa.mla_param_specs(cfg) if cfg.mla
                 else attn_param_specs(cfg))
    if cfg.sac.enabled:
        p["idx"] = dsa.indexer_param_specs(cfg)
    p["mlp"] = (moe.moe_param_specs(cfg) if cfg.n_experts
                else mlp_param_specs(cfg))
    return p


def segment_specs(seg: Segment, cfg: ModelConfig) -> List[Dict[str, Any]]:
    """One spec dict per layer, in pool-layer order (the reference
    stacks them on a leading [n] axis for its scan; an ``lg_super``
    segment as ``{"local": [n, r, ...], "global": [n, ...]}``)."""
    if seg.kind not in _PORTED_KINDS:
        raise NotImplementedError(_OTHER_FAMILIES.format(seg.kind))
    return [_attn_layer_specs(cfg) for _ in range(seg.n * seg.kv_per_iter)]


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    return {
        "embed": ParamSpec((v, d), ("V", "D"), scale=1.0),
        "segments": [segment_specs(s, cfg) for s in build_segments(cfg)],
        "final_norm": _norm(cfg),
        "lm_head": ParamSpec((d, v), ("D", "V")),
    }


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------


def _mlp_apply(p_mlp, x, cfg, *, groups: int = 1):
    """MLP or MoE on [B, S, D]; returns (out, aux)."""
    if cfg.n_experts:
        return moe.moe_block(p_mlp, x, cfg, groups=groups)
    return mlp_block(p_mlp, x), torch.zeros((), device=x.device)


def _layer_fwd(p, x, cfg, positions, window, groups, warm_w=0):
    """Full (attn + mlp) prefill layer.  Returns (x', entry, idx_keys,
    warm_idx).

    ``warm_idx`` ([B, w] int32, or None when ``warm_w`` is 0) is the
    layer's warm-up candidate set: the top-``w`` prompt positions by
    indexer score against the LAST prompt position (the closest proxy
    for the first decode query), lanes of -1 where masked (outside a
    windowed layer's trailing window).
    """
    xn = rms_norm(x, p["ln1"])
    if cfg.mla:
        out, entry = dsa.mla_prefill_attention(p["attn"], xn, cfg, positions)
    else:
        out, (k, v) = dense_attention_block(p["attn"], xn, cfg, positions,
                                            window=window)
        entry = dsa.pack_kv_entry(k, v)
    idx_keys = dsa.indexer_keys(p["idx"], xn) if cfg.sac.enabled else None
    warm = None
    if warm_w and cfg.sac.enabled:
        scores = dsa.indexer_scores(p["idx"], xn[:, -1], idx_keys, cfg)
        S = scores.shape[-1]
        if window:
            # windowed layers only select from the trailing window
            pos = torch.arange(S, dtype=torch.int32, device=x.device)
            scores = torch.where(pos[None, :] > S - window, scores,
                                 dsa.NEG_INF)
        ws, warm = top_k(scores, min(warm_w, S))
        warm = torch.where(ws > dsa.NEG_INF / 2, warm, -1).to(torch.int32)
    x = x + out
    out, _ = _mlp_apply(p["mlp"], rms_norm(x, p["ln2"]), cfg, groups=groups)
    return x + out, entry, idx_keys, warm


def _attn_decode(p, x, cfg, ctx, kv_slice, idx_slice, window, hbuf=None):
    """One attention layer's decode.  x: [B, D]; kv_slice: [B, S, d].

    Returns (delta [B,D], new_entry [B,d_kv], new_idx_key [B,d_idx],
    new_hbuf, hits [B], misses [B]); the last three are None unless a
    hot-tier state was threaded in.
    """
    xn = rms_norm(x, p["ln1"])
    positions, cache_len = ctx["positions"], ctx["cache_len"]
    own = (dsa.mla_kv_entry(p["attn"], xn, cfg, positions) if cfg.mla
           else dsa.gqa_kv_entry(p["attn"], xn, cfg, positions))
    if ctx["mode"] == "dense" or not cfg.sac.enabled:
        if window:
            delta = sac_core.window_attend(
                p["attn"], xn, cfg, kv_slice, cache_len, positions, own,
                window, fetch_fn=ctx["fetch_fn"])
        else:
            delta = sac_core.dense_attend(p["attn"], xn, cfg, kv_slice,
                                          cache_len, positions, own)
        new_key = torch.zeros((x.shape[0], cfg.sac.d_idx), dtype=DTYPE,
                              device=x.device)
        if hbuf is not None:   # untouched buffer, zero counts
            zero = torch.zeros((x.shape[0],), dtype=torch.int32,
                               device=x.device)
            return delta, own, new_key, hbuf, zero, zero
        return delta, own, new_key, None, None, None
    # SAC path: indexer -> top-k -> fetch -> sparse attention
    new_key = dsa.indexer_keys(p["idx"], xn)
    if hbuf is None:
        delta = sac_core.sparse_attend(
            p["attn"], p["idx"], xn, cfg, kv_slice, idx_slice, cache_len,
            positions, own, fetch_fn=ctx["fetch_fn"],
            topk_fn=ctx["topk_fn"], window=window)
        return delta, own, new_key, None, None, None
    # buffered read-through: bit-identical values, measured residency
    # (prefetch_width > 0 also warm-inserts next-step speculation)
    delta, hbuf, hits, misses = sac_core.sparse_attend(
        p["attn"], p["idx"], xn, cfg, kv_slice, idx_slice, cache_len,
        positions, own, fetch_fn=ctx["fetch_fn"], topk_fn=ctx["topk_fn"],
        window=window, buf_state=hbuf,
        prefetch_width=ctx["prefetch_width"],
        prefetch_fn=ctx["prefetch_fn"], score_margin=ctx["score_margin"],
        pf_budget=ctx["pf_budget"])
    return delta, own, new_key, hbuf, hits, misses


def _layer_decode(p, x, cfg, ctx, kv_slice, idx_slice, window, hbuf=None):
    delta, own, new_key, hbuf2, hits, misses = _attn_decode(
        p, x, cfg, ctx, kv_slice, idx_slice, window, hbuf)
    x = x + delta
    out, _ = _mlp_apply(p["mlp"], rms_norm(x, p["ln2"])[:, None, :], cfg)
    return x + out[:, 0], own, new_key, hbuf2, hits, misses


# ---------------------------------------------------------------------------
# the model facade
# ---------------------------------------------------------------------------


class TransformerLM:
    """Built once per (cfg, fetch_fn, mode, device)."""

    def __init__(self, cfg: ModelConfig, fetch_fn: FetchFn = local_fetch,
                 mode: str = "sac", topk_fn: Optional[Callable] = None,
                 opts: Optional[Dict] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.fetch_fn = fetch_fn
        self.mode = mode if cfg.sac.enabled else "dense"
        self.topk_fn = topk_fn
        self.opts = dict(opts or {})
        self.segments = build_segments(cfg)
        self.specs = model_param_specs(cfg)
        self.n_kv = n_kv_layers(cfg)
        self.kv_dim = kv_entry_dim(cfg)
        self.windows = kv_layer_windows(cfg)     # per pool layer
        # beyond the paper: fp8 pool storage halves the pool's and the
        # hot tier's bytes and the fetch traffic
        self.kv_dtype = E4M3 if cfg.sac.kv_quant == "fp8" else DTYPE

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters drawn from ``generator`` (on the model's
        device), one tensor at a time in its own dtype."""
        return init_params(self.specs, generator, self.device)

    # -- prefill -------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens, lengths=None):
        """tokens [B, S] -> (serve_state, last_logits [B, V]).

        Emits every position's latent entry and indexer key as the pool
        of a fresh serve state; with the ``warmup_w`` opt also
        ``warm_idx`` [L, B, w], the warm-up candidates (popped by the
        engine: not part of the serve state).  Logits are computed for the last
        prompt position only (the reference computes all S and keeps the
        last; the result is the same)."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        x = params["embed"][tokens.long()].to(DTYPE)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev)[None, :].expand(B, S)
        groups = int(self.opts.get("moe_groups", 1))
        warm_w = int(self.opts.get("warmup_w", 0))
        # each layer's entries land in the pool as they are made (no
        # second copy of a long prompt's pool from a stack); every layer
        # of a ported segment kind is an attention layer
        state: Dict[str, Any] = {"kv_pool": torch.empty(
            (self.n_kv, B, S, self.kv_dim), dtype=self.kv_dtype, device=dev)}
        if cfg.sac.enabled:
            state["idx_pool"] = torch.empty(
                (self.n_kv, B, S, cfg.sac.d_idx), dtype=DTYPE, device=dev)
        warms = []
        for layer, p in enumerate(itertools.chain(*params["segments"])):
            x, entry, ik, wm = _layer_fwd(p, x, cfg, positions,
                                          self.windows[layer], groups, warm_w)
            state["kv_pool"][layer] = to_kv_dtype(entry, self.kv_dtype)
            if ik is not None:
                state["idx_pool"][layer] = ik.to(DTYPE)
            warms.append(wm)
        if warms[0] is not None:
            state["warm_idx"] = torch.stack(warms)
        state["cache_len"] = lengths.to(torch.int32)
        last_idx = torch.clamp(lengths.long() - 1, 0, S - 1)
        x_last = x[torch.arange(B, device=dev), last_idx]
        return state, self._logits(params, x_last)

    # -- decode ----------------------------------------------------------------
    @torch.no_grad()
    def decode(self, params, state, tokens, pf_budget=None):
        """One decode step.  tokens [B] -> (state, logits [B, V]); the
        state dict is updated IN PLACE (pools, hot tier, counters).

        ``pf_budget`` ([B] int32 or None) is the step's arbiter-granted
        speculative width per request: it caps the speculation lanes
        each request may warm-insert (traffic only, never tokens)."""
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(DTYPE)
        cache_len = state["cache_len"]
        ctx = {
            "positions": cache_len,       # 0-indexed position of new token
            "cache_len": cache_len,
            "fetch_fn": self.fetch_fn,
            "topk_fn": self.topk_fn,
            "mode": self.mode,
            "prefetch_width": int(self.opts.get("prefetch_width", 0)),
            "prefetch_fn": self.opts.get("prefetch_fn"),
            "score_margin": float(self.opts.get("score_margin", -1.0)),
            "pf_budget": pf_budget,
        }
        kv_pool, idx_pool = state.get("kv_pool"), state.get("idx_pool")
        hot = state.get("hot_buf")
        pf_ins0 = hot.pf_inserted.sum(0) if hot is not None else None
        pf_use0 = hot.pf_used.sum(0) if hot is not None else None
        use_idx = idx_pool is not None and self.mode == "sac"
        new_entries, new_keys, hits_l, misses_l = [], [], [], []
        for layer, p in enumerate(itertools.chain(*params["segments"])):
            hb = (None if hot is None
                  else hisparse.BufferState(*(t[layer] for t in hot)))
            x, own, key, hb2, h, m = _layer_decode(
                p, x, cfg, ctx, kv_pool[layer],
                idx_pool[layer] if use_idx else None, self.windows[layer],
                hb)
            new_entries.append(own)
            new_keys.append(key)
            if hb2 is not None:
                hisparse.store(hb, hb2)
                hits_l.append(h)
                misses_l.append(m)
        if new_entries and kv_pool is not None:
            # one launch writes every layer's entry and indexer key
            pools, rows = [kv_pool], [torch.stack(new_entries)]
            if idx_pool is not None:
                pools.append(idx_pool)
                rows.append(torch.stack(new_keys))
            pool_write_step(pools, rows, cache_len)
        if hot is not None:
            B = tokens.shape[0]
            zeros = torch.zeros((self.n_kv, B), dtype=torch.int32,
                                device=x.device)
            hl = torch.stack(hits_l) if hits_l else zeros
            ml = torch.stack(misses_l) if misses_l else zeros
            state["buf_hits_l"] = hl
            state["buf_misses_l"] = ml
            state["buf_hits"] = hl.sum(0, dtype=torch.int32)
            state["buf_misses"] = ml.sum(0, dtype=torch.int32)
            state["pf_inserted"] = hot.pf_inserted.sum(0) - pf_ins0
            state["pf_useful"] = hot.pf_used.sum(0) - pf_use0
        state["cache_len"] = cache_len + 1
        return state, self._logits(params, x)

    # -- state builders ---------------------------------------------------------
    def init_serve_state(self, batch: int, seq_len: int,
                         device_buffer=0, buffer_width=None) -> Dict:
        """Zero serve state: pools [L, B, S, d], cache lengths and, with
        ``device_buffer`` (one size or per-layer sizes), the HiSparse hot
        tier and its measured counters."""
        cfg = self.cfg
        dev = self.device
        buffered = (max(device_buffer) if isinstance(device_buffer,
                                                     (list, tuple))
                    else device_buffer)
        i32 = dict(dtype=torch.int32, device=dev)
        state: Dict[str, Any] = {"cache_len": torch.zeros((batch,), **i32)}
        if self.n_kv:
            state["kv_pool"] = torch.zeros(
                (self.n_kv, batch, seq_len, self.kv_dim), dtype=self.kv_dtype,
                device=dev)
            if cfg.sac.enabled:
                state["idx_pool"] = torch.zeros(
                    (self.n_kv, batch, seq_len, cfg.sac.d_idx), dtype=DTYPE,
                    device=dev)
            if buffered and cfg.sac.enabled and self.mode == "sac":
                state["hot_buf"] = hisparse.init_layered_buffer(
                    self.n_kv, batch, device_buffer, seq_len, self.kv_dim,
                    self.kv_dtype, buf_max=buffer_width, device=dev)
                state["buf_hits"] = torch.zeros((batch,), **i32)
                state["buf_misses"] = torch.zeros((batch,), **i32)
                state["buf_hits_l"] = torch.zeros((self.n_kv, batch), **i32)
                state["buf_misses_l"] = torch.zeros((self.n_kv, batch),
                                                    **i32)
                state["pf_inserted"] = torch.zeros((batch,), **i32)
                state["pf_useful"] = torch.zeros((batch,), **i32)
        return state

    # -- shared pieces -----------------------------------------------------------
    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"])
        return (x @ params["lm_head"]).float()
