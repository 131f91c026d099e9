"""Decoder-only LM assembly (``repro/models/transformer.py``) for every
segment kind of the reference:

  - ``dense``, ``moe``        one (GQA attn + MLP or MoE) layer (Qwen2,
                              MiniCPM, Granite, Chameleon, Mixtral, DBRX;
                              sliding window where the config has one)
  - ``mla_dense``, ``mla_moe`` one (MLA attn + MLP or MoE) layer
                              (DeepSeek-V3.2)
  - ``lg_super``     Gemma3's super-block: ``local_global_ratio`` layers
                     with the window ``local_window``, then one global one
  - ``zamba_super``  Zamba2's super-block: ``shared_attn_every`` Mamba2
                     layers, then the ONE tied shared-attention layer
                     (``params["shared"]``: the same tensors every time)
  - ``mamba_tail``   Zamba2's trailing Mamba2 layers (81 = 13 * 6 + 3)
  - ``xlstm_super``  xLSTM's super-block: 3 mLSTM layers + 1 sLSTM layer

A model is a list of segments; where the reference scans stacked
parameters with ``lax.scan``, the port loops over a list per segment:
one dict per layer for the attention kinds (an ``lg_super`` segment's
list is super-block i's local layers 0..r-1 then its global layer, for
each i), one dict per iteration for the others
(``{"mamba_layers": [a dicts]}``, ``{"ln", "mamba"}``,
``{"mlstm": [3 dicts], "slstm": dict}``).  Only attention layers are
pool layers: pool layer ``l`` takes its window from
``kv_layer_windows``.  Entry points:

  ``forward`` -- the training forward (reference ``forward``): full
                 logits and the MoE load-balance loss summed over layers,
                 under autograd, each layer under activation
                 checkpointing with ``remat``; no pool, no kernel;
  ``prefill`` -- the prompt forward, emitting the SAC pool (entries +
                 indexer keys of the attention layers) and, with the
                 ``warmup_w`` opt, each pool layer's warm-up candidates
                 (``warm_idx``); the recurrent state ``rec_{si}`` of a
                 fresh serve state is zeros, as the reference's is (it
                 never carries the prompt into it);
  ``decode``  -- one token per request: each Mamba2 / xLSTM layer reads
                 and updates its slice of ``rec_{si}``; each attention
                 layer runs indexer -> top-k -> fetch (the gather kernel,
                 or ``fetch_fn``) -> sparse attention -> MLP or MoE over
                 the pool, then the write-back of the new entries (the
                 scatter kernel); with the ``prefetch_width`` opt and a
                 hot tier, the speculated entrants are fetched and
                 warm-inserted too.

``decode`` updates the serve state IN PLACE (pools, hot tier, recurrent
state) and returns the same dict.  With the pooled fetch
(``core/pool.py::make_pooled_fetch``) the pools are this rank's slices
of a pool sharded over the mesh's ``model`` axis: each layer's scores
are all-gathered before the selection (``core/sac.py``) and the
write-back lands only on the rank that owns the position.

Tensor parallelism of the weights: under ``sharding.use_rules(rules,
mesh)`` (the context the reference's model reads its mesh and rules
from) ``forward``, ``prefill`` and ``decode`` take this rank's block of
every weight (``sharding.shard_params`` / ``init_shards``;
``param_shapes`` gives their shapes) and run through a
``distributed/tp.py::RankView`` of the config: a vocab-parallel
embedding, column-parallel ``lm_head`` (the logits all-gathered), the
attention, MLP and MoE layers of ``models/{layers,dsa,moe}.py`` on their
blocks, each with its collectives; the d_model rows split over ``data``
too under the training rules (each layer's row blocks gathered inside
its activation checkpoint) and under the serve rules of a batch that
does not split.  The ``opts`` key ``batch_axes`` names the axes the
rank's lanes are split over (by default the rules' ``B`` axes in the
mesh).  Every segment kind runs so: the Mamba2, mLSTM and sLSTM layers
of ``models/ssm.py`` on their blocks, and the recurrent state ``rec_*``
that prefill and ``init_serve_state`` make is the rank's block of it
(``tp.rec_block``: the reference's ``_rec_pspec`` layout).  The
attention families (every segment of ``_ATTN_KINDS``) keep the residual
of ``forward`` and ``prefill`` split over the sequence there
(``seq_parallel``; the reference's ``constrain(x, ("B", "S", "D"))``
with ``"S": ("model",)``): each ``model`` rank holds its contiguous
block of each lane's positions between layers, and a prefill over the
sharded pool writes only the rank's slice of each pool layer
(``[L, B, S/m, d]``; over whole pools every rank gets each layer's
entries all-gathered).  Zamba2, xLSTM and decode keep the residual whole.
Outside that context nothing changes, bit for bit.  Under ``torch.profiler`` it marks each
layer's work as a range named by ``DECODE_SPANS`` (a pool layer, a Mamba2
layer, an xLSTM super-block), so that a trace splits a step by layer
kind; with no profiler on, a layer pays one flag check.  With ``kv_quant="fp8"`` the pool and
the hot tier hold ``float8_e4m3fn`` entries (cast by ``core/pool.py::
to_kv_dtype``) and the indexer pool stays bf16, as in the reference.
f32 products assume ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default, set by the engine).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hisparse
from repro_torch.core import sac as sac_core
from repro_torch.core.pool import (E4M3, FetchFn, local_fetch,
                                   pool_write_step, to_kv_dtype)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.tp import rank_view, tp_of
from repro_torch.models import dsa, moe, ssm
from repro_torch.models.layers import (DTYPE, ParamSpec, attn_param_specs,
                                       dense_attention_block, init_params,
                                       mlp_block, mlp_param_specs, rms_norm,
                                       spec_shapes, top_k)

_ATTN_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "lg_super")
#: decode's profiler ranges: one per pool (attention) layer, Mamba2 layer
#: and xLSTM super-block
DECODE_SPANS = ("pool_layer", "mamba2_layer", "xlstm_super")


def _span(name: str):
    """A ``torch.profiler`` range while a profiler records, else nothing."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


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


def seq_parallel(cfg: ModelConfig) -> bool:
    """Whether a decoder-only config's training forward and prefill split
    the residual over the sequence under the rules: the attention
    families, every segment of ``_ATTN_KINDS``."""
    return not cfg.enc_dec and all(s.kind in _ATTN_KINDS
                                   for s in build_segments(cfg))


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


def _mamba_layer_specs(cfg) -> Dict[str, Any]:
    return {"ln": _norm(cfg), "mamba": ssm.mamba2_param_specs(cfg)}


def segment_specs(seg: Segment, cfg: ModelConfig) -> List[Dict[str, Any]]:
    """The segment's spec list (the reference stacks the same leaves on
    a leading [n] axis for its scan, and the inner lists on a second
    one): one dict per layer, in pool-layer order, for the attention
    kinds (an ``lg_super`` segment in the reference is ``{"local":
    [n, r, ...], "global": [n, ...]}``); one dict per iteration for the
    recurrent kinds."""
    if seg.kind in _ATTN_KINDS:
        return [_attn_layer_specs(cfg)
                for _ in range(seg.n * seg.kv_per_iter)]
    if seg.kind == "zamba_super":
        return [{"mamba_layers": [_mamba_layer_specs(cfg)
                                  for _ in range(cfg.shared_attn_every)]}
                for _ in range(seg.n)]
    if seg.kind == "mamba_tail":
        return [_mamba_layer_specs(cfg) for _ in range(seg.n)]
    if seg.kind == "xlstm_super":
        return [{"mlstm": [{"ln": _norm(cfg), **ssm.mlstm_param_specs(cfg)}
                           for _ in range(3)],
                 "slstm": {"ln": _norm(cfg), **ssm.slstm_param_specs(cfg)}}
                for _ in range(seg.n)]
    raise ValueError(seg.kind)


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("V", "D"), scale=1.0),
        "segments": [segment_specs(s, cfg) for s in build_segments(cfg)],
        "final_norm": _norm(cfg),
        "lm_head": ParamSpec((d, v), ("D", "V")),
    }
    if cfg.ssm_state and cfg.shared_attn_every:
        # zamba2's tied shared-attention layer: one set of weights,
        # applied after every ``shared_attn_every``-th Mamba2 layer
        specs["shared"] = _attn_layer_specs(cfg)
    return specs


def pool_layer_params(cfg: ModelConfig, params) -> List[Dict[str, Any]]:
    """The attention layer's parameters of each pool layer, in pool-layer
    order: zamba2's pool layers all get the one ``params["shared"]``
    dict (the same tensors, not copies)."""
    out: List[Dict[str, Any]] = []
    for seg, items in zip(build_segments(cfg), params["segments"]):
        if seg.kind in _ATTN_KINDS:
            out += items
        elif seg.kind == "zamba_super":
            out += [params["shared"]] * seg.n
    return out


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------


def _mlp_apply(p_mlp, x, cfg, *, groups: int = 1):
    """MLP or MoE on [B, S, D]; returns (out, aux)."""
    if cfg.n_experts:
        return moe.moe_block(p_mlp, x, cfg, groups=groups)
    return mlp_block(p_mlp, x, cfg), torch.zeros((), device=x.device)


def _layer_fwd(p, x, cfg, positions, window, groups, warm_w=0,
               collect=True):
    """Full (attn + mlp) layer over a sequence, the one body of prefill
    and of the training forward.  Returns (x', entry, idx_keys, warm_idx,
    aux): the MLP's MoE load-balance loss ``aux`` (0 without MoE) and,
    with ``collect``, the layer's pool entries and indexer keys (None
    without: the training forward, the reference's
    ``collect_entries=False``).

    ``warm_idx`` ([B, w] int32, or None when ``warm_w`` is 0) is the
    layer's warm-up candidate set: the top-``w`` prompt positions by
    indexer score against the LAST prompt position (the closest proxy
    for the first decode query), lanes of -1 where masked (outside a
    windowed layer's trailing window).

    With the residual split over the sequence (``tp.seq``) ``x``, ``x'``,
    the entries and the keys are the rank's block of the positions
    (``positions`` stays the whole sequence's); the warm-up query is the
    last position's row from the rank that holds it, the block's scores
    are all-gathered, and the top-``w`` runs over the whole row.
    """
    tp = tp_of(cfg)
    xn = rms_norm(x, tp.on_slice(p["ln1"]))
    entry = idx_keys = warm = None
    if cfg.mla:
        out, entry = dsa.mla_prefill_attention(p["attn"], xn, cfg, positions)
    else:
        out, (k, v) = dense_attention_block(p["attn"], xn, cfg, positions,
                                            window=window)
        entry = (dsa.pack_kv_entry(tp.own_seq(k), tp.own_seq(v)) if collect
                 else None)
    if collect and cfg.sac.enabled:
        idx_keys = dsa.indexer_keys(p["idx"], xn, cfg)
        if warm_w:
            B, S = positions.shape
            last = tp.seq_rows(xn, torch.full((B,), S - 1, device=x.device))
            scores = tp.all_gather(
                dsa.indexer_scores(p["idx"], last, idx_keys, cfg),
                tp.seq.axes, dim=1)
            if window:
                # windowed layers only select from the trailing window
                pos = torch.arange(S, dtype=torch.int32, device=x.device)
                scores = torch.where(pos[None, :] > S - window, scores,
                                     dsa.NEG_INF)
            ws, warm = top_k(scores, min(warm_w, S))
            warm = torch.where(ws > dsa.NEG_INF / 2, warm,
                               -1).to(torch.int32)
    x = x + out
    out, aux = _mlp_apply(p["mlp"], rms_norm(x, tp.on_slice(p["ln2"])), cfg,
                          groups=groups)
    return x + out, (entry if collect else None), idx_keys, warm, aux


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
            shard = ctx.get("shard")
            if shard is not None:            # the whole layer on each rank
                kv_slice = shard.gather_pool(kv_slice, ctx.get("pool_bufs"))
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
    new_key = dsa.indexer_keys(p["idx"], xn, cfg)
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


def _mamba_fwd(p, x, cfg, chunk):
    out, _ = ssm.mamba2_block(p["mamba"], rms_norm(x, p["ln"]), cfg,
                              chunk=chunk)
    return x + out


def _mlstm_fwd(p, x, cfg):
    return x + ssm.mlstm_block(p, rms_norm(x, p["ln"]), cfg)


def _slstm_fwd(p, x, cfg):
    return x + ssm.slstm_block(p, rms_norm(x, p["ln"]), cfg)


def run_layer(remat: bool, fn, *args):
    """``fn(*args)``: under activation checkpointing when ``remat`` is on
    and autograd records (the training forward), else directly."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _store(dst, src):
    """Write a recurrent state's new leaves into its serve-state views."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _mamba_decode(p, x, cfg, st):
    """One Mamba2 layer's decode; ``st`` = (ssm [B,nh,N,hd], conv
    [B,3,F]) views of the serve state, updated in place."""
    out, new = ssm.mamba2_decode(p["mamba"], rms_norm(x, p["ln"]), cfg, st)
    _store(st, new)
    return x + out


def _xlstm_decode(p, x, cfg, rec, i):
    """Iteration ``i`` of an ``xlstm_super`` segment; ``rec`` = ((C, n, m)
    [n, 3, ...], (h, c, n, m) [n, B, d]), updated in place."""
    m_rec, s_rec = rec
    for j, pl in enumerate(p["mlstm"]):
        st = tuple(t[i, j] for t in m_rec)
        out, new = ssm.mlstm_decode(pl, rms_norm(x, pl["ln"]), cfg, st)
        _store(st, new)
        x = x + out
    ps = p["slstm"]
    st = tuple(t[i] for t in s_rec)
    out, new = ssm.slstm_decode(ps, rms_norm(x, ps["ln"]), cfg, st)
    _store(st, new)
    return x + out


def segment_rec_shapes(seg: Segment, cfg: ModelConfig, batch: int):
    """(shape, dtype) leaves of one iteration's recurrent state, in the
    reference's layout (None for the attention kinds)."""
    if seg.kind in ("zamba_super", "mamba_tail"):
        ssm_s, conv_s = ssm.mamba2_state_shape(cfg, batch)
        a = ((cfg.shared_attn_every,) if seg.kind == "zamba_super" else ())
        return ((a + ssm_s, torch.float32), (a + conv_s, DTYPE))
    if seg.kind == "xlstm_super":
        d, nh = cfg.d_model, cfg.n_heads
        hd = d // nh
        f32 = torch.float32
        return (((3, batch, nh, hd, hd), f32), ((3, batch, nh, hd), f32),
                ((3, batch, nh), f32)), \
            tuple(((batch, d), f32) for _ in range(4))
    return None


def _zero_rec(shapes, marks, n, device, tp):
    """Zeros of a segment's recurrent state, stacked on its [n] axis:
    each leaf's block under ``tp`` (``marks``: the same shapes with the
    lanes marked -1)."""
    if isinstance(shapes[1], torch.dtype):
        (shape, dtype), (mark, _) = shapes, marks
        shape = [n, *shape]
        block = tp.rec_block(shape, 1 + mark.index(-1))
        if block is not None:
            axis, split = block
            shape[axis] //= split.n
        return torch.zeros(shape, dtype=dtype, device=device)
    return tuple(_zero_rec(s, m, n, device, tp)
                 for s, m in zip(shapes, marks))


# ---------------------------------------------------------------------------
# the model facade
# ---------------------------------------------------------------------------


class TransformerLM:
    """Built once per (cfg, fetch_fn, mode, device)."""

    def __init__(self, cfg: ModelConfig, fetch_fn: FetchFn = local_fetch,
                 mode: str = "sac", topk_fn: Optional[Callable] = None,
                 remat: bool = True, opts: Optional[Dict] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.remat = remat
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
        # a pool sharded over ranks (core/pool.py::make_pooled_fetch):
        # each rank runs every layer on its own lanes; the pool layers
        # read through the pooled fetch (``dense`` mode all-gathers each
        # layer), the recurrent layers keep ``rec_*`` of those lanes
        self.shard = getattr(fetch_fn, "shard", None)
        self._views: Dict[Any, Any] = {}   # tensor parallelism
        # the families whose training forward and prefill split the
        # residual over the sequence under the rules
        self.seq_parallel = seq_parallel(cfg)

    def rank_cfg(self, seq: bool = False):
        """The config this rank runs: ``cfg`` itself outside
        ``use_rules(rules, mesh)``, else a ``RankView`` with the mesh's
        ``TensorParallel`` plan (``tp.rank_view``; with ``seq`` and a
        ``seq_parallel`` model, the plan whose residual is split over the
        sequence)."""
        return rank_view(self.cfg, self._views, self.opts.get("batch_axes"),
                         seq and self.seq_parallel)

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters drawn from ``generator`` (on the model's
        device), one tensor at a time in its own dtype."""
        return init_params(self.specs, generator, self.device)

    def param_shapes(self) -> Dict:
        """The parameters as empty ``meta`` tensors (the dry-run's): the
        tree ``init`` returns, with no storage; under ``use_rules(rules,
        mesh)`` this rank's blocks (``sharding.block_shape``)."""
        if shd._mesh() is None:
            return spec_shapes(self.specs)
        return shd.map_specs(lambda _, s: torch.empty(
            shd.block_shape(s), dtype=s.dtype, device="meta"),
            self.specs, self.specs)

    # -- the layer walk, shared by the training forward and prefill -----------
    def _embed_seq(self, params, tokens, cfg=None):
        """(the residual [B, S, D], the positions [B, S]); with the
        residual split over the sequence, the rank's block of it (a
        sequence that does not split over its ranks raises), the
        positions still the whole sequence's."""
        cfg = cfg or self.cfg
        B, S = tokens.shape
        tp_of(cfg).check_seq(S)
        x = embed_of(params, tokens, cfg)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(B, S)
        return x, positions

    def _walk(self, params, x, attn, cfg, remat=False):
        """``x`` through every layer in order: ``attn(p, x) -> x`` runs
        each attention layer (in pool-layer order), ``run_layer`` each
        Mamba2 layer and each mLSTM / sLSTM layer (on ``cfg``, the rank's
        view)."""
        layer = functools.partial(run_layer, remat)
        chunk = int(self.opts.get("ssm_chunk", 256))
        for seg, items in zip(self.segments, params["segments"]):
            for it in items:
                if seg.kind == "zamba_super":
                    for pl in it["mamba_layers"]:
                        x = layer(_mamba_fwd, pl, x, cfg, chunk)
                    x = attn(params["shared"], x)
                elif seg.kind == "mamba_tail":
                    x = layer(_mamba_fwd, it, x, cfg, chunk)
                elif seg.kind == "xlstm_super":
                    for pl in it["mlstm"]:
                        x = layer(_mlstm_fwd, pl, x, cfg)
                    x = layer(_slstm_fwd, it["slstm"], x, cfg)
                else:
                    x = attn(it, x)
        return x

    # -- training forward ----------------------------------------------------
    def forward(self, params, tokens):
        """tokens [B, S] -> (logits [B, S, V] f32, aux f32: the MoE
        load-balance loss summed over layers).  Under autograd; no pool
        entries, indexer keys or warm-up candidates are made, so no
        kernel of the port runs.  Under ``use_rules(rules, mesh)`` it runs
        on this rank's blocks and lanes (``rank_cfg``), the attention
        families' residual split over the sequence; the logits are the
        lanes' whole sequence's and ``aux`` the whole batch's."""
        cfg = self.rank_cfg(seq=True)
        x, positions = self._embed_seq(params, tokens, cfg)
        groups = int(self.opts.get("moe_groups", 1))
        windows = iter(self.windows)
        aux = [torch.zeros((), device=x.device)]

        def attn(p, x):
            x, _, _, _, a = run_layer(self.remat, _layer_fwd, p, x, cfg,
                                      positions, next(windows), groups, 0,
                                      False)
            aux[0] = aux[0] + a
            return x

        x = self._walk(params, x, attn, cfg, self.remat)
        return self._logits(params, x, cfg), aux[0]

    # -- prefill -------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens, lengths=None):
        """tokens [B, S] -> (serve_state, last_logits [B, V]).

        Emits every position's entry and indexer key of each attention
        layer as the pool of a fresh serve state (no pool without an
        attention layer); with the ``warmup_w`` opt also ``warm_idx``
        [L, B, w], the warm-up candidates (popped by the engine: not part
        of the serve state).  The recurrent state ``rec_{si}`` is zeros,
        as the reference's prefill returns it.  Logits are computed for
        the last prompt position only (the reference computes all S and
        keeps the last; the result is the same).

        Under ``use_rules`` an attention family runs with its residual
        split over the sequence (``rank_cfg(seq=True)``): over the sharded
        pool (the model's ``fetch_fn`` is the pooled fetch, its pool axis
        the sequence's) the pools are the rank's slice ``[L, B, S/m, d]``
        of the positions, made and written by the rank alone; over whole
        pools each layer's entries are all-gathered into them.  The last
        position's row comes from the rank that holds it."""
        cfg = self.rank_cfg(seq=True)
        tp = tp_of(cfg)
        B, S = tokens.shape
        dev = tokens.device
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        x, positions = self._embed_seq(params, tokens, cfg)
        groups = int(self.opts.get("moe_groups", 1))
        warm_w = int(self.opts.get("warmup_w", 0))
        gather = tp.seq.n > 1 and self.shard is None
        if tp.seq.n > 1 and not gather and (
                self.shard.size, self.shard.rank) != (tp.seq.n, tp.seq.index):
            raise ValueError(
                f"the pool's slices ({self.shard.size} ranks) are not the "
                f"residual's blocks over {tp.seq.axes}")
        rows = S if gather else S // tp.seq.n
        # each layer's entries land in the pool as they are made (no
        # second copy of a long prompt's pool from a stack)
        state: Dict[str, Any] = {}
        if self.n_kv:
            state["kv_pool"] = torch.empty(
                (self.n_kv, B, rows, self.kv_dim), dtype=self.kv_dtype,
                device=dev)
            if cfg.sac.enabled:
                state["idx_pool"] = torch.empty(
                    (self.n_kv, B, rows, cfg.sac.d_idx), dtype=DTYPE,
                    device=dev)
        warms = []

        def attn(p, x):                  # pool layer len(warms)
            layer = len(warms)
            x, entry, ik, wm, _ = _layer_fwd(p, x, cfg, positions,
                                             self.windows[layer], groups,
                                             warm_w)
            if gather:                   # whole pools on every rank
                entry = tp.all_gather(entry, tp.seq.axes, dim=1)
                ik = ik if ik is None else tp.all_gather(ik, tp.seq.axes,
                                                         dim=1)
            state["kv_pool"][layer] = to_kv_dtype(entry, self.kv_dtype)
            if ik is not None:
                state["idx_pool"][layer] = ik.to(DTYPE)
            warms.append(wm)
            return x

        x = self._walk(params, x, attn, cfg)
        if warms and warms[0] is not None:
            state["warm_idx"] = torch.stack(warms)
        state.update(self._zero_recs(B, dev, cfg))
        state["cache_len"] = lengths.to(torch.int32)
        x_last = tp.seq_rows(x, torch.clamp(lengths.long() - 1, 0, S - 1))
        return state, self._logits(params, x_last, self.rank_cfg())

    # -- decode ----------------------------------------------------------------
    @torch.no_grad()
    def decode(self, params, state, tokens, pf_budget=None):
        """One decode step.  tokens [B] -> (state, logits [B, V]); the
        state dict is updated IN PLACE (pools, hot tier, counters).

        ``pf_budget`` ([B] int32 or None) is the step's arbiter-granted
        speculative width per request: it caps the speculation lanes
        each request may warm-insert (traffic only, never tokens)."""
        cfg = self.rank_cfg()
        x = embed_of(params, tokens, cfg)
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
            "shard": self.shard,
            "pool_bufs": {},     # dense mode's gathered layer, reused
        }
        kv_pool, idx_pool = state.get("kv_pool"), state.get("idx_pool")
        hot = state.get("hot_buf")
        pf_ins0 = hot.pf_inserted.sum(0) if hot is not None else None
        pf_use0 = hot.pf_used.sum(0) if hot is not None else None
        use_idx = idx_pool is not None and self.mode == "sac"
        new_entries, new_keys, hits_l, misses_l = [], [], [], []

        def attn(p, x):                  # pool layer len(new_entries)
            layer = len(new_entries)
            hb = (None if hot is None
                  else hisparse.BufferState(*(t[layer] for t in hot)))
            with _span("pool_layer"):
                x, own, key, hb2, h, m = _layer_decode(
                    p, x, cfg, ctx, kv_pool[layer],
                    idx_pool[layer] if use_idx else None,
                    self.windows[layer], hb)
            new_entries.append(own)
            new_keys.append(key)
            if hb2 is not None:
                hisparse.store(hb, hb2)
                hits_l.append(h)
                misses_l.append(m)
            return x

        for si, (seg, items) in enumerate(zip(self.segments,
                                              params["segments"])):
            rec = state.get(f"rec_{si}")
            for i, it in enumerate(items):
                if seg.kind == "zamba_super":
                    for j, pl in enumerate(it["mamba_layers"]):
                        with _span("mamba2_layer"):
                            x = _mamba_decode(pl, x, cfg,
                                              (rec[0][i, j], rec[1][i, j]))
                    x = attn(params["shared"], x)
                elif seg.kind == "mamba_tail":
                    with _span("mamba2_layer"):
                        x = _mamba_decode(it, x, cfg,
                                          (rec[0][i], rec[1][i]))
                elif seg.kind == "xlstm_super":
                    with _span("xlstm_super"):
                        x = _xlstm_decode(it, x, cfg, rec, i)
                else:
                    x = attn(it, x)
        if new_entries and kv_pool is not None:
            # one launch writes every layer's entry and indexer key
            pools, rows = [kv_pool], [torch.stack(new_entries)]
            if idx_pool is not None:
                pools.append(idx_pool)
                rows.append(torch.stack(new_keys))
            pool_write_step(pools, rows, cache_len, shard=self.shard)
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
        return state, self._logits(params, x, cfg)

    # -- state builders ---------------------------------------------------------
    def init_serve_state(self, batch: int, seq_len: int,
                         device_buffer=0, buffer_width=None) -> Dict:
        """Zero serve state: pools [L, B, S, d] (with a pool layer),
        cache lengths, each recurrent segment's ``rec_{si}`` and, with
        ``device_buffer`` (one size or per-layer sizes), the HiSparse hot
        tier and its measured counters."""
        return self._empty_state(batch, seq_len, device_buffer,
                                 buffer_width, self.device)

    def serve_state_shapes(self, batch: int, seq_len: int,
                           device_buffer=0, buffer_width=None) -> Dict:
        """``init_serve_state``'s tree on the ``meta`` device: every
        shape and dtype, nothing allocated (the dry-run's inputs)."""
        return self._empty_state(batch, seq_len, device_buffer,
                                 buffer_width, torch.device("meta"))

    def _empty_state(self, batch: int, seq_len: int, device_buffer,
                     buffer_width, dev) -> Dict:
        cfg = self.cfg
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
        state.update(self._zero_recs(batch, dev, self.rank_cfg()))
        return state

    def _zero_recs(self, batch: int, device, cfg) -> Dict[str, Any]:
        """``rec_{si}`` zeros of each recurrent segment, in the
        reference's layout: ``zamba_super`` (ssm f32 [n, a, B, nh, N,
        hd], conv bf16 [n, a, B, 3, d_inner]), ``mamba_tail`` the same
        without the [a] axis, ``xlstm_super`` ((C, n, m) [n, 3, B, ...],
        (h, c, n, m) [n, B, d]); over a tensor-parallel rank (``cfg``'s
        plan) each leaf's block."""
        out = {}
        for si, seg in enumerate(self.segments):
            shapes = segment_rec_shapes(seg, self.cfg, batch)
            if shapes is not None:
                out[f"rec_{si}"] = _zero_rec(
                    shapes, segment_rec_shapes(seg, self.cfg, -1), seg.n,
                    device, tp_of(cfg))
        return out

    # -- shared pieces -----------------------------------------------------------
    def _logits(self, params, x, cfg=None):
        return logits_of(params, x, cfg or self.cfg)


def logits_of(params, x, cfg) -> torch.Tensor:
    """The final norm and ``lm_head``; column-parallel over a
    tensor-parallel rank: its vocab block's logits, all-gathered (the
    loss, the same on every rank of the vocab's axes, takes the whole
    gradient of each block)."""
    tp, shape = tp_of(cfg), (cfg.d_model, cfg.vocab)
    x = rms_norm(x, tp.on_slice(params["final_norm"]))
    v = tp.split(("D", "V"), shape, 1)
    y = tp.matmul(tp.gather_seq(x, v.axes), params["lm_head"], ("D", "V"),
                  shape)
    return tp.all_gather(y, v.axes).float()


def embed_of(params, tokens, cfg) -> torch.Tensor:
    """The tokens' embedding rows; vocab-parallel over a tensor-parallel
    rank: its block's rows (zeros for another block's tokens), summed
    over the vocab's axes (with the residual split over the sequence, a
    reduce-scatter to the rank's block of it); a block of the rows'
    columns (``D`` over axes the tokens are the same on) all-gathered,
    rows over the batch's axes gathered first (``tp.rows``)."""
    tp = tp_of(cfg)
    dims, shape = ("V", "D"), (cfg.vocab, cfg.d_model)
    v = tp.split(dims, shape, 0)
    embed = tp.rows(params["embed"], dims, shape)
    if v.n == 1:
        x = embed[tokens.long()].to(DTYPE)
    else:
        lo, hi = v.bounds(cfg.vocab)
        t = tokens.long() - lo
        mine = ((t >= 0) & (t < hi - lo))[..., None]
        rows = embed[t.clamp(0, hi - lo - 1)].to(DTYPE)
        x = torch.where(mine, rows, torch.zeros((), dtype=DTYPE,
                                                device=rows.device))
    x = tp.all_reduce(x, v.axes, scatter=True)
    if x.shape[-1] != cfg.d_model:
        x = tp.all_gather(x, tp.split(dims, shape, 1).axes)
    return x
