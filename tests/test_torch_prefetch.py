"""The port's fetch pipeline against the reference, piece by piece.

Every input is made from a numpy seed and fed to the JAX function and its
counterpart in ``repro_torch``; comparisons are exact (integer state,
copied bf16 rows, selected indices):

- the hot tier's warm inserts (``warm_insert``, ``warm_lane``) and the
  online re-sizing (``resize_layers``), on states with duplicates,
  protected slots, DISABLED slots and more wanted lanes than free slots;
- the speculation helpers (``_spec_tail``, ``speculate_next_topk``,
  ``topk_select_with_tail``, ``budget_mask``) on scores with exact ties
  at score margins -1, 0 and 1;
- ``FetchPlanner.warmup_plan`` and ``cap_warmup``, windowed layers
  included;
- the prefill's ``warm_idx`` on reduced DeepSeek-V3.2 and Qwen2 with
  bridged weights;
- inside the port: decoded tokens do not depend on prefetch, the arbiter
  or online re-sizing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import hisparse as jh
from repro.models import dsa as jdsa
from repro.models import transformer as jtr
from repro.models.layers import rms_norm as jrms_norm
from repro.models.model import build_model as jbuild
from repro.serving import prefetch as jpf
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.core import hisparse as th
from repro_torch.models import dsa as tdsa
from repro_torch.models import transformer as ttr
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving import prefetch as tpf
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import sharegpt_trace as ttrace

_jread = jax.jit(jh.read_through)
_jwarm = jax.jit(jh.warm_insert)
_jwarm_lane = jax.jit(jh.warm_lane, static_argnums=1)
_FIELDS = ("slot_pos", "page_table", "last_use", "clock", "pf_flag",
           "pf_inserted", "pf_used")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_state(js, ts, where=""):
    for name in _FIELDS + ("entries",):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      _np(getattr(js, name)),
                                      err_msg=f"{name} {where}")


def _layered_pair(L, B, sizes, S, d, buf_max=None):
    return (jh.init_layered_buffer(L, B, sizes, S, d, buf_max=buf_max),
            th.init_layered_buffer(L, B, sizes, S, d, buf_max=buf_max,
                                   device="cpu"))


def _bf16(a):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16))


def _lanes(rng, B, w, S, hot=6, p_invalid=0.2):
    """Positions with duplicates (a small hot set revisited), fresh ones
    and invalid lanes."""
    idx = np.where(rng.random((B, w)) < 0.5, rng.integers(0, hot, (B, w)),
                   rng.integers(0, S, (B, w))).astype(np.int32)
    return idx, rng.random((B, w)) >= p_invalid


def _read(js, ts, rng, k, S, d):
    idx, valid = _lanes(rng, js.slot_pos.shape[0], k, S)
    jv, tv = _bf16(rng.standard_normal((idx.shape[0], k, d)))
    _, js, _, _ = _jread(js, jnp.asarray(idx), jv, jnp.asarray(valid))
    _, ts, _, _ = th.read_through(ts, torch.from_numpy(idx), tv,
                                  torch.from_numpy(valid))
    return js, ts


def _warm(js, ts, rng, w, S, d):
    idx, valid = _lanes(rng, js.slot_pos.shape[0], w, S)
    jv, tv = _bf16(rng.standard_normal((idx.shape[0], w, d)))
    js, jins = _jwarm(js, jnp.asarray(idx), jv, jnp.asarray(valid))
    ts, tins = th.warm_insert(ts, torch.from_numpy(idx), tv,
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(tins.numpy(), np.asarray(jins))
    return js, ts


@pytest.mark.parametrize("sizes,k,w", [((4, 7, 9), 3, 5), ((9, 9, 9), 6, 14),
                                       ((2, 5, 9), 8, 20)])
def test_warm_insert_exact(sizes, k, w):
    """Demand reads then warm inserts, alternating: the reads' hits are
    protected (``last_use == clock``), requests 0-1 have DISABLED slots,
    ``w`` > free slots in the later cases, and the lanes repeat
    positions."""
    rng = np.random.default_rng(sum(sizes) + 10 * k + w)
    S, d = 24, 8
    jl, tl = _layered_pair(3, 1, list(sizes), S, d)
    # the three layers of one lane are a batch of three requests
    js = jh.BufferState(*(f[:, 0] for f in jl))
    ts = th.BufferState(*(f[:, 0].clone() for f in tl))
    for t in range(6):
        js, ts = _read(js, ts, rng, k, S, d)
        js, ts = _warm(js, ts, rng, w, S, d)
        _assert_state(js, ts, f"step {t}")
    assert int(ts.pf_inserted.sum()) > 0 and int(ts.pf_used.sum()) > 0


def test_warm_lane_exact():
    """Warm-up of one lane of a layered buffer, before and after demand
    reads on every layer, with duplicate and invalid lanes."""
    rng = np.random.default_rng(3)
    L, B, S, d, w = 2, 3, 30, 8, 12
    jl, tl = _layered_pair(L, B, [5, 9], S, d)
    for t in range(4):
        idx, valid = _lanes(rng, L, w, S)
        jv, tv = _bf16(rng.standard_normal((L, w, d)))
        jl, jn = _jwarm_lane(jl, 1, jnp.asarray(idx), jv,
                             jnp.asarray(valid))
        tl, tn = th.warm_lane(tl, 1, torch.from_numpy(idx), tv,
                              torch.from_numpy(valid))
        assert int(tn) == int(jn)
        _assert_state(jl, tl, f"warm {t}")
        for layer in range(L):
            js = jh.BufferState(*(f[layer] for f in jl))
            ts = th.BufferState(*(f[layer] for f in tl))
            js, ts = _read(js, ts, rng, 6, S, d)
            jl = jh.BufferState(*(full.at[layer].set(part)
                                  for full, part in zip(jl, js)))
            for full, part in zip(tl, ts):
                full[layer].copy_(part)
        _assert_state(jl, tl, f"read {t}")


def test_resize_layers_exact():
    """Shrink and grow layers of a filled, partly prefetched layered
    buffer: displaced positions unmapped, survivors kept, the pf_*
    counters kept; then more reads and warm inserts on the new sizes."""
    rng = np.random.default_rng(11)
    L, B, S, d, cap = 3, 2, 40, 8, 12
    jl, tl = _layered_pair(L, B, [6, 8, 10], S, d, buf_max=cap)

    def traffic(jl, tl, steps):
        for _ in range(steps):
            for layer in range(L):
                js = jh.BufferState(*(f[layer] for f in jl))
                ts = th.BufferState(*(f[layer] for f in tl))
                js, ts = _read(js, ts, rng, 7, S, d)
                js, ts = _warm(js, ts, rng, 6, S, d)
                jl = jh.BufferState(*(full.at[layer].set(part)
                                      for full, part in zip(jl, js)))
                for full, part in zip(tl, ts):
                    full[layer].copy_(part)
        return jl, tl

    for sizes in ([12, 3, 9], [0, 12, 5], [6, 8, 10]):
        jl, tl = traffic(jl, tl, 3)
        _assert_state(jl, tl, "before resize")
        jl = jh.resize_layers(jl, sizes)
        tl = th.resize_layers(tl, sizes)
        _assert_state(jl, tl, f"resize to {sizes}")
        assert ((tl.slot_pos == th.DISABLED).sum(-1)
                == torch.tensor([cap - s for s in sizes])[:, None]).all()
    with pytest.raises(ValueError):
        th.resize_layers(tl, [13, 0, 0])


# ---------------------------------------------------------------------------
# speculation helpers
# ---------------------------------------------------------------------------


def _tied_scores(rng, B, S):
    """Scores on a coarse grid, so many positions tie exactly."""
    return (rng.integers(-3, 4, (B, S)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("margin", [-1.0, 0.0, 1.0])
@pytest.mark.parametrize("k,width", [(4, 12), (16, 8)])
def test_speculation_helpers_exact(margin, k, width):
    """Ties break to the lower index in both; cache lengths below k give
    invalid demand lanes, and k + width > S pads the tail."""
    rng = np.random.default_rng(int(10 * margin) + 7 * k + width)
    B, S = 4, 20
    scores = _tied_scores(rng, B, S)
    cache_len = np.array([20, 9, 3, 14], np.int32)
    js, jc = jnp.asarray(scores), jnp.asarray(cache_len)
    ts, tc = torch.from_numpy(scores), torch.from_numpy(cache_len)

    jt = jdsa.speculate_next_topk(js, jc, k, width, margin)
    tt = tdsa.speculate_next_topk(ts, tc, k, width, margin)
    jf = jdsa.topk_select_with_tail(js, jc, k, width, margin)
    tf = tdsa.topk_select_with_tail(ts, tc, k, width, margin)
    for a, b in zip(tt + tf, jt + jf):
        np.testing.assert_array_equal(_np(a), _np(b))
    # the fused demand half is the unfused selection, bit for bit
    for a, b in zip(tf[:2], tdsa.topk_select(ts, tc, k)):
        assert torch.equal(a, b)
    # _spec_tail on a top-(k+width) result straight from lax.top_k
    top_s, top_i = jax.lax.top_k(js, min(k + width, S))
    tail_j = jdsa._spec_tail(top_s, top_i, k, width, margin)
    tail_t = tdsa._spec_tail(torch.from_numpy(np.array(top_s)),
                             torch.from_numpy(np.array(top_i)), k, width,
                             margin)
    for a, b in zip(tail_t, tail_j):
        np.testing.assert_array_equal(_np(a), _np(b))

    budget = np.array([0, 2, width, width + 3], np.int32)
    np.testing.assert_array_equal(
        tdsa.budget_mask(tf[3], torch.from_numpy(budget)).numpy(),
        np.asarray(jdsa.budget_mask(jf[3], jnp.asarray(budget))))


# ---------------------------------------------------------------------------
# warm-up planning
# ---------------------------------------------------------------------------


def _plans_equal(tp, jp):
    assert (tp is None) == (jp is None)
    if tp is not None:
        np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
        np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b",
                                  "gemma3-12b"])
def test_warmup_plan_and_cap_exact(arch):
    """Score lanes with -1 (masked) entries, radix tails longer and
    shorter than the match, prompts shorter than ``warmup_radix``, and
    every cap width from none to all; windowed layers (Mixtral's window,
    Gemma3's local layers) mask old radix positions."""
    cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    n_layers = len(jtr.kv_layer_windows(cfg))
    jplan = jpf.FetchPlanner(cfg, n_layers=n_layers)
    tplan = tpf.FetchPlanner(tcfg, n_layers=n_layers, device="cpu")
    assert tplan.layer_windows == jplan.layer_windows
    rng = np.random.default_rng(5)
    for matched, prompt_len, with_scores in ((0, 40, True), (4, 40, True),
                                             (32, 40, False), (12, 6, True),
                                             (0, 40, False)):
        warm = None
        if with_scores:
            warm = rng.integers(-1, prompt_len, (n_layers, 5)).astype(
                np.int32)
        jp = jplan.warmup_plan(None if warm is None else jnp.asarray(warm),
                               matched, prompt_len)
        tp = tplan.warmup_plan(None if warm is None
                               else torch.from_numpy(warm),
                               matched, prompt_len)
        _plans_equal(tp, jp)
        if tp is None:
            continue
        for width in (-1, 0, 1, 3, tp.idx.shape[1], tp.idx.shape[1] + 5):
            _plans_equal(tpf.cap_warmup(tp, width), jpf.cap_warmup(jp, width))


# ---------------------------------------------------------------------------
# prefill warm-up candidates
# ---------------------------------------------------------------------------


def _layer_inputs_and_warm(cfg, params, prompt, windows):
    """JAX: every layer's input, its warm-up scores and its ``warm_idx``
    (the ``_layer_fwd`` of the reference under the ``warmup_w`` opt),
    once per window."""
    w = cfg.sac.warmup_entries
    seg = params["segments"][0]
    n = jax.tree.leaves(seg)[0].shape[0]

    @jax.jit
    def run(params, prompt):
        B, T = prompt.shape
        pos = jnp.arange(T, dtype=jnp.int32)[None].repeat(B, 0)
        x = jnp.take(params["embed"], prompt, axis=0).astype(jnp.bfloat16)
        xs, scores, warms = [], [], []
        with jtr._use_opts({"warmup_w": w}):
            for i in range(n):
                p = jax.tree.map(lambda a: a[i], params["segments"][0])
                xs.append(x)
                xn = jrms_norm(x, p["ln1"])
                sc = jdsa.indexer_scores(p["idx"], xn[:, -1],
                                         jdsa.indexer_keys(p["idx"], xn), cfg)
                for win in windows:
                    keep = jnp.arange(T)[None] > T - win if win else True
                    scores.append(jnp.where(keep, sc, jdsa.NEG_INF))
                    warms.append(jtr._layer_fwd(p, x, cfg, pos, win)[3])
                x = jtr._layer_fwd(p, x, cfg, pos, 0)[0]
        return xs, scores, warms

    return run(params, jnp.asarray(prompt))


@pytest.mark.parametrize("arch", ["deepseek-v32", "qwen2-1.5b"])
def test_prefill_warm_idx_exact(arch):
    """Each layer's warm-up candidates (the top-w prompt positions by
    indexer score against the last prompt position; -1 where a window of
    6 < w masks them), from equal layer inputs, equal the reference's;
    and the port's prefill emits them as ``warm_idx`` [L, B, w] (its
    first layer's input is the embedding, equal in both).  The seed's
    top w+1 scores are, pair by adjacent pair, either exact ties (both
    break them to the lower index) or more than 1e-4 apart, the w-th
    and (w+1)-th included: the indexer's f32 sums differ in the last
    bits between the two."""
    cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    w, windows = cfg.sac.warmup_entries, (0, 6)
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)
    xs, scores, warms = _layer_inputs_and_warm(cfg, params, prompt, windows)
    for sc in scores:
        top = -np.sort(-np.asarray(sc), axis=-1)[:, :w + 1]
        gaps = top[:, :-1] - top[:, 1:]
        assert ((gaps == 0) | (gaps > 1e-4)).all(), gaps
    tpos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    for i, x in enumerate(xs):
        tx = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
            torch.bfloat16)
        for j, win in enumerate(windows):
            got = ttr._layer_fwd(tparams["segments"][0][i], tx, tcfg, tpos,
                                 win, 1, w)[3]
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(warms[i * len(windows) + j]),
                err_msg=f"layer {i}, window {win}")
    # a window of 6 leaves 5 candidates: w - 5 lanes of -1 per request
    assert (np.asarray(warms[1]) == -1).sum() == 2 * (w - 5)
    st, _ = tbuild(tcfg, opts={"warmup_w": w}, device="cpu").prefill(
        tparams, torch.from_numpy(prompt))
    assert st["warm_idx"].shape == (len(xs), 2, w)
    np.testing.assert_array_equal(st["warm_idx"][0].numpy(),
                                  np.asarray(warms[0]))


# ---------------------------------------------------------------------------
# the port's invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v32", "qwen2-1.5b"])
def test_tokens_unchanged_by_fetch_pipeline(arch):
    """Prefetch (with prefill warm-up), the arbiter and online re-sizing,
    each on and off, decode the same tokens; each setting that is on
    really acts (entries prefetched, grants between 0 and the full
    width, layers re-sized)."""
    base = tget(arch).reduced()
    # a link budget wide enough that the reduced model's grants vary
    cfg = dataclasses.replace(base, sac=dataclasses.replace(
        base.sac, link_budget_frac=300.0))
    resized = dataclasses.replace(cfg, sac=dataclasses.replace(
        cfg.sac, resize_interval=2))
    runs = {}
    for name, c, knobs in (("off", cfg, {}),
                           ("prefetch", cfg, dict(prefetch=True)),
                           ("arbiter", cfg, dict(prefetch=True,
                                                 arbiter=True)),
                           ("resize", resized, {}),
                           ("all", resized, dict(prefetch=True,
                                                 arbiter=True))):
        eng = TEngine(c, slots=2, max_ctx=80, seed=4, device="cpu", **knobs)
        reqs = ttrace(4, context_len=36, output_len=8, seed=2,
                      ctx_jitter=0.0, vocab=c.vocab)
        out = eng.run(reqs)
        runs[name] = (eng, out, [r.out_tokens for r in reqs])
    tokens = runs["off"][2]
    for name, (eng, out, toks) in runs.items():
        assert toks == tokens, name
        assert (eng.stats.prefetched_entries > 0) == (name != "off"
                                                      and name != "resize")
        assert (eng.stats.resizes > 0) == (name in ("resize", "all"))
    for name in ("arbiter", "all"):
        assert 0 < runs[name][1]["arbiter_width_mean"] < cfg.sac.prefetch_width
