"""The port's Zamba2 hybrid (``zamba_super``: Mamba2 layers then the one
tied shared-attention layer; ``mamba_tail``) against the JAX reference,
on reduced Zamba2-7B (2 super-blocks of 2 Mamba2 layers + the shared
layer, 1 tail layer; d=64, 4 heads over 4 KV heads of 16, SSM state 16)
with weights bridged by ``repro_torch/bridge.py``.

- The bridge: the nested ``{"mamba_layers": [n, a, ...]}`` and tail
  ``[n, ...]`` stacks and the top-level ``"shared"`` layer both ways,
  bit for bit; every pool layer's attention parameters are the one
  ``params["shared"]`` dict (the same tensors, not copies); the serve
  state (``rec_*`` tuples, pools, hot tier) both ways, bit for bit.
- Prefill and decode (SAC mode with an injected, score-independent
  top-k, and dense mode), teacher-forced, walked layer by layer in the
  reference's order: each port layer against the reference's on the
  port's own input and state to it, within REL_L2 (tests/test_torch_
  gqa.py's 3e-2; 0.2-0.8 % measured, about one bf16 rounding: XLA keeps
  f32 between some bf16 operations that PyTorch rounds one by one):
  outputs, entries and indexer keys, every ``rec_*`` leaf a layer
  updates; the hot tier's integer state and hit/miss counts exact; and
  the whole model's ``prefill`` / ``decode`` equal to that walk bit for
  bit (pools, logits, ``rec_*``, hot tier).
- The whole model against the reference (prefill logits, teacher-forced
  decode logits, every ``rec_*`` leaf; SAC and dense mode) within
  WHOLE_L2, limits derived from the reference's own spread: random-weight
  layers amplify a one-rounding difference of their input, so that the
  reference run op by op (``jax.disable_jit``) and under ``jax.jit``
  differs by up to 0.036 in the prefill logits and 0.38 in decode here,
  which a test records.  Controls (the SSD's carried state dropped
  between prefill chunks, ``rec_*`` dropped between decode steps) must
  exceed the limits.
- ``warm_idx``: the reference's shape and valid lanes (its ranks sit on
  near-ties between the packages); ``rec_*`` after prefill in the
  reference's layouts and dtypes, all zeros, as the reference returns
  it.
- Inside the port: sparse == dense bit for bit when top-k covers the
  context (pools and ``rec_*`` too).
- The serving Engine against the JAX Engine on one trace: timelines,
  EngineStats (the per-layer hot-tier outcome included) and
  TrafficStats exact, the hot tier's integer state exact.

The reference's whole-model runs (under jax.jit and op by op) run in one
subprocess started with the module, beside the layer walks here.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.core.pool import local_fetch as jfetch
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.request import sharegpt_trace as jtrace
from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                state_from_jax, state_to_numpy)
from repro_torch.configs import get_config as tget
from repro_torch.core import hisparse
from repro_torch.core.pool import local_fetch as tfetch
from repro_torch.core.pool import pool_write_step
from repro_torch.models import transformer as ttr
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import sharegpt_trace as ttrace
from torch_engine_pair import assert_engines_equal, jax_topk, torch_topk

REL_L2 = 3e-2
ARCH = "zamba2-7b"
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_rel_close(got, want, axis, what):
    """Relative L2 error of every slice along ``axis`` within REL_L2."""
    got, want = np.moveaxis(_np(got), axis, 0), np.moveaxis(_np(want), axis,
                                                            0)
    assert got.shape == want.shape, what
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= REL_L2, f"{what}[{i}]: relative L2 error {err:.4f}"


def _configs():
    return get_config(ARCH).reduced(), tget(ARCH).reduced()


@pytest.fixture(scope="module")
def bridged():
    cfg, tcfg = _configs()
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, np_params, params_from_jax(np_params, tcfg,
                                                         "cpu")


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


def test_bridge_round_trip_and_shared_layer(bridged):
    """JAX pytree -> port params -> numpy, every leaf bit-identical; the
    segments as lists of iterations; one shared layer, used by every
    pool layer as the same tensors."""
    cfg, tcfg, _, np_params, tp = bridged
    back = params_to_numpy(tp, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        want = leaf.view(np.uint16) if leaf.dtype.itemsize == 2 else leaf
        assert node.shape == want.shape, path
        np.testing.assert_array_equal(node, want, err_msg=str(path))
    assert [len(s) for s in tp["segments"]] == [2, 1]
    assert len(tp["segments"][0][1]["mamba_layers"]) == cfg.shared_attn_every
    # iteration 1's Mamba2 layer 0 is the reference's [1, 0] slice
    np.testing.assert_array_equal(
        tp["segments"][0][1]["mamba_layers"][0]["mamba"]["w_in"].view(
            torch.int16).numpy().view(np.uint16),
        np_params["segments"][0]["mamba_layers"]["mamba"]["w_in"][1, 0]
        .view(np.uint16))
    layers = ttr.pool_layer_params(tcfg, tp)
    assert len(layers) == ttr.n_kv_layers(tcfg) == 2
    assert all(p is tp["shared"] for p in layers)
    # the model's own init holds one shared layer too: its parameters
    # count the shared layer once, as the reference's do
    model = tbuild(tcfg, device="cpu")
    own = model.init(torch.Generator().manual_seed(0))
    n_port = sum(t.numel() for t in jax.tree.leaves(
        own, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n_port == sum(a.size for a in jax.tree.leaves(np_params))


def test_serve_state_bridge_round_trip(bridged):
    """A reference serve state with non-zero ``rec_*`` (after two decode
    steps) -> the port's -> numpy, bit for bit, tuples and dtypes kept."""
    cfg, _, params, _, _ = bridged
    jm = jbuild(cfg)
    jst = jm.init_serve_state(2, 24, device_buffer=8)
    for tok in ([1, 2], [3, 4]):
        jst, _ = jax.jit(jm.decode)(params, jst, jnp.asarray(tok, jnp.int32))
    np_st = jax.tree.map(np.asarray, jst)
    tst = state_from_jax(np_st, device="cpu")
    assert type(tst["rec_0"]) is tuple and len(tst["rec_0"]) == 2
    assert tst["rec_0"][0].dtype == torch.float32
    assert tst["rec_0"][1].dtype == torch.bfloat16
    assert float(tst["rec_0"][0].abs().max()) > 0
    back = state_to_numpy(tst)
    for (path, leaf), got in zip(jax.tree_util.tree_leaves_with_path(np_st),
                                 jax.tree.leaves(back)):
        want = leaf.view(np.uint16) if leaf.dtype.name == "bfloat16" \
            else leaf
        np.testing.assert_array_equal(got, want, err_msg=str(path))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _jax_tree(x):
    """Port tensors (nested tuples) -> JAX arrays of the same bits."""
    if isinstance(x, tuple):
        return type(x)(*map(_jax_tree, x)) if hasattr(x, "_fields") \
            else tuple(map(_jax_tree, x))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(x.numpy())


def _clone(state):
    return {k: (type(v)(*(t.clone() for t in v)) if hasattr(v, "_fields")
                else jax.tree.map(torch.clone, v))
            for k, v in state.items()}


def test_prefill_pools_warm_idx_logits(bridged):
    """Prefill of a 24-token prompt cut into 3 SSD chunks, walked layer
    by layer in the reference's order: each port layer against the
    reference's on the port's own input to it (output, and for the
    shared layer its entries and indexer keys, within REL_L2); the whole
    model's ``prefill`` equal to that walk bit for bit (pools, logits);
    ``warm_idx`` with the reference's shape and valid lanes (its ranks
    sit on near-ties between the packages); the state's keys the
    reference's, ``rec_*`` in its layouts and all zeros."""
    cfg, tcfg, params, _, tp = bridged
    opts = {"warmup_w": 16, "ssm_chunk": 8}
    tm = tbuild(tcfg, opts=opts, device="cpu")
    T = 24
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, T)).astype(np.int32)
    tst, tlast = tm.prefill(tp, torch.from_numpy(prompt))
    jst, _ = jax.jit(jbuild(cfg, opts=opts).prefill)(params,
                                                     jnp.asarray(prompt))
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (2, T))
    tpos = torch.from_numpy(np.array(pos))
    jattn = jax.jit(lambda p, x: jtr._layer_fwd(p, x, cfg, pos, 0)[:3])
    jmamba = jax.jit(lambda p, x: x + jssm.mamba2_block(
        p["mamba"], jlayers.rms_norm(x, p["ln"]), cfg, chunk=8)[0])
    x = tp["embed"][torch.from_numpy(prompt).long()]
    n, entries, keys = 0, [], []
    for seg, items, jseg in zip(ttr.build_segments(tcfg), tp["segments"],
                                params["segments"]):
        for i, it in enumerate(items):
            if seg.kind == "zamba_super":
                steps = [("mamba", jax.tree.map(lambda a: a[i, j],
                                                jseg["mamba_layers"]), pl)
                         for j, pl in enumerate(it["mamba_layers"])]
                steps.append(("attn", params["shared"], tp["shared"]))
            else:
                steps = [("mamba", jax.tree.map(lambda a: a[i], jseg), it)]
            for kind, jp, tpl in steps:
                if kind == "mamba":
                    want = jmamba(jp, _jax_tree(x))
                    x = ttr._mamba_fwd(tpl, x, tcfg, 8)
                else:
                    want, jentry, jkey = jattn(jp, _jax_tree(x))
                    x, entry, key, _, _ = ttr._layer_fwd(tpl, x, tcfg, tpos,
                                                         0, 1)
                    _assert_rel_close(entry, jentry, 0, f"entry {n}")
                    _assert_rel_close(key, jkey, 0, f"key {n}")
                    entries.append(entry)
                    keys.append(key)
                _assert_rel_close(x, want, 0, f"layer {n}")
                n += 1
    assert n == cfg.n_layers + cfg.n_layers // cfg.shared_attn_every
    assert torch.equal(tst["kv_pool"], torch.stack(entries))
    assert torch.equal(tst["idx_pool"], torch.stack(keys))
    assert torch.equal(tlast, tm._logits(tp, x[:, -1]))
    assert set(tst) == set(jst)
    warm, jwarm = tst["warm_idx"].numpy(), np.asarray(jst["warm_idx"])
    assert warm.shape == jwarm.shape == (2, 2, 16)
    assert warm.dtype == np.int32
    np.testing.assert_array_equal(warm >= 0, jwarm >= 0)
    assert all(len(set(row)) == 16 and max(row) < T
               for row in warm.reshape(-1, 16).tolist())
    for key in ("rec_0", "rec_1"):
        for a, b in zip(jax.tree.leaves(tst[key]), jax.tree.leaves(jst[key])):
            assert tuple(a.shape) == b.shape and not a.any()
            assert str(a.dtype).split(".")[-1] == str(b.dtype)


def _prefilled(cfg, params, jm, sac, T=30, S=48):
    """A reference serve state of 2 slots holding a T-token prompt's
    pools (and, in SAC mode, a hot tier of 12), and the prompt's rng."""
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    jst1, _ = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
    jst = jm.init_serve_state(2, S, device_buffer=12 if sac else 0)
    for key in ("kv_pool", "idx_pool"):
        jst[key] = jst[key].at[:, :, :T].set(jst1[key])
    jst["cache_len"] = jnp.full((2,), T, jnp.int32)
    return jst, rng


def _ctx(cache_len, fetch_fn, topk_fn, mode):
    return dict(positions=cache_len, cache_len=cache_len, fetch_fn=fetch_fn,
                topk_fn=topk_fn, mode=mode, prefetch_width=0,
                prefetch_fn=None, score_margin=-1.0, pf_budget=None)


@pytest.mark.parametrize("mode", ["sac", "dense"])
def test_decode_teacher_forced(bridged, mode):
    """Two teacher-forced decode steps of the whole model from a
    prefilled state, walked layer by layer in the reference's order
    (iteration i's Mamba2 layer j on ``rec_0[:, i, j]``, then the shared
    layer on pool layer i; the tail on ``rec_1[:, i]``):

    - each port layer against the reference's on the port's own input
      and state to it (output, every ``rec_*`` leaf it updates, the new
      entry and indexer key within REL_L2; in SAC mode its hot-tier
      integer state and hit/miss counts exact);
    - the whole model's ``decode`` equal to that walk bit for bit
      (logits, pools, ``rec_*``, hot tier);
    - in SAC mode the hot tier's integer state and counters equal the
      reference decode's (the injected top-k makes them independent of
      the activations)."""
    cfg, tcfg, params, _, tp = bridged
    sac = mode == "sac"
    jm = jbuild(cfg, mode=mode, topk_fn=jax_topk if sac else None)
    tm = tbuild(tcfg, mode=mode, topk_fn=torch_topk if sac else None,
                device="cpu")
    jst, rng = _prefilled(cfg, params, jm, sac)
    tst = state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    jdecode = jax.jit(jm.decode)
    # the reference's layers, each compiled once (every layer and step
    # has the same shapes)
    jmamba = jax.jit(lambda p, x, st: jssm.mamba2_decode(
        p["mamba"], jlayers.rms_norm(x, p["ln"]), cfg, st))
    jshared = jax.jit(lambda x, kv, idx, hb, cache_len: jtr._layer_decode(
        params["shared"], x, cfg, _ctx(cache_len, jfetch,
                                       jax_topk if sac else None, mode),
        kv, idx, 0, hb))
    for step in range(2):
        toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        ttoks = torch.from_numpy(toks)
        want_st, want_log = tm.decode(tp, _clone(tst), ttoks)
        jlen = jnp.asarray(tst["cache_len"].numpy())
        tctx = _ctx(tst["cache_len"], tfetch, torch_topk if sac else None,
                    mode)
        x = tp["embed"][ttoks.long()]
        layer, entries, keys = 0, [], []
        for si, (seg, items) in enumerate(zip(ttr.build_segments(tcfg),
                                              tp["segments"])):
            jseg, trec = params["segments"][si], tst[f"rec_{si}"]
            for i, it in enumerate(items):
                if seg.kind == "zamba_super":
                    mambas = [((i, j), pl)
                              for j, pl in enumerate(it["mamba_layers"])]
                    jlayers_ = jseg["mamba_layers"]
                else:
                    mambas, jlayers_ = [((i,), it)], jseg
                for at, tpl in mambas:
                    what = f"step {step} mamba {si}.{at}"
                    jp = jax.tree.map(lambda a: a[at], jlayers_)
                    st = tuple(t[at] for t in trec)
                    jx = _jax_tree(x)
                    jout, jnew = jmamba(jp, jx, _jax_tree(st))
                    x = ttr._mamba_decode(tpl, x, tcfg, st)
                    _assert_rel_close(x, jx + jout, 0, what)
                    for k, (a, b) in enumerate(zip(st, jnew)):
                        _assert_rel_close(a, b, 0, f"{what} rec.{k}")
                if seg.kind != "zamba_super":
                    continue
                what = f"step {step} pool layer {layer}"
                hb_t = (hisparse.BufferState(
                    *(t[layer] for t in tst["hot_buf"])) if sac else None)
                jx, jown, jkey, jhb, jh, jmiss = jshared(
                    _jax_tree(x), _jax_tree(tst["kv_pool"][layer]),
                    _jax_tree(tst["idx_pool"][layer]) if sac else None,
                    _jax_tree(hb_t) if sac else None, jlen)
                x, town, tkey, thb, th, tmiss = ttr._layer_decode(
                    tp["shared"], x, tcfg, tctx, tst["kv_pool"][layer],
                    tst["idx_pool"][layer] if sac else None, 0, hb_t)
                _assert_rel_close(x, jx, 0, what)
                _assert_rel_close(town, jown, 0, f"{what} entry")
                entries.append(town)
                keys.append(tkey)
                if sac:
                    _assert_rel_close(tkey, jkey, 0, f"{what} key")
                    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
                    np.testing.assert_array_equal(tmiss.numpy(),
                                                  np.asarray(jmiss))
                    for name in ("slot_pos", "page_table", "last_use",
                                 "clock"):
                        np.testing.assert_array_equal(
                            getattr(thb, name).numpy(),
                            np.asarray(getattr(jhb, name)), err_msg=name)
                    hisparse.store(hb_t, thb)
                layer += 1
        assert layer == ttr.n_kv_layers(tcfg)
        # the walk's pool write and logits: the model's decode, exactly
        pool_write_step([tst["kv_pool"], tst["idx_pool"]],
                        [torch.stack(entries), torch.stack(keys)],
                        tst["cache_len"])
        assert torch.equal(tm._logits(tp, x), want_log)
        for key in ("kv_pool", "idx_pool", "rec_0", "rec_1"):
            for a, b in zip(jax.tree.leaves(tst[key]),
                            jax.tree.leaves(want_st[key])):
                assert torch.equal(a, b), (step, key)
        if sac:
            for a, b in zip(tst["hot_buf"], want_st["hot_buf"]):
                assert torch.equal(a, b), step
        tst = want_st
        jst, _ = jdecode(params, jst, jnp.asarray(toks))
        if sac:
            for key in ("buf_hits", "buf_misses", "buf_hits_l",
                        "buf_misses_l"):
                np.testing.assert_array_equal(
                    tst[key].numpy(), np.asarray(jst[key]), err_msg=key)
            for name in ("slot_pos", "page_table", "last_use", "clock"):
                np.testing.assert_array_equal(
                    getattr(tst["hot_buf"], name).numpy(),
                    np.asarray(getattr(jst["hot_buf"], name)), err_msg=name)


def test_sparse_equals_dense_when_topk_covers_context():
    """top-k >= the context: the sparse decode (indexer, top-k, gather,
    sparse attention on the shared layer) is bit-identical to the dense
    one, logits, pools and recurrent state."""
    B, S = 2, 40
    cfg = tget(ARCH).reduced()
    cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                           topk=S + 8))
    m_sac = tbuild(cfg, mode="sac", device="cpu")
    m_dense = tbuild(cfg, mode="dense", device="cpu")
    params = m_sac.init(torch.Generator().manual_seed(0))
    inp = torch.randint(0, cfg.vocab, (B, S),
                        generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32)
    lengths = torch.full((B,), S - 4, dtype=torch.int32)
    st1, _ = m_sac.prefill(params, inp, lengths=lengths)
    st2, _ = m_dense.prefill(params, inp, lengths=lengths)
    toks = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(3):
        st1, l1 = m_sac.decode(params, st1, toks)
        st2, l2 = m_dense.decode(params, st2, toks)
        assert torch.equal(l1, l2)
        assert torch.equal(st1["kv_pool"], st2["kv_pool"])
        for key in ("rec_0", "rec_1"):
            for a, b in zip(jax.tree.leaves(st1[key]),
                            jax.tree.leaves(st2[key])):
                assert torch.equal(a, b)
        toks = torch.argmax(l1, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_engine_timeline_and_traffic_exact(bridged):
    """Engine.run on reduced Zamba2 with the injected top-k: per-request
    timeline, EngineStats, TrafficStats and the hot tier's integer state
    equal the JAX engine's exactly; every slot's recurrent state was
    spliced (non-zero after decoding)."""
    cfg, tcfg, params, _, tparams = bridged
    kw = dict(slots=2, max_ctx=96, seed=3)
    je = JEngine(cfg, topk_fn=jax_topk, **kw)
    je.params = params
    jreqs = jtrace(5, context_len=40, output_len=6, seed=1, ctx_jitter=0.0,
                   vocab=cfg.vocab)
    jout = je.run(jreqs)
    te = TEngine(tcfg, topk_fn=torch_topk, device="cpu", **kw)
    te.params = tparams
    treqs = ttrace(5, context_len=40, output_len=6, seed=1, ctx_jitter=0.0,
                   vocab=cfg.vocab)
    tout = te.run(treqs)
    assert_engines_equal(je, jreqs, jout, te, treqs, tout)
    assert te.stats.buffer_hits + te.stats.buffer_misses > 0
    for name in ("slot_pos", "page_table", "last_use"):
        np.testing.assert_array_equal(
            getattr(te.state["hot_buf"], name).numpy(),
            np.asarray(getattr(je.state["hot_buf"], name)), err_msg=name)
    for key in ("rec_0", "rec_1"):
        for leaf in jax.tree.leaves(te.state[key]):
            assert leaf.float().abs().sum() > 0


# ---------------------------------------------------------------------------
# the whole model against the reference
# ---------------------------------------------------------------------------

# The whole model's limits, relative L2 of the prefill logits, the decode
# logits and each rec_* leaf.  Random-weight layers amplify a
# one-rounding difference of their input, so that the reference run op
# by op (jax.disable_jit) differs from itself under jax.jit by up to 0.036
# in the prefill logits here and 0.38 in decode (rec_* after the first
# dense step; 0.06 in SAC mode).  The port's sound runs reach 0.052 and
# 0.36; the controls reach 0.48 (the SSD's carried state dropped between
# prefill chunks) and 1.0-1.5 (rec_* dropped between decode steps).
# Each limit sits between the two.
WHOLE_L2 = {"prefill": 0.15, "decode": 0.5, "rec": 0.5}


def _rel(got, want):
    a, b = _np(got), _np(want)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _no_carry(block):
    """``mamba2_block`` with its carried state (SSD and conv) dropped at
    each chunk boundary: a wrong chunking, the prefill's control."""
    def wrong(p, x, cfg, *, chunk=256):
        S = x.shape[1]
        Lc = S // max(S // chunk, 1)
        return torch.cat([block(p, x[:, c:c + Lc], cfg, chunk=chunk)[0]
                          for c in range(0, S, Lc)], 1), None
    return wrong


# The reference's runs of the ``whole`` fixture (under jax.jit and op by
# op, both modes), in one subprocess started with the module: they need
# none of the port's results, so they run while this process walks the
# layers.  Its results cross as numpy.
_REFERENCE = textwrap.dedent("""
    import pickle, sys
    sys.path.insert(0, sys.argv[2])
    import numpy as np, jax, jax.numpy as jnp
    from repro.models.model import build_model as jbuild
    from test_torch_zamba import _configs, _prefilled
    from torch_engine_pair import jax_topk

    cfg, _ = _configs()
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(3))
    leaves = lambda st: [np.asarray(a) for key in ("rec_0", "rec_1")
                         for a in jax.tree.leaves(st[key])]
    out = {}
    for mode in ("sac", "dense"):
        sac = mode == "sac"
        jm = jbuild(cfg, mode=mode, topk_fn=jax_topk if sac else None,
                    opts={"ssm_chunk": 8})
        jst, rng = _prefilled(cfg, params, jm, sac)
        prompt = np.random.default_rng(30).integers(
            0, cfg.vocab, size=(2, 30)).astype(np.int32)
        _, want = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
        with jax.disable_jit():
            _, ref = jm.prefill(params, jnp.asarray(prompt))
        res = dict(prompt=prompt, state=jax.tree.map(np.asarray, jst),
                   prefill=(np.asarray(want), np.asarray(ref)), steps=[])
        jdecode = jax.jit(jm.decode)
        ref_st = jst
        for _ in range(3):
            toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
            jst, want = jdecode(params, jst, jnp.asarray(toks))
            with jax.disable_jit():
                ref_st, ref = jm.decode(params, ref_st, jnp.asarray(toks))
            res["steps"].append(dict(
                toks=toks, want=np.asarray(want), ref=np.asarray(ref),
                want_rec=leaves(jst), ref_rec=leaves(ref_st)))
        out[mode] = res
    pickle.dump(out, open(sys.argv[1], "wb"))
""")


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference subprocess, started with the module; ``result()``
    waits for its runs."""
    path = tmp_path_factory.mktemp("zamba") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'tests'}:{ROOT / 'src'}")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(path), str(ROOT / "tests")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    done = {}

    def result():
        if not done:
            out, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, out
            with open(path, "rb") as f:
                done.update(pickle.load(f))
        return done
    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module", params=["sac", "dense"])
def whole(bridged, reference, request):
    """A 30-token prompt in 3 SSD chunks, then 3 teacher-forced decode
    steps from the reference's prefilled state, through the reference
    under jax.jit (``want``), the reference op by op (``ref``; both in
    the ``reference`` subprocess), the port (``port``) and the port's
    controls (``control``: the prefill with the SSD's carry dropped,
    decode with ``rec_*`` zeroed before each step): relative L2 errors
    against ``want`` of each request's prefill logits, each request's
    decode logits a step and each ``rec_*`` leaf a step."""
    _, tcfg, _, _, tp = bridged
    mode = request.param
    sac = mode == "sac"
    tm = tbuild(tcfg, mode=mode, topk_fn=torch_topk if sac else None,
                opts={"ssm_chunk": 8}, device="cpu")
    res = reference()[mode]
    prompt = res["prompt"]
    want, ref = res["prefill"]
    _, port = tm.prefill(tp, torch.from_numpy(prompt))
    block = ttr.ssm.mamba2_block
    ttr.ssm.mamba2_block = _no_carry(block)
    try:
        _, control = tm.prefill(tp, torch.from_numpy(prompt))
    finally:
        ttr.ssm.mamba2_block = block
    out = {k: dict(prefill=[_rel(x[i], want[i]) for i in range(2)],
                   decode=[], rec=[])
           for k, x in (("ref", ref), ("port", port), ("control", control))}
    states = dict(port=state_from_jax(res["state"], device="cpu"),
                  control=state_from_jax(res["state"], device="cpu"))
    for step in res["steps"]:
        toks, want = step["toks"], step["want"]
        for key in ("rec_0", "rec_1"):
            for leaf in jax.tree.leaves(states["control"][key]):
                leaf.zero_()
        logits, recs = {"ref": step["ref"]}, {"ref": step["ref_rec"]}
        for k in ("port", "control"):
            states[k], logits[k] = tm.decode(tp, states[k],
                                             torch.from_numpy(toks))
            recs[k] = [a for key in ("rec_0", "rec_1")
                       for a in jax.tree.leaves(states[k][key])]
        for k, lg in logits.items():
            out[k]["decode"].append([_rel(lg[i], want[i]) for i in range(2)])
            out[k]["rec"].append([_rel(a, b) for a, b in
                                  zip(recs[k], step["want_rec"])])
    return mode, out


def test_reference_spread_jit_vs_op_by_op(whole):
    """The reference against itself, op by op and under jax.jit: more
    than the per-layer REL_L2 (in the logits or ``rec_*``), and within
    the limits WHOLE_L2 derived from it."""
    mode, out = whole
    spread = {what: float(np.max(errs)) for what, errs in out["ref"].items()}
    assert max(spread.values()) > REL_L2, (mode, spread)
    for what, worst in spread.items():
        assert worst <= WHOLE_L2[what], (mode, what, worst)


def test_whole_model_against_reference(whole):
    """The port's whole model against the reference under jax.jit:
    prefill logits, teacher-forced decode logits and every ``rec_*``
    leaf within WHOLE_L2 for every request and step; the controls (the
    SSD's carry dropped in prefill; ``rec_*`` dropped, which shows from
    the second decode step) beyond it for every request."""
    mode, out = whole
    port, control = out["port"], out["control"]
    for what, limit in WHOLE_L2.items():
        errs = np.asarray(port[what])
        assert errs.max() <= limit, (mode, what, errs.round(4).tolist())
    assert min(control["prefill"]) > WHOLE_L2["prefill"], control["prefill"]
    for step, errs in enumerate(control["decode"][1:], 1):
        assert min(errs) > WHOLE_L2["decode"], (mode, step, errs)

