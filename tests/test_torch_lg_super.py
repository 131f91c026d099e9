"""The port's ``lg_super`` segment (Gemma3: super-blocks of local-window
layers followed by one global layer) against the JAX reference, on the
same numpy-seeded weights bridged by ``repro_torch/bridge.py``.

- The bridge: the reference nests the segment as ``{"local": [n, r, ...],
  "global": [n, ...]}``; the port keeps a flat list in pool-layer order
  (super-block i's local layers, then its global layer).  Round trip bit
  for bit at ``reduced()`` (r = 1, n = 1, which cannot show a nesting
  mistake) and at r = 2, n = 2, where each port layer is also checked
  against the reference leaf it must come from.
- Prefill: pools, the warm-up candidates ``warm_idx`` and the logits at
  r = 2, n = 2 with a local window below the prompt, so that the local
  layers' mask bites.
- Decode under teacher forcing with an injected, score-independent top-k
  in SAC mode (hot-tier integer state exact) and in dense mode: pools
  and logits within the relative L2 error of tests/test_torch_gqa.py.
- Inside the port: sparse == dense bit for bit when top-k covers the
  context, with the local layers past their window.
- The serving Engine against the JAX Engine on one trace: timelines,
  EngineStats and TrafficStats exact, with uniform and with windowed
  hot-tier sizing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as jtr
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.request import sharegpt_trace as jtrace
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config as tget
from repro_torch.core.pool import pool_write_prefill
from repro_torch.models import transformer as ttr
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import sharegpt_trace as ttrace

K = 16
REL_L2 = 3e-2
ARCH = "gemma3-12b"
# two super-blocks of 2 local layers (window 12) + 1 global layer
NESTED = dict(local_global_ratio=2, n_layers=6, local_window=12)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_rel_close(got, want, axis, what):
    got, want = np.moveaxis(_np(got), axis, 0), np.moveaxis(_np(want), axis,
                                                            0)
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= REL_L2, f"{what}[{i}]: relative L2 error {err:.4f}"


def jax_topk(scores, cache_len):
    j = jnp.arange(K, dtype=jnp.int32)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * ((t + j) // 5)) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), (j < t) & (j % 5 != 3)


def torch_topk(scores, cache_len):
    j = torch.arange(K, dtype=torch.int32, device=scores.device)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * torch.div(t + j, 5, rounding_mode="floor")) \
        % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def _configs(**replace):
    cfg, tcfg = get_config(ARCH).reduced(), tget(ARCH).reduced()
    return (dataclasses.replace(cfg, **replace),
            dataclasses.replace(tcfg, **replace))


def _bridged(cfg, tcfg, seed):
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    return params, np_params, params_from_jax(np_params, tcfg, "cpu")


@pytest.fixture(scope="module")
def nested():
    cfg, tcfg = _configs(**NESTED)
    return (cfg, tcfg) + _bridged(cfg, tcfg, 3)


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replace", [{}, NESTED])
def test_bridge_round_trip(replace):
    """JAX pytree -> port params -> numpy, every leaf bit-identical, and
    the segment flattened to one layer dict per pool layer."""
    cfg, tcfg = _configs(**replace)
    _, np_params, tp = _bridged(cfg, tcfg, 1)
    assert len(tp["segments"]) == 1
    assert len(tp["segments"][0]) == ttr.n_kv_layers(tcfg) == cfg.n_layers
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


def test_bridge_layer_order(nested):
    """Port layer (r + 1) i + j is local layer j of super-block i, and
    layer (r + 1) i + r its global layer."""
    cfg, tcfg, _, np_params, tp = nested
    r = cfg.local_global_ratio
    seg = np_params["segments"][0]
    for i in range(cfg.n_layers // (r + 1)):
        for j in range(r + 1):
            got = tp["segments"][0][(r + 1) * i + j]["attn"]["wq"]
            want = (seg["local"]["attn"]["wq"][i, j] if j < r
                    else seg["global"]["attn"]["wq"][i])
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))


def test_layer_windows_follow_the_reference(nested):
    cfg, tcfg = nested[:2]
    assert ttr.kv_layer_windows(tcfg) == jtr.kv_layer_windows(cfg) \
        == [12, 12, 0, 12, 12, 0]
    assert tbuild(tcfg, device="cpu").windows == [12, 12, 0, 12, 12, 0]


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_pools_warm_idx_and_logits(nested):
    """Pools and logits close; the warm-up candidates of the local
    layers lie inside their trailing window, with -1 on the lanes the
    window leaves empty, exactly where the reference has them."""
    cfg, tcfg, params, _, tp = nested
    opts = {"warmup_w": 16}
    jm = jbuild(cfg, opts=opts)
    tm = tbuild(tcfg, opts=opts, device="cpu")
    T = 30
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, T)).astype(np.int32)
    jst, jlast = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
    tst, tlast = tm.prefill(tp, torch.from_numpy(prompt))
    for key in ("kv_pool", "idx_pool"):
        assert tuple(tst[key].shape) == tuple(jst[key].shape)
        _assert_rel_close(tst[key], jst[key], 1, f"prefill {key}")
    _assert_rel_close(tlast, jlast, 0, "prefill logits")
    warm, jwarm = tst["warm_idx"].numpy(), np.asarray(jst["warm_idx"])
    assert warm.shape == jwarm.shape == (6, 2, 16)
    np.testing.assert_array_equal(warm >= 0, jwarm >= 0)
    for layer, w in enumerate(tm.windows):
        got = warm[layer]
        if w:      # 11 positions in (T - 12, T): 5 lanes of -1
            assert ((got > T - w) | (got == -1)).all()
            assert (got == -1).sum() == 2 * 5
        else:
            assert (got >= 0).all()


@pytest.mark.parametrize("mode", ["sac", "dense"])
def test_decode_teacher_forced(nested, mode):
    """Pools and logits under teacher forcing past the local window; in
    SAC mode the injected top-k makes the hot-tier integer state and
    counters exact."""
    cfg, tcfg, params, _, tp = nested
    sac = mode == "sac"
    jm = jbuild(cfg, mode=mode, topk_fn=jax_topk if sac else None)
    tm = tbuild(tcfg, mode=mode, topk_fn=torch_topk if sac else None,
                device="cpu")
    T, S = 30, 48
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    jst1, _ = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
    buf = 12 if sac else 0
    jst = jm.init_serve_state(2, S, device_buffer=buf)
    tst = tm.init_serve_state(2, S, device_buffer=buf)
    for key in ("kv_pool", "idx_pool"):
        jst[key] = jst[key].at[:, :, :T].set(jst1[key])
        pool_write_prefill(tst[key], torch.from_numpy(
            np.asarray(jst1[key]).view(np.int16).copy()).view(torch.bfloat16))
    jst["cache_len"] = jnp.full((2,), T, jnp.int32)
    tst["cache_len"][:] = T
    jdecode = jax.jit(jm.decode)
    for step in range(4):
        toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jst, jlog = jdecode(params, jst, jnp.asarray(toks))
        tst, tlog = tm.decode(tp, tst, torch.from_numpy(toks))
        _assert_rel_close(tlog, jlog, 0, f"step {step} logits")
        _assert_rel_close(tst["kv_pool"], jst["kv_pool"], 1, "kv_pool")
        _assert_rel_close(tst["idx_pool"], jst["idx_pool"], 1, "idx_pool")
        if not sac:
            continue
        for key in ("buf_hits", "buf_misses", "buf_hits_l", "buf_misses_l"):
            np.testing.assert_array_equal(tst[key].numpy(),
                                          np.asarray(jst[key]), err_msg=key)
        for name in ("slot_pos", "page_table", "last_use", "clock"):
            np.testing.assert_array_equal(
                getattr(tst["hot_buf"], name).numpy(),
                np.asarray(getattr(jst["hot_buf"], name)), err_msg=name)


def test_sparse_equals_dense_when_topk_covers_context():
    """top-k >= the context: the sparse decode (indexer, window mask of
    the local layers, top-k, gather, sparse attention) is bit-identical
    to the dense one (window_attend on the local layers, the whole pool
    on the global ones), with the context past the local window."""
    B, S = 2, 40
    cfg = tget(ARCH).reduced()
    cfg = dataclasses.replace(cfg, **NESTED, sac=dataclasses.replace(
        cfg.sac, topk=S + 8))
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
        toks = torch.argmax(l1, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer_sizing", ["uniform", "windowed"])
def test_engine_timeline_and_traffic_exact(layer_sizing):
    """Engine.run on reduced Gemma3 (local window 8 under a 40-token
    context, below the top-k of 16) with the injected top-k: per-request
    timeline, EngineStats, the per-layer hot-tier outcome, the sizes the
    LayerSizer gives and TrafficStats equal the JAX engine's exactly."""
    cfg, tcfg = _configs(local_window=8)
    params, _, tparams = _bridged(cfg, tcfg, 2)
    kw = dict(slots=2, max_ctx=96, topk_fn=None, seed=3,
              layer_sizing=layer_sizing)
    je = JEngine(cfg, **dict(kw, topk_fn=jax_topk))
    je.params = params
    jreqs = jtrace(5, context_len=40, output_len=6, seed=1, ctx_jitter=0.0,
                   vocab=cfg.vocab)
    jout = je.run(jreqs)
    te = TEngine(tcfg, **dict(kw, topk_fn=torch_topk), device="cpu")
    te.params = tparams
    treqs = ttrace(5, context_len=40, output_len=6, seed=1, ctx_jitter=0.0,
                   vocab=cfg.vocab)
    tout = te.run(treqs)
    assert te.buffer_sizes == je.buffer_sizes
    if layer_sizing == "windowed":
        assert te.buffer_sizes[0] != te.buffer_sizes[1]
    for a, b in zip(jreqs, treqs):
        assert (a.dispatch_s, a.first_token_s, a.finish_s, a.pool_device) \
            == (b.dispatch_s, b.first_token_s, b.finish_s, b.pool_device)
    assert dataclasses.asdict(te.stats.traffic) == \
        dataclasses.asdict(je.stats.traffic)
    for f in ("steps", "tokens", "buffer_hits", "buffer_misses",
              "radix_hit_tokens", "radix_evicted_pages"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    assert te.stats.buffer_hits + te.stats.buffer_misses > 0
    np.testing.assert_array_equal(te.stats.layer_misses,
                                  je.stats.layer_misses)
    for name in ("slot_pos", "page_table", "last_use"):
        np.testing.assert_array_equal(
            getattr(te.state["hot_buf"], name).numpy(),
            np.asarray(getattr(je.state["hot_buf"], name)), err_msg=name)
    assert tout == jout
