"""The port's GQA families (segment kinds ``dense`` and ``moe``) against
the JAX reference, on the same numpy inputs and bridged weights.

- Modules (``gqa_kv_entry``, ``gqa_sparse_decode``,
  ``dense_attention_block``, ``window_attend``) on reduced Qwen2 with
  NON-ZERO QKV biases (the specs initialise them to zeros, which would
  hide a bias bug): relative L2 error per request <= 3e-2, as in
  tests/test_torch_engine.py (bf16 activations round at other places in
  XLA and PyTorch; about 1% is typical).
- Models: teacher-forced prefill + decode of reduced Qwen2 (QKV bias),
  Mixtral (MoE, sliding window of 64 under a longer context), Granite
  (MQA) and a Qwen2 with 6 heads over 2 KV groups (n_rep = 3), in SAC
  mode with the hot tier and an injected score-independent top-k (the
  hot-tier integer state then must be exact), and in dense mode.
- The serving Engine on reduced Qwen2 against the JAX Engine with the
  injected top-k: timelines, TrafficStats and hot-tier counts exact.
- Inside the port: sparse == dense bit for bit when top-k covers the
  context, for every dense/moe config of ASSIGNED (the port's copy of
  tests/test_sac_equivalence.py), and beyond Mixtral's window.

The kernel-level checks of the GQA attention are in
tests/test_torch_kernels.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import sac as jsac
from repro.models import dsa as jdsa
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.request import sharegpt_trace as jtrace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ASSIGNED
from repro_torch.configs import get_config as tget
from repro_torch.core import sac as tsac
from repro_torch.core.pool import pool_write_prefill
from repro_torch.models import dsa as tdsa
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import sharegpt_trace as ttrace

K = 16
REL_L2 = 3e-2
# Mixtral's top-2 gate: with this seed the closest call between the 2nd
# and 3rd expert is 0.036 in probability in the decode steps and 0.0011
# in the prefill, which both frameworks route alike (seed 8 has an exact
# tie in the prefill, which the two may break either way)
SEED_MIXTRAL = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_rel_close(got, want, axis, what):
    """Relative L2 error of every slice along ``axis`` (a request)."""
    got, want = np.moveaxis(_np(got), axis, 0), np.moveaxis(_np(want), axis,
                                                            0)
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= REL_L2, f"{what}[{i}]: relative L2 error {err:.4f}"


def _pair(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def jax_topk(scores, cache_len):
    """Score-independent selection with duplicates and invalid lanes."""
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


def _configs(arch, **replace):
    cfg = get_config(arch).reduced()
    tcfg = tget(arch).reduced()
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    return cfg, tcfg


def _bridged(cfg, tcfg, seed):
    """JAX params (QKV biases set to non-zero values when the config has
    them) and their bridged copy on the CPU."""
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = np_params["segments"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            b = rng.standard_normal(attn[name].shape).astype(np.float32)
            attn[name] = np.asarray(jnp.asarray(0.5 * b, jnp.bfloat16))
        params = jax.tree.map(jnp.asarray, np_params)
    return params, params_from_jax(np_params, tcfg, "cpu")


@pytest.fixture(scope="module")
def qwen():
    cfg, tcfg = _configs("qwen2-1.5b")
    params, tparams = _bridged(cfg, tcfg, 7)
    return cfg, tcfg, params, tparams


def _attn_layer(params, tparams, i=0):
    pj = jax.tree.map(lambda a: a[i], params["segments"][0])["attn"]
    return pj, tparams["segments"][0][i]["attn"]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_qkv_biases_are_nonzero_and_bridged(qwen):
    cfg, tcfg, params, tparams = qwen
    pj, pt = _attn_layer(params, tparams, 1)
    for name in ("bq", "bk", "bv"):
        assert float(pt[name].float().abs().max()) > 0.1, name
        np.testing.assert_array_equal(_np(pt[name]), _np(pj[name]))
    assert set(pt) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


def test_gqa_kv_entry(qwen):
    cfg, tcfg, params, tparams = qwen
    pj, pt = _attn_layer(params, tparams)
    rng = np.random.default_rng(1)
    x_j, x_t = _pair(rng, 3, cfg.d_model)
    pos = np.array([0, 17, 40], np.int32)
    want = jdsa.gqa_kv_entry(pj, x_j, cfg, jnp.asarray(pos))
    got = tdsa.gqa_kv_entry(pt, x_t, tcfg, torch.from_numpy(pos))
    assert got.shape == (3, tdsa.gqa_entry_dim(tcfg))
    _assert_rel_close(got, want, 0, "entry")


@pytest.mark.parametrize("k", [K + 1, 40])
def test_gqa_sparse_decode(qwen, k):
    cfg, tcfg, params, tparams = qwen
    pj, pt = _attn_layer(params, tparams, 1)
    rng = np.random.default_rng(k)
    B = 3
    x_j, x_t = _pair(rng, B, cfg.d_model)
    e_j, e_t = _pair(rng, B, k, jdsa.gqa_entry_dim(cfg))
    valid = rng.random((B, k)) > 0.3
    valid[:, -1] = True
    pos = np.array([20, 33, 5], np.int32)
    want = jax.jit(jdsa.gqa_sparse_decode, static_argnums=2)(
        pj, x_j, cfg, e_j, jnp.asarray(valid), jnp.asarray(pos))
    got = tdsa.gqa_sparse_decode(pt, x_t, tcfg, e_t, torch.from_numpy(valid),
                                 torch.from_numpy(pos))
    _assert_rel_close(got, want, 0, "gqa_sparse_decode")


def test_gqa_dense_decode(qwen):
    """Dense decode over a whole pool slice with ragged cache lengths."""
    cfg, tcfg, params, tparams = qwen
    pj, pt = _attn_layer(params, tparams)
    rng = np.random.default_rng(6)
    B, S = 3, 21
    x_j, x_t = _pair(rng, B, cfg.d_model)
    p_j, p_t = _pair(rng, B, S, jdsa.gqa_entry_dim(cfg))
    cl = np.array([21, 5, 12], np.int32)
    want = jax.jit(jdsa.gqa_dense_decode, static_argnums=2)(
        pj, x_j, cfg, p_j, jnp.asarray(cl), jnp.asarray(cl))
    got = tdsa.gqa_dense_decode(pt, x_t, tcfg, p_t, torch.from_numpy(cl),
                                torch.from_numpy(cl))
    _assert_rel_close(got, want, 0, "gqa_dense_decode")


@pytest.mark.parametrize("window", [0, 5])
def test_dense_attention_block(qwen, window):
    cfg, tcfg, params, tparams = qwen
    pj, pt = _attn_layer(params, tparams)
    rng = np.random.default_rng(2 + window)
    B, S = 2, 24
    x_j, x_t = _pair(rng, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    out_j, (k_j, v_j) = jax.jit(jlayers.dense_attention_block,
                                static_argnums=2, static_argnames="window")(
        pj, x_j, cfg, jnp.asarray(pos), window=window)
    out_t, (k_t, v_t) = tlayers.dense_attention_block(
        pt, x_t, tcfg, torch.from_numpy(pos), window=window)
    _assert_rel_close(out_t, out_j, 0, "out")
    _assert_rel_close(tdsa.pack_kv_entry(k_t, v_t),
                      jdsa.pack_kv_entry(k_j, v_j), 0, "entries")


def test_window_attend(qwen):
    """Sliding-window decode: the trailing window-1 entries (fetched
    through the gather path) + the own entry, with cache lengths below,
    at and above the window."""
    cfg, tcfg, params, tparams = qwen
    pj, pt = _attn_layer(params, tparams, 1)
    rng = np.random.default_rng(3)
    B, S, window = 3, 40, 9
    x_j, x_t = _pair(rng, B, cfg.d_model)
    pool_j, pool_t = _pair(rng, B, S, jdsa.gqa_entry_dim(cfg))
    own_j, own_t = _pair(rng, B, jdsa.gqa_entry_dim(cfg))
    cl = np.array([4, 9, 31], np.int32)
    want = jax.jit(jsac.window_attend, static_argnums=(2, 7))(
        pj, x_j, cfg, pool_j, jnp.asarray(cl), jnp.asarray(cl), own_j,
        window)
    got = tsac.window_attend(pt, x_t, tcfg, pool_t, torch.from_numpy(cl),
                             torch.from_numpy(cl), own_t, window)
    _assert_rel_close(got, want, 0, "window_attend")


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

MODEL_CASES = [
    # (arch, config replacements, mode, prompt length, pool length, seed)
    ("qwen2-1.5b", {}, "sac", 30, 48, 5),
    ("qwen2-1.5b", {"n_heads": 6, "n_kv_heads": 2}, "sac", 30, 48, 5),
    ("granite-34b", {}, "sac", 30, 48, 5),
    ("mixtral-8x22b", {}, "sac", 72, 96, SEED_MIXTRAL),
    ("mixtral-8x22b", {}, "dense", 72, 96, SEED_MIXTRAL),
]


@pytest.mark.parametrize("arch,replace,mode,T,S,seed", MODEL_CASES)
def test_prefill_decode_teacher_forced(arch, replace, mode, T, S, seed):
    """Pools and logits under teacher forcing (the same token ids fed to
    both).  In SAC mode the selection is injected, and the hot-tier
    integer state and counters must be exact.  Mixtral's top-2 gate is
    checked for a near-tie (ROADMAP §3: a gate within a bf16 rounding of
    a tie may route differently in the two frameworks), and its seed is
    one whose decode steps have none."""
    cfg, tcfg = _configs(arch, **replace)
    params, tparams = _bridged(cfg, tcfg, seed)
    sac = mode == "sac"
    jm = jbuild(cfg, mode=mode, topk_fn=jax_topk if sac else None)
    tm = tbuild(tcfg, mode=mode, topk_fn=torch_topk if sac else None,
                device="cpu")
    rng = np.random.default_rng(T + seed)
    prompt = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    jst1, jlast = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
    tst1, tlast = tm.prefill(tparams, torch.from_numpy(prompt))
    keys = ("kv_pool", "idx_pool")
    for key in keys:
        _assert_rel_close(tst1[key], jst1[key], 1, f"prefill {key}")
    _assert_rel_close(tlast, jlast, 0, "prefill logits")
    buf = 12 if sac else 0
    jst = jm.init_serve_state(2, S, device_buffer=buf)
    tst = tm.init_serve_state(2, S, device_buffer=buf)
    for key in keys:
        # the JAX pools are spliced in bit for bit on both sides, so the
        # decode comparison starts from one state
        jst[key] = jst[key].at[:, :, :T].set(jst1[key])
        pool_write_prefill(tst[key], torch.from_numpy(
            np.asarray(jst1[key]).view(np.int16).copy()).view(torch.bfloat16))
    jst["cache_len"] = jnp.full((2,), T, jnp.int32)
    tst["cache_len"][:] = T
    jdecode = jax.jit(jm.decode)
    for step in range(4):
        toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jst, jlog = jdecode(params, jst, jnp.asarray(toks))
        tst, tlog = tm.decode(tparams, tst, torch.from_numpy(toks))
        _assert_rel_close(tlog, jlog, 0, f"step {step} logits")
        _assert_rel_close(tst["kv_pool"], jst["kv_pool"], 1, "kv_pool")
        if not sac:
            continue
        for key in ("buf_hits", "buf_misses", "buf_hits_l", "buf_misses_l"):
            np.testing.assert_array_equal(tst[key].numpy(),
                                          np.asarray(jst[key]), err_msg=key)
        for name in ("slot_pos", "page_table", "last_use", "clock"):
            np.testing.assert_array_equal(
                getattr(tst["hot_buf"], name).numpy(),
                np.asarray(getattr(jst["hot_buf"], name)), err_msg=name)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_engine_timeline_and_traffic_exact(qwen):
    """Engine.run on reduced Qwen2 with the injected top-k: per-request
    dispatch/first-token/finish, EngineStats, the per-layer hot-tier
    outcome and TrafficStats equal the JAX engine's exactly."""
    cfg, tcfg, params, tparams = qwen
    je = JEngine(cfg, slots=2, max_ctx=96, topk_fn=jax_topk, seed=3)
    je.params = params
    jreqs = jtrace(5, context_len=40, output_len=6, seed=1, ctx_jitter=0.0,
                   vocab=cfg.vocab)
    jout = je.run(jreqs)
    te = TEngine(tcfg, slots=2, max_ctx=96, topk_fn=torch_topk, seed=3,
                 device="cpu")
    te.params = tparams
    treqs = ttrace(5, context_len=40, output_len=6, seed=1, ctx_jitter=0.0,
                   vocab=cfg.vocab)
    tout = te.run(treqs)
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


# ---------------------------------------------------------------------------
# inside the port: sparse == dense
# ---------------------------------------------------------------------------

GQA_ASSIGNED = sorted(a for a in ASSIGNED
                      if not (tget(a).enc_dec or tget(a).xlstm
                              or tget(a).ssm_state
                              or tget(a).local_global_ratio or tget(a).mla))


def test_gqa_assigned_families():
    assert GQA_ASSIGNED == ["chameleon-34b", "dbrx-132b", "granite-34b",
                            "minicpm-2b", "mixtral-8x22b", "qwen2-1.5b"]


@pytest.mark.parametrize("arch,S", [(a, 32) for a in GQA_ASSIGNED]
                         + [("mixtral-8x22b", 96)])
def test_sparse_equals_dense_when_topk_covers_context(arch, S):
    """With top-k >= the context the sparse decode (indexer, top-k,
    gather, sparse GQA attention) is bit-identical to the dense decode
    (the whole pool, or the trailing window under a sliding window: at
    S=96 Mixtral's context of 92 is past its window of 64)."""
    B = 2
    cfg = tget(arch).reduced()
    cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                           topk=S + 8))
    m_sac = tbuild(cfg, mode="sac", device="cpu")
    m_dense = tbuild(cfg, mode="dense", device="cpu")
    params = m_sac.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    inp = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                        dtype=torch.int32)
    # pool headroom for the decoded tokens, as the reference's test keeps
    lengths = torch.full((B,), S - 4, dtype=torch.int32)
    st1, _ = m_sac.prefill(params, inp, lengths=lengths)
    st2, _ = m_dense.prefill(params, inp, lengths=lengths)
    toks = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(2):
        st1, l1 = m_sac.decode(params, st1, toks)
        st2, l2 = m_dense.decode(params, st2, toks)
        assert torch.equal(l1, l2)
        assert torch.equal(st1["kv_pool"], st2["kv_pool"])
        toks = torch.argmax(l1, -1).to(torch.int32)


def test_unported_families_raise():
    """No family is left unported: build_model builds every config of
    the registry (encoder-decoder included) without raising."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.encdec import EncDecLM
    for name, cfg in sorted(ARCHS.items()):
        m = tbuild(cfg.reduced(), device="cpu")
        assert isinstance(m, EncDecLM) == cfg.enc_dec, name
