"""The fp8 pool (``SACConfig.kv_quant="fp8"``: the pool and the hot tier
hold ``float8_e4m3fn`` entries, the indexer pool stays bf16) in the port
against the JAX reference.

- The cast: ``core/pool.py::to_kv_dtype`` equals ``astype(float8_e4m3fn)``
  of the reference bit for bit on all 65,536 bf16 patterns (PyTorch's own
  cast saturates past 464 where the reference gives NaN) and on f32
  values around the range's edge.
- The plain versions of the kernels take e4m3 entries exactly: the row
  movers copy their bytes, the attention reads them through ``.float()``.
- Prefill: the pools of reduced Qwen2 and DeepSeek-V3.2 are the
  reference's cast of the same bf16 entries, byte for byte (compared as
  ``uint8``), and close to the reference's own fp8 pool.
- Decode under teacher forcing from the reference's fp8 pool, with an
  injected top-k, also with the fetch pipeline on (injected speculation,
  per-request budgets): logits and pools close, the hot tier's integer
  state and ``pf_*`` counters exact.
- The reference's own criterion (tests/test_beyond_paper.py::
  test_fp8_pool_decode_close_to_bf16) inside the port.
- The serving Engine on reduced Gemma3 with fp8 against the JAX Engine
  on a shared-prefix trace (radix hits): timelines, EngineStats,
  TrafficStats and the hot tier exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.request import shared_prefix_trace as jtrace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.core.pool import E4M3, pool_write_prefill, to_kv_dtype
from repro_torch.kernels import ops, ref
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import shared_prefix_trace as ttrace

K, W = 16, 8
REL_L2 = 3e-2
_INT_FIELDS = ("slot_pos", "page_table", "last_use", "clock", "pf_flag",
               "pf_inserted", "pf_used")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _u8(x):
    """An e4m3 array of either framework as its bytes."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_rel_close(got, want, axis, what):
    got, want = np.moveaxis(_np(got), axis, 0), np.moveaxis(_np(want), axis,
                                                            0)
    for i, (a, b) in enumerate(zip(got, want)):
        err = _rel_l2(a, b)
        assert err <= REL_L2, f"{what}[{i}]: relative L2 error {err:.4f}"


def jax_topk(scores, cache_len):
    j = jnp.arange(K, dtype=jnp.int32)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * ((t + j) // 5)) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), (j < t) & (j % 5 != 3)


def torch_topk(scores, cache_len):
    j = torch.arange(K, dtype=torch.int32)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * torch.div(t + j, 5, rounding_mode="floor")) \
        % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def jax_spec(scores, cache_len):
    j = jnp.arange(W, dtype=jnp.int32)[None, :]
    t = cache_len[:, None]
    pos = (t - 1 - (j * j) % 11) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), jnp.broadcast_to(j % 4 != 1,
                                                   (t.shape[0], W))


def torch_spec(scores, cache_len):
    j = torch.arange(W, dtype=torch.int32)[None, :]
    t = cache_len[:, None]
    pos = (t - 1 - (j * j) % 11) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j % 4 != 1).expand(t.shape[0], W)


def _fp8(cfg, **sac):
    return dataclasses.replace(cfg, sac=dataclasses.replace(
        cfg.sac, kv_quant="fp8", **sac))


def _reduced(get, arch):
    """The reduced config, DeepSeek-V3.2's with a dense MLP: with these
    seeds its top-2 MoE gate sits within a bf16 rounding of a tie in the
    prefill, which the two frameworks route differently (a pool off by
    about 9% in bf16 already); the MoE itself is held in
    tests/test_torch_engine.py."""
    cfg = get(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=0, topk_experts=0)
    return cfg


def _bridged(cfg, tcfg, seed):
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")


# ---------------------------------------------------------------------------
# the cast and the plain versions
# ---------------------------------------------------------------------------


def test_cast_equals_reference_on_every_bf16_pattern():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = _u8(jnp.asarray(bits.view(jnp.bfloat16)).astype(
        jnp.float8_e4m3fn))
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = to_kv_dtype(x, E4M3)
    np.testing.assert_array_equal(_u8(got), want)
    # what the shared cast is for: PyTorch's own cast saturates there
    past = (x.float().abs() > 464).numpy()
    assert past.sum() == 30512                  # 30,510 finite, +-inf
    assert torch.isnan(got.float()).numpy()[past].all()
    assert not (_u8(x.to(E4M3)) == want)[past].any()


def test_cast_equals_reference_on_f32():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 16) * rng.choice(
        [1e-3, 1.0, 300.0, 464.0, 1e3], 1 << 16)).astype(np.float32)
    x[:6] = [464.0, -464.0, 464.00003, -464.00003, np.inf, np.nan]
    want = _u8(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(_u8(to_kv_dtype(torch.from_numpy(x), E4M3)),
                                  want)


def test_plain_versions_take_e4m3_exactly():
    """The CPU path of every kernel on e4m3 entries: the gather and the
    scatter move their bytes, the attention forms and the GQA form read
    them through ``.float()``, which is exact, so they equal the same
    call on the f32 values bit for bit."""
    g = torch.Generator().manual_seed(0)
    B, S, k = 2, 40, 9
    pool = to_kv_dtype(torch.randn(B, S, 64, generator=g), E4M3)
    idx = torch.randint(0, S, (B, k), generator=g, dtype=torch.int32)
    got = ops.batched_gather(pool, idx)
    assert got.dtype == E4M3
    np.testing.assert_array_equal(
        _u8(got), _u8(pool)[np.arange(B)[:, None], idx.numpy()])
    rows = torch.stack([torch.randperm(S, generator=g)[:k]
                        for _ in range(B)]).to(torch.int32)
    new = to_kv_dtype(torch.randn(B, k, 64, generator=g), E4M3)
    want = _u8(pool).copy()
    want[np.arange(B)[:, None], rows.numpy()] = _u8(new)
    np.testing.assert_array_equal(
        _u8(ops.batched_scatter(pool.clone(), new, rows)), want)
    with pytest.raises(TypeError, match="to_kv_dtype"):
        ops.batched_scatter(pool.clone(), new.float(), rows)
    valid = torch.rand(B, k, generator=g) > 0.3
    valid[:, -1] = True
    q = torch.randn(B, 4, 16, generator=g)
    ent = to_kv_dtype(torch.randn(B, k, 2 * 2 * 16, generator=g), E4M3)
    assert torch.equal(ops.batched_sparse_gqa(q, ent, valid, n_kv=2),
                       ops.batched_sparse_gqa(q, ent.float(), valid, n_kv=2))
    ql, qp = torch.randn(B, 4, 32, generator=g), torch.randn(B, 4, 16,
                                                              generator=g)
    lat = to_kv_dtype(torch.randn(B, k, 48, generator=g), E4M3)
    assert torch.equal(
        ops.batched_sparse_mla(ql, qp, lat, valid, dc=32, scale=0.2),
        ops.batched_sparse_mla(ql, qp, lat.float(), valid, dc=32, scale=0.2))
    assert torch.equal(ref.sparse_gqa_attn_ref(q[0], ent[0], valid[0], 2),
                       ref.sparse_gqa_attn_ref(q[0], ent[0].float(),
                                               valid[0], 2))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v32"])
def test_prefill_pool_is_the_reference_cast(arch):
    cfg, tcfg = _reduced(get_config, arch), _reduced(tget, arch)
    params, tparams = _bridged(cfg, tcfg, 5)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 30)).astype(np.int32)
    jst, jlast = jax.jit(jbuild(_fp8(cfg)).prefill)(params,
                                                    jnp.asarray(prompt))
    tst, tlast = tbuild(_fp8(tcfg), device="cpu").prefill(
        tparams, torch.from_numpy(prompt))
    tsb, _ = tbuild(tcfg, device="cpu").prefill(tparams,
                                                torch.from_numpy(prompt))
    assert tst["kv_pool"].dtype == E4M3
    assert jst["kv_pool"].dtype == jnp.float8_e4m3fn
    assert tst["idx_pool"].dtype == torch.bfloat16
    assert tst["kv_pool"].nbytes * 2 == tsb["kv_pool"].nbytes
    # the port's pool is the reference's cast of the port's bf16 entries
    bf16 = np.asarray(tsb["kv_pool"].view(torch.int16).numpy()).view(
        jnp.bfloat16)
    np.testing.assert_array_equal(
        _u8(tst["kv_pool"]), _u8(jnp.asarray(bf16).astype(jnp.float8_e4m3fn)))
    # and close to the reference's own fp8 pool (the bf16 entries of the
    # two frameworks round at other places; the cast keeps 3 mantissa
    # bits, so most bytes are equal)
    _assert_rel_close(tst["kv_pool"], jst["kv_pool"], 1, "kv_pool")
    assert (_u8(tst["kv_pool"]) == _u8(jst["kv_pool"])).mean() > 0.9
    _assert_rel_close(tst["idx_pool"], jst["idx_pool"], 1, "idx_pool")
    _assert_rel_close(tlast, jlast, 0, "prefill logits")


@pytest.mark.parametrize("arch,prefetch", [("qwen2-1.5b", False),
                                           ("qwen2-1.5b", True),
                                           ("deepseek-v32", True)])
def test_decode_teacher_forced(arch, prefetch):
    """Both start from the reference's fp8 prefill pool (the same bytes);
    the injected selection (and speculation) makes the hot tier's
    integer state and counters exact."""
    cfg, tcfg = _fp8(_reduced(get_config, arch)), _fp8(_reduced(tget, arch))
    params, tparams = _bridged(cfg, tcfg, 5)
    jopts = topts = None
    if prefetch:
        jopts = dict(prefetch_width=W, prefetch_fn=jax_spec, score_margin=1.0)
        topts = dict(jopts, prefetch_fn=torch_spec)
    jm = jbuild(cfg, topk_fn=jax_topk, opts=jopts)
    tm = tbuild(tcfg, topk_fn=torch_topk, opts=topts, device="cpu")
    T, S = 30, 48
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    jst1, _ = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
    jst = jm.init_serve_state(2, S, device_buffer=12)
    tst = tm.init_serve_state(2, S, device_buffer=12)
    assert tst["kv_pool"].dtype == E4M3 == tst["hot_buf"].entries.dtype
    for key, dtype in (("kv_pool", E4M3), ("idx_pool", torch.bfloat16)):
        jst[key] = jst[key].at[:, :, :T].set(jst1[key])
        raw = np.asarray(jst1[key])
        raw = raw.view(np.uint8 if dtype == E4M3 else np.int16).copy()
        pool_write_prefill(tst[key], torch.from_numpy(raw).view(dtype))
    np.testing.assert_array_equal(_u8(tst["kv_pool"]), _u8(jst["kv_pool"]))
    jst["cache_len"] = jnp.full((2,), T, jnp.int32)
    tst["cache_len"][:] = T
    jdecode = jax.jit(jm.decode)
    for step in range(4):
        toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        budget = np.array([step % 3, W - 2 * step], np.int32)
        jst, jlog = jdecode(params, jst, jnp.asarray(toks),
                            jnp.asarray(budget) if prefetch else None)
        tst, tlog = tm.decode(tparams, tst, torch.from_numpy(toks),
                              torch.from_numpy(budget) if prefetch else None)
        assert torch.isfinite(tlog).all()
        _assert_rel_close(tlog, jlog, 0, f"step {step} logits")
        _assert_rel_close(tst["kv_pool"], jst["kv_pool"], 1, "kv_pool")
        for key in ("buf_hits", "buf_misses", "buf_hits_l", "buf_misses_l",
                    "pf_inserted", "pf_useful"):
            np.testing.assert_array_equal(tst[key].numpy(),
                                          np.asarray(jst[key]), err_msg=key)
        for name in _INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(tst["hot_buf"], name).numpy(),
                np.asarray(getattr(jst["hot_buf"], name)), err_msg=name)
    if prefetch:
        assert int(tst["hot_buf"].pf_inserted.sum()) > 0


def test_fp8_pool_decode_close_to_bf16():
    """The reference's criterion for the fp8 pool, in the port: half the
    pool bytes, logits within 0.5 of the bf16 pool's, no NaN."""
    B, S = 2, 32
    cfg = tget("qwen2-1.5b").reduced()
    cfgb = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                            topk=64))
    cfg8 = _fp8(cfgb)
    m8 = tbuild(cfg8, device="cpu")
    mb = tbuild(cfgb, device="cpu")
    params = m8.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    st8, _ = m8.prefill(params, toks)
    stb, _ = mb.prefill(params, toks)
    assert st8["kv_pool"].dtype == E4M3
    assert st8["kv_pool"].nbytes == stb["kv_pool"].nbytes // 2
    assert st8["idx_pool"].nbytes == stb["idx_pool"].nbytes
    _, l8 = m8.decode(params, st8, toks[:, 0])
    _, lb = mb.decode(params, stb, toks[:, 0])
    assert float((l8 - lb).abs().max()) < 0.5
    assert not torch.isnan(l8).any()


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_engine_gemma3_fp8_exact():
    """Reduced Gemma3 (local window 8) with the fp8 pool, both engines on
    one shared-prefix trace with radix hits and the injected top-k:
    timelines, EngineStats, the per-layer hot-tier outcome and
    TrafficStats exact; the hot tier holds e4m3 entries."""
    cfg = _fp8(dataclasses.replace(get_config("gemma3-12b").reduced(),
                                   local_window=8))
    tcfg = _fp8(dataclasses.replace(tget("gemma3-12b").reduced(),
                                    local_window=8))
    params, tparams = _bridged(cfg, tcfg, 2)
    knobs = dict(slots=2, max_ctx=48, seed=3, placement="radix_affinity")
    je = JEngine(cfg, topk_fn=jax_topk, **knobs)
    je.params = params
    te = TEngine(tcfg, topk_fn=torch_topk, device="cpu", **knobs)
    te.params = tparams
    assert te.state["kv_pool"].dtype == E4M3
    assert te.state["hot_buf"].entries.dtype == E4M3
    assert te.state["idx_pool"].dtype == torch.bfloat16

    def trace(fn):
        return fn(6, prefix_len=16, suffix_len=20, output_len=5,
                  reuse_p=0.8, seed=4, vocab=cfg.vocab)
    jreqs, treqs = trace(jtrace), trace(ttrace)
    jout, tout = je.run(jreqs), te.run(treqs)
    for a, b in zip(jreqs, treqs):
        assert (a.dispatch_s, a.first_token_s, a.finish_s, a.pool_device) \
            == (b.dispatch_s, b.first_token_s, b.finish_s, b.pool_device)
    assert dataclasses.asdict(te.stats.traffic) == \
        dataclasses.asdict(je.stats.traffic)
    for f in ("steps", "tokens", "buffer_hits", "buffer_misses",
              "radix_hit_tokens", "radix_hit_requests"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    assert te.stats.radix_hit_tokens > 0
    np.testing.assert_array_equal(te.stats.layer_misses,
                                  je.stats.layer_misses)
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(te.state["hot_buf"], name).numpy(),
            np.asarray(getattr(je.state["hot_buf"], name)), err_msg=name)
    assert tout == jout
