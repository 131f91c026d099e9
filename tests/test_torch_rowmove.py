"""The row movers' forms against the JAX reference, bit for bit.

On the CPU each form runs as its plain version (``kernels/ref.py``),
through the dispatch that the port's paths call (``kernels/ops.py``,
``core/pool.py``), on the same numpy inputs as the reference:

- the multi-segment gather (the decode step's demand set and
  speculation tail in one launch on the card) against the Pallas
  ``gather_kv`` in interpret mode, request by request, on pre-clamped
  indices (the port clamps them itself);
- the index-form scatter against the Pallas ``scatter_kv``, out-of-range
  rows skipped (handed to Pallas without them);
- the two-pool decode write against the reference's ``pool_write`` on
  each pool (positions past the pool clamp);
- the slot splice against the reference engine's splice (the prompt's
  pool zero-padded with ``jnp.pad``, written by ``pool_write_prefill``),
  and ``pool_write_prefill`` at an offset;

with ragged shapes, out-of-range indices and e4m3 rows.  Then the
decode step with the fused gather against the unfused one (an injected
``fetch_fn``): logits, pools, hot-tier integer state and ``pf_*``
equal; and the engine's launches of each form per step and per prompt.
The shard forms (a pool whose sequence axis is split over ranks, odd
slices) compose to the whole: the ranks' gathers, combined byte by byte
with MAX, are the whole gather; their decode writes and splices, side by
side, are the whole pool's (and the decode write the reference's
``pool_write``).

The card-only tests (marker ``gpu``) hold each form's CUDA kernel
against the plain version at the main paths' shapes (Zamba2-7B's rows of
14,336 B included).
This file imports JAX only inside its CPU tests' fixture, so the card
runs it without JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_rowmove.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.core import pool as tpool
from repro_torch.core.pool import E4M3, local_fetch, to_kv_dtype
from repro_torch.kernels import ops, ref
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import sharegpt_trace as ttrace


@pytest.fixture(scope="module")
def jx():
    """The reference's modules (imported here, not at the top: the card's
    machine runs this file's card-only tests without JAX)."""
    import jax.numpy as jnp
    from repro.core import pool as jpool
    from repro.kernels.gather_kv import gather_kv
    from repro.kernels.scatter_kv import scatter_kv
    return dict(jnp=jnp, pool=jpool, gather=gather_kv, scatter=scatter_kv)


def _bits(rng, shape, dtype):
    """Random values of ``dtype`` as numpy bytes-compatible arrays: bf16 from
    f32 normals (nearest even in both frameworks), e4m3 through the
    port's reference-exact cast."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16() if dtype == "bf16" else to_kv_dtype(x, E4M3)


def _to_jax(jx, t):
    """The same bits as a jax array."""
    jnp = jx["jnp"]
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    if t.dtype == E4M3:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _u8(x):
    """The bytes of a tensor or jax array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("segs", [
    [(2, 40, 24, 7)],                                  # (B, S, d, k)
    [(3, 33, 40, 9), (3, 33, 40, 5)],                  # demand + tail
    [(2, 17, 8, 4), (1, 50, 72, 11), (2, 9, 16, 3)],   # ragged, 3 pools
])
def test_gather_many_matches_pallas(jx, segs, dtype):
    """One launch of several segments equals the Pallas gather of each
    request on the clamped indices; a third of the indices lie outside
    [0, S)."""
    rng = np.random.default_rng(len(segs))
    pairs = []
    for B, S, d, k in segs:
        kv = _bits(rng, (B, S, d), dtype)
        idx = torch.from_numpy(rng.integers(-4, S + 4, (B, k)).astype(
            np.int32))
        pairs.append((kv, idx))
    got = ops.batched_gather_many(pairs)
    for (kv, idx), out in zip(pairs, got):
        assert out.dtype == kv.dtype and out.shape == (*idx.shape,
                                                       kv.shape[-1])
        S = kv.shape[1]
        for b in range(kv.shape[0]):
            want = jx["gather"](_to_jax(jx, kv[b]),
                                _to_jax(jx, idx[b].clamp(0, S - 1)),
                                interpret=True)
            np.testing.assert_array_equal(_u8(out[b]), _u8(want))
    assert [o.shape for o in got] == [o.shape for o in
                                      ref.gather_kv_many_ref(pairs)]


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
def test_index_scatter_matches_pallas(jx, dtype):
    """The index form (the TPU kernel's): rows inside [0, S) as the
    Pallas scatter writes them; rows outside are skipped."""
    rng = np.random.default_rng(3)
    B, S, k, d = 2, 29, 9, 40
    pool = _bits(rng, (B, S, d), dtype)
    entries = _bits(rng, (B, k, d), dtype)
    rows = np.stack([rng.permutation(S + 6)[:k] - 3 for _ in range(B)])
    got = ops.batched_scatter(pool.clone(),
                              entries, torch.from_numpy(rows.astype(np.int32)))
    for b in range(B):
        keep = (rows[b] >= 0) & (rows[b] < S)
        want = jx["scatter"](_to_jax(jx, pool[b]),
                             _to_jax(jx, entries[b][torch.from_numpy(keep)]),
                             jx["jnp"].asarray(rows[b][keep].astype(np.int32)),
                             interpret=True)
        np.testing.assert_array_equal(_u8(got[b]), _u8(want))


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
def test_decode_write_matches_pool_write(jx, dtype):
    """Both pools in one write (latent or (k, v) entries, and bf16
    indexer keys) equal the reference's ``pool_write`` of each;
    positions before 0 and past S clamp, as in the reference.  The
    port's one-pool ``pool_write`` is the same write."""
    rng = np.random.default_rng(4)
    L, B, S, d, di = 3, 4, 21, 24, 8
    pos = torch.tensor([-2, 0, 13, S + 5], dtype=torch.int32)
    kv, keys = _bits(rng, (L, B, S, d), dtype), _bits(rng, (L, B, S, di),
                                                      "bf16")
    e = torch.from_numpy(rng.standard_normal((L, B, d)).astype(np.float32)
                         ).bfloat16()
    k_new = _bits(rng, (L, B, di), "bf16")
    got = [kv.clone(), keys.clone()]
    tpool.pool_write_step(got, [e, k_new], pos)
    jpos = _to_jax(jx, pos)
    for pool, new, out in ((kv, e, got[0]), (keys, k_new, got[1])):
        want = jx["pool"].pool_write(_to_jax(jx, pool), _to_jax(jx, new),
                                     jpos)
        np.testing.assert_array_equal(_u8(out), _u8(want))
        one = tpool.pool_write(pool.clone(), new, pos)
        np.testing.assert_array_equal(_u8(one), _u8(want))


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("T,lane", [(13, 2), (21, 0), (1, 3)])
def test_splice_matches_reference_splice(jx, dtype, T, lane):
    """The slot splice of both pools equals the reference engine's: the
    prompt's pools padded with zeros to S (``jnp.pad``) and written into
    the lane (``pool_write_prefill``); the other lanes keep their
    bytes."""
    rng = np.random.default_rng(T)
    L, B, S, d, di = 2, 4, 21, 24, 8
    pools = [_bits(rng, (L, B, S, d), dtype), _bits(rng, (L, B, S, di),
                                                    "bf16")]
    prompts = [_bits(rng, (L, 1, T, d), dtype), _bits(rng, (L, 1, T, di),
                                                       "bf16")]
    got = [p.clone() for p in pools]
    tpool.pool_splice_lane(got, prompts, lane)
    jnp = jx["jnp"]
    for pool, src, out in zip(pools, prompts, got):
        padded = jnp.pad(_to_jax(jx, src), [(0, 0), (0, 0), (0, S - T),
                                            (0, 0)])
        jpool_ = _to_jax(jx, pool)
        lane_rows = jx["pool"].pool_write_prefill(
            jpool_[:, lane:lane + 1], padded)
        want = jpool_.at[:, lane].set(lane_rows[:, 0])
        np.testing.assert_array_equal(_u8(out), _u8(want))


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
def test_pool_write_prefill_offset_matches_reference(jx, dtype):
    """``pool_write_prefill`` (every lane, then one lane) at an offset
    equals the reference's ``dynamic_update_slice``; rows past the
    written run keep their bytes (no zero tail)."""
    rng = np.random.default_rng(6)
    L, B, S, T, d, off = 2, 3, 23, 7, 40, 5
    pool = _bits(rng, (L, B, S, d), dtype)
    src = _bits(rng, (L, B, T, d), dtype)
    want = jx["pool"].pool_write_prefill(_to_jax(jx, pool), _to_jax(jx, src),
                                         offset=off)
    got = tpool.pool_write_prefill(pool.clone(), src, offset=off)
    np.testing.assert_array_equal(_u8(got), _u8(want))
    jp = _to_jax(jx, pool)
    want = jp.at[:, 1, off:off + T].set(_to_jax(jx, src)[:, 1])
    got = tpool.pool_write_prefill(pool.clone(), src[:, 1:2], offset=off,
                                   lane=1)
    np.testing.assert_array_equal(_u8(got), _u8(want))
    with pytest.raises(ValueError):
        tpool.pool_write_prefill(pool.clone(), src, offset=S - T + 1)


# ---------------------------------------------------------------------------
# the fused fetch and the forms' launches on the serving path
# ---------------------------------------------------------------------------


def _count(monkeypatch, name):
    """Count the calls of ``ops.<name>`` (what launches one kernel on the
    card)."""
    calls = [0]
    plain = getattr(ops, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)
    monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("arch,injected_spec", [("qwen2-1.5b", False),
                                                ("deepseek-v32", True)])
def test_fused_fetch_matches_unfused(monkeypatch, arch, injected_spec):
    """The decode step with the default fetch gathers the demand set and
    the speculation tail in one call; with an injected ``fetch_fn`` it
    keeps two (the tail's indices clamped first).  Logits, pools, every
    hot-tier tensor and the ``pf_*`` counters are equal, step by step,
    with per-request budgets, for the default speculation and for an
    injected one (whose tail holds positions past the context, invalid
    lanes)."""
    cfg = tget(arch).reduced()
    w, B, T, S = 6, 2, 30, 48
    opts = {"prefetch_width": w, "score_margin": -1.0}
    if injected_spec:
        def spec(scores, cache_len):
            j = torch.arange(w, dtype=torch.int32)[None, :]
            idx = (j * 11 + cache_len[:, None]) % S
            return idx, idx < cache_len[:, None]
        opts["prefetch_fn"] = spec
    fetches = [0]

    def fetch(kv, idx):
        fetches[0] += 1
        return local_fetch(kv, idx)
    fused = tbuild(cfg, opts=opts, device="cpu")
    unfused = tbuild(cfg, fetch_fn=fetch, opts=opts, device="cpu")
    params = fused.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, T)).astype(np.int32))
    st1, _ = fused.prefill(params, prompt)
    states = []
    for m in (fused, unfused):
        st = m.init_serve_state(B, S, device_buffer=32)
        tpool.pool_write_prefill(st["kv_pool"], st1["kv_pool"])
        tpool.pool_write_prefill(st["idx_pool"], st1["idx_pool"])
        st["cache_len"][:] = T
        states.append(st)
    many = _count(monkeypatch, "batched_gather_many")
    steps, budget = 4, torch.tensor([w, 2], dtype=torch.int32)
    for step in range(steps):
        tok = torch.tensor([3 + step, 7 * step], dtype=torch.int32)
        states[0], la = fused.decode(params, states[0], tok, pf_budget=budget)
        states[1], lb = unfused.decode(params, states[1], tok,
                                       pf_budget=budget)
        assert torch.equal(la, lb), step
        for key, a in states[0].items():
            b = states[1][key]
            if key == "hot_buf":
                for name, x, y in zip(a._fields, a, b):
                    assert torch.equal(x, y), (step, name)
            else:
                assert torch.equal(a, b), (step, key)
    assert many[0] == steps * cfg.n_layers
    assert fetches[0] == 2 * steps * cfg.n_layers
    assert int(states[0]["hot_buf"].pf_inserted.sum()) > 0


def test_engine_launches_each_form_per_step(monkeypatch):
    """What chip_smoke.py checks on the card, counted on the CPU at the
    dispatch calls that launch one kernel each: with the fetch pipeline
    on, one gather a layer a step (the fused demand set and tail) plus
    one warm-up gather a prompt at most; one decode write a step (every
    layer of both pools); one splice a prompt (both pools)."""
    cfg = tget("qwen2-1.5b").reduced()
    eng = TEngine(cfg, slots=2, max_ctx=80, seed=4, device="cpu",
                  prefetch=True)
    counts = {name: _count(monkeypatch, name) for name in (
        "batched_gather", "batched_gather_many", "pool_rows_at",
        "pool_splice", "batched_scatter")}
    reqs = ttrace(4, context_len=36, output_len=5, seed=2, ctx_jitter=0.0,
                  vocab=cfg.vocab)
    out = eng.run(reqs)
    steps, layers = eng.stats.steps, cfg.n_layers
    assert out["n_done"] == len(reqs)
    assert counts["batched_gather_many"][0] == steps * layers
    assert counts["batched_gather"][0] <= len(reqs)          # warm-ups
    assert counts["pool_rows_at"][0] == steps
    assert counts["pool_splice"][0] == len(reqs)
    assert counts["batched_scatter"][0] == 0
    assert eng.stats.prefetched_entries > 0


# ---------------------------------------------------------------------------
# the shard forms: one rank's slice [base, base + S_local) of the pool
# ---------------------------------------------------------------------------


def _edge_rows(S_local: int, n: int):
    """Global rows at every slice's edges (base - 1, base, base +
    S_local - 1, base + S_local) and past the pool on both sides."""
    rows = [-2, -1, n * S_local, n * S_local + 3]
    for r in range(n):
        b = r * S_local
        rows += [b - 1, b, b + S_local - 1, b + S_local]
    return rows


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("n,S_local", [(2, 17), (3, 5), (4, 1)])
def test_shard_gathers_combine_to_the_whole(n, S_local, dtype):
    """Each rank's gather of its slice is zeros outside it; the MAX of
    the ranks' bytes is the whole pool's gather (indices in range), and
    zeros where no rank holds the row."""
    rng = np.random.default_rng(n * 100 + S_local)
    B, d, S = 3, 6, n * S_local
    pool = _bits(rng, (B, S, d), dtype)
    rows = _edge_rows(S_local, n)
    idx = torch.tensor(np.stack([rng.permutation(rows)
                                 for _ in range(B)]), dtype=torch.int32)
    parts = [ops.batched_gather_shard(
        pool[:, r * S_local:(r + 1) * S_local].contiguous(), idx,
        r * S_local) for r in range(n)]
    got = torch.stack([p.view(torch.uint8) for p in parts]).amax(0)
    whole = ops.batched_gather(pool, idx).view(torch.uint8)
    inside = ((idx >= 0) & (idx < S))[..., None]
    assert torch.equal(got, torch.where(inside, whole,
                                        torch.zeros_like(whole)))
    for r, part in enumerate(parts):
        mine = ((idx >= r * S_local) & (idx < (r + 1) * S_local))[..., None]
        assert not part.view(torch.uint8).masked_select(~mine).any()


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("n,S_local", [(2, 17), (3, 5), (4, 1)])
def test_shard_decode_writes_make_the_whole_write(jx, n, S_local, dtype):
    """The ranks' decode writes, slices side by side, are the whole
    pool's write and the reference's ``pool_write`` (positions at the
    slices' edges and past the pool, which clamp)."""
    rng = np.random.default_rng(n + 7 * S_local)
    L, d, S = 2, 6, n * S_local
    pos_l = _edge_rows(S_local, n)
    B = len(pos_l)
    pool = _bits(rng, (L, B, S, d), dtype)
    new = _bits(rng, (L, B, d), dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32)
    slices = [pool[:, :, r * S_local:(r + 1) * S_local].clone()
              for r in range(n)]
    for r, part in enumerate(slices):
        ops.pool_rows_at([part], [new], pos, r * S_local, S)
    got = torch.cat(slices, 2)
    whole = pool.clone()
    ops.pool_rows_at([whole], [new], pos)
    assert _same(got, whole)
    want = jx["pool"].pool_write(_to_jax(jx, pool), _to_jax(jx, new),
                                 jx["jnp"].asarray(np.array(pos_l,
                                                            np.int32)))
    np.testing.assert_array_equal(_u8(got), _u8(want))


@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("n,S_local,T", [(2, 17, 30), (3, 5, 15), (3, 5, 4),
                                         (4, 3, 0)])
def test_shard_splices_make_the_whole_splice(n, S_local, T, dtype):
    """The ranks' splices of a prompt's pool [L, B, T, d], slices side by
    side, are the whole pool's splice with the tail zeroed (a slice past
    the prompt all zeros)."""
    rng = np.random.default_rng(T + n)
    L, B, d, S = 2, 3, 6, n * S_local
    src = _bits(rng, (L, B, T, d), dtype)
    slices = [_bits(rng, (L, B, S_local, d), dtype) for _ in range(n)]
    for r, part in enumerate(slices):
        ops.pool_splice_shard([part], [src], r * S_local)
    whole = _bits(rng, (L, B, S, d), dtype)
    ops.pool_splice([whole], [src], zero_tail=True)
    assert _same(torch.cat(slices, 2), whole)


# ---------------------------------------------------------------------------
# on the card (marker gpu): each form's kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc for "
                    "sm_90a); run on the card with -m gpu")
    return torch.device("cuda")


def _rand(g, shape, dtype, dev):
    """Random bytes viewed as ``dtype`` (the row movers copy bits)."""
    width = shape[-1] * dtype.itemsize
    return torch.randint(0, 256, (*shape[:-1], width), generator=g,
                         device=dev, dtype=torch.uint8).view(dtype)


def _same(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("segs", [
    [(4, 4160, 576, 2048)],                            # DeepSeek-V3.2
    [(8, 8256, 512, 2048), (8, 8256, 512, 512)],       # Qwen2 fetch, fused
    [(4, 8256, 3840, 2048)],                           # Gemma3-12B
    [(8, 8256, 7168, 2048)],                           # Zamba2-7B
    [(2, 300, 7168, 33)],                              # past a chunk
    [(2, 300, 7168, 33), (3, 50, 36, 7), (1, 9, 3, 5)],  # unaligned rows
])
def test_gpu_gather_many_exact(cuda, segs, dtype):
    from repro_torch.kernels import gather_kv
    g = torch.Generator(device=cuda).manual_seed(len(segs))
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    pairs = []
    for B, S, d, k in segs:
        idx = torch.randint(-3, S + 3, (B, k), generator=g, device=cuda,
                            dtype=torch.int32)
        pairs.append((_rand(g, (B, S, d), dt, cuda), idx))
    n0 = ops.launch_counts()["gather_kv"]
    got = gather_kv.gather_kv_many(pairs)
    assert ops.launch_counts()["gather_kv"] == n0 + 1
    for a, b in zip(got, ref.gather_kv_many_ref(
            [(kv.view(torch.uint8), i) for kv, i in pairs])):
        assert _same(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("shape", [(2, 4, 4160, 576, 128),   # DeepSeek
                                   (3, 4, 257, 3840, 64),    # Gemma3 width
                                   (13, 8, 300, 7168, 64),   # Zamba2 rows
                                   (2, 3, 40, 7168, 64),     # past a chunk
                                   (2, 3, 40, 100, 36)])     # unaligned
def test_gpu_write_rows_at_exact(cuda, shape, dtype):
    from repro_torch.kernels import scatter_kv
    L, B, S, d, di = shape
    g = torch.Generator(device=cuda).manual_seed(S)
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    pools = [_rand(g, (L, B, S, d), dt, cuda),
             _rand(g, (L, B, S, di), torch.bfloat16, cuda)]
    entries = [_rand(g, (L, B, d), dt, cuda),
               _rand(g, (L, B, di), torch.bfloat16, cuda)]
    pos = torch.randint(-2, S + 2, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    got = [p.clone() for p in pools]
    n0 = ops.launch_counts()["scatter_kv.rows_at"]
    scatter_kv.write_rows_at(got, entries, pos)
    assert ops.launch_counts()["scatter_kv.rows_at"] == n0 + 1
    for p, e, out in zip(pools, entries, got):
        want = ref.write_rows_at_ref(p.view(torch.uint8).clone(),
                                     e.view(torch.uint8), pos)
        assert _same(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("T,offset,lane,zero_tail", [
    (8192, 0, 3, True),          # a Gemma3-12B prompt into the last slot
    (257, 0, 1, True), (300, 0, 0, True), (0, 0, 2, True),
    (33, 5, None, False), (1, 299, 2, False)])
def test_gpu_splice_exact(cuda, T, offset, lane, zero_tail, dtype):
    from repro_torch.kernels import scatter_kv
    L, B, S, d, di = (48, 4, 8256, 3840, 64) if T == 8192 else \
        (3, 4, 300, 3840, 64)
    g = torch.Generator(device=cuda).manual_seed(T + offset)
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    n = B if lane is None else 1
    pools = [_rand(g, (L, B, S, d), dt, cuda),
             _rand(g, (L, B, S, di), torch.bfloat16, cuda)]
    srcs = [_rand(g, (L, n, T, d), dt, cuda),
            _rand(g, (L, n, T, di), torch.bfloat16, cuda)]
    got = [p.clone() for p in pools]
    n0 = ops.launch_counts()["scatter_kv.splice"]
    scatter_kv.splice(got, srcs, offset=offset, lane=lane,
                      zero_tail=zero_tail)
    assert ops.launch_counts()["scatter_kv.splice"] == n0 + 1
    for p, s, out in zip(pools, srcs, got):
        want = ref.splice_ref(p.view(torch.uint8), s.view(torch.uint8),
                              offset, lane, zero_tail)
        assert _same(out, want)
    del pools, srcs, got
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_gpu_index_scatter_exact(cuda):
    """The index form: rows outside [0, S) skipped, rows past a chunk."""
    from repro_torch.kernels import scatter_kv
    g = torch.Generator(device=cuda).manual_seed(5)
    for B, S, d, k in ((2, 4160, 576, 8), (3, 100, 7168, 40)):
        pool = _rand(g, (B, S, d), torch.bfloat16, cuda)
        e = _rand(g, (B, k, d), torch.bfloat16, cuda)
        rows = torch.stack([torch.randperm(S + 10, generator=g, device=cuda)
                            [:k] - 5 for _ in range(B)]).to(torch.int32)
        got = scatter_kv.scatter_kv(pool.clone(), e, rows)
        for b in range(B):
            assert _same(got[b], ref.scatter_kv_ref(pool[b].clone(), e[b],
                                                    rows[b]))


@pytest.mark.gpu
def test_gpu_engine_fetch_pipeline_launches(cuda):
    """The engine on the card with the fetch pipeline (the fused gather,
    the decode write and the splice as kernels) decodes the tokens of the
    same engine with the pipeline off, and launches the gather once a
    layer a step plus at most one warm-up a prompt, the decode write once
    a step and the splice once a prompt."""
    base = tget("qwen2-1.5b").reduced()
    cfg = dataclasses.replace(base, sac=dataclasses.replace(base.sac,
                                                            d_idx=32))
    toks = []
    for prefetch in (False, True):
        eng = TEngine(cfg, slots=2, max_ctx=80, seed=4, device=cuda,
                      prefetch=prefetch)
        reqs = ttrace(4, context_len=36, output_len=5, seed=2,
                      ctx_jitter=0.0, vocab=cfg.vocab)
        ops.reset_launch_counts()
        eng.run(reqs)
        toks.append([r.out_tokens for r in reqs])
    counts = ops.launch_counts()
    steps, layers = eng.stats.steps, cfg.n_layers
    assert steps * layers <= counts["gather_kv"] <= steps * layers + 4
    assert counts["scatter_kv.rows_at"] == steps
    assert counts["scatter_kv.splice"] == 4
    assert eng.stats.prefetched_entries > 0
    assert toks[0] == toks[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("B,S_local,d,k,rank", [
    (8, 2064, 512, 2048, 1),      # Qwen2-1.5B's pool over 4 ranks
    (8, 4128, 512, 2048, 1),      # ... over 2
    (4, 2080, 576, 2048, 1),      # DeepSeek-V3.2's over 2
    (3, 33, 7168, 17, 2),         # odd slice, rows past a chunk
    (2, 7, 36, 9, 0)])            # unaligned rows, rank 0
def test_gpu_gather_shard_exact(cuda, B, S_local, d, k, rank, dtype):
    from repro_torch.kernels import gather_kv
    g = torch.Generator(device=cuda).manual_seed(S_local + rank)
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    base = rank * S_local
    kv = _rand(g, (B, S_local, d), dt, cuda)
    idx = torch.randint(-3, 4 * S_local + 3, (B, k), generator=g,
                        device=cuda, dtype=torch.int32)
    idx[:, :4] = torch.tensor([base - 1, base, base + S_local - 1,
                               base + S_local], device=cuda)
    n0 = ops.launch_counts()["gather_kv.shard"]
    got = gather_kv.gather_kv_shard([(kv, idx)], base)[0]
    assert ops.launch_counts()["gather_kv.shard"] == n0 + 1
    for b in range(B):
        assert _same(got[b], ref.gather_kv_shard_ref(kv[b].view(torch.uint8),
                                                     idx[b], base))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("L,B,S_local,d,di,rank,n", [
    (28, 8, 2064, 512, 64, 1, 4),     # Qwen2-1.5B over 4 ranks
    (2, 4, 2080, 576, 128, 1, 2),     # DeepSeek-V3.2 over 2
    (3, 8, 33, 7168, 64, 2, 3)])      # odd slice, rows past a chunk
def test_gpu_write_rows_at_shard_exact(cuda, L, B, S_local, d, di, rank, n,
                                       dtype):
    from repro_torch.kernels import scatter_kv
    g = torch.Generator(device=cuda).manual_seed(S_local * n + rank)
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    base, S = rank * S_local, n * S_local
    pools = [_rand(g, (L, B, S_local, d), dt, cuda),
             _rand(g, (L, B, S_local, di), torch.bfloat16, cuda)]
    entries = [_rand(g, (L, B, d), dt, cuda),
               _rand(g, (L, B, di), torch.bfloat16, cuda)]
    pos = torch.tensor(([base - 1, base, base + S_local - 1, base + S_local,
                         S + 2, -1, S - 1, 0] * B)[:B], dtype=torch.int32,
                       device=cuda)
    got = [p.clone() for p in pools]
    n0 = ops.launch_counts()["scatter_kv.rows_at_shard"]
    scatter_kv.write_rows_at_shard(got, entries, pos, base, S)
    assert ops.launch_counts()["scatter_kv.rows_at_shard"] == n0 + 1
    for p, e, out in zip(pools, entries, got):
        want = ref.write_rows_at_ref(p.view(torch.uint8).clone(),
                                     e.view(torch.uint8), pos, base, S)
        assert _same(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
@pytest.mark.parametrize("L,B,S_local,T,d,rank", [
    (28, 4, 2064, 8192, 512, 3),      # a Qwen2-1.5B prompt's last slice
    (28, 4, 2064, 8192, 512, 0),
    (3, 2, 33, 80, 7168, 2),          # odd slice past the prompt's end
    (3, 2, 33, 40, 100, 1)])          # a slice the prompt ends inside
def test_gpu_splice_shard_exact(cuda, L, B, S_local, T, d, rank, dtype):
    from repro_torch.kernels import scatter_kv
    g = torch.Generator(device=cuda).manual_seed(T + rank)
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    pools = [_rand(g, (L, B, S_local, d), dt, cuda),
             _rand(g, (L, B, S_local, 64), torch.bfloat16, cuda)]
    srcs = [_rand(g, (L, B, T, d), dt, cuda),
            _rand(g, (L, B, T, 64), torch.bfloat16, cuda)]
    got = [p.clone() for p in pools]
    n0 = ops.launch_counts()["scatter_kv.splice_shard"]
    scatter_kv.splice_shard(got, srcs, rank * S_local)
    assert ops.launch_counts()["scatter_kv.splice_shard"] == n0 + 1
    for p, s, out in zip(pools, srcs, got):
        want = ref.splice_ref(p.view(torch.uint8), s.view(torch.uint8),
                              zero_tail=True, src_row0=rank * S_local)
        assert _same(out, want)
    del pools, srcs, got
    torch.cuda.empty_cache()
