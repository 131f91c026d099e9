"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch version on the card, at the
serving shapes of DeepSeek-V3.2 (B=4, pool S=4160, k=2048 / 2049 lanes
with invalid lanes) and, for the GQA attention, at the (heads, KV heads,
head dim) of the dense/MoE configs (B=8, 2049 lanes), both attention
forms also at the edges of their split-k plan (ragged k up to 8257, one
chunk +- 1, a chunk of invalid lanes, no valid lane, B = 1), and the
indexer at three head shapes, ragged and tile-edge S and B in {1, 4, 8}
with both kinds of q: gather, page gather and scatter bit-exact, indexer
and attention at rtol = atol = 1e-4 (f32 sums in another order).  Plus the port's Engine on the card
against its CPU path with the same weights on small inputs (reduced
DeepSeek-V3.2 and reduced Qwen2), also with the fetch pipeline, the
arbiter and online re-sizing on; and the fused selection (demand top-k
and speculation tail from one sort) on the indexer kernel's scores
against the unfused one and against the CPU, bit for bit.  Both
attention forms also take the fp8 pool's e4m3 entries: at the edges of
their plans, twice for equal bits, and GQA at Gemma3-12B's (16, 8, 240)
in both dtypes, also at its 4 served slots with a local layer's lanes;
the pool write at Gemma3-12B's row width in both dtypes, byte for byte;
the e4m3 shapes outside the 16-byte rule are refused;
and reduced Gemma3 (bf16 and fp8 pools) and reduced Zamba2 on the card
against the CPU.  GQA also at Zamba2-7B's (32, 32, 112): head dim 112
with n_rep 1, in both dtypes.

This file imports no JAX, so it runs on the machine with the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided inside the tests, so every
pytest worker collects the same tests).
"""
import dataclasses
import itertools
import math

import pytest
import torch

from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc for "
                    "sm_90a); run on the card with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_gather_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    kv = torch.randn(4, 4160, 576, generator=g, device=cuda).bfloat16()
    idx = torch.randint(0, 4160, (4, 2048), generator=g, device=cuda,
                        dtype=torch.int32)
    want = torch.stack([ref.gather_kv_ref(kv[b], idx[b]) for b in range(4)])
    n0 = ops.launch_counts()["gather_kv"]
    assert torch.equal(ops.batched_gather(kv, idx), want)
    assert ops.launch_counts()["gather_kv"] == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,S,n_rows", [
    (576, "bf16", 4160, 8), (576, "bf16", 4160, 8320),
    (3840, "bf16", 8256, 8), (3840, "bf16", 8256, 8256),
    (3840, "e4m3", 8256, 8), (3840, "e4m3", 8256, 8256)])
def test_gpu_scatter_exact(cuda, d, dtype, S, n_rows):
    """The pool write into 2 layers x 4 slots of S positions, DeepSeek-V3.2's
    rows (576) and Gemma3-12B's (3840: 7680 B in bf16, 3840 B in e4m3), on
    random bits: a decode write and a layer's splice, byte for byte
    against the plain version on the same bytes."""
    from repro_torch.core.pool import E4M3
    dt = torch.bfloat16 if dtype == "bf16" else E4M3
    width = d * dt.itemsize
    g = torch.Generator(device=cuda).manual_seed(n_rows)
    pool = torch.randint(0, 256, (1, 2 * 4 * S, width), generator=g,
                         device=cuda, dtype=torch.uint8)
    rows = torch.randperm(pool.shape[1], generator=g, device=cuda)[:n_rows]
    e = torch.randint(0, 256, (1, n_rows, width), generator=g, device=cuda,
                      dtype=torch.uint8)
    want = ref.scatter_kv_ref(pool[0].clone(), e[0], rows)
    got = ops.batched_scatter(pool.clone().view(dt), e.view(dt),
                              rows[None].to(torch.int32))
    assert got.dtype == dt
    assert torch.equal(got[0].view(torch.uint8), want)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16_q", [False, True])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("S", [1, 37, 63, 64, 65, 127, 128, 129, 4160, 8256])
@pytest.mark.parametrize("H,di", [(64, 128), (4, 64), (8, 16)])
def test_gpu_indexer_close(cuda, H, di, S, B, bf16_q):
    """The tensor-core indexer at DeepSeek-V3.2's heads (64 x 128), the
    GQA families' (4 x 64) and the smallest dims it takes (8 x 16), at
    ragged and tile-edge S, with a general f32 q (hi and lo products) and
    a bf16-exact q (lo products skipped): close to the plain version, and
    two launches give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(S + B + di)
    q = torch.randn(B, H, di, generator=g, device=cuda)
    if bf16_q:
        q = q.bfloat16().float()
    w = torch.randn(B, H, generator=g, device=cuda)
    keys = torch.randn(B, S, di, generator=g, device=cuda).bfloat16()
    want = torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                        for b in range(B)])
    n0 = ops.launch_counts()["indexer_scores"]
    got = ops.batched_indexer_scores(q, w, keys)
    assert ops.launch_counts()["indexer_scores"] == n0 + 1
    torch.testing.assert_close(got, want, **F32_TOL)
    assert torch.equal(got, ops.batched_indexer_scores(q, w, keys))


@pytest.mark.gpu
@pytest.mark.parametrize("H,di", [(4, 8), (4, 24), (129, 128), (64, 272)])
def test_gpu_indexer_refuses_shapes(cuda, H, di):
    """di must be a multiple of 16 in [16, 256] and H at most 128: the C
    side refuses other shapes and the wrapper raises ValueError."""
    from repro_torch.kernels import indexer
    q = torch.zeros(2, H, di, device=cuda)
    w = torch.zeros(2, H, device=cuda)
    keys = torch.zeros(2, 64, di, device=cuda, dtype=torch.bfloat16)
    assert indexer.indexer_slots(H, di) == (0, 0)
    with pytest.raises(ValueError):
        indexer.indexer_scores(q, w, keys)


@pytest.mark.gpu
def test_gpu_indexer_occupancy(cuda):
    """The blocks the indexer's plan fills, from the occupancy calculator:
    two blocks of 128 threads per SM at both served shapes (a two-stage
    ring of 128-row tiles and q's hi and lo halves, 105 KB, at
    DeepSeek-V3.2's 64 x 128; a four-stage ring, 78 KB, at 4 x 64)."""
    from repro_torch.kernels import indexer
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert indexer.indexer_slots(64, 128) == (2 * sms, 128)
    assert indexer.indexer_slots(4, 64) == (2 * sms, 128)
    assert indexer.indexer_slots(8, 256)[1] == 64


def _lanes(dev, g, B, k, pattern, chunk):
    """valid [B, k]: about 10 % invalid with the last lane valid, or one
    whole split chunk invalid, or no lane valid, or a local layer's lanes
    (Gemma3-12B's window of 1024 leaves its 1023 latest positions valid,
    first in the position-sorted top-k, and the own entry)."""
    valid = torch.rand(B, k, generator=g, device=dev) > 0.1
    valid[:, -1] = True
    if pattern == "local":
        valid[:, :-1] = torch.arange(k - 1, device=dev) < 1023
    elif pattern == "chunk_invalid":
        valid[:, chunk:2 * chunk] = False
    elif pattern == "all_invalid":
        valid[:] = False
    return valid


def _edge_k(k, chunk):
    """k, or the served plan's chunk - 1 / + 1 for "chunk-1" / "chunk+1"."""
    return {"chunk-1": chunk - 1, "chunk+1": chunk + 1}.get(k, k)


# ragged k (dense decode's 8257 included), one split's chunk +- 1, a chunk
# of invalid lanes, no valid lane, a single request
EDGES = ([(k, "random") for k in (1, 5, 65, "chunk-1", "chunk+1", 2049,
                                  8257)]
         + [(2049, "chunk_invalid"), (2049, "all_invalid")])


@pytest.mark.gpu
@pytest.mark.parametrize("B,k,pattern", [(4, k, pat) for k, pat in EDGES]
                         + [(4, 4161, "random"), (1, 2049, "random")])
def test_gpu_sparse_mla_close(cuda, B, k, pattern):
    from repro_torch.kernels import sparse_attn
    k = _edge_k(k, sparse_attn.mla_plan(B, 128, 512, 2049)[1])
    g = torch.Generator(device=cuda).manual_seed(k)
    ql = torch.randn(B, 128, 512, generator=g, device=cuda)
    qp = torch.randn(B, 128, 64, generator=g, device=cuda)
    ent = torch.randn(B, k, 576, generator=g, device=cuda).bfloat16()
    valid = _lanes(cuda, g, B, k, pattern,
                   sparse_attn.mla_plan(B, 128, 512, k)[1])
    scale = 1.0 / math.sqrt(192)
    want = torch.stack([ref.sparse_mla_attn_ref(ql[b], qp[b], ent[b],
                                                valid[b], 512, scale)
                        for b in range(B)])
    n0 = ops.launch_counts()["sparse_attn"]
    got = ops.batched_sparse_mla(ql, qp, ent, valid, dc=512, scale=scale)
    assert ops.launch_counts()["sparse_attn"] == n0 + 1
    torch.testing.assert_close(got, want, **F32_TOL)


GQA_SHAPES = [(12, 2, 128), (36, 36, 64), (48, 1, 128), (48, 8, 128),
              (64, 8, 128), (16, 8, 240), (32, 32, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("H,n_kv,hd,B,k,pattern",
                         [(*s, 8, k, "random") for s in GQA_SHAPES
                          for k in (2049, 5)]
                         + [(12, 2, 128, 8, k, pat) for k, pat in EDGES
                            if k not in (2049, 5) or pat != "random"]
                         + [(12, 2, 128, 1, 2049, "random"),
                            (16, 8, 240, 4, 2049, "random"),
                            (16, 8, 240, 4, 2049, "local"),
                            (6, 2, 72, 8, 2049, "random"),
                            (8, 2, 512, 2, 2049, "random")])
def test_gpu_sparse_gqa_close(cuda, H, n_kv, hd, B, k, pattern):
    """Also hd = 72 (zero-padded to 80 columns in shared memory) and
    hd = 512 (one tile stage: two overflow shared memory)."""
    from repro_torch.kernels import sparse_attn
    k = _edge_k(k, sparse_attn.gqa_plan(B, H, n_kv, hd, 2049)[1])
    g = torch.Generator(device=cuda).manual_seed(H + k)
    q = torch.randn(B, H, hd, generator=g, device=cuda)
    ent = torch.randn(B, k, 2 * n_kv * hd, generator=g,
                      device=cuda).bfloat16()
    valid = _lanes(cuda, g, B, k, pattern,
                   sparse_attn.gqa_plan(B, H, n_kv, hd, k)[1])
    want = torch.stack([ref.sparse_gqa_attn_ref(q[b], ent[b], valid[b], n_kv)
                        for b in range(B)])
    n0 = ops.launch_counts()["sparse_attn_gqa"]
    got = ops.batched_sparse_gqa(q, ent, valid, n_kv=n_kv)
    assert ops.launch_counts()["sparse_attn_gqa"] == n0 + 1
    torch.testing.assert_close(got, want, **F32_TOL)


def _e4m3(shape, g, dev):
    from repro_torch.core.pool import E4M3, to_kv_dtype
    return to_kv_dtype(torch.randn(shape, generator=g, device=dev), E4M3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,k,pattern", [(4, k, pat) for k, pat in EDGES]
                         + [(1, 2049, "random")])
def test_gpu_sparse_mla_e4m3_close(cuda, B, k, pattern):
    """The MLA form on e4m3 entries at DeepSeek-V3.2's heads, at the
    edges of its e4m3 plan: close to the plain version (which widens the
    entries exactly), equal bits on a second launch."""
    from repro_torch.kernels import sparse_attn
    k = _edge_k(k, sparse_attn.mla_plan(B, 128, 512, 2049, fp8=True)[1])
    g = torch.Generator(device=cuda).manual_seed(k + 1)
    ql = torch.randn(B, 128, 512, generator=g, device=cuda)
    qp = torch.randn(B, 128, 64, generator=g, device=cuda)
    ent = _e4m3((B, k, 576), g, cuda)
    valid = _lanes(cuda, g, B, k, pattern,
                   sparse_attn.mla_plan(B, 128, 512, k, fp8=True)[1])
    scale = 1.0 / math.sqrt(192)
    want = torch.stack([ref.sparse_mla_attn_ref(ql[b], qp[b], ent[b],
                                                valid[b], 512, scale)
                        for b in range(B)])
    got = ops.batched_sparse_mla(ql, qp, ent, valid, dc=512, scale=scale)
    torch.testing.assert_close(got, want, **F32_TOL)
    assert torch.equal(got, ops.batched_sparse_mla(ql, qp, ent, valid,
                                                   dc=512, scale=scale))


@pytest.mark.gpu
@pytest.mark.parametrize("H,n_kv,hd,B,k,pattern",
                         [(*s, 8, k, "random") for s in GQA_SHAPES
                          if s[2] % 16 == 0 for k in (2049, 5)]
                         + [(12, 2, 128, 8, k, pat) for k, pat in EDGES
                            if k not in (2049, 5) or pat != "random"]
                         + [(12, 2, 128, 1, 2049, "random"),
                            (16, 8, 240, 4, 8257, "random"),
                            (16, 8, 240, 4, 2049, "random"),
                            (16, 8, 240, 4, 2049, "local"),
                            (4, 4, 16, 2, 70, "random")])
def test_gpu_sparse_gqa_e4m3_close(cuda, H, n_kv, hd, B, k, pattern):
    """The GQA form on e4m3 entries at the served head shapes (Gemma3's
    hd = 240 among them, also at its 4 served slots with a global and a
    local layer's lanes; 16: the reduced configs'), at the edges of its
    plan: close to the plain version, equal bits on a second launch."""
    from repro_torch.kernels import sparse_attn
    k = _edge_k(k, sparse_attn.gqa_plan(B, H, n_kv, hd, 2049, fp8=True)[1])
    g = torch.Generator(device=cuda).manual_seed(H + k + 1)
    q = torch.randn(B, H, hd, generator=g, device=cuda)
    ent = _e4m3((B, k, 2 * n_kv * hd), g, cuda)
    valid = _lanes(cuda, g, B, k, pattern,
                   sparse_attn.gqa_plan(B, H, n_kv, hd, k, fp8=True)[1])
    want = torch.stack([ref.sparse_gqa_attn_ref(q[b], ent[b], valid[b], n_kv)
                        for b in range(B)])
    n0 = ops.launch_counts()["sparse_attn_gqa"]
    got = ops.batched_sparse_gqa(q, ent, valid, n_kv=n_kv)
    assert ops.launch_counts()["sparse_attn_gqa"] == n0 + 1
    torch.testing.assert_close(got, want, **F32_TOL)
    assert torch.equal(got, ops.batched_sparse_gqa(q, ent, valid, n_kv=n_kv))


@pytest.mark.gpu
@pytest.mark.parametrize("form,shape", [
    ("gqa", (6, 2, 72)),        # hd not a multiple of 16
    ("gqa", (4, 2, 8)),
    ("gqa", (8, 2, 512)),       # e4m3 ring + bf16 tile overflow shared memory
    ("mla", (8, 0)),            # staged column offset not on 16 bytes
    ("mla", (0, 520))])         # row of 520 values, not a 16-multiple
def test_gpu_e4m3_refused_shapes(cuda, form, shape):
    """e4m3 shapes outside the 16-byte rule (or shared memory) raise
    ValueError, as the bf16 ones do, and launch nothing."""
    from repro_torch.kernels import sparse_attn
    g = torch.Generator(device=cuda).manual_seed(7)
    n0 = ops.launch_counts()
    if form == "gqa":
        H, n_kv, hd = shape
        q = torch.randn(2, H, hd, generator=g, device=cuda)
        ent = _e4m3((2, 65, 2 * n_kv * hd), g, cuda)
        valid = _lanes(cuda, g, 2, 65, "random", 0)
        with pytest.raises(ValueError):
            ops.batched_sparse_gqa(q, ent, valid, n_kv=n_kv)
    else:
        col, de = shape
        de = de or 584
        q = torch.randn(2, 16, 64, generator=g, device=cuda)
        ent = _e4m3((2, 65, de), g, cuda)
        valid = _lanes(cuda, g, 2, 65, "random", 0)
        with pytest.raises(ValueError):
            sparse_attn.sparse_attn(q, ent, valid, scale=0.1, dv=64,
                                    k_col=col, v_col=col)
    assert ops.launch_counts() == n0


@pytest.mark.gpu
@pytest.mark.parametrize("n_rep,hd,taken", [(68, 128, True), (69, 128, False),
                                            (80, 128, False), (72, 64, True),
                                            (80, 64, False)])
def test_gpu_sparse_gqa_q_rows_fit_one_stage(cuda, n_rep, hd, taken):
    """Pass 1 lands a group's f32 q rows in one stage of its tile ring
    (2 x 64 rows of ceil(hd/16)*16 + 8 bf16): the largest group that fits
    agrees with the plain version, one more head is refused."""
    g = torch.Generator(device=cuda).manual_seed(n_rep)
    q = torch.randn(2, n_rep, hd, generator=g, device=cuda)
    ent = torch.randn(2, 2049, 2 * hd, generator=g, device=cuda).bfloat16()
    valid = _lanes(cuda, g, 2, 2049, "random", 0)
    if not taken:
        with pytest.raises(ValueError):
            ops.batched_sparse_gqa(q, ent, valid, n_kv=1)
        return
    want = torch.stack([ref.sparse_gqa_attn_ref(q[b], ent[b], valid[b], 1)
                        for b in range(2)])
    torch.testing.assert_close(ops.batched_sparse_gqa(q, ent, valid, n_kv=1),
                               want, **F32_TOL)


@pytest.mark.gpu
def test_gpu_pass1_occupancy(cuda):
    """The blocks the split plans fill, from the occupancy calculator: two
    GQA blocks per SM at Qwen2-1.5B's heads (256 threads, at most 128
    registers, 90 KB of shared memory) and one MLA block (196 KB)."""
    from repro_torch.kernels import sparse_attn
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sparse_attn.gqa_slots(6, 128) == 2 * sms
    assert sparse_attn.mla_slots(576, 576) == sms


@pytest.mark.gpu
@pytest.mark.parametrize("d,page", [(512, 16), (576, 4)])
def test_gpu_gather_pages_exact(cuda, d, page):
    from repro_torch.kernels import gather_kv
    g = torch.Generator(device=cuda).manual_seed(d)
    kv = torch.randn(8 * 8256, d, generator=g, device=cuda).bfloat16()
    pidx = torch.randint(0, kv.shape[0] // page, (1024,), generator=g,
                         device=cuda, dtype=torch.int32)
    assert torch.equal(gather_kv.gather_kv_pages(kv, pidx, page=page),
                       ref.gather_kv_pages_ref(kv, pidx, page))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,attn,kv_quant", [
    ("deepseek-v32", "sparse_attn", None),
    ("qwen2-1.5b", "sparse_attn_gqa", None),
    ("gemma3-12b", "sparse_attn_gqa", None),
    ("gemma3-12b", "sparse_attn_gqa", "fp8"),
    ("deepseek-v32", "sparse_attn", "fp8"),
    ("zamba2-7b", "sparse_attn_gqa", None)])
def test_gpu_engine_matches_cpu_path(cuda, arch, attn, kv_quant):
    """The port's Engine on the card against the same engine on the CPU
    (a reduced config with a 32-dim indexer, dense MLP; Gemma3's local
    window of 32 under a 40-token context), the same weights and an
    injected top-k, with the bf16 or the fp8 pool: the timeline, the
    traffic and the hot-tier outcome are exact, and every kernel of the
    path ran."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import sharegpt_trace

    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, n_experts=0, topk_experts=0,
                              sac=dataclasses.replace(base.sac, d_idx=32,
                                                      kv_quant=kv_quant))

    def topk(scores, cache_len):
        j = torch.arange(16, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        return ((j * 7 + 3 * t) % torch.clamp(t, min=1)).to(torch.int32), \
            (j < t) & (j % 5 != 3)

    engines, reqs = [], []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, slots=2, max_ctx=96, topk_fn=topk, seed=3,
                     device=dev)
        if engines:
            eng.params = _to(engines[0].params, dev)
        r = sharegpt_trace(4, context_len=40, output_len=5, seed=1,
                           vocab=cfg.vocab)
        ops.reset_launch_counts()
        eng.run(r)
        engines.append(eng)
        reqs.append(r)
    counts = ops.launch_counts()
    for name in ("gather_kv", "indexer_scores", attn, "scatter_kv"):
        assert counts[name] > 0, counts
    for a, b in zip(*reqs):
        assert (a.dispatch_s, a.first_token_s, a.finish_s) == \
            (b.dispatch_s, b.first_token_s, b.finish_s)
    assert dataclasses.asdict(engines[0].stats.traffic) == \
        dataclasses.asdict(engines[1].stats.traffic)


@pytest.mark.gpu
@pytest.mark.parametrize("margin", [-1.0, 1.0])
@pytest.mark.parametrize("ties", [False, True])
def test_gpu_fused_selection_matches_unfused(cuda, margin, ties):
    """Decoded tokens with prefetch on and off are equal only if the
    fused selection's demand half is the unfused set: checked on the
    indexer kernel's scores at Qwen2-1.5B's serving shape (B=8, S=8256,
    top-k 2048 + a 512-lane tail), ragged cache lengths, and with scores
    rounded to a coarse grid so that many tie; the card's selection also
    equals the CPU's."""
    from repro_torch.models import dsa

    g = torch.Generator(device=cuda).manual_seed(int(ties))
    B, S, H, di = 8, 8256, 4, 64
    q = torch.randn(B, H, di, generator=g, device=cuda).bfloat16().float()
    w = torch.randn(B, H, generator=g, device=cuda)
    keys = torch.randn(B, S, di, generator=g, device=cuda).bfloat16()
    scores = ops.batched_indexer_scores(q, w, keys)
    assert torch.equal(scores, ops.batched_indexer_scores(q, w, keys))
    if ties:
        scores = torch.round(scores * 4) / 4
    cache_len = torch.tensor([8192, 8000, 2047, 2048, 2049, 2560, 1, 8256],
                             dtype=torch.int32, device=cuda)
    fused = dsa.topk_select_with_tail(scores, cache_len, 2048, 512, margin)
    unfused = dsa.topk_select(scores, cache_len, 2048)
    assert torch.equal(fused[0], unfused[0])
    assert torch.equal(fused[1], unfused[1])
    cpu = dsa.topk_select_with_tail(scores.cpu(), cache_len.cpu(), 2048,
                                    512, margin)
    for a, b in zip(fused, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v32", "qwen2-1.5b"])
def test_gpu_engine_fetch_pipeline_matches_cpu_path(cuda, arch):
    """The port's Engine with prefetch, the arbiter and the re-sizing
    evaluated every 2 steps, on the card against the CPU with the same
    weights and an injected top-k and speculation (score seeds off: they
    rank f32 scores): the traffic (prefetch included), the grants, the
    layer sizes and the hot tier's integer state are exact, and each
    step launched the gather once a layer (the demand set and the
    speculation tail in one launch).  The injected top-k churns
    on odd layers only, so the layers' miss rates differ and the
    re-sizing moves slots between them."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import sharegpt_trace

    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, n_experts=0, topk_experts=0,
                              sac=dataclasses.replace(
                                  base.sac, d_idx=32, warmup_entries=0,
                                  resize_interval=2, link_budget_frac=300.0))

    def layer_skewed_topk():
        # decode calls the top-k once per layer, layer by layer
        calls = itertools.count()

        def topk(scores, cache_len):
            odd = next(calls) % cfg.n_layers % 2
            j = torch.arange(16, dtype=torch.int32, device=scores.device)[None]
            t = cache_len[:, None]
            churn = 13 * torch.div(t + j, 5, rounding_mode="floor") * odd
            return ((j * 7 + churn) % torch.clamp(t, min=1)) \
                .to(torch.int32), (j < t) & (j % 5 != 3)
        return topk

    def spec(scores, cache_len):
        j = torch.arange(8, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        pos = (t - 1 - (j * j) % 11) % torch.clamp(t, min=1)
        return pos.to(torch.int32), (j % 4 != 1).expand(t.shape[0], 8)

    engines, grants, hot = [], [], []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, slots=2, max_ctx=96, topk_fn=layer_skewed_topk(),
                     prefetch_fn=spec, prefetch=True, arbiter=True, seed=3,
                     device=dev)
        if engines:
            eng.params = _to(engines[0].params, dev)
        for r in sharegpt_trace(4, context_len=40, output_len=5, seed=1,
                                vocab=cfg.vocab):
            eng.submit(r)
        ops.reset_launch_counts()
        g, h = [], []
        while eng.queue or any(eng.slot_req):
            eng.step()
            g.append((dict(eng.last_grants), list(eng.buffer_sizes)))
            h.append([t.to("cpu", copy=True)
                      for t in eng.state["hot_buf"][1:]])
        engines.append(eng)
        grants.append(g)
        hot.append(h)
    counts = ops.launch_counts()
    cpu, card = engines
    assert counts["gather_kv"] == card.stats.steps * cfg.n_layers
    assert grants[0] == grants[1]
    for a, b in zip(*hot):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert dataclasses.asdict(cpu.stats.traffic) == \
        dataclasses.asdict(card.stats.traffic)
    assert card.stats.prefetched_entries > 0
    assert card.stats.resizes == cpu.stats.resizes > 0
    assert len({tuple(s) for _, s in grants[1]}) > 1


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
