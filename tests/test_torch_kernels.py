"""The port's kernel layer (``repro_torch.kernels``) against the reference.

On the CPU every kernel of the port runs as its plain PyTorch version.
Each is held against three references on the same numpy inputs:
``repro.kernels.ref`` (any shape, including ragged S and k = topk + 1),
the Pallas kernel in interpret mode (at the block-divisible shapes it
accepts), and the jnp function the JAX model actually runs.  Gather,
the page gather and scatter must match bit for bit; the indexer and the attention take bf16
inputs and use rtol = atol = 2e-2, as tests/test_kernels.py does.
The card-only checks of the CUDA kernels are in tests/test_torch_gpu.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool as jpool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gather_kv import gather_kv as pl_gather
from repro.kernels.gather_kv import gather_kv_pages as pl_gather_pages
from repro.kernels.indexer import indexer_scores as pl_indexer
from repro.kernels.scatter_kv import scatter_kv as pl_scatter
from repro.kernels.sparse_attn import sparse_attn as pl_attn
from repro.models import dsa as jdsa
from repro.configs import get_config
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.core import pool as tpool
from repro_torch.kernels import indexer as tindexer
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_attn as tattn
from repro_torch.models import dsa as tdsa

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16(rng, *shape):
    """The same bf16 values for both frameworks (f32 -> bf16 rounds to
    nearest even in both)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,d,k", [(64, 32, 16), (256, 576, 64),
                                   (77, 48, 17)])
def test_gather_plain_vs_ref_and_pallas(S, d, k):
    rng = np.random.default_rng(S + k)
    kv_j, kv_t = _bf16(rng, S, d)
    idx = rng.integers(0, S, size=k).astype(np.int32)
    got = _np(ref.gather_kv_ref(kv_t, torch.from_numpy(idx)))
    np.testing.assert_array_equal(got, _np(jref.gather_kv_ref(kv_j, idx)))
    np.testing.assert_array_equal(got, _np(pl_gather(kv_j, jnp.asarray(idx))))


def test_gather_batched_vs_local_fetch():
    rng = np.random.default_rng(1)
    B, S, d, k = 3, 50, 48, 17
    kv_j, kv_t = _bf16(rng, B, S, d)
    idx = rng.integers(0, S, size=(B, k)).astype(np.int32)
    got = _np(tpool.local_fetch(kv_t, torch.from_numpy(idx)))
    np.testing.assert_array_equal(got, _np(jpool.local_fetch(kv_j,
                                                             jnp.asarray(idx))))
    np.testing.assert_array_equal(
        got, _np(ops.batched_gather(kv_t, torch.from_numpy(idx))))


@pytest.mark.parametrize("S,d,page,pages", [(128, 64, 4, [0, 3, 5, 7]),
                                            (128, 64, 16, [7, 0, 3, 3]),
                                            (96, 512, 16, [5, 1])])
def test_gather_pages_plain_vs_pallas(S, d, page, pages):
    """The page gather's plain version against the Pallas kernel in
    interpret mode, bit for bit (repeated page ids included)."""
    rng = np.random.default_rng(S + page)
    kv_j, kv_t = _bf16(rng, S, d)
    pidx = np.array(pages, np.int32)
    got = _np(ref.gather_kv_pages_ref(kv_t, torch.from_numpy(pidx), page))
    assert got.shape == (len(pages) * page, d)
    np.testing.assert_array_equal(
        got, _np(pl_gather_pages(kv_j, jnp.asarray(pidx), page=page,
                                 interpret=True)))


# ---------------------------------------------------------------------------
# indexer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,di,H", [(512, 64, 4), (1024, 128, 8),
                                    (300, 32, 2)])
def test_indexer_plain_vs_ref_and_pallas(S, di, H):
    rng = np.random.default_rng(S + di)
    q_j, q_t = _bf16(rng, H, di)
    w_j, w_t = _bf16(rng, H)
    k_j, k_t = _bf16(rng, S, di)
    got = _np(ref.indexer_scores_ref(q_t, w_t, k_t))
    np.testing.assert_allclose(got, _np(jref.indexer_scores_ref(q_j, w_j,
                                                                k_j)),
                               **BF16_TOL)
    if S % 256 == 0:      # the Pallas kernel asserts S % block_s == 0
        np.testing.assert_allclose(
            got, _np(pl_indexer(q_j, w_j, k_j, block_s=256)), **BF16_TOL)


def test_indexer_scores_vs_jax_model():
    """The port's dsa.indexer_scores (projections + ops) against the jnp
    function the JAX model runs, on bridged indexer weights."""
    cfg = get_config("deepseek-v32").reduced()
    tcfg = tget("deepseek-v32").reduced()
    rng = np.random.default_rng(2)
    B, S = 3, 37
    p_j = {k: jnp.asarray(rng.standard_normal(s.shape) * 0.2, jnp.bfloat16)
           for k, s in jdsa.indexer_param_specs(cfg).items()}
    p_t = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy())
           .view(torch.bfloat16) for k, v in p_j.items()}
    x_j, x_t = _bf16(rng, B, cfg.d_model)
    k_j, k_t = _bf16(rng, B, S, cfg.sac.d_idx)
    want = _np(jdsa.indexer_scores(p_j, x_j, k_j, cfg))
    got = _np(tdsa.indexer_scores(p_t, x_t, k_t, tcfg))
    np.testing.assert_allclose(got, want, **BF16_TOL)


def _indexer_hi_lo(q, w, keys):
    """The tensor-core indexer's arithmetic in plain torch (for the tests):
    q [H, di] f32 split into bf16 hi and lo = bf16(q - hi); each product
    of two bf16 values is exact in f32 and the products sum in f32; then
    ReLU and w / sqrt(di).  Returns the scores [S] and lo."""
    hi = q.to(torch.bfloat16)
    lo = (q - hi.float()).to(torch.bfloat16)
    k = keys.float()
    s = k @ hi.float().T + k @ lo.float().T                    # [S, H]
    return (torch.relu(s) * (w / math.sqrt(q.shape[-1]))).sum(-1), lo


@pytest.mark.parametrize("S,di,H", [(512, 64, 4), (1024, 128, 64),
                                    (300, 16, 8), (37, 256, 128)])
def test_indexer_hi_lo_split_vs_ref_and_pallas(S, di, H):
    """Splitting an f32 q into bf16 hi + lo keeps the scores within 1e-5
    of the largest score against the f32 oracle; a bf16-exact q (the
    serving path's) has lo = 0 exactly, so the kernel may skip its
    products; and the split agrees with the Pallas kernel in interpret
    mode at the bf16 tolerance."""
    rng = np.random.default_rng(S + di + H)
    q = torch.from_numpy(rng.standard_normal((H, di)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    k_j, k_t = _bf16(rng, S, di)
    for qq, exact in ((q, False), (q.bfloat16().float(), True)):
        got, lo = _indexer_hi_lo(qq, w, k_t)
        want = ref.indexer_scores_ref(qq, w, k_t)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        if exact:
            assert not lo.view(torch.int16).any()
        else:
            assert lo.view(torch.int16).any()
        if S % 256 == 0:      # the Pallas kernel asserts S % block_s == 0
            np.testing.assert_allclose(
                _np(got), _np(pl_indexer(jnp.asarray(qq.numpy()),
                                         jnp.asarray(w.numpy()), k_j,
                                         block_s=256)), **BF16_TOL)


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("S", [1, 37, 64, 65, 4160, 8256, 65536])
def test_indexer_plan_covers_s(S, B):
    """Block (c, b) scores positions [c*chunk, (c+1)*chunk) of request b,
    chunk = chunk_tiles tiles: together they cover [0, S) once, none is
    empty, and they fill at least half of the card's block slots when the
    tiles allow (tiles of 128 or 64 rows; one, two or four blocks of 132
    SMs)."""
    for rows, slots in ((128, 264), (64, 132), (128, 528)):
        chunks, chunk_tiles = tindexer.indexer_plan(B, S, rows, slots)
        chunk = chunk_tiles * rows
        starts = [c * chunk for c in range(chunks)]
        assert chunk_tiles >= 1 and all(s0 < S for s0 in starts)
        assert starts[-1] + chunk >= S
        assert B * chunks >= min(slots / 2, B * -(-S // rows))


@pytest.mark.parametrize("B,S,slots", [(4, 4160, 264), (8, 8256, 264),
                                       (4, 65536, 264), (3, 777, 132)])
def test_indexer_plan_minimises_modelled_time(B, S, slots):
    """No other chunk gives fewer waves x (tiles per chunk + 1)."""
    n = -(-S // 128)

    def cost(ct):
        return -(-B * -(-n // ct) // slots) * (ct + 1)
    chunk_tiles = tindexer.indexer_plan(B, S, 128, slots)[1]
    assert cost(chunk_tiles) == min(cost(c) for c in range(1, n + 1))


# ---------------------------------------------------------------------------
# sparse MLA attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,H,dc,dr", [(128, 4, 32, 16), (256, 8, 64, 16),
                                       (17, 4, 32, 16), (2049 // 8, 2, 32, 8)])
def test_sparse_mla_plain_vs_ref_and_pallas(k, H, dc, dr):
    rng = np.random.default_rng(k + H)
    ql_j, ql_t = _bf16(rng, H, dc)
    qp_j, qp_t = _bf16(rng, H, dr)
    e_j, e_t = _bf16(rng, k, dc + dr)
    valid = rng.random(k) > 0.2
    valid[-1] = True
    scale = 1.0 / math.sqrt(dc + dr)
    got = _np(ref.sparse_mla_attn_ref(ql_t, qp_t, e_t,
                                      torch.from_numpy(valid), dc, scale))
    np.testing.assert_allclose(
        got, _np(jref.sparse_mla_attn_ref(ql_j, qp_j, e_j, jnp.asarray(valid),
                                          dc, scale)), **BF16_TOL)
    if k % 128 == 0:      # the Pallas kernel asserts k % block_k == 0
        q = jnp.concatenate([ql_j, qp_j], -1)
        bias = jnp.where(jnp.asarray(valid), 0.0, -1e30).astype(jnp.float32)
        np.testing.assert_allclose(
            got, _np(pl_attn(q, e_j, e_j[:, :dc], bias, scale=scale,
                             block_k=128)), **BF16_TOL)


def test_mla_absorbed_decode_vs_jax_model():
    """Absorbed MLA decode (q absorption, the attention core through ops,
    w_uv and wo) against the jnp function the JAX model runs, with
    k = topk + 1 lanes, on bridged weights."""
    cfg = get_config("deepseek-v32").reduced()
    tcfg = tget("deepseek-v32").reduced()
    from repro.models.model import build_model as jbuild
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    pj = jax.tree.map(lambda a: a[0], params["segments"][0])["attn"]
    pt = tp["segments"][0][0]["attn"]
    rng = np.random.default_rng(3)
    B, k = 2, cfg.sac.topk + 1
    x_j, x_t = _bf16(rng, B, cfg.d_model)
    e_j, e_t = _bf16(rng, B, k, cfg.kv_lora_rank + cfg.qk_rope_dim)
    valid = rng.random((B, k)) > 0.3
    valid[:, -1] = True
    pos = np.array([20, 33], np.int32)
    want = _np(jdsa.mla_absorbed_decode(pj, x_j, cfg, e_j, jnp.asarray(valid),
                                        jnp.asarray(pos)))
    got = _np(tdsa.mla_absorbed_decode(pt, x_t, tcfg, e_t,
                                       torch.from_numpy(valid),
                                       torch.from_numpy(pos)))
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("k,H,n_kv,hd", [(19, 4, 2, 16), (64, 8, 8, 8)])
def test_sparse_gqa_plain_vs_ref(k, H, n_kv, hd):
    """The GQA oracle, one request at a time, against ref.py."""
    rng = np.random.default_rng(k + n_kv)
    q_j, q_t = _bf16(rng, H, hd)
    e_j, e_t = _bf16(rng, k, 2 * n_kv * hd)
    valid = rng.random(k) > 0.25
    valid[0] = True
    got = _np(ref.sparse_gqa_attn_ref(q_t, e_t, torch.from_numpy(valid),
                                      n_kv))
    np.testing.assert_allclose(
        got, _np(jref.sparse_gqa_attn_ref(q_j, e_j, jnp.asarray(valid),
                                          n_kv)), **BF16_TOL)


GQA_HEADS = [(4, 1), (4, 2), (4, 4), (6, 2)]


@pytest.mark.parametrize("H,n_kv", GQA_HEADS)
def test_batched_sparse_gqa_ragged_vs_ref(H, n_kv):
    """ops.batched_sparse_gqa on the CPU (the plain version the kernel is
    held against on the card) against the reference's oracle, at the
    ragged k = topk + 1 = 17."""
    rng = np.random.default_rng(H * 10 + n_kv)
    B, k, hd = 3, 17, 16
    q_j, q_t = _bf16(rng, B, H, hd)
    e_j, e_t = _bf16(rng, B, k, 2 * n_kv * hd)
    valid = rng.random((B, k)) > 0.25
    valid[:, -1] = True
    got = ops.batched_sparse_gqa(q_t, e_t, torch.from_numpy(valid),
                                 n_kv=n_kv)
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    want = jax.vmap(lambda a, b, c: jref.sparse_gqa_attn_ref(a, b, c, n_kv))(
        q_j, e_j, jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("H,n_kv", GQA_HEADS)
def test_batched_sparse_gqa_vs_pallas(H, n_kv):
    """The same against the Pallas kernel in interpret mode, vmapped over
    requests and KV groups by the reference's ops (k = 512: two blocks of
    256, so the running max and sum carry across grid steps)."""
    rng = np.random.default_rng(H * 100 + n_kv)
    B, k, hd = 2, 512, 16
    q_j, q_t = _bf16(rng, B, H, hd)
    e_j, e_t = _bf16(rng, B, k, 2 * n_kv * hd)
    valid = rng.random((B, k)) > 0.25
    valid[:, -1] = True
    got = ops.batched_sparse_gqa(q_t, e_t, torch.from_numpy(valid),
                                 n_kv=n_kv)
    want = jops.batched_sparse_gqa(q_j, e_j, jnp.asarray(valid), n_kv=n_kv,
                                   use_pallas=True, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# split-k attention: the host's split plan and the two passes in plain torch
# ---------------------------------------------------------------------------

# (k, blocks of the grid without splits, scratch bytes of one split,
#  blocks the H100 holds at once)
SERVED_SPLITS = {
    "qwen2-1.5b sparse": (2049, 8 * 2, 8 * 12 * (128 + 2) * 4, 2 * 132),
    "qwen2-1.5b dense": (8257, 8 * 2, 8 * 12 * (128 + 2) * 4, 2 * 132),
    "deepseek-v32": (2049, 4 * 128 // tattn.MLA_HEADS, 4 * 128 * 514 * 4,
                     132),
}


def test_form_plans_are_the_split_plan():
    """The wrappers' plans are split_plan at each form's grid and scratch,
    for the blocks the card holds (given here; the card's occupancy, two
    GQA blocks or one MLA block per SM, is checked on the card)."""
    assert tattn.gqa_plan(8, 12, 2, 128, 2049, 2 * 132) == tattn.split_plan(
        *SERVED_SPLITS["qwen2-1.5b sparse"])
    assert tattn.mla_plan(4, 128, 512, 2049, 132) == tattn.split_plan(
        *SERVED_SPLITS["deepseek-v32"])


@pytest.mark.parametrize("k,blocks,row_bytes,slots",
                         list(SERVED_SPLITS.values())
                         + [(1, 16, 100, 264), (5, 1, 100, 264),
                            (65, 8, 100, 264),
                            (2049, 8 * 36, 8 * 36 * 66 * 4, 264),
                            (2049, 8, 8 * 48 * 130 * 4, 132),
                            (2049, 1, 1 << 22, 264), (8257, 2, 1 << 20, 264)])
def test_split_plan_covers_k(k, blocks, row_bytes, slots):
    """Chunks are whole tiles, cover [0, k) exactly with none empty, and
    the scratch stays under its cap."""
    splits, chunk = tattn.split_plan(k, blocks, row_bytes, slots)
    assert chunk > 0 and chunk % tattn.TILE == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    assert splits == 1 or splits * row_bytes <= tattn.MAX_SCRATCH_BYTES


def _modelled_cost(k, blocks, chunk, slots):
    splits = -(-k // chunk)
    return -(-blocks * splits // slots) * (chunk // tattn.TILE + 1)


@pytest.mark.parametrize("k,blocks,row_bytes,slots",
                         list(SERVED_SPLITS.values())
                         + [(2049, 8 * 36, 1, 264), (777, 3, 1, 264)])
def test_split_plan_minimises_modelled_time(k, blocks, row_bytes, slots):
    """No other whole-tile chunk gives fewer waves x (tiles + 1)."""
    _, chunk = tattn.split_plan(k, blocks, row_bytes, slots)
    best = min(_modelled_cost(k, blocks, c * tattn.TILE, slots)
               for c in range(1, -(-k // tattn.TILE) + 1))
    assert _modelled_cost(k, blocks, chunk, slots) == best


@pytest.mark.parametrize("shape", sorted(SERVED_SPLITS))
def test_split_plan_fills_the_card_at_served_shapes(shape):
    """One wave that keeps at least half the card's block slots busy."""
    k, blocks, row_bytes, slots = SERVED_SPLITS[shape]
    splits, _ = tattn.split_plan(k, blocks, row_bytes, slots)
    assert slots / 2 <= splits * blocks <= slots


def _edge_valid(rng, k, pattern, chunk):
    valid = rng.random(k) > 0.1
    valid[-1] = True
    if pattern == "chunk_invalid":          # one whole chunk of invalid lanes
        valid[chunk:2 * chunk] = False
        if k <= chunk + 1:
            valid[:chunk] = False
    elif pattern == "all_invalid":
        valid[:] = False
    return torch.from_numpy(valid)


EDGE_CASES = ([(k, "random") for k in (1, 5, 65, 127, 129, 2049, 8257)]
              + [(129, "chunk_invalid"), (2049, "chunk_invalid"),
                 (5, "all_invalid"), (2049, "all_invalid")])


@pytest.mark.parametrize("form", ["gqa", "mla"])
@pytest.mark.parametrize("k,pattern", EDGE_CASES)
def test_split_softmax_combine_matches_one_pass(form, k, pattern):
    """Chunked partials merged as pass 2 merges them equal the one-pass
    softmax of the plain versions within 1e-6 (f32), at ragged k, a chunk
    of invalid lanes and no valid lane at all (the mean of the values)."""
    rng = np.random.default_rng(k + len(pattern))
    chunk = 128
    valid = _edge_valid(rng, k, pattern, chunk)
    if form == "gqa":
        H, n_kv, hd = 6, 2, 16
        q = torch.from_numpy(rng.standard_normal((H, hd)).astype(np.float32))
        e = torch.from_numpy(rng.standard_normal((k, 2 * n_kv * hd))
                             .astype(np.float32)).to(torch.bfloat16)
        want = ref.sparse_gqa_attn_ref(q, e, valid, n_kv)
        kv = e.view(k, 2, n_kv, hd)
        rep = H // n_kv
        got = torch.cat([ref.split_softmax_combine_ref(
            q[g * rep:(g + 1) * rep], kv[:, 0, g], kv[:, 1, g], valid,
            1.0 / math.sqrt(hd), chunk) for g in range(n_kv)])
        mean_v = kv[:, 1].float().mean(0).repeat_interleave(rep, 0)
    else:
        H, dc, dr = 4, 32, 16
        ql = torch.from_numpy(rng.standard_normal((H, dc)).astype(np.float32))
        qp = torch.from_numpy(rng.standard_normal((H, dr)).astype(np.float32))
        e = torch.from_numpy(rng.standard_normal((k, dc + dr))
                             .astype(np.float32)).to(torch.bfloat16)
        scale = 1.0 / math.sqrt(dc + dr)
        want = ref.sparse_mla_attn_ref(ql, qp, e, valid, dc, scale)
        got = ref.split_softmax_combine_ref(torch.cat([ql, qp], -1), e,
                                            e[:, :dc], valid, scale, chunk)
        mean_v = e.float()[:, :dc].mean(0).expand(H, dc)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if pattern == "all_invalid":
        torch.testing.assert_close(got, mean_v, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,d,k", [(64, 32, 8), (97, 576, 13)])
def test_scatter_plain_vs_ref_and_pallas(S, d, k):
    rng = np.random.default_rng(S)
    p_j, p_t = _bf16(rng, S, d)
    e_j, e_t = _bf16(rng, k, d)
    idx = rng.permutation(S)[:k].astype(np.int32)
    got = _np(ref.scatter_kv_ref(p_t.clone(), e_t, torch.from_numpy(idx)))
    np.testing.assert_array_equal(got, _np(jref.scatter_kv_ref(p_j, e_j,
                                                               idx)))
    np.testing.assert_array_equal(got, _np(pl_scatter(p_j, e_j,
                                                      jnp.asarray(idx))))


@pytest.mark.parametrize("pos", [[0, 5, 11], [15, 16, 3]])
def test_pool_write_vs_jax_model(pos):
    """One scatter of L*B rows against the reference's masked select,
    including pos == S (clamped to S-1 in both)."""
    rng = np.random.default_rng(4)
    L, B, S, d = 2, 3, 16, 24
    pool_j, pool_t = _bf16(rng, L, B, S, d)
    e_j, e_t = _bf16(rng, L, B, d)
    pos = np.array(pos, np.int32)
    want = _np(jpool.pool_write(pool_j, e_j, jnp.asarray(pos)))
    got = _np(tpool.pool_write(pool_t, e_t, torch.from_numpy(pos)))
    np.testing.assert_array_equal(got, want)


def test_pool_write_prefill_vs_jax_model():
    rng = np.random.default_rng(5)
    L, B, S, T, d = 2, 3, 20, 7, 8
    pool_j, pool_t = _bf16(rng, L, B, S, d)
    e_j, e_t = _bf16(rng, L, B, T, d)
    want = _np(jpool.pool_write_prefill(pool_j, e_j, offset=4))
    got = _np(tpool.pool_write_prefill(pool_t, e_t, offset=4))
    np.testing.assert_array_equal(got, want)
    # one lane only (the engine's slot splice)
    pool_j, pool_t = _bf16(rng, L, B, S, d)
    want = _np(pool_j.at[:, 1, 4:4 + T].set(e_j[:, 1]))
    got = _np(tpool.pool_write_prefill(pool_t, e_t[:, 1:2], offset=4,
                                       lane=1))
    np.testing.assert_array_equal(got, want)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: a CPU tensor handed to
    a kernel wrapper raises (ops sends CPU tensors to the plain versions
    instead)."""
    from repro_torch.kernels import gather_kv, indexer, scatter_kv, \
        sparse_attn
    kv = torch.zeros(1, 4, 8, dtype=torch.bfloat16)
    idx = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_kv.gather_kv(kv, idx)
    with pytest.raises(ValueError):
        scatter_kv.scatter_kv(kv, kv[:, :2], idx)
    with pytest.raises(ValueError):
        indexer.indexer_scores(torch.zeros(1, 2, 32), torch.zeros(1, 2),
                               torch.zeros(1, 4, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        sparse_attn.sparse_attn(torch.zeros(1, 2, 8), kv, torch.zeros(1, 4),
                                scale=1.0, dv=8)
    with pytest.raises(ValueError):
        sparse_attn.sparse_attn_gqa(torch.zeros(1, 2, 8),
                                    torch.zeros(1, 4, 16,
                                                dtype=torch.bfloat16),
                                    torch.zeros(1, 4), n_kv=1, scale=1.0)
    with pytest.raises(ValueError):
        gather_kv.gather_kv_pages(kv[0], idx[0], page=2)
    with pytest.raises(ValueError):
        gather_kv.gather_kv_many([(kv, idx), (kv, idx)])
    pool = kv[None]
    with pytest.raises(ValueError):
        scatter_kv.write_rows_at([pool], [kv[:, :1]], idx[0, :1])
    with pytest.raises(ValueError):
        scatter_kv.splice([pool], [pool[:, :, :2]], lane=0, zero_tail=True)
    with pytest.raises(ValueError):
        gather_kv.gather_kv_shard([(kv, idx)], base=4)
    with pytest.raises(ValueError):
        scatter_kv.write_rows_at_shard([pool], [kv[:, :1]], idx[0, :1],
                                       base=0, seq_len=64)
    with pytest.raises(ValueError):
        scatter_kv.splice_shard([pool], [pool], base=0)
    assert ops.launch_counts() == {"gather_kv": 0, "gather_kv.rows": 0,
                                   "gather_kv.shard": 0,
                                   "gather_kv_pages": 0,
                                   "indexer_scores": 0, "sparse_attn": 0,
                                   "sparse_attn_gqa": 0, "scatter_kv": 0,
                                   "scatter_kv.scatter": 0,
                                   "scatter_kv.rows_at": 0,
                                   "scatter_kv.rows_at_shard": 0,
                                   "scatter_kv.splice": 0,
                                   "scatter_kv.splice_shard": 0}
