"""The port's kernel layer (``repro_torch.kernels``) against the reference.

On the CPU every kernel of the port runs as its plain PyTorch version.
Each is held against three references on the same numpy inputs:
``repro.kernels.ref`` (any shape, including ragged S and k = topk + 1),
the Pallas kernel in interpret mode (at the block-divisible shapes it
accepts), and the jnp function the JAX model actually runs.  Gather and
scatter must match bit for bit; the indexer and the attention take bf16
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
from repro.kernels import ref as jref
from repro.kernels.gather_kv import gather_kv as pl_gather
from repro.kernels.indexer import indexer_scores as pl_indexer
from repro.kernels.scatter_kv import scatter_kv as pl_scatter
from repro.kernels.sparse_attn import sparse_attn as pl_attn
from repro.models import dsa as jdsa
from repro.configs import get_config
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.core import pool as tpool
from repro_torch.kernels import ops, ref
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
    """The GQA oracle (for the GQA families' slice) against ref.py."""
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
    assert ops.launch_counts() == {"gather_kv": 0, "indexer_scores": 0,
                                   "sparse_attn": 0, "scatter_kv": 0}
