"""The port's model modules (``repro_torch.models``) against the JAX
reference, on the same numpy inputs and on bridged weights.

Tolerances: bf16 activations round at other places in XLA and PyTorch
(matmul accumulation order, where a product is rounded), so bf16
outputs are compared with rtol = atol = 2e-2 (the kernel tests'
tolerance); f32 paths on f32 inputs at 1e-5.  Selections (top-k) and
the capacity dispatch are integer results and must be exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import dsa as jdsa
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config as tget
from repro_torch.models import dsa as tdsa
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(rng, *shape, dtype="bf16", scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if dtype == "bf16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def bridged():
    """Reduced DeepSeek-V3.2 (d=64, 4 heads, latent 32+16, indexer 2x8,
    top-k 16, 4 experts top-2): JAX params and their bridged copy."""
    cfg = get_config("deepseek-v32").reduced()
    tcfg = tget("deepseek-v32").reduced()
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(11))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, params_from_jax(np_params, tcfg, "cpu")


def _layer(params, tp, i=0):
    return (jax.tree.map(lambda a: a[i], params["segments"][0]),
            tp["segments"][0][i])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_swiglu():
    rng = np.random.default_rng(0)
    x_j, x_t = _pair(rng, 3, 5, 64)
    g_j, g_t = _pair(rng, 64)
    np.testing.assert_allclose(_np(tlayers.rms_norm(x_t, g_t)),
                               _np(jlayers.rms_norm(x_j, g_j)), **BF16_TOL)
    ws = [_pair(rng, 64, 96, scale=0.1), _pair(rng, 64, 96, scale=0.1),
          _pair(rng, 96, 64, scale=0.1)]
    want = jlayers.mlp_block({"w_gate": ws[0][0], "w_up": ws[1][0],
                              "w_down": ws[2][0]}, x_j)
    got = tlayers.mlp_block({"w_gate": ws[0][1], "w_up": ws[1][1],
                             "w_down": ws[2][1]}, x_t)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("shape", [(2, 7, 4, 16), (2, 7, 16)])
def test_apply_rope(shape):
    rng = np.random.default_rng(1)
    x_j, x_t = _pair(rng, *shape, dtype="f32")
    pos = rng.integers(0, 500, size=shape[:2]).astype(np.int32)
    want = jlayers.apply_rope(x_j, jnp.asarray(pos), 1e6)
    got = tlayers.apply_rope(x_t, torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("S,chunk,window", [(32, 8, 0), (24, 1024, 0),
                                            (32, 8, 5)])
def test_blocked_causal_attention(S, chunk, window):
    rng = np.random.default_rng(S + window)
    q = [_pair(rng, 2, S, 3, 16, dtype="f32") for _ in range(3)]
    want = jlayers.blocked_causal_attention(q[0][0], q[1][0], q[2][0],
                                            chunk=chunk, window=window)
    got = tlayers.blocked_causal_attention(q[0][1], q[1][1], q[2][1],
                                           chunk=chunk, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_select_tied_scores(seed):
    """Heavily tied scores (few distinct values, many exact zeros as two
    ReLU heads give at reduced size): idx and valid equal the reference
    in value AND order."""
    rng = np.random.default_rng(seed)
    B, S, k = 4, 40, 16
    scores = rng.choice(np.array([0.0, 0.0, 0.5, 1.0, -0.25], np.float32),
                        size=(B, S))
    cache_len = np.array([40, 9, 23, 0], np.int32)
    ji, jv = jdsa.topk_select(jnp.asarray(scores), jnp.asarray(cache_len), k)
    ti, tv = tdsa.topk_select(torch.from_numpy(scores),
                              torch.from_numpy(cache_len), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


# ---------------------------------------------------------------------------
# indexer + MLA on bridged weights
# ---------------------------------------------------------------------------


def test_indexer_keys_and_scores(bridged):
    cfg, tcfg, params, tp = bridged
    pj, pt = _layer(params, tp)
    rng = np.random.default_rng(3)
    x_j, x_t = _pair(rng, 2, 30, cfg.d_model)
    keys_j = jdsa.indexer_keys(pj["idx"], x_j)
    keys_t = tdsa.indexer_keys(pt["idx"], x_t)
    np.testing.assert_allclose(_np(keys_t), _np(keys_j), **BF16_TOL)
    want = jdsa.indexer_scores(pj["idx"], x_j[:, -1], keys_j, cfg)
    got = tdsa.indexer_scores(pt["idx"], x_t[:, -1], keys_t, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_mla_prefill_attention(bridged):
    cfg, tcfg, params, tp = bridged
    pj, pt = _layer(params, tp, 1)
    rng = np.random.default_rng(4)
    B, S = 2, 24
    x_j, x_t = _pair(rng, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    out_j, ent_j = jax.jit(jdsa.mla_prefill_attention, static_argnums=2)(
        pj["attn"], x_j, cfg, jnp.asarray(pos))
    out_t, ent_t = tdsa.mla_prefill_attention(pt["attn"], x_t, tcfg,
                                              torch.from_numpy(pos))
    np.testing.assert_allclose(_np(ent_t), _np(ent_j), **BF16_TOL)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **BF16_TOL)


def test_mla_absorbed_vs_dense_decode(bridged):
    """Absorbed decode over the whole pool (the dense path) against the
    reference on bridged weights, with a ragged cache length."""
    cfg, tcfg, params, tp = bridged
    pj, pt = _layer(params, tp)
    rng = np.random.default_rng(5)
    B, S = 3, 21
    x_j, x_t = _pair(rng, B, cfg.d_model)
    p_j, p_t = _pair(rng, B, S, cfg.kv_lora_rank + cfg.qk_rope_dim)
    cl = np.array([21, 5, 12], np.int32)
    want = jax.jit(jdsa.mla_dense_decode, static_argnums=2)(
        pj["attn"], x_j, cfg, p_j, jnp.asarray(cl), jnp.asarray(cl))
    got = tdsa.mla_dense_decode(pt["attn"], x_t, tcfg, p_t,
                                torch.from_numpy(cl), torch.from_numpy(cl))
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,cap,groups", [(4, 1, 1.25, 1), (2, 12, 1.25, 1),
                                            (2, 12, 1.0, 2), (1, 9, 0.3, 1)])
def test_moe_block_with_capacity_drops(bridged, B, S, cap, groups):
    """Capacity dispatch (tokens dropped when an expert is full) against
    the reference: the slot map is exact, the outputs within bf16
    tolerance."""
    cfg, tcfg, params, tp = bridged
    pj, pt = _layer(params, tp)
    rng = np.random.default_rng(B * S)
    x_j, x_t = _pair(rng, B, S, cfg.d_model)
    out_j, aux_j = jax.jit(jmoe.moe_block, static_argnums=(2,),
                           static_argnames=("cap_factor", "groups"))(
        pj["mlp"], x_j, cfg, cap_factor=cap, groups=groups)
    out_t, aux_t = tmoe.moe_block(pt["mlp"], x_t, tcfg, cap_factor=cap,
                                  groups=groups)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **BF16_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    # the dispatch itself is integer: compare one group's slot map
    E, K = cfg.n_experts, cfg.topk_experts
    Tg = B * S // groups
    C = max(int(K * Tg * cap / E), 1)
    probs = np.asarray(jax.nn.softmax(
        (x_j.reshape(groups, Tg, -1)[0] @ pj["mlp"]["router"]
         ).astype(jnp.float32), axis=-1))
    _, slot_j, _, _ = jax.jit(jmoe._dispatch_one, static_argnums=(2, 3, 4))(
        x_j.reshape(groups, Tg, -1)[0], jnp.asarray(probs), E, K, C)
    _, slot_t, _, _ = tmoe._dispatch_one(x_t.reshape(groups, Tg, -1)[0],
                                         torch.from_numpy(probs.copy()), E,
                                         K, C)
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    if C * E < Tg * K:
        assert (slot_t.numpy() == E * C).any()     # drops happened


def test_moe_decode(bridged):
    cfg, tcfg, params, tp = bridged
    pj, pt = _layer(params, tp, 1)
    rng = np.random.default_rng(7)
    x_j, x_t = _pair(rng, 3, cfg.d_model)
    np.testing.assert_allclose(_np(tmoe.moe_decode(pt["mlp"], x_t, tcfg)),
                               _np(jax.jit(jmoe.moe_decode, static_argnums=2)(
                                   pj["mlp"], x_j, cfg)),
                               **BF16_TOL)


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------


def test_bridge_round_trip(bridged):
    """JAX pytree -> port params -> numpy: every leaf bit-identical (bf16
    compared as its 16 bits), shapes and dtypes kept, segments unstacked
    into per-layer dicts."""
    cfg, tcfg, params, tp = bridged
    assert len(tp["segments"][0]) == cfg.n_layers
    assert tp["embed"].dtype == torch.bfloat16
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        a = np.asarray(leaf)
        want = a.view(np.uint16) if a.dtype.itemsize == 2 else a
        assert node.shape == want.shape, path
        np.testing.assert_array_equal(node, want, err_msg=str(path))
