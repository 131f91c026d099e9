"""The port's encoder-decoder (``repro_torch/models/encdec.py``, Whisper)
against the JAX reference, on reduced Whisper-small (2 encoder + 2
decoder layers, d=64, 4 heads of 16, top-k 16) with weights bridged by
``repro_torch/bridge.py`` and inputs made from numpy seeds.

- ``bidir_attention`` at f32 tolerance (1e-5) on f32 inputs, with one
  and with several key chunks and with the query axis cut into blocks;
  a key length that does not divide into its chunks raises
  ``ValueError`` (the reference's reshape fails there).
- The bridge both ways, bit for bit (``enc`` / ``dec`` stacks as lists),
  and a decoded serve state (``self_kv``, ``dec_len``) both ways.
- ``encode``, then ``prefill``'s ``kv_pool`` / ``idx_pool`` per (layer,
  request) within 2e-2 relative L2 (bf16 activations round at other
  places in XLA and PyTorch).
- Teacher-forced decode, each package from its own prefill, in SAC
  mode (one score-independent top-k injected into both: the port's
  ``topk_fn``, the reference's ``dsa.topk_select``, which its decode
  calls) and in dense mode: logits per request within 3e-2, ``self_kv``
  written at the same positions (rows past ``dec_len`` zero in both) and
  within 3e-2, ``dec_len`` exact.
- Inside the port: sparse == dense bit for bit when top-k covers the
  encoder length, as tests/test_sac_equivalence.py holds the reference.
- The training forward (``forward``) and its gradients against the
  reference's ``forward`` and ``jax.value_and_grad`` on a synthetic
  batch (frames and 448 decoder tokens): logits per request within 3e-2,
  aux 0, the loss within 1e-3 relative and each gradient leaf within 5e-2
  relative L2, the limits of tests/test_torch_training.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import dsa as jdsa
from repro.models import encdec as jencdec
from repro.models.model import build_model as jbuild
from repro.training.data import synthetic_batch
from repro.training.train_loop import make_loss_fn as jloss
from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                state_from_jax, state_to_numpy)
from repro_torch.configs import get_config as tget
from repro_torch.models import encdec as tencdec
from repro_torch.models.model import build_model as tbuild
from repro_torch.training.train_loop import make_grad_fn

ARCH = "whisper-small"
REL_L2 = 3e-2
GRAD_L2 = 5e-2
LOSS_REL = 1e-3
POOL_L2 = 2e-2
K = 16
S_ENC = 24
LENGTHS = [24, 17]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: faster alone, and no
    oversubscription when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def bridged():
    cfg = get_config(ARCH).reduced()
    tcfg = tget(ARCH).reduced()
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, np_params, params_from_jax(np_params, tcfg,
                                                         "cpu")


def _frames(cfg, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, S_ENC, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# bidir_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,chunk,block", [(5, 8, 1024, None),
                                               (6, 12, 4, None),
                                               (9, 12, 4, 3)])
def test_bidir_attention_matches_reference(sq, sk, chunk, block,
                                           monkeypatch):
    """f32 inputs at f32 tolerance; ``block`` cuts the query axis into
    blocks of that many rows (the score-block budget made small)."""
    rng = np.random.default_rng(sq * 100 + sk)
    q, k, v = (rng.standard_normal((2, n, 3, 8)).astype(np.float32)
               for n in (sq, sk, sk))
    want = jencdec.bidir_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), chunk=chunk)
    if block:
        monkeypatch.setattr(tencdec, "_SCORE_BLOCK_BYTES",
                            block * 2 * 3 * (sk // max(sk // chunk, 1)) * 4)
    got = tencdec.bidir_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bidir_attention_refuses_an_uneven_key_length():
    """13 keys in max(13 // 4, 1) = 3 chunks of 4: the reference's
    reshape fails; the port names the constraint."""
    x = torch.zeros((1, 4, 2, 8))
    k = torch.zeros((1, 13, 2, 8))
    with pytest.raises(ValueError, match="divide into 3 chunks"):
        tencdec.bidir_attention(x, k, k, chunk=4)
    with pytest.raises(TypeError):
        jencdec.bidir_attention(jnp.zeros((1, 4, 2, 8)),
                                jnp.zeros((1, 13, 2, 8)),
                                jnp.zeros((1, 13, 2, 8)), chunk=4)


# ---------------------------------------------------------------------------
# bridge, encode, prefill
# ---------------------------------------------------------------------------


def test_bridge_round_trip(bridged):
    cfg, tcfg, _, np_params, tp = bridged
    assert len(tp["enc"]) == cfg.n_enc_layers == 2
    assert len(tp["dec"]) == cfg.n_layers == 2 and "idx" in tp["dec"][0]
    back = params_to_numpy(tp, tcfg)
    flat = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        want = leaf.view(np.uint16) if leaf.dtype.itemsize == 2 else leaf
        np.testing.assert_array_equal(node, want, err_msg=str(path))


def test_serve_state_bridge_round_trip(bridged):
    """A reference serve state after two decode steps -> the port's ->
    numpy, bit for bit; the port decodes on from it."""
    cfg, tcfg, params, _, tp = bridged
    jm = jbuild(cfg)
    jf, _ = _frames(cfg)
    jst, _ = jax.jit(jm.prefill)(params, jf)
    for tok in ([1, 2], [3, 4]):
        jst, _ = jax.jit(jm.decode)(params, jst, jnp.asarray(tok, jnp.int32))
    np_st = jax.tree.map(np.asarray, jst)
    tst = state_from_jax(np_st, device="cpu")
    assert tst["self_kv"].dtype == torch.bfloat16
    assert tst["dec_len"].tolist() == [2, 2]
    back = state_to_numpy(tst)
    assert set(back) == set(np_st)
    for k, want in np_st.items():
        want = want.view(np.uint16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    tm = tbuild(tcfg, device="cpu")
    tst, _ = tm.decode(tp, tst, torch.tensor([5, 6], dtype=torch.int32))
    assert tst["dec_len"].tolist() == [3, 3] and tst["self_kv"][:, :, 2].any()


def test_encode_and_prefill_pools(bridged):
    cfg, tcfg, params, _, tp = bridged
    jm, tm = jbuild(cfg), tbuild(tcfg, device="cpu")
    jf, tf = _frames(cfg)
    want = jax.jit(jm.encode)(params, jf)
    got = tm.encode(tp, tf)
    for b in range(2):
        assert _rel(got[b], want[b]) <= POOL_L2, b
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    jst, jlog = jax.jit(jm.prefill)(params, jf, lengths)
    tst, tlog = tm.prefill(tp, tf, torch.tensor(LENGTHS, dtype=torch.int32))
    assert set(tst) == set(jst) == {"cache_len", "dec_len", "self_kv",
                                    "kv_pool", "idx_pool"}
    for key in ("kv_pool", "idx_pool"):
        assert tuple(tst[key].shape) == jst[key].shape
        assert tst[key].dtype == torch.bfloat16
        for layer in range(cfg.n_layers):
            for b in range(2):
                err = _rel(tst[key][layer, b], jst[key][layer, b])
                assert err <= POOL_L2, (key, layer, b, err)
    assert tst["cache_len"].tolist() == LENGTHS
    assert not tst["dec_len"].any() and not tst["self_kv"].any()
    assert tuple(tst["self_kv"].shape) == (2, 2, tencdec.MAX_DEC, 128)
    assert not tlog.any() and not np.asarray(jlog).any()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def jax_topk(scores, cache_len, k):
    """Score-independent selection with repeats and invalid lanes."""
    j = jnp.arange(K, dtype=jnp.int32)[None]
    t = cache_len[:, None]
    pos = (j * 7 + 3) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), (j < t) & (j % 5 != 3)


def torch_topk(scores, cache_len):
    j = torch.arange(K, dtype=torch.int32)[None]
    t = cache_len[:, None]
    pos = (j * 7 + 3) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


@pytest.mark.parametrize("mode", ["sac", "dense"])
def test_decode_against_reference(bridged, mode, monkeypatch):
    cfg, tcfg, params, _, tp = bridged
    sac = mode == "sac"
    if sac:
        monkeypatch.setattr(jdsa, "topk_select", jax_topk)
    jm = jbuild(cfg, mode=mode)
    tm = tbuild(tcfg, mode=mode, topk_fn=torch_topk if sac else None,
                device="cpu")
    jf, tf = _frames(cfg, seed=1)
    jst, _ = jax.jit(jm.prefill)(params, jf, jnp.asarray(LENGTHS, jnp.int32))
    tst, _ = tm.prefill(tp, tf, torch.tensor(LENGTHS, dtype=torch.int32))
    assert ("idx_pool" in tst) == sac
    jdecode = jax.jit(jm.decode)
    rng = np.random.default_rng(5)
    steps = 4
    for step in range(steps):
        toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jst, jlog = jdecode(params, jst, jnp.asarray(toks))
        tst, tlog = tm.decode(tp, tst, torch.from_numpy(toks))
        for b in range(2):
            err = _rel(tlog[b], jlog[b])
            assert err <= REL_L2, (mode, step, b, err)
        assert tst["dec_len"].tolist() == np.asarray(jst["dec_len"]).tolist() \
            == [step + 1] * 2
    jkv = _np(jst["self_kv"])
    tkv = _np(tst["self_kv"])
    assert not jkv[:, :, steps:].any() and not tkv[:, :, steps:].any()
    for layer in range(cfg.n_layers):
        for b in range(2):
            for pos in range(steps):
                assert tkv[layer, b, pos].any()
                err = _rel(tkv[layer, b, pos], jkv[layer, b, pos])
                assert err <= REL_L2, (layer, b, pos, err)


def test_sparse_equals_dense_when_topk_covers_the_encoder():
    """With top-k >= the encoder length the sparse decode (indexer,
    top-k, gather, GQA over the k lanes) is bit-identical to the dense
    decode over the whole pool, logits and ``self_kv``."""
    cfg = tget(ARCH).reduced()
    cfg = dataclasses.replace(cfg, sac=dataclasses.replace(
        cfg.sac, topk=S_ENC + 8))
    m_sac = tbuild(cfg, mode="sac", device="cpu")
    m_dense = tbuild(cfg, mode="dense", device="cpu")
    params = m_sac.init(torch.Generator().manual_seed(0))
    frames = torch.randn((2, S_ENC, cfg.d_model),
                         generator=torch.Generator().manual_seed(1)
                         ).to(torch.bfloat16)
    st1, _ = m_sac.prefill(params, frames)
    st2, _ = m_dense.prefill(params, frames)
    toks = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(3):
        st1, l1 = m_sac.decode(params, st1, toks)
        st2, l2 = m_dense.decode(params, st2, toks)
        assert torch.equal(l1, l2)
        assert torch.equal(st1["self_kv"], st2["self_kv"])
        toks = torch.argmax(l1, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# the training forward and its gradients
# ---------------------------------------------------------------------------


def test_forward_and_grads_against_reference(bridged):
    cfg, tcfg, params, np_params, tp = bridged
    jm, tm = jbuild(cfg), tbuild(tcfg, device="cpu")
    batch = synthetic_batch(cfg, 2, S_ENC, seed=1)
    assert batch["tokens"].shape == (2, tencdec.MAX_DEC)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p, b):
        return (jm.forward(p, {"frames": b["frames"], "tokens": b["tokens"]}),
                jax.value_and_grad(jloss(jm), has_aux=True)(p, b))
    (jlogits, jaux), ((_, jmetrics), jgrads) = jax.jit(run)(params, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, aux = tm.forward(tp, {"frames": tb["frames"],
                                  "tokens": tb["tokens"]})
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (2, tencdec.MAX_DEC, cfg.vocab)
    for b in range(2):
        assert _rel(logits[b], jlogits[b]) <= REL_L2, b
    assert float(aux) == float(jaux) == 0.0
    metrics, grads = make_grad_fn(tm)(tp, tb)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=LOSS_REL)
    got = params_to_numpy(grads, tcfg)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        node = got
        for key in path:
            node = node[key.key]
        if node.dtype == np.uint16:
            node = (node.astype(np.uint32) << 16).view(np.float32)
        want = np.asarray(want, np.float32)
        if not want.any():            # the indexer: unused by the forward
            assert not node.any(), path
            continue
        err = _rel(node, want)
        assert err <= GRAD_L2, (jax.tree_util.keystr(path), err)
