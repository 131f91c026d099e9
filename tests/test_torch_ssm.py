"""The port's recurrent blocks (``repro_torch/models/ssm.py``: Mamba2's
chunked SSD scan, mLSTM and sLSTM) against the JAX reference
(``repro/models/ssm.py``), on the same numpy-seeded weights and inputs,
and against their own one-token recurrences.

Tolerances: bf16 activations round at other places in XLA and PyTorch
(the conv's products and the gates may be kept in f32 by XLA between
bf16 operations), so outputs and states are compared by relative L2
error, REL_L2 = 3e-2 (tests/test_torch_gqa.py's), per request.  The
port's block-versus-step checks use tests/test_ssm_parity.py's
tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ssm as jssm
from repro.models.layers import init_params
from repro_torch.bridge import tree_from_numpy
from repro_torch.configs import get_config as tget
from repro_torch.models import ssm as tssm

REL_L2 = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_rel_close(got, want, what, tol=REL_L2):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= tol, f"{what}[{i}]: relative L2 error {err:.4f}"


def _x(rng, *shape, scale=0.5):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _params(jspecs, tspecs, seed, perturb=()):
    """Reference-initialised weights of one block, with the leaves in
    ``perturb`` redrawn from a seeded normal (the init leaves A_log and
    dt_bias at 0 and D_skip at 1), as (JAX, port) twins."""
    tree = jax.tree.map(np.asarray, init_params(jspecs,
                                                jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in perturb:
        tree[k] = (rng.standard_normal(tree[k].shape) * 0.5).astype(
            tree[k].dtype)
    return (jax.tree.map(jnp.asarray, tree),
            tree_from_numpy(tree, tspecs, "cpu"))


@pytest.fixture(scope="module")
def mamba():
    cfg, tcfg = get_config("zamba2-7b").reduced(), tget("zamba2-7b").reduced()
    jp, tp = _params(jssm.mamba2_param_specs(cfg),
                     tssm.mamba2_param_specs(tcfg), 3,
                     ("A_log", "dt_bias", "D_skip", "norm_g"))
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def xlstm():
    cfg, tcfg = get_config("xlstm-125m").reduced(), \
        tget("xlstm-125m").reduced()
    jm, tm = _params(jssm.mlstm_param_specs(cfg),
                     tssm.mlstm_param_specs(tcfg), 4, ("norm_g",))
    js, ts = _params(jssm.slstm_param_specs(cfg),
                     tssm.slstm_param_specs(tcfg), 5, ("norm_g",))
    return cfg, tcfg, (jm, tm), (js, ts)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(16, 4), (20, 8), (12, 16), (7, 4),
                                     (32, 256)])
def test_mamba2_block_matches_reference(mamba, S, chunk):
    """Divisible (16 = 4 x 4), ragged against the chunk (20 = 2 x 10
    with chunk 8; 12 and 7 below two chunks: one chunk of S) and the
    default chunk: output and last state."""
    cfg, tcfg, jp, tp = mamba
    jx, tx = _x(np.random.default_rng(S), 2, S, cfg.d_model)
    jy, jst = jssm.mamba2_block(jp, jx, cfg, chunk=chunk)
    ty, tst = tssm.mamba2_block(tp, tx, tcfg, chunk=chunk)
    assert ty.dtype == torch.bfloat16 and tst.dtype == torch.float32
    _assert_rel_close(ty, jy, f"y S={S}")
    _assert_rel_close(tst, jst, f"state S={S}")


def test_mamba2_block_refuses_uneven_chunks(mamba):
    """S = 9 with chunk 4 is cut into 2 chunks of 4, which leaves one
    position: the reference fails on its reshape, the port names the
    constraint."""
    cfg, tcfg, jp, tp = mamba
    jx, tx = _x(np.random.default_rng(9), 1, 9, cfg.d_model)
    with pytest.raises(TypeError):
        jssm.mamba2_block(jp, jx, cfg, chunk=4)
    with pytest.raises(ValueError, match="multiple of"):
        tssm.mamba2_block(tp, tx, tcfg, chunk=4)


def test_mamba2_decode_matches_reference(mamba):
    """Six one-token steps from a non-zero state (a prefix's SSD state
    and conv tail): outputs and both state leaves."""
    cfg, tcfg, jp, tp = mamba
    rng = np.random.default_rng(21)
    B = 2
    ssm_s, conv_s = jssm.mamba2_state_shape(cfg, B)
    s0 = (rng.standard_normal(ssm_s) * 0.3).astype(np.float32)
    jc, tc = _x(rng, *conv_s)
    jstate = (jnp.asarray(s0), jc)
    tstate = (torch.from_numpy(s0), tc)
    for step in range(6):
        jx, tx = _x(rng, B, cfg.d_model)
        jy, jstate = jssm.mamba2_decode(jp, jx, cfg, jstate)
        ty, tstate = tssm.mamba2_decode(tp, tx, tcfg, tstate)
        _assert_rel_close(ty, jy, f"step {step} y")
        _assert_rel_close(tstate[0], jstate[0], f"step {step} ssm")
        _assert_rel_close(tstate[1], jstate[1], f"step {step} conv")


@pytest.mark.parametrize("S", [5, 12])
def test_mlstm_block_matches_reference(xlstm, S):
    cfg, tcfg, (jp, tp), _ = xlstm
    jx, tx = _x(np.random.default_rng(S), 2, S, cfg.d_model)
    _assert_rel_close(tssm.mlstm_block(tp, tx, tcfg),
                      jssm.mlstm_block(jp, jx, cfg), f"mlstm S={S}")


@pytest.mark.parametrize("S", [3, 10])
def test_slstm_block_matches_reference(xlstm, S):
    cfg, tcfg, _, (jp, tp) = xlstm
    jx, tx = _x(np.random.default_rng(S + 1), 2, S, cfg.d_model)
    _assert_rel_close(tssm.slstm_block(tp, tx, tcfg),
                      jssm.slstm_block(jp, jx, cfg), f"slstm S={S}")


def test_xlstm_decode_matches_reference(xlstm):
    """Five mLSTM and sLSTM steps from zero state: outputs and every
    state leaf ((C, n, m) and (h, c, n, m))."""
    cfg, tcfg, (jm, tm), (js, ts) = xlstm
    rng = np.random.default_rng(31)
    B, D, nh = 2, cfg.d_model, cfg.n_heads
    hd = D // nh
    shapes = ((B, nh, hd, hd), (B, nh, hd), (B, nh))
    jms = tuple(jnp.zeros(s, jnp.float32) for s in shapes)
    tms = tuple(torch.zeros(s) for s in shapes)
    jss = tuple(jnp.zeros((B, D), jnp.float32) for _ in range(4))
    tss = tuple(torch.zeros((B, D)) for _ in range(4))
    for step in range(5):
        jx, tx = _x(rng, B, D)
        jy, jms = jssm.mlstm_decode(jm, jx, cfg, jms)
        ty, tms = tssm.mlstm_decode(tm, tx, tcfg, tms)
        _assert_rel_close(ty, jy, f"mlstm step {step}")
        for i, (a, b) in enumerate(zip(tms, jms)):
            _assert_rel_close(a, b, f"mlstm step {step} state {i}")
        jy, jss = jssm.slstm_decode(js, jx, cfg, jss)
        ty, tss = tssm.slstm_decode(ts, tx, tcfg, tss)
        _assert_rel_close(ty, jy, f"slstm step {step}")
        for i, (a, b) in enumerate(zip(tss, jss)):
            _assert_rel_close(a, b, f"slstm step {step} state {i}")


# ---------------------------------------------------------------------------
# the port's block against its own recurrence (test_ssm_parity.py's
# tolerances)
# ---------------------------------------------------------------------------


def test_mamba2_block_matches_sequential_decode(mamba):
    _, cfg, _, p = mamba
    B, S = 2, 16
    _, x = _x(np.random.default_rng(41), B, S, cfg.d_model)
    y_par, last = tssm.mamba2_block(p, x, cfg, chunk=4)
    ssm_s, conv_s = tssm.mamba2_state_shape(cfg, B)
    state = (torch.zeros(ssm_s), torch.zeros(conv_s, dtype=torch.bfloat16))
    ys = []
    for t in range(S):
        y_t, state = tssm.mamba2_decode(p, x[:, t], cfg, state)
        ys.append(y_t)
    np.testing.assert_allclose(_np(y_par), _np(torch.stack(ys, 1)),
                               rtol=0.15, atol=0.05)
    # the block's last state is the recurrence's
    np.testing.assert_allclose(_np(last), _np(state[0]), rtol=0.15,
                               atol=0.05)


def test_mlstm_block_matches_recurrent_decode(xlstm):
    _, cfg, (_, p), _ = xlstm
    B, S = 2, 12
    _, x = _x(np.random.default_rng(42), B, S, cfg.d_model)
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    state = (torch.zeros(B, nh, hd, hd), torch.zeros(B, nh, hd),
             torch.zeros(B, nh))
    ys = []
    for t in range(S):
        y_t, state = tssm.mlstm_decode(p, x[:, t], cfg, state)
        ys.append(y_t)
    np.testing.assert_allclose(_np(tssm.mlstm_block(p, x, cfg)),
                               _np(torch.stack(ys, 1)), rtol=0.2, atol=0.08)


def test_slstm_block_matches_decode(xlstm):
    _, cfg, _, (_, p) = xlstm
    B, S = 2, 10
    _, x = _x(np.random.default_rng(43), B, S, cfg.d_model)
    state = tuple(torch.zeros(B, cfg.d_model) for _ in range(4))
    ys = []
    for t in range(S):
        y_t, state = tssm.slstm_decode(p, x[:, t], cfg, state)
        ys.append(y_t)
    np.testing.assert_allclose(_np(tssm.slstm_block(p, x, cfg)),
                               _np(torch.stack(ys, 1)), rtol=0.1, atol=0.03)


def test_mamba2_state_carries_context(mamba):
    """Different one-token prefixes -> different next outputs."""
    _, cfg, _, p = mamba
    rng = np.random.default_rng(44)
    ssm_s, conv_s = tssm.mamba2_state_shape(cfg, 1)
    zero = (torch.zeros(ssm_s), torch.zeros(conv_s, dtype=torch.bfloat16))
    xa, xb, xq = (_x(rng, 1, cfg.d_model, scale=1.0)[1] for _ in range(3))
    _, sa = tssm.mamba2_decode(p, xa, cfg, zero)
    _, sb = tssm.mamba2_decode(p, xb, cfg, zero)
    ya, _ = tssm.mamba2_decode(p, xq, cfg, sa)
    yb, _ = tssm.mamba2_decode(p, xq, cfg, sb)
    assert float((ya.float() - yb.float()).abs().max()) > 1e-3


def test_mamba2_decay_mask_stays_finite(mamba):
    """A chunk long enough that exp(seg) above the diagonal overflows to
    inf in f32: the where-mask keeps the output finite (a 0/1 product
    would give inf * 0 = NaN)."""
    _, cfg, _, p = mamba
    q = dict(p, A_log=torch.full_like(p["A_log"], 4.0),
             dt_bias=torch.full_like(p["dt_bias"], 4.0))
    _, x = _x(np.random.default_rng(45), 1, 64, cfg.d_model)
    y, last = tssm.mamba2_block(q, x, cfg, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(last).all()
