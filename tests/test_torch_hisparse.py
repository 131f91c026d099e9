"""The port's HiSparse hot tier (``repro_torch.core.hisparse``) against
the reference, step by step on the same request streams.

Every integer field of ``BufferState`` (``page_table``, ``slot_pos``,
``last_use``, ``clock``, ``pf_*``) and the per-step hits/misses must be
EXACT; the buffered entries and the served values are copied bf16 rows
and must be exact too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hisparse as jh
from repro_torch.core import hisparse as th

_read_through = jax.jit(jh.read_through)
_INT_FIELDS = ("slot_pos", "page_table", "last_use", "clock", "pf_flag",
               "pf_inserted", "pf_used")


def _assert_same(js, ts, where=""):
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=f"{name} {where}")
    np.testing.assert_array_equal(
        ts.entries.float().numpy(),
        np.asarray(js.entries.astype(jnp.float32)), err_msg=f"entries {where}")


def _step(js, ts, idx, vals, valid):
    """One read_through on both; compares the served values and counts."""
    jv, js, jhit, jmiss = _read_through(js, jnp.asarray(idx),
                                        jnp.asarray(vals, jnp.bfloat16),
                                        jnp.asarray(valid))
    tv, ts, thit, tmiss = th.read_through(
        ts, torch.from_numpy(idx), torch.from_numpy(vals).to(torch.bfloat16),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tmiss.numpy(), np.asarray(jmiss))
    return js, ts


def _stream(rng, B, S, k, steps, d, p_invalid=0.2, hot=6):
    """Request stream with duplicates (a small hot set revisited), invalid
    lanes and fresh positions."""
    for t in range(steps):
        idx = np.where(rng.random((B, k)) < 0.5,
                       rng.integers(0, hot, (B, k)),
                       rng.integers(0, S, (B, k))).astype(np.int32)
        valid = rng.random((B, k)) >= p_invalid
        vals = rng.standard_normal((B, k, d)).astype(np.float32)
        yield idx, vals, valid


@pytest.mark.parametrize("buf,k", [(8, 5), (8, 12), (16, 16)])
def test_read_through_sequences_exact(buf, k):
    """Duplicates, invalid lanes, and k > buf (overflow misses stay
    unbuffered) over 10 steps."""
    rng = np.random.default_rng(buf * 100 + k)
    B, S, d = 3, 40, 8
    js = jh.init_buffer(B, buf, S, d)
    ts = th.init_buffer(B, buf, S, d, device="cpu")
    for t, (idx, vals, valid) in enumerate(_stream(rng, B, S, k, 10, d)):
        js, ts = _step(js, ts, idx, vals, valid)
        _assert_same(js, ts, f"step {t}")


def test_lru_ties_follow_stable_order():
    """Every slot filled in one step shares a clock, so the LRU victims
    are decided by the stable argsort's slot order."""
    B, S, d, buf = 2, 32, 4, 4
    js = jh.init_buffer(B, buf, S, d)
    ts = th.init_buffer(B, buf, S, d, device="cpu")
    seq = [
        np.array([[3, 9, 1, 7], [30, 2, 8, 4]], np.int32),     # fill all
        np.array([[11, 12, 3, 9], [5, 6, 30, 2]], np.int32),   # 2 ties out
        np.array([[13, 14, 15, 16], [3, 4, 17, 18]], np.int32),
        np.array([[3, 3, 13, 20], [18, 18, 18, 19]], np.int32),
    ]
    for t, idx in enumerate(seq):
        vals = np.full((B, 4, d), t + 1, np.float32)
        js, ts = _step(js, ts, idx, vals, np.ones((B, 4), bool))
        _assert_same(js, ts, f"step {t}")


def test_disabled_layers_and_reset_lane():
    """Per-layer sizes via DISABLED slots in one layered buffer, then a
    recycled lane: every field exact, DISABLED markers kept by reset."""
    rng = np.random.default_rng(7)
    L, B, S, d, k = 2, 3, 30, 8, 6
    sizes = [3, 7]
    jl = jh.init_layered_buffer(L, B, sizes, S, d)
    tl = th.init_layered_buffer(L, B, sizes, S, d, device="cpu")
    _assert_same(jl, tl, "init")
    for t, (idx, vals, valid) in enumerate(_stream(rng, B, S, k, 8, d)):
        for layer in range(L):
            js = jh.BufferState(*(f[layer] for f in jl))
            ts = th.BufferState(*(f[layer] for f in tl))
            js, ts = _step(js, ts, idx, vals, valid)
            jl = jh.BufferState(*(full.at[layer].set(part)
                                  for full, part in zip(jl, js)))
            for full, part in zip(tl, ts):
                full[layer].copy_(part)
        _assert_same(jl, tl, f"step {t}")
        if t == 4:
            jl = jh.reset_lane(jl, 1)
            tl = th.reset_lane(tl, 1)
            _assert_same(jl, tl, "after reset_lane")
    assert (tl.slot_pos[0, :, 3:] == th.DISABLED).all()
