"""The port's xLSTM (``xlstm_super``: 3 mLSTM layers + 1 sLSTM layer a
super-block; attention-free, ``sac.enabled=False``: no pool, no hot tier,
no kernel) against the JAX reference, on reduced xLSTM-125M widened to 2
super-blocks (8 layers; d=64, 4 heads) with weights bridged by
``repro_torch/bridge.py``.

- The bridge: ``{"mlstm": [n, 3, ...], "slstm": [n, ...]}`` both ways,
  bit for bit; the serve state (``rec_0`` = ((C, n, m) [n, 3, ...],
  (h, c, n, m) [n, B, d])) both ways, bit for bit.
- Prefill and teacher-forced decode walked layer by layer in the
  reference's order: each port layer against the reference's on the
  port's own input and state to it, within REL_L2 (3e-2, as
  tests/test_torch_zamba.py; about 0.4 % measured): outputs and every
  ``rec_0`` leaf a layer updates; the whole model's ``prefill`` /
  ``decode`` equal to that walk bit for bit.
- The whole model against the reference (prefill logits, teacher-forced
  decode logits, every ``rec_0`` leaf) within WHOLE_L2, limits derived
  from the reference's own spread: random-weight layers amplify a
  one-rounding difference of their input, so that the reference run op
  by op (``jax.disable_jit``) and under ``jax.jit`` differs by up to
  0.075 here, which a test records.  Controls (the recurrent state
  dropped every 8 prompt tokens or between decode steps) must exceed
  the limits.
- The state holds only ``cache_len`` and ``rec_0``, as the reference's;
  SAC mode is forced to dense.
- The serving Engine against the JAX Engine on one trace: timelines,
  EngineStats and TrafficStats exact, with no pool at all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.request import sharegpt_trace as jtrace
from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                state_from_jax, state_to_numpy)
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as ttr
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import sharegpt_trace as ttrace
from torch_engine_pair import assert_engines_equal

REL_L2 = 3e-2
ARCH = "xlstm-125m"
TWO_SUPERS = dict(n_layers=8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_rel_close(got, want, axis, what):
    """Relative L2 error of every slice along ``axis`` within REL_L2."""
    got, want = np.moveaxis(_np(got), axis, 0), np.moveaxis(_np(want), axis,
                                                            0)
    assert got.shape == want.shape, what
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= REL_L2, f"{what}[{i}]: relative L2 error {err:.4f}"


def _jax_tree(x):
    """Port tensors (nested tuples) -> JAX arrays of the same bits."""
    if isinstance(x, tuple):
        return tuple(map(_jax_tree, x))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def bridged():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **TWO_SUPERS)
    tcfg = dataclasses.replace(tget(ARCH).reduced(), **TWO_SUPERS)
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(7))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, np_params, params_from_jax(np_params, tcfg,
                                                         "cpu")


def _walk(params, tp, tcfg, x, visit):
    """Every layer in the reference's order: ``visit(kind, at, jp, tpl,
    x)`` -> x', with ``at`` the layer's index into the stacks ((i, j) for
    mLSTM layer j of super-block i, (i,) for its sLSTM layer)."""
    jseg = params["segments"][0]
    for i, it in enumerate(tp["segments"][0]):
        for j, pl in enumerate(it["mlstm"]):
            x = visit("mlstm", (i, j),
                      jax.tree.map(lambda a: a[i, j], jseg["mlstm"]), pl, x)
        x = visit("slstm", (i,), jax.tree.map(lambda a: a[i], jseg["slstm"]),
                  it["slstm"], x)
    return x


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


def test_bridge_round_trip(bridged):
    cfg, tcfg, _, np_params, tp = bridged
    back = params_to_numpy(tp, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        want = leaf.view(np.uint16) if leaf.dtype.itemsize == 2 else leaf
        assert node.shape == want.shape, path
        np.testing.assert_array_equal(node, want, err_msg=str(path))
    assert len(tp["segments"]) == 1 and len(tp["segments"][0]) == 2
    assert len(tp["segments"][0][1]["mlstm"]) == 3
    np.testing.assert_array_equal(
        tp["segments"][0][1]["mlstm"][2]["wq"].view(torch.int16).numpy()
        .view(np.uint16),
        np_params["segments"][0]["mlstm"]["wq"][1, 2].view(np.uint16))
    assert "shared" not in tp and ttr.pool_layer_params(tcfg, tp) == []


def test_serve_state_bridge_round_trip(bridged):
    cfg, _, params, _, _ = bridged
    jm = jbuild(cfg)
    jst = jm.init_serve_state(2, 16)
    jst, _ = jax.jit(jm.decode)(params, jst, jnp.asarray([1, 2], jnp.int32))
    np_st = jax.tree.map(np.asarray, jst)
    tst = state_from_jax(np_st, device="cpu")
    assert set(tst) == {"cache_len", "rec_0"}
    (C, n, m), s = tst["rec_0"]
    assert C.shape == (2, 3, 2, 4, 16, 16) and len(s) == 4
    assert s[0].shape == (2, 2, 64) and float(C.abs().max()) > 0
    back = state_to_numpy(tst)
    for (path, leaf), got in zip(jax.tree_util.tree_leaves_with_path(np_st),
                                 jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, leaf, err_msg=str(path))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_layer_by_layer(bridged):
    """Each layer of a 20-token prefill against the reference's on the
    port's own input; the whole prefill's logits equal the walk's; the
    state is ``cache_len`` and zero ``rec_0`` in the reference's
    layouts, with no pool."""
    cfg, tcfg, params, _, tp = bridged
    T = 20
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab, size=(2, T)).astype(np.int32)
    tm = tbuild(tcfg, device="cpu")
    tst, tlast = tm.prefill(tp, torch.from_numpy(prompt))
    jst, _ = jax.jit(jbuild(cfg).prefill)(params, jnp.asarray(prompt))
    blocks = {"mlstm": (jax.jit(lambda p, x: jssm.mlstm_block(p, x, cfg)),
                        ttr.ssm.mlstm_block),
              "slstm": (jax.jit(lambda p, x: jssm.slstm_block(p, x, cfg)),
                        ttr.ssm.slstm_block)}

    def visit(kind, at, jp, tpl, x):
        jblock, tblock = blocks[kind]
        want = _jax_tree(x) + jblock(jp, jlayers.rms_norm(_jax_tree(x),
                                                          jp["ln"]))
        x = x + tblock(tpl, ttr.rms_norm(x, tpl["ln"]), tcfg)
        _assert_rel_close(x, want, 0, f"{kind} {at}")
        return x

    x = _walk(params, tp, tcfg, tp["embed"][torch.from_numpy(prompt).long()],
              visit)
    assert torch.equal(tlast, tm._logits(tp, x[:, -1]))
    assert set(tst) == set(jst) == {"cache_len", "rec_0"}
    for a, b in zip(jax.tree.leaves(tst["rec_0"]),
                    jax.tree.leaves(jst["rec_0"])):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert not a.any()


def test_decode_teacher_forced(bridged):
    """Three decode steps from zero state (a model built in SAC mode runs
    dense: no pool), walked layer by layer against the reference on the
    port's own input and ``rec_0`` slices (outputs and every state leaf
    within REL_L2); the whole decode equal to the walk bit for bit."""
    cfg, tcfg, params, _, tp = bridged
    tm = tbuild(tcfg, mode="sac", device="cpu")
    assert tm.mode == "dense" and tm.n_kv == 0
    tst = tm.init_serve_state(2, 32, device_buffer=8)
    assert set(tst) == {"cache_len", "rec_0"}
    rng = np.random.default_rng(9)
    decodes = {"mlstm": (jssm.mlstm_decode, ttr.ssm.mlstm_decode),
               "slstm": (jssm.slstm_decode, ttr.ssm.slstm_decode)}
    for step in range(3):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, size=2).astype(np.int32))
        want_st, want_log = tm.decode(
            tp, {"cache_len": tst["cache_len"].clone(),
                 "rec_0": jax.tree.map(torch.clone, tst["rec_0"])}, toks)
        m_rec, s_rec = tst["rec_0"]

        def visit(kind, at, jp, tpl, x):
            jdec, tdec = decodes[kind]
            st = tuple(t[at] for t in (m_rec if kind == "mlstm" else s_rec))
            jx = _jax_tree(x)
            jout, jnew = jdec(jp, jlayers.rms_norm(jx, jp["ln"]), cfg,
                              _jax_tree(st))
            out, new = tdec(tpl, ttr.rms_norm(x, tpl["ln"]), tcfg, st)
            x = x + out
            _assert_rel_close(x, jx + jout, 0, f"step {step} {kind} {at}")
            for k, (a, b, d) in enumerate(zip(new, jnew, st)):
                _assert_rel_close(a, b, 0, f"step {step} {kind} {at} .{k}")
                d.copy_(a)
            return x

        x = _walk(params, tp, tcfg, tp["embed"][toks.long()], visit)
        assert torch.equal(tm._logits(tp, x), want_log)
        for a, b in zip(jax.tree.leaves(tst["rec_0"]),
                        jax.tree.leaves(want_st["rec_0"])):
            assert torch.equal(a, b), step
        assert torch.equal(want_st["cache_len"], tst["cache_len"] + 1)
        tst = want_st


# ---------------------------------------------------------------------------
# the whole model against the reference
# ---------------------------------------------------------------------------

# The whole model's limits, relative L2 of the prefill logits, the decode
# logits and each rec_0 leaf.  Random-weight layers amplify a
# one-rounding difference of their input, so that the reference run op
# by op (jax.disable_jit) differs from itself under jax.jit by up to 0.075
# here (0.11 on other seeds).  The port's sound runs reach 0.11; the
# controls (the recurrent state dropped every 8 prompt tokens, or
# between decode steps) reach 1.0-1.4.  Each limit sits between the two.
WHOLE_L2 = {"prefill": 0.25, "decode": 0.25, "rec": 0.25}


def _rel(got, want):
    a, b = _np(got), _np(want)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _no_carry(block, n=8):
    """An mLSTM or sLSTM block whose recurrent state is dropped every
    ``n`` positions: the prefill's control."""
    def wrong(p, x, cfg):
        return torch.cat([block(p, x[:, c:c + n], cfg)
                          for c in range(0, x.shape[1], n)], 1)
    return wrong


@pytest.fixture(scope="module")
def whole(bridged):
    """A 20-token prompt, then 3 teacher-forced decode steps from zero
    state, through the reference under jax.jit (``want``), the reference
    op by op (``ref``), the port (``port``) and the port's controls
    (``control``: the prefill with the state dropped every 8 tokens,
    decode with ``rec_0`` zeroed before each step): relative L2 errors
    against ``want`` of each request's prefill logits, each request's
    decode logits a step and each ``rec_0`` leaf a step."""
    cfg, tcfg, params, _, tp = bridged
    jm, tm = jbuild(cfg), tbuild(tcfg, device="cpu")
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab, size=(2, 20)).astype(np.int32)
    _, want = jax.jit(jm.prefill)(params, jnp.asarray(prompt))
    with jax.disable_jit():
        _, ref = jm.prefill(params, jnp.asarray(prompt))
    _, port = tm.prefill(tp, torch.from_numpy(prompt))
    blocks = (ttr.ssm.mlstm_block, ttr.ssm.slstm_block)
    ttr.ssm.mlstm_block, ttr.ssm.slstm_block = map(_no_carry, blocks)
    try:
        _, control = tm.prefill(tp, torch.from_numpy(prompt))
    finally:
        ttr.ssm.mlstm_block, ttr.ssm.slstm_block = blocks
    out = {k: dict(prefill=[_rel(x[i], want[i]) for i in range(2)],
                   decode=[], rec=[])
           for k, x in (("ref", ref), ("port", port), ("control", control))}
    jst = jm.init_serve_state(2, 32)
    states = dict(ref=jst, port=tm.init_serve_state(2, 32),
                  control=tm.init_serve_state(2, 32))
    rng = np.random.default_rng(9)
    jdecode = jax.jit(jm.decode)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jst, want = jdecode(params, jst, jnp.asarray(toks))
        with jax.disable_jit():
            states["ref"], ref = jm.decode(params, states["ref"],
                                           jnp.asarray(toks))
        for leaf in jax.tree.leaves(states["control"]["rec_0"]):
            leaf.zero_()
        logits = {"ref": ref}
        for k in ("port", "control"):
            states[k], logits[k] = tm.decode(tp, states[k],
                                             torch.from_numpy(toks))
        for k, lg in logits.items():
            out[k]["decode"].append([_rel(lg[i], want[i]) for i in range(2)])
            out[k]["rec"].append([
                _rel(a, b) for a, b in zip(jax.tree.leaves(states[k]["rec_0"]),
                                           jax.tree.leaves(jst["rec_0"]))])
    return out


def test_reference_spread_jit_vs_op_by_op(whole):
    """The reference against itself, op by op and under jax.jit: more
    than the per-layer REL_L2 (in the logits or ``rec_0``), and within
    the limits WHOLE_L2 derived from it."""
    spread = {what: float(np.max(errs)) for what, errs in whole["ref"].items()}
    assert max(spread.values()) > REL_L2, spread
    for what, worst in spread.items():
        assert worst <= WHOLE_L2[what], (what, worst)


def test_whole_model_against_reference(whole):
    """The port's whole model against the reference under jax.jit:
    prefill logits, teacher-forced decode logits and every ``rec_0``
    leaf within WHOLE_L2 for every request and step; the controls (the
    state dropped every 8 prompt tokens; ``rec_0`` dropped, which shows
    from the second decode step) beyond it for every request."""
    port, control = whole["port"], whole["control"]
    for what, limit in WHOLE_L2.items():
        errs = np.asarray(port[what])
        assert errs.max() <= limit, (what, errs.round(4).tolist())
    assert min(control["prefill"]) > WHOLE_L2["prefill"], control["prefill"]
    for step, errs in enumerate(control["decode"][1:], 1):
        assert min(errs) > WHOLE_L2["decode"], (step, errs)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_engine_timeline_and_traffic_exact(bridged):
    """Engine.run on the two-super-block xLSTM: per-request timeline,
    EngineStats and TrafficStats equal the JAX engine's exactly; the
    engine's state has no pool and no hot tier, and every slot's
    recurrent state was spliced and decoded (non-zero)."""
    cfg, tcfg, params, _, tparams = bridged
    kw = dict(slots=2, max_ctx=64, seed=3)
    je = JEngine(cfg, **kw)
    je.params = params
    jreqs = jtrace(5, context_len=24, output_len=5, seed=2, ctx_jitter=0.2,
                   vocab=cfg.vocab)
    jout = je.run(jreqs)
    te = TEngine(tcfg, device="cpu", **kw)
    te.params = tparams
    treqs = ttrace(5, context_len=24, output_len=5, seed=2, ctx_jitter=0.2,
                   vocab=cfg.vocab)
    tout = te.run(treqs)
    assert_engines_equal(je, jreqs, jout, te, treqs, tout)
    assert set(te.state) == set(je.state) == {"cache_len", "rec_0"}
    assert te.stats.tokens == 25
    for leaf in jax.tree.leaves(te.state["rec_0"]):
        assert leaf.abs().sum() > 0
