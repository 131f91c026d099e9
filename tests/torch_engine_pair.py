"""Lockstep runs of the port's ``Engine`` and the JAX reference's on the
same trace, for the engine-parity tests (tests/test_torch_engine_knobs.py,
tests/test_torch_engine_radix.py): reduced DeepSeek-V3.2 with bridged
weights and an injected, score-independent top-k (as in
tests/test_torch_engine.py), so that timelines, ``EngineStats`` and
summaries can be held equal number for number.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model as jbuild
from repro.serving import request as jrequest
from repro.serving.engine import Engine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.serving import request as trequest
from repro_torch.serving.engine import Engine as TEngine

K = 16


def jax_topk(scores, cache_len):
    """Score-independent selection with duplicates and invalid lanes."""
    j = jnp.arange(K, dtype=jnp.int32)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * ((t + j) // 5)) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), (j < t) & (j % 5 != 3)


def torch_topk(scores, cache_len):
    j = torch.arange(K, dtype=torch.int32, device=scores.device)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * torch.div(t + j, 5, rounding_mode="floor")) \
        % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def _cfgs(**sac):
    cfg = get_config("deepseek-v32").reduced()
    tcfg = tget("deepseek-v32").reduced()
    if sac:
        cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                               **sac))
        tcfg = dataclasses.replace(tcfg, sac=dataclasses.replace(tcfg.sac,
                                                                 **sac))
    return cfg, tcfg


@pytest.fixture(scope="module")
def weights():
    cfg, tcfg = _cfgs()
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(5))
    return params, params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")


def assert_engines_equal(je, jreqs, jout, te, treqs, tout):
    """Timelines, EngineStats, shed requests and summaries, exactly."""
    for a, b in zip(jreqs, treqs):
        assert (a.request_id, a.dispatch_s, a.first_token_s, a.finish_s,
                a.pool_device) == (b.request_id, b.dispatch_s,
                                   b.first_token_s, b.finish_s,
                                   b.pool_device), a.request_id
    for f in dataclasses.fields(je.stats):
        a, b = getattr(je.stats, f.name), getattr(te.stats, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert sorted(r.request_id for r in je.shed) == \
        sorted(r.request_id for r in te.shed)
    assert tout == jout


def run_pair(weights, trace, knobs, *, sac=None, slots=2, max_ctx=96):
    """The same trace through both engines with the same weights, the
    injected top-k and ``knobs``; returns what assert_engines_equal
    takes.  ``trace(package)`` builds the requests with the request
    module of ``repro`` or ``repro_torch``."""
    cfg, tcfg = _cfgs(**(sac or {}))
    params, tparams = weights
    je = JEngine(cfg, slots=slots, max_ctx=max_ctx, topk_fn=jax_topk,
                 seed=3, **knobs)
    je.params = params
    jreqs = trace(jrequest, cfg.vocab)
    jout = je.run(jreqs)
    te = TEngine(tcfg, slots=slots, max_ctx=max_ctx, topk_fn=torch_topk,
                 seed=3, device="cpu", **knobs)
    te.params = tparams
    treqs = trace(trequest, tcfg.vocab)
    tout = te.run(treqs)
    return je, jreqs, jout, te, treqs, tout
