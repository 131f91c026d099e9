"""The port's ``Engine`` against the JAX ``Engine`` with the whole fetch
pipeline on: speculative prefetch, prefill warm-up (score seeds and radix
tails), the budget arbiter and online hot-tier re-sizing every 2 steps,
on reduced DeepSeek-V3.2 and Qwen2 with bridged weights and a
shared-prefix trace (radix hits, so the radix tails seed too).

Both the demand selection (``topk_fn``) and the speculation
(``prefetch_fn``) are injected and score-independent, so no selection
depends on f32 sum order.  The prefill's score seeds (``warm_idx``) are
the one selection left to the indexer: its scores agree at equal inputs
(tests/test_torch_prefetch.py), but past the first layer the bf16
activations of the two frameworks round at other places, and a seed
within a rounding of its neighbour can change rank.  Each trace seed
used here is one whose prompts have no such near-tie, and the test
checks that first.  After every step the grants, the layer sizes and
the hot tier's integer state are equal; at the end the timelines and
``TrafficStats`` are equal number for number.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.request import shared_prefix_trace as jtrace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import shared_prefix_trace as ttrace

K, W = 16, 8
_INT_FIELDS = ("slot_pos", "page_table", "last_use", "clock", "pf_flag",
               "pf_inserted", "pf_used")


def jax_topk(scores, cache_len):
    j = jnp.arange(K, dtype=jnp.int32)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * ((t + j) // 5)) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), (j < t) & (j % 5 != 3)


def torch_topk(scores, cache_len):
    j = torch.arange(K, dtype=torch.int32)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 13 * torch.div(t + j, 5, rounding_mode="floor")) \
        % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def jax_spec(scores, cache_len):
    """Score-independent speculation: recent positions and a stride, with
    duplicates and invalid lanes."""
    j = jnp.arange(W, dtype=jnp.int32)[None, :]
    t = cache_len[:, None]
    pos = (t - 1 - (j * j) % 11) % jnp.maximum(t, 1)
    return pos.astype(jnp.int32), (j % 4 != 1)


def torch_spec(scores, cache_len):
    j = torch.arange(W, dtype=torch.int32)[None, :]
    t = cache_len[:, None]
    pos = (t - 1 - (j * j) % 11) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j % 4 != 1)


def _cfg(get, arch):
    base = get(arch).reduced()
    # a link budget wide enough that the reduced model's grants vary
    # between 0 and the full width
    return dataclasses.replace(base, sac=dataclasses.replace(
        base.sac, resize_interval=2, link_budget_frac=300.0))


def _trace(fn, vocab, seed):
    return fn(6, prefix_len=16, suffix_len=20, output_len=5, reuse_p=0.8,
              seed=seed, vocab=vocab)


def _check_seeds_agree(cfg, tcfg, params, tparams, reqs):
    """Every prompt's prefill warm-up candidates are equal in both."""
    w = cfg.sac.warmup_entries
    jprefill = jax.jit(jbuild(cfg, opts={"warmup_w": w}).prefill)
    tm = tbuild(tcfg, opts={"warmup_w": w}, device="cpu")
    for r in reqs:
        prompt = np.asarray(r.prompt_tokens[:r.context_len], np.int32)[None]
        want = np.asarray(jprefill(params, jnp.asarray(prompt))[0]
                          ["warm_idx"])
        got = tm.prefill(tparams, torch.from_numpy(prompt))[0]["warm_idx"]
        np.testing.assert_array_equal(
            got.numpy(), want, err_msg=f"request {r.request_id}: a seed "
            "near a tie ranks differently; pick another trace seed")


def _assert_hot_equal(te, je, where):
    jh, th = je.state["hot_buf"], te.state["hot_buf"]
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)),
                                      err_msg=f"{name} {where}")


@pytest.mark.parametrize("arch,trace_seed", [("deepseek-v32", 9),
                                             ("qwen2-1.5b", 4)])
def test_engine_fetch_pipeline_exact(arch, trace_seed):
    cfg, tcfg = _cfg(get_config, arch), _cfg(tget, arch)
    params = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    jreqs = _trace(jtrace, cfg.vocab, trace_seed)
    treqs = _trace(ttrace, cfg.vocab, trace_seed)
    _check_seeds_agree(cfg, tcfg, params, tparams, jreqs)
    knobs = dict(slots=2, max_ctx=48, prefetch=True, arbiter=True, seed=3,
                 placement="radix_affinity")
    je = JEngine(cfg, topk_fn=jax_topk, prefetch_fn=jax_spec, **knobs)
    je.params = params
    te = TEngine(tcfg, topk_fn=torch_topk, prefetch_fn=torch_spec,
                 device="cpu", **knobs)
    te.params = tparams
    assert te.buffer_width == je.buffer_width
    for a, b in zip(jreqs, treqs):
        je.submit(a)
        te.submit(b)
    grants, sizes = [], []
    for step in range(40):
        jfin, tfin = je.step(), te.step()
        assert [r.request_id for r in tfin] == [r.request_id for r in jfin]
        assert te.last_grants == je.last_grants, f"step {step}"
        assert te.buffer_sizes == je.buffer_sizes, f"step {step}"
        _assert_hot_equal(te, je, f"step {step}")
        grants.append(dict(te.last_grants))
        sizes.append(list(te.buffer_sizes))
        if all(r.finish_s >= 0 for r in treqs):
            break
    assert all(r.finish_s >= 0 for r in jreqs + treqs)
    for a, b in zip(jreqs, treqs):
        assert (a.dispatch_s, a.first_token_s, a.finish_s, a.pool_device) \
            == (b.dispatch_s, b.first_token_s, b.finish_s, b.pool_device)
    assert dataclasses.asdict(te.stats.traffic) == \
        dataclasses.asdict(je.stats.traffic)
    for f in ("steps", "tokens", "resizes", "resize_skips",
              "radix_hit_tokens", "radix_hit_requests"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    np.testing.assert_array_equal(te.stats.layer_misses,
                                  je.stats.layer_misses)
    # the run exercised what it claims to
    s = te.stats
    assert s.prefetched_entries > 0 and s.prefetch_useful > 0
    assert s.prefetched_entries == s.prefetch_useful + s.prefetch_wasted
    assert s.resizes > 0 and len({tuple(x) for x in sizes}) > 1
    widths = [w for g in grants for w in g.values()]
    assert 0 < sum(widths) < W * len(widths)
    assert s.radix_hit_tokens > 0
