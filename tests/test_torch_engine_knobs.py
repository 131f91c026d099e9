"""The port's ``Engine`` against the JAX reference's on the host branches
that the default-settings parity tests (tests/test_torch_engine.py) do
not reach: chunked prefill, EDF admission with load shedding and the
``tree:2x2`` fabric topology.  Each branch admits prompts through the
slot splice (``Engine._splice_state``, one launch of the scatter kernel's
splice form on the card) and decodes through the two-pool decode write,
so each is also a check of those paths on the CPU.

Reduced DeepSeek-V3.2 with bridged weights and the injected,
score-independent top-k of tests/test_torch_engine.py: the per-request
timelines (dispatch, first token, finish, pool device), ``EngineStats``
(``TrafficStats`` and the per-layer counters included), the shed
requests and the run's summary equal the reference's exactly.  The
radix branches are in tests/test_torch_engine_radix.py.  (The engines
allocate pool pages themselves: a page id backs one radix node.)
"""
import pytest
from torch_engine_pair import assert_engines_equal, run_pair, weights  # noqa: F401


def _sharegpt(pkg, vocab):
    return pkg.sharegpt_trace(4, context_len=36, output_len=4, seed=1,
                              ctx_jitter=0.2, vocab=vocab)


def _burst(pkg, vocab):
    """Six requests at t=0 against a shedding depth of 2, then a second
    wave long after the first drains."""
    reqs = pkg.sharegpt_trace(8, context_len=32, output_len=3, seed=7,
                              ctx_jitter=0.2, vocab=vocab)
    for r in reqs[6:]:
        r.arrival_s = 1e5
    return reqs


@pytest.mark.parametrize("case", ["chunked_prefill", "edf_shed",
                                  "tree_2x2"])
def test_engine_knobs_match_reference(weights, case):
    trace, knobs, sac = {
        "chunked_prefill": (_sharegpt, dict(prefill_chunk_tokens=16), None),
        "edf_shed": (_burst, dict(admission="edf", shed_queue_depth=2,
                                  overlap=False), dict(slo_ttft_s=0.05)),
        "tree_2x2": (_sharegpt, dict(topology="tree:2x2"), None),
    }[case]
    je, jreqs, jout, te, treqs, tout = run_pair(weights, trace, knobs,
                                                sac=sac)
    assert_engines_equal(je, jreqs, jout, te, treqs, tout)
    if case == "edf_shed":
        assert 0 < len(te.shed) < len(treqs)
    else:
        assert tout["n_done"] == len(treqs)
