"""The port's ``Engine`` against the JAX reference's on the radix
branches of the host layer: the ``radix_affinity`` placement with prefix
replication, page dedup and radix-aware admission, and the same on the
``tree:2x2`` fabric with replica reads and warm-up pressure seeding, on
a shared-prefix trace (every prompt reuses one 24-token prefix).  Each
admitted prompt goes through the slot splice and every decode step
through the two-pool decode write (one launch each on the card).

Lockstep runs as in tests/test_torch_engine_knobs.py: the per-request
timelines, ``EngineStats`` (radix hits, replicated and dedup-shared
pages, replica redirects, ``TrafficStats``) and the summary equal the
reference's exactly, and the radix cache really hit.  (The engines
allocate pool pages themselves, so no page id backs two radix nodes.)
"""
import pytest
from torch_engine_pair import assert_engines_equal, run_pair, weights  # noqa: F401

RADIX = dict(placement="radix_affinity", replicate_prefixes=True,
             dedup_pages=True, radix_admission=True)


def _shared_prefix(pkg, vocab):
    return pkg.shared_prefix_trace(4, prefix_len=24, suffix_len=8,
                                   output_len=4, reuse_p=1.0, seed=3,
                                   vocab=vocab)


@pytest.mark.parametrize("case", ["radix_affinity", "radix_affinity_tree"])
def test_engine_radix_match_reference(weights, case):
    knobs = dict(RADIX) if case == "radix_affinity" else dict(
        RADIX, topology="tree:2x2", replica_reads=True,
        warmup_pressure_seed=True)
    je, jreqs, jout, te, treqs, tout = run_pair(weights, _shared_prefix,
                                                knobs)
    assert_engines_equal(je, jreqs, jout, te, treqs, tout)
    assert tout["n_done"] == len(treqs)
    assert te.stats.radix_hit_tokens > 0
    assert te.stats.dedup_shared_pages > 0
