"""The drift trace of ``tests/parity.py`` for the port's ``Engine``
(``tests/test_torch_simulator.py``): the same controlled top-k stream,
written in PyTorch and injected through the port engine's ``topk_fn``,
and the same report of the engine's measured numbers beside the port's
simulator twins (``hit_rate``, ``analytic_prefetch``, ``PipelineModel``,
the fabric models).  ``tests/parity.py`` imports JAX, so the few helpers
the port needs are kept here, formula for formula.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.transfer import FABRICS, PipelineModel
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefetch import analytic_prefetch
from repro_torch.serving.request import sharegpt_trace
from repro_torch.serving.simulator import hit_rate

# the shared drift-trace constants of tests/parity.py
K, T, CTX, OUT = 16, 32, 80, 40


def drift_topk(scores, cache_len):
    """Lane j re-points every T steps (staggered): ~K/T changes a step."""
    B = scores.shape[0]
    j = torch.arange(K, dtype=torch.int32, device=scores.device)[None, :]
    t = cache_len[:, None]
    pos = (j * 7 + 131 * torch.div(t + j, T, rounding_mode="floor")) % CTX
    return pos.to(torch.int32), torch.ones((B, K), dtype=torch.bool,
                                           device=scores.device)


def drift_requests(cfg, n=1, ctx=CTX, out=OUT, seed=5):
    return sharegpt_trace(n, context_len=ctx, output_len=out, seed=seed,
                          ctx_jitter=0.0, vocab=cfg.vocab)


def build_engine(buf: int, *, arch: str = "qwen2-1.5b", overlap=True,
                 slots: int = 1, seed: int = 0) -> Engine:
    """A reduced port engine on the CPU wired to the drift top-k."""
    cfg = get_config(arch).reduced()
    return Engine(cfg, slots=slots, max_ctx=160, device_buffer=buf,
                  topk_fn=drift_topk, overlap=overlap, seed=seed,
                  device="cpu")


def run_to_completion(eng: Engine, reqs, *, max_steps: int = 300,
                      on_step=None) -> int:
    """Submit ``reqs`` and step until drained; ``on_step(eng)`` runs
    after every step."""
    for r in reqs:
        eng.submit(r)
    steps = 0
    while any(eng.slot_req) or eng.queue or eng._prefill_inflight():
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng)
        assert steps < max_steps, "drift trace failed to drain"
    return steps


@dataclasses.dataclass
class ParityReport:
    """Engine-measured against simulator-analytic numbers on one trace."""

    buf: int
    steps: int
    measured_hit: float
    modeled_hit: float
    issued_s: float
    analytic_issued_s: float
    measured_exposed_s: float
    predicted_exposed_s: float


def drift_parity(buf: int, *, arch="qwen2-1.5b",
                 warmup_steps: int = 5) -> ParityReport:
    """The drift trace through the port's engine (the hot tier on, no
    speculation) and the port's analytic twins on the same parameters,
    as ``tests/parity.py::drift_parity`` does for the reference."""
    eng = build_engine(buf, arch=arch, overlap=True)
    assert eng.overlap_on
    pipeline = eng.pipeline
    assert isinstance(pipeline, PipelineModel)
    reqs = drift_requests(eng.cfg)
    t_comp = eng.step_compute_s(1)
    marks = {"steps": 0, "predicted": 0.0, "warm": (0, 0),
             "issued0": None, "exposed0": None, "last_issued": 0.0}

    def on_step(e):
        marks["steps"] += 1
        if marks["steps"] == 1:
            # the cold first step (prefill + full-miss burst) starts the
            # replay window
            marks["issued0"] = e.stats.issued_fabric_s
            marks["exposed0"] = e.stats.exposed_fabric_s
        else:
            marks["predicted"] += pipeline.exposed_time(
                e.stats.issued_fabric_s - marks["last_issued"], t_comp)
        if marks["steps"] == warmup_steps:
            marks["warm"] = (e.stats.buffer_hits, e.stats.buffer_misses)
        marks["last_issued"] = e.stats.issued_fabric_s

    steps = run_to_completion(eng, reqs, on_step=on_step)
    h = eng.stats.buffer_hits - marks["warm"][0]
    m = eng.stats.buffer_misses - marks["warm"][1]
    modeled_hit, spec_issued = analytic_prefetch(hit_rate(buf, K, CTX), 0, K)
    per_step_entries = ((1 - modeled_hit) * K + spec_issued) * eng.model.n_kv
    return ParityReport(
        buf=buf, steps=steps, measured_hit=h / max(h + m, 1),
        modeled_hit=modeled_hit,
        issued_s=eng.stats.issued_fabric_s - marks["issued0"],
        analytic_issued_s=steps * FABRICS["cxl"].sparse_fetch_time(
            per_step_entries, eng.sac.entry_bytes),
        measured_exposed_s=eng.stats.exposed_fabric_s - marks["exposed0"],
        predicted_exposed_s=marks["predicted"])


def assert_parity(rep: ParityReport, *, hit_tol: float = 0.08,
                  exposed_rel: float = 1e-6, issued_band=(0.2, 5.0)):
    """``tests/parity.py::assert_parity``'s bounds (speculation off):
    the hit rate within ``hit_tol``, the exposed seconds equal to a
    replay of the ``PipelineModel`` split, the issued seconds within a
    loose factor of the analytic model's."""
    assert abs(rep.measured_hit - rep.modeled_hit) < hit_tol, rep
    assert 0.0 <= rep.measured_exposed_s <= rep.issued_s + 1e-12, rep
    np.testing.assert_allclose(rep.measured_exposed_s,
                               rep.predicted_exposed_s,
                               rtol=exposed_rel, atol=1e-12)
    lo, hi = issued_band
    assert lo * rep.analytic_issued_s < rep.issued_s \
        < hi * rep.analytic_issued_s, rep
