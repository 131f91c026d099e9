"""The port's serving simulator and scheduler (``repro_torch.serving.
{simulator,scheduler}``, verbatim copies of the reference's) held against
the port's ``Engine`` and against the reference, on the CPU.

- ``replay_engine_timeline`` reproduces the port engine's per-request
  ``dispatch_s`` / ``first_token_s`` / ``finish_s`` within 1e-9 s in the
  replay's parity regime (no warm-up, radix seeds or prefetch, no hot
  tier, overlap off, rolling admission), monolithic, chunked and
  disaggregated, and those timestamps equal the reference engine's run
  of the same trace;
- the analytic hit model (``hit_rate``) agrees with the hit rate the
  port's engine measures on the drift trace (``tests/torch_parity.py``)
  within the reference's ``hit_tol``;
- ``simulate`` and ``run_backend_sweep`` of both packages give the same
  summaries, key for key and bit for bit, on the same traces.
"""
import dataclasses

import pytest

from torch_parity import assert_parity, drift_parity

from repro.configs import get_config as jget
from repro.serving import request as jrequest
from repro.serving import simulator as jsim
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.serving import request as trequest
from repro_torch.serving import simulator as tsim
from repro_torch.serving.engine import Engine as TEngine

TIME_TOL = 1e-9


def _parity_cfg(get_config):
    """The replay's regime (``tests/test_serving.py::_parity_cfg``):
    warm-up and prefetch traffic off (radix stays on: random prompts
    never match, so it is inert)."""
    cfg = get_config("qwen2-1.5b").reduced()
    return dataclasses.replace(cfg, sac=dataclasses.replace(
        cfg.sac, warmup_entries=0, warmup_radix=0, prefetch_width=0))


def _rolling_trace(request_mod, cfg):
    return request_mod.sharegpt_trace(8, context_len=64, output_len=10,
                                      seed=7, arrival_rate=2000.0,
                                      ctx_jitter=0.2, vocab=cfg.vocab)


def _timeline(reqs):
    return [(r.request_id, r.dispatch_s, r.first_token_s, r.finish_s)
            for r in sorted(reqs, key=lambda r: r.request_id)]


@pytest.mark.parametrize("chunk,disagg", [(0, False), (16, False),
                                          (0, True)])
def test_rolling_admission_engine_replay_parity(chunk, disagg):
    knobs = dict(slots=2, max_ctx=160, device_buffer=0, seed=0,
                 overlap=False, prefill_chunk_tokens=chunk, disagg=disagg)
    tcfg = _parity_cfg(tget)
    treqs = _rolling_trace(trequest, tcfg)
    eng = TEngine(tcfg, device="cpu", **knobs)
    assert eng.run(treqs)["n_done"] == 8
    rep = tsim.replay_engine_timeline(eng, treqs)
    for (rid, d, f, e), (qid, qd, qf, qe) in zip(_timeline(treqs),
                                                 _timeline(rep)):
        assert rid == qid
        assert abs(d - qd) < TIME_TOL, rid
        assert abs(f - qf) < TIME_TOL, rid
        assert abs(e - qe) < TIME_TOL, rid
    # the reference engine's run of the same trace: the same timeline
    jcfg = _parity_cfg(jget)
    jreqs = _rolling_trace(jrequest, jcfg)
    assert JEngine(jcfg, **knobs).run(jreqs)["n_done"] == 8
    for a, b in zip(_timeline(jreqs), _timeline(treqs)):
        assert a[0] == b[0]
        assert all(abs(x - y) < TIME_TOL for x, y in zip(a[1:], b[1:])), a


@pytest.mark.parametrize("buf", [32, 64])
def test_engine_hit_rate_parity_with_analytic_model(buf):
    """The analytic hit model against the port engine's measured hit rate
    on the drift trace injected through ``topk_fn`` (the read path, the
    hot tier and its counters are the port's own)."""
    rep = drift_parity(buf)
    assert rep.measured_hit > 0.0
    assert_parity(rep)


def _burst(request_mod, n=64):
    """``tests/test_serving.py::_burst_trace``."""
    return request_mod.diurnal_trace(
        n, prefix_len=4096, suffix_len=4096, output_len=64, base_rate=0.5,
        seed=2, n_tenants=2, burst_p=0.15, burst_size=6, ctx_tail_alpha=2.5,
        max_ctx_mult=3.0)


def _sharegpt(request_mod, n=64):
    return request_mod.sharegpt_trace(n, context_len=8192, output_len=64,
                                      seed=3, arrival_rate=2.0)


TRACES = {"diurnal": _burst, "sharegpt": _sharegpt}
# tests/test_serving.py::_sim_cell's settings: concurrency 16, buffer 2048
CELLS = {"colocated": dict(colocated_prefill=True),
         "chunked": dict(colocated_prefill=True, prefill_chunk_tokens=1024),
         "disagg": dict(round1=True)}


def _sim_cfg(sim_mod, cell):
    return sim_mod.SimConfig(concurrency=16, device_buffer=2048,
                             **CELLS[cell])


@pytest.mark.parametrize("trace,cell,sweep", [
    (t, c, False) for t in TRACES for c in CELLS] + [
    (t, "colocated", True) for t in TRACES])
def test_simulate_equals_reference(trace, cell, sweep):
    """The same Python on the same inputs: any difference is a copy that
    drifted.  ``sweep`` runs ``run_backend_sweep`` over
    ``default_backends()`` (cxl, rdma, dram, hbm), else ``simulate`` on
    the cxl backend."""
    got, want = {}, {}
    for sim_mod, req_mod, get_config, out in (
            (tsim, trequest, tget, got), (jsim, jrequest, jget, want)):
        model = sim_mod.profile_from_config(get_config("deepseek-v32"))
        reqs = TRACES[trace](req_mod)
        backends = sim_mod.default_backends()
        if sweep:
            out.update(sim_mod.run_backend_sweep(
                reqs, model, backends, _sim_cfg(sim_mod, cell)))
        else:
            out["cxl"] = sim_mod.simulate(
                [dataclasses.replace(r) for r in reqs], model,
                backends["cxl"], _sim_cfg(sim_mod, cell))
    assert sorted(got) == sorted(want)
    for name in want:
        assert list(got[name]) == list(want[name]), name
        for key, value in want[name].items():
            # bit for bit: repr also tells -0.0 and NaN apart
            assert repr(got[name][key]) == repr(value), (name, key)
        assert got[name]["n_done"] > 0, name
