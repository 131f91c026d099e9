"""chip_smoke.py's reading of a profiler trace (``_trace_facts``) and its
in-run profile (``last_wave_ready``), on the CPU.

``_trace_facts`` reads kineto's events directly instead of building the
profiler's Python event list; on a trace of the port's decode steps (the
layer ranges of ``transformer.DECODE_SPANS`` inside) it must give what
that list gives: every host key's calls, inclusive and own host time
as ``key_averages``, and each range's host time and launches as its
subtree.  The serve runs of phases 5-9, 11 and 13 profile their own last
wave: with the phase's slots and requests at reduced size, that wave
must come, every slot full and no prefill in it."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.models.transformer import DECODE_SPANS  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import sharegpt_trace  # noqa: E402


def _subtree(event):
    """Host events below ``event`` in the profiler's tree."""
    stack, out = list(event.cpu_children), []
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def _traced_decode(name: str):
    from torch.profiler import ProfilerActivity, profile
    cfg = chip_smoke.small_config(name)
    eng = Engine(cfg, slots=2, max_ctx=96, device="cpu", seed=0)
    for r in sharegpt_trace(2, context_len=40, output_len=4, ctx_jitter=0.0,
                            seed=0, vocab=cfg.vocab):
        eng.submit(r)
    eng.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
        eng.step()
    return eng, prof


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-7b", "xlstm-125m"])
def test_trace_facts_equal_the_profilers_event_list(name):
    eng, prof = _traced_decode(name)
    facts = chip_smoke._trace_facts(torch, prof, DECODE_SPANS)
    want = {e.key: (e.count, e.cpu_time_total, e.self_cpu_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    assert set(facts["keys"]) == set(want)
    for key, (n, total, own) in want.items():
        got = facts["keys"][key]
        assert got[0] == n, key
        assert got[1] == pytest.approx(total, abs=1e-6), key
        assert got[2] == pytest.approx(own, abs=1e-6), key
    ranges = sorted(
        (e.name, e.cpu_time_total, sum(c.name == "cudaLaunchKernel"
                                       for c in _subtree(e)))
        for e in prof.events() if e.name in DECODE_SPANS)
    got = sorted((n, host, launches)
                 for n, host, _, launches in facts["spans"])
    assert [(n, k) for n, _, k in got] == [(n, k) for n, _, k in ranges]
    assert [h for _, h, _ in got] == pytest.approx(
        [h for _, h, _ in ranges], abs=1e-6)
    # each layer kind opened its range once per such layer a step
    cfg = eng.cfg
    per_step = {"pool_layer": eng.model.n_kv,
                "mamba2_layer": cfg.n_layers if cfg.ssm_state else 0,
                "xlstm_super": sum(seg.n for seg in eng.model.segments
                                   if seg.kind == "xlstm_super")}
    for kind, n in per_step.items():
        assert sum(r[0] == kind for r in ranges) == 2 * n, kind
    assert facts["device"] == []            # no device on this machine


@pytest.mark.parametrize("name", ["deepseek-v32", "zamba2-7b"])
def test_serve_profiles_its_own_last_wave(monkeypatch, name):
    """``serve`` with ``device_kernels`` profiles the run's last two
    decode steps in place: the run keeps its steps and tokens (those of
    the same run without a profile), and the traced steps finish the
    wave with every slot full."""
    from repro_torch.kernels import ops
    seen = []

    def fake_profile(torch, step, *, n_steps, device_kernels, spans, **kw):
        seen.append([r is not None for r in eng_box[0].slot_req])
        for _ in range(n_steps):
            step()
        return dict(wall_s=0.0, decode_steps=n_steps)
    eng_box = []
    plain_init = Engine.__init__

    def init(self, *a, **kw):
        plain_init(self, *a, **kw)
        eng_box.append(self)
    monkeypatch.setattr(Engine, "__init__", init)
    monkeypatch.setattr(chip_smoke, "profile_steps", fake_profile)
    cfg = chip_smoke.small_config(name)
    spec = chip_smoke.SERVES[name]
    sizes = dict(slots=spec["slots"], max_ctx=96, requests=spec["requests"],
                 context=40, output=spec["output"], device="cpu")
    plain = chip_smoke.serve(torch, ops, cfg, **sizes)
    eng_box.clear()
    run = chip_smoke.serve(torch, ops, cfg, device_kernels=(), **sizes)
    prof = run[5]
    assert plain[5] is None
    assert prof["slots"] == spec["slots"] and prof["decode_steps"] == 2
    assert seen == [[True] * spec["slots"]]
    assert run[2]["steps"] == plain[2]["steps"]
    assert run[3] == plain[3]                 # every request's tokens
