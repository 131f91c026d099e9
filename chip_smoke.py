#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and check)

Phases, each printing one JSON line; any failure raises (exit code != 0):

1. the card: name, count, and ``nvidia-smi`` name and power limit;
2. the build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a
   (one process per source, in parallel) into one library;
3. each kernel against its plain PyTorch version on the card, at the
   serving shapes (B=4 requests, pool S=4160, top-k 2048 / 2049 lanes
   with invalid lanes), with CUDA-event times of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (``library_ms``; the port never calls it);
4. a small-input check: the port on the card against the port's plain
   path on the CPU with the same weights (reduced DeepSeek-V3.2 with a
   dense MLP and a 32-dim indexer), logits and pool within tolerance and
   the hot-tier integer state exact under an injected top-k;
5. serving: the port's ``Engine`` on DeepSeek-V3.2 at full width with 2
   layers (d=7168, 128 heads, latent 512+64, indexer 64x128, top-k 2048,
   hot tier 6144, 256 experts top-8; random bf16 weights from a seed),
   4 slots, 8 requests of 4096-token context and 8 output tokens; every
   kernel's launch count during the run must cover the decode steps;
6. a profile of three more pure decode steps at full width: the device's
   busy share and the kernels that take its time.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/repro_torch`` beside this file, the
script exits with an error and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# bandwidth and peak of one H100 SXM (NVIDIA data sheet): the bound of a
# kernel is max(bytes / HBM rate, operations / bf16 tensor-core peak)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# stated tolerances against the plain PyTorch versions on the card:
# row movers copy bits; the indexer and attention sum in f32 in another
# order (and the attention uses the hardware exp), so they agree to
# about 1e-6 relative, checked at 1e-4
TOL_F32 = dict(rtol=1e-4, atol=1e-4)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: a pair of CUDA events around each of
    ``iters`` calls, all queued behind a ~50 ms busy-wait kernel so that
    the host has enqueued them before the first starts (a call that
    synchronizes the host, as a boolean-mask index does, still includes
    host time).  The inputs stay warm in the 50 MB L2 between calls, as
    the profile phase finds them on the serving path."""
    import torch
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # ~50 ms of GPU cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / BF16_FLOP_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(torch, ops, ref, mods):
    """Returns {name: record}; launches are filled in by the serve phase."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, d, k, di, H_idx = 4, 4160, 576, 2048, 128, 64
    H, dc = 128, 512
    recs = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- gather: kv [B, S, 576] bf16, idx [B, 2048]
    kv = randn(B, S, d)
    idx = torch.randint(0, S, (B, k), generator=g, device=dev,
                        dtype=torch.int32)
    out = mods["gather_kv"].gather_kv(kv, idx)

    def plain_gather():
        return torch.stack([ref.gather_kv_ref(kv[b], idx[b])
                            for b in range(B)])
    want = plain_gather()
    if not torch.equal(out, want):
        raise AssertionError("gather_kv differs from its plain version")
    idx_l = idx.long()[..., None].expand(-1, -1, d)
    nb = B * k * 4 + 2 * B * k * d * 2
    recs["gather_kv"] = dict(
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: mods["gather_kv"].gather_kv(kv, idx)),
        plain_ms=cuda_time_ms(plain_gather),
        library_ms=cuda_time_ms(lambda: torch.gather(kv, 1, idx_l)),
        bound=bound_ms(nb, 0.0))

    # -- indexer: q [B, 64, 128] f32, w [B, 64] f32, keys [B, S, 128] bf16
    q = randn(B, H_idx, di).float()
    w = randn(B, H_idx).float()
    keys = randn(B, S, di)
    out = mods["indexer"].indexer_scores(q, w, keys)

    def plain_indexer():
        return torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                            for b in range(B)])
    want = plain_indexer()
    torch.testing.assert_close(out, want, **TOL_F32)
    nb = B * S * di * 2 + B * H_idx * (di + 1) * 4 + B * S * 4
    recs["indexer_scores"] = dict(
        max_abs_err=(out - want).abs().max().item(),
        ms=cuda_time_ms(lambda: mods["indexer"].indexer_scores(q, w, keys)),
        plain_ms=cuda_time_ms(plain_indexer),
        library_ms=None,
        bound=bound_ms(nb, 2.0 * B * S * H_idx * di))

    # -- sparse MLA attention: H=128, dq=576, dv=512, k = 2048 + 1 lanes
    kk = k + 1
    q_lat = randn(B, H, dc).float()
    q_pe = randn(B, H, d - dc).float()
    ent = randn(B, kk, d)
    valid = torch.rand((B, kk), generator=g, device=dev) > 0.1
    valid[:, -1] = True                          # the own entry
    scale = 1.0 / math.sqrt(192)
    out = ops.batched_sparse_mla(q_lat, q_pe, ent, valid, dc=dc, scale=scale)

    def plain_attn():
        return torch.stack([ref.sparse_mla_attn_ref(
            q_lat[b], q_pe[b], ent[b], valid[b], dc, scale)
            for b in range(B)])
    want = plain_attn()
    torch.testing.assert_close(out, want, **TOL_F32)
    qcat = torch.cat([q_lat, q_pe], -1).contiguous()
    bias = torch.where(valid, 0.0, ref.NEG_INF).float()
    kf = ent.float()[:, None]                    # [B, 1, k, 576]
    vf = ent[..., :dc].float()[:, None]
    mask = bias[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_valid = int(valid.sum().item())
    nb = n_valid * d * 2 + B * H * d * 4 + B * kk * 4 + B * H * dc * 4
    recs["sparse_attn"] = dict(
        max_abs_err=(out - want).abs().max().item(),
        ms=cuda_time_ms(lambda: mods["sparse_attn"].sparse_attn(
            qcat, ent, bias, scale=scale, dv=dc)),
        plain_ms=cuda_time_ms(plain_attn),
        library_ms=cuda_time_ms(lambda: sdpa(
            qcat[:, None], kf, vf, attn_mask=mask, scale=scale)),
        bound=bound_ms(nb, 2.0 * n_valid * H * (d + dc)))

    # -- scatter: the decode write (L*B = 8 rows of 576 into the flattened
    #    [1, L*B*S, 576] pool) and the prefill splice (L*S rows)
    L = 2
    pool = randn(1, L * B * S, d)
    for n_rows in (L * B, L * S):
        rows = torch.randperm(L * B * S, generator=g, device=dev)[:n_rows]
        rows = rows.to(torch.int32)[None]
        e = randn(1, n_rows, d)
        got = mods["scatter_kv"].scatter_kv(pool.clone(), e, rows)
        want = ref.scatter_kv_ref(pool[0].clone(), e[0], rows[0])
        if not torch.equal(got[0], want):
            raise AssertionError(f"scatter_kv differs from its plain "
                                 f"version ({n_rows} rows)")
        if n_rows == L * B:
            dst = pool.clone()
            rows_l = rows[0].long()
            nb = n_rows * 4 + 2 * n_rows * d * 2
            recs["scatter_kv"] = dict(
                max_abs_err=0.0,
                ms=cuda_time_ms(lambda: mods["scatter_kv"].scatter_kv(
                    dst, e, rows)),
                plain_ms=cuda_time_ms(lambda: ref.scatter_kv_ref(
                    dst[0], e[0], rows[0])),
                library_ms=cuda_time_ms(lambda: dst[0].index_copy_(
                    0, rows_l, e[0])),
                bound=bound_ms(nb, 0.0))
    return recs


# ---------------------------------------------------------------------------
# phase 4: small input, card vs the plain path on the CPU
# ---------------------------------------------------------------------------


def small_check(torch, devices=("cpu", "cuda")):
    """Reduced DeepSeek-V3.2 (MLA, dense MLP so that no MoE gate sits on
    a rounding tie, indexer widened to 32 dims for the kernel) on the
    card against the same weights on the CPU: per-request relative L2
    error of the logits and the pool within 5e-2 (bf16 activations round
    at other places in cuBLAS and on the CPU; about 1e-2 is typical),
    and the hot-tier integer state exact under an injected top-k."""
    from repro_torch.configs import get_config
    from repro_torch.core.pool import pool_write_prefill
    from repro_torch.models.model import build_model

    base = get_config("deepseek-v32").reduced()
    cfg = dataclasses.replace(base, n_experts=0, topk_experts=0,
                              sac=dataclasses.replace(base.sac, d_idx=32))
    K = 16

    def topk(scores, cache_len):      # score-independent, with invalid lanes
        j = torch.arange(K, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        pos = (j * 7 + 3 * t) % torch.clamp(t, min=1)
        return pos.to(torch.int32), (j < t) & (j % 5 != 3)

    runs = []
    params = None
    for dev in devices:
        m = build_model(cfg, topk_fn=topk, device=dev)
        if params is None:
            params = m.init(torch.Generator(device=dev).manual_seed(1))
        p = _to(params, dev)
        prompt = torch.arange(3, 43, dtype=torch.int32,
                              device=dev)[None] % cfg.vocab
        st, first = m.prefill(p, prompt)
        state = m.init_serve_state(2, 64, device_buffer=8)
        for key in ("kv_pool", "idx_pool"):
            pool_write_prefill(state[key], st[key], lane=1)
        state["cache_len"][1] = 40
        logits = [first]
        tok = torch.tensor([5, 7], dtype=torch.int32, device=dev)
        for _ in range(4):
            state, lg = m.decode(p, state, tok)
            logits.append(lg)
        runs.append(dict(logits=[x.float().cpu() for x in logits],
                         hot=[t.cpu() for t in state["hot_buf"][1:]],
                         pool=state["kv_pool"].float().cpu()))
    ref_run, dev_run = runs
    worst = 0.0
    pairs = [(a[i], b[i]) for a, b in zip(ref_run["logits"],
                                          dev_run["logits"])
             for i in range(a.shape[0])]
    pairs += [(ref_run["pool"][:, i], dev_run["pool"][:, i])
              for i in range(2)]
    for want, got in pairs:
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite values on the card")
        err = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        worst = max(worst, err)
    if worst > 5e-2:
        raise AssertionError(f"card vs CPU relative L2 error {worst:.4f}")
    for a, b in zip(ref_run["hot"], dev_run["hot"]):
        if not torch.equal(a, b):
            raise AssertionError("hot-tier state differs card vs CPU")
    return worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 5: serving at full width
# ---------------------------------------------------------------------------


def serve(torch, ops, cfg=None, device="cuda"):
    """Serve the trace through the port's Engine; returns the kernels'
    launch counts during the run and a summary.  (``cfg``/``device``
    let the same phase run reduced on the CPU as a rehearsal.)"""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import sharegpt_trace

    if cfg is None:
        cfg = dataclasses.replace(get_config("deepseek-v32"), n_layers=2)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=4, max_ctx=4160, device=device, seed=0)
    sync()
    init_s = time.perf_counter() - t0
    reqs = sharegpt_trace(8, context_len=4096, output_len=8, ctx_jitter=0.0,
                          seed=0, vocab=cfg.vocab)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step_s = []
    ops.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    done = []
    t_run = time.perf_counter()
    while len(done) < len(reqs) and eng.stats.steps < 100:
        s0 = eng.stats.steps
        t1 = time.perf_counter()
        done += eng.step()
        sync()
        if eng.stats.steps > s0:
            step_s.append(time.perf_counter() - t1)
    run_s = time.perf_counter() - t_run
    counts = ops.launch_counts()
    steps = eng.stats.steps
    if len(done) != 8 or eng.stats.tokens != 64:
        raise AssertionError(f"served {len(done)} requests, "
                             f"{eng.stats.tokens} tokens (want 8, 64)")
    for r in done:
        if len(r.out_tokens) != 8 or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens")
    # wall time of the decode steps alone (steps that also ran a prefill
    # are the slowest; the median is a pure decode step)
    step_sorted = sorted(step_s)
    summary = dict(
        phase="serve", config=(f"{cfg.name} (n_layers={cfg.n_layers}, "
                               f"d_model={cfg.d_model})"),
        requests=len(done), tokens=eng.stats.tokens, steps=steps,
        buffer_hit_rate=eng.stats.hit_rate,
        buffer_hits=eng.stats.buffer_hits,
        buffer_misses=eng.stats.buffer_misses,
        wall_s_per_decode_step_median=step_sorted[len(step_sorted) // 2],
        wall_s_per_step_max=step_sorted[-1],
        run_wall_s=run_s, engine_init_s=init_s,
        max_memory_allocated_bytes=(torch.cuda.max_memory_allocated()
                                    if device == "cuda" else None),
        launches=counts)
    return eng, counts, summary


# ---------------------------------------------------------------------------
# phase 6: where the device time of a decode step goes
# ---------------------------------------------------------------------------


def profile_decode(torch, eng, n_steps: int = 3, top: int = 8):
    """Device busy share and the kernels that take the device time of
    pure decode steps at full width.  Four more requests (new ids, the
    serving phase's lengths) are admitted and prefilled outside the
    trace; their next ``n_steps`` decode steps run under torch.profiler
    (CUPTI), whose host overhead lowers the busy share a little."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.request import sharegpt_trace

    reqs = sharegpt_trace(4, context_len=4096, output_len=n_steps + 1,
                          ctx_jitter=0.0, seed=1, vocab=eng.cfg.vocab)
    for i, r in enumerate(reqs):
        r.request_id = 1000 + i
        eng.submit(r)
    eng.step()                                   # admission, prefill, token 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = []
        for _ in range(n_steps):
            done += eng.step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if len(done) != len(reqs):
        raise AssertionError(f"profiled steps finished {len(done)} of "
                             f"{len(reqs)} requests")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end_us, by_name = 0.0, -math.inf, {}
    for a, b, name in spans:                     # union of the intervals
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (b - a) * 1e-6, n + 1)
    ours = {}
    for key in ("gather_rows", "indexer_kernel", "sparse_attn_kernel",
                "scatter_rows"):
        hits = [v for name, v in by_name.items() if key in name]
        ours[key] = dict(seconds=sum(t for t, _ in hits),
                         calls=sum(n for _, n in hits))
        if not ours[key]["calls"]:
            raise AssertionError(f"no {key} on the device in the profile")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        phase="profile", decode_steps=n_steps, wall_s=wall_s,
        device_busy_s=busy_us * 1e-6,
        device_busy_share=busy_us * 1e-6 / wall_s,
        port_kernels=ours,
        top_kernels=[dict(name=name[:96], seconds=t, calls=n)
                     for name, (t, n) in ranked])


def check_launches(counts, steps: int, layers: int) -> None:
    """Every kernel of the path ran in the serving run: the per-layer
    ones at least once per layer per decode step, the pool write at
    least once per step."""
    for name in ("gather_kv", "indexer_scores", "sparse_attn"):
        if counts[name] < steps * layers:
            raise AssertionError(f"{name}: {counts[name]} launches for "
                                 f"{steps} steps x {layers} layers")
    if counts["scatter_kv"] < steps:
        raise AssertionError(f"scatter_kv: {counts['scatter_kv']} launches "
                             f"for {steps} steps")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc/ptxas resource usage of each kernel")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels import gather_kv, indexer, scatter_kv, \
        sparse_attn

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit(dict(phase="card", name=kind, count=count, nvidia_smi=smi[0],
              torch=torch.__version__, cuda=torch.version.cuda))

    # 2. the build
    t0 = time.perf_counter()
    _lib.build(verbose=args.ptxas)
    _lib.lib()
    emit(dict(phase="build", seconds=time.perf_counter() - t0))

    # 3. kernels against their plain versions
    mods = {"gather_kv": gather_kv, "indexer": indexer,
            "sparse_attn": sparse_attn, "scatter_kv": scatter_kv}
    recs = check_kernels(torch, ops, ref, mods)
    emit(dict(phase="kernels_vs_plain", tolerance_f32=TOL_F32,
              max_abs_err={k: v["max_abs_err"] for k, v in recs.items()}))

    counts = None
    if not args.kernels:
        # 4. small input: card vs CPU plain path
        ops.reset_launch_counts()
        err = small_check(torch)
        small_counts = ops.launch_counts()
        emit(dict(phase="small_check", max_rel_l2_err=err,
                  launches=small_counts))
        if not all(small_counts.values()):
            raise AssertionError("the small check did not run every kernel")
        # 5. serving at full width
        eng, counts, summary = serve(torch, ops)
        emit(summary)
        check_launches(counts, summary["steps"], 2)
        # 6. the device time of a decode step, by kernel
        emit(profile_decode(torch, eng))

    info = {
        "gather_kv": ("src/repro_torch/csrc/gather_kv.cu",
                      "src/repro/kernels/gather_kv.py:29"),
        "indexer_scores": ("src/repro_torch/csrc/indexer.cu",
                           "src/repro/kernels/indexer.py:31"),
        "sparse_attn": ("src/repro_torch/csrc/sparse_attn.cu",
                        "src/repro/kernels/sparse_attn.py:63"),
        "scatter_kv": ("src/repro_torch/csrc/scatter_kv.cu",
                       "src/repro/kernels/scatter_kv.py:25"),
    }
    kernels = []
    for name, (source, replaces) in info.items():
        r = recs[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None if counts is None else counts[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
    emit({"kernels": kernels})
    print(smi[0])
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
