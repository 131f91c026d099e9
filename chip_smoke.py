#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and check)

Phases, each printing one JSON line with its seconds; any failure raises
(exit code != 0):

1. the card: name, count, and ``nvidia-smi`` name and power limit;
2. the build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a
   (one process per source, in parallel) into one library;
3. each kernel against its plain PyTorch version on the card, with
   CUDA-event times of the kernel, the plain version and, where one
   PyTorch call computes the same function, that call (``library_ms``;
   the port never calls it): the MLA path's gather and pool write at
   DeepSeek-V3.2's serving shapes (B=4 requests, pool S=4160, top-k
   2048; the pool write also at one row, the floor of a launch), the
   indexer at DeepSeek-V3.2's and Qwen2-1.5B's serving pools and at a
   long context past the L2 (B=4, S=65536); both attention forms, in
   bf16 and with the fp8 pool's e4m3 entries, at DeepSeek-V3.2's and
   Qwen2-1.5B's serving shapes (2049 lanes, about 10% invalid) and at
   Gemma3-12B's 16 heads over 8 of 240, at B=8 and as served (4 slots: a
   global layer's lanes, and a local layer's, whose window leaves 1024
   of the 2049 valid), and the GQA form in bf16 at the (heads, KV heads,
   head dim) of every other dense/MoE and local:global config of the
   registry (B=8); the page gather (on no path) at Qwen2-1.5B's pool;
   the gather at Gemma3-12B's width in bf16 and e4m3, and the pool
   write at Gemma3-12B's row width in both (the 48-layer pool of 4
   slots: a decode step's 192 rows and a prefill splice), bit-exact;
   then both attention forms
   (each a split-k pass and a combine pass), with bf16 and with e4m3
   entries, at the edges of their split plan, each case launched twice
   for equal bits: k in {1, 5, 65, one chunk - 1 and + 1, 2049, 8257}, a
   chunk of invalid lanes, no valid lane, B = 1, and the GQA form at
   head dims 72 and 512 (refused in e4m3); and the indexer at the edges
   of its plan (S = 1, a chunk
   - 1 and + 1 tile, a ragged tile, B = 1, a bf16-exact q), each case
   launched twice for equal bits; and the gather at the two shapes the
   fetch pipeline gives it on Qwen2-1.5B's path (the speculation tail,
   [8, 8256, 512] with 512 lanes; the prefill warm-up, 1536 rows of each
   of 28 layers addressed with slot offsets in the [28, 8 * 8256, 512]
   view of the pool), bit-exact;
4. small-input checks: the port on the card against the port's plain
   path on the CPU with the same weights (reduced DeepSeek-V3.2, reduced
   Qwen2 with non-zero QKV biases, reduced Mixtral past its sliding
   window in SAC and in dense mode; dense MLPs so that no MoE gate sits
   on a rounding tie, indexer widened to 32 dims for the kernel), logits
   and pool within tolerance and the hot-tier integer state exact under
   an injected top-k; reduced DeepSeek-V3.2 and Qwen2 again with the
   fetch pipeline on (an injected speculation, per-request budgets as
   the arbiter grants them, a warm-up plan gathered as the engine does),
   the hot tier's integer state and ``pf_*`` counters exact; reduced
   Gemma3 (its local window of 32 below the context), and reduced
   Gemma3, Qwen2 and DeepSeek-V3.2 with the fp8 pool;
5. serving DeepSeek-V3.2 through the port's ``Engine`` at full width
   with 2 layers (d=7168, 128 heads, latent 512+64, indexer 64x128,
   top-k 2048, hot tier 6144, 256 experts top-8; random bf16 weights
   from a seed), 4 slots, 8 requests of 4096-token context and 8 output
   tokens; every kernel of the path launched on every layer of every
   decode step; then a profile of three pure decode steps (the device's
   busy share and the kernels that take its time; each kernel of the
   path, both attention passes included, must show on the device);
6. the same for Qwen2-1.5B at full width and full depth (28 layers,
   12 heads over 2 KV heads of 128, QKV bias, top-k 2048, hot tier
   6144): 8 slots, 16 requests of 8192-token context and 16 output
   tokens, then its profile;
7. the fetch pipeline: the same Qwen2-1.5B trace served through the
   port's CLI (``repro_torch.launch.serve.main``) with ``--prefetch
   --arbiter --resize-interval 4`` (the config's prefetch width 512,
   score margin 1.0, warm-up 1024 score + 512 radix seeds): tokens
   equal to phase 6's token for token, entries prefetched (and no more
   useful than prefetched), the gather launched twice per layer per
   decode step (demand and speculation) plus at most once per admitted
   prompt (its warm-up), at least one online resize; the hit rates with
   and without prefetch, the precision, the grants' mean width, the
   median decode-step wall time and, from a profile, the busy share.
   Then the same trace with ``--prefetch`` alone (no arbiter to cut the
   grants): tokens equal to phase 6's again, and the speculation (the
   entries prefetched beyond the warm-up's) filling at least one in
   ten of its lanes;
8. serving Gemma3-12B at full width and depth (48 layers: 8
   super-blocks of 5 local layers with window 1024 and 1 global layer;
   d=3840, 16 heads over 8 KV heads of 240, d_ff 15360, vocab 262144,
   indexer 4x64, top-k 2048, hot tier 6144): 4 slots, ``max_ctx`` 8256,
   8 requests of 8192 tokens and 8 output tokens, every kernel of the
   path on every layer of every decode step, the pool's bytes and the
   peak device memory; then its profile;
9. the same trace with the fp8 pool (``kv_quant="fp8"``): the pool's and
   the hot tier's entries exactly half the bytes, the indexer pool
   unchanged, every kernel on every layer; the first decode step's
   largest logit difference from phase 8 and the share of equal tokens
   (reported); then its profile.  Every serve run of phases 5-9 checks
   that every logit of every decode step is finite;
10. ``python -m repro_torch.launch.serve --arch gemma3-12b`` at the
   CLI's defaults (4 slots, max_ctx 96, 8 requests of 48 tokens) through
   its ``main``: every request served, every kernel on every layer.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/repro_torch`` beside this file, the
script exits with an error and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
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

# the served paths: arch, depth (None: the config's), pool dtype, engine
# and trace sizes, the attention kernel of the path and the device
# kernel names the profile looks for.  Gemma3-12B holds 4 slots: 8 would
# need about 68 GB in bf16 before transients
GQA_DEVICE_KERNELS = ("gather_rows", "indexer_kernel",
                      "sparse_gqa_partial_kernel",
                      "sparse_attn_combine_kernel", "scatter_rows")
SERVES = {
    "deepseek-v32": dict(arch="deepseek-v32", n_layers=2, slots=4,
                         max_ctx=4160, requests=8, context=4096, output=8,
                         attn="sparse_attn",
                         device_kernels=("gather_rows", "indexer_kernel",
                                         "sparse_mla_partial_kernel",
                                         "sparse_attn_combine_kernel",
                                         "scatter_rows")),
    "qwen2-1.5b": dict(arch="qwen2-1.5b", slots=8, max_ctx=8256,
                       requests=16, context=8192, output=16,
                       attn="sparse_attn_gqa",
                       device_kernels=GQA_DEVICE_KERNELS),
    "gemma3-12b": dict(arch="gemma3-12b", slots=4, max_ctx=8256,
                       requests=8, context=8192, output=8,
                       attn="sparse_attn_gqa",
                       device_kernels=GQA_DEVICE_KERNELS),
}
SERVES["gemma3-12b-fp8"] = dict(SERVES["gemma3-12b"], kv_quant="fp8")


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


def check_mla_path_kernels(torch, ops, ref, mods):
    """The DeepSeek-V3.2 path's gather and pool write at its serving
    shapes (the indexer: check_indexer; the attention:
    check_attention).  Returns {name: record}; launches are filled in by
    the serve phases."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, d, k = 4, 4160, 576, 2048
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

    # -- scatter: the decode write (L*B = 8 rows of 576 into the flattened
    #    [1, L*B*S, 576] pool) and the prefill splice (L*S rows)
    L = 2
    pool = randn(1, L * B * S, d)
    for n_rows in (1, L * B, L * S):
        rows = torch.randperm(L * B * S, generator=g, device=dev)[:n_rows]
        rows = rows.to(torch.int32)[None]
        e = randn(1, n_rows, d)
        got = mods["scatter_kv"].scatter_kv(pool.clone(), e, rows)
        want = ref.scatter_kv_ref(pool[0].clone(), e[0], rows[0])
        if not torch.equal(got[0], want):
            raise AssertionError(f"scatter_kv differs from its plain "
                                 f"version ({n_rows} rows)")
        dst = pool.clone() if n_rows < L * S else None
        if n_rows == 1:                # the floor of one launch
            one_row_ms = cuda_time_ms(lambda: mods["scatter_kv"].scatter_kv(
                dst, e, rows))
        elif n_rows == L * B:
            rows_l = rows[0].long()
            nb = n_rows * 4 + 2 * n_rows * d * 2
            recs["scatter_kv"] = dict(
                max_abs_err=0.0,
                ms=cuda_time_ms(lambda: mods["scatter_kv"].scatter_kv(
                    dst, e, rows)),
                ms_one_row=one_row_ms,
                plain_ms=cuda_time_ms(lambda: ref.scatter_kv_ref(
                    dst[0], e[0], rows[0])),
                library_ms=cuda_time_ms(lambda: dst[0].index_copy_(
                    0, rows_l, e[0])),
                bound=bound_ms(nb, 0.0))
    return recs


def check_fetch_gathers(torch, ops, ref):
    """The gather at the two shapes the fetch pipeline adds on Qwen2-1.5B's
    path, through the wrapper the path calls: the speculation tail (a
    layer's pool [8, 8256, 512], 512 lanes a request) and the prefill
    warm-up (every layer's 1536 planned rows of the last of 8 slots,
    addressed in the contiguous [28, 8 * 8256, 512] view of the pool
    with offsets lane * S: 1.9 GB, the widest addressing the kernel is
    given), each bit-exact against the plain gather of the lane's own
    view, timed beside it.  Returns one record per shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    L, slots, S, d = 28, 8, 8256, 512
    recs = []
    kv = torch.randn((slots, S, d), generator=g, device=dev,
                     dtype=torch.bfloat16)
    idx = torch.randint(0, S, (slots, 512), generator=g, device=dev,
                        dtype=torch.int32)
    pool = torch.randn((L, slots, S, d), generator=g, device=dev,
                       dtype=torch.bfloat16)
    lane = slots - 1
    w_idx = torch.randint(0, S, (L, 1536), generator=g, device=dev,
                          dtype=torch.int32)
    flat = pool.view(L, slots * S, d)
    for shape, (src, rows, plain) in {
            "speculation_tail": (kv, idx, lambda: torch.stack(
                [ref.gather_kv_ref(kv[b], idx[b]) for b in range(slots)])),
            "warmup_plan": (flat, w_idx + lane * S, lambda: torch.stack(
                [ref.gather_kv_ref(pool[l, lane], w_idx[l])
                 for l in range(L)]))}.items():
        if not torch.equal(ops.batched_gather(src, rows), plain()):
            raise AssertionError(f"gather_kv differs from its plain version "
                                 f"at the {shape} shape")
        B, k = rows.shape
        rows_l = rows.long()[..., None].expand(-1, -1, d)
        bound, by = bound_ms(B * k * 4 + 2 * B * k * d * 2, 0.0)
        recs.append(dict(
            shape=shape, kv=list(src.shape), idx=[B, k], max_abs_err=0.0,
            ms=cuda_time_ms(lambda: ops.batched_gather(src, rows)),
            plain_ms=cuda_time_ms(plain),
            library_ms=cuda_time_ms(lambda: torch.gather(src, 1, rows_l)),
            bound_ms=bound, bound_by=by))
    del kv, pool, flat
    torch.cuda.empty_cache()
    return recs


# the indexer's timed shapes (B, S, H, di): DeepSeek-V3.2's and
# Qwen2-1.5B's serving pools, and a long context whose 67 MB of keys do
# not fit the 50 MB L2 (so its keys come from HBM on every call)
INDEXER_SHAPES = {"deepseek-v32": (4, 4160, 64, 128),
                  "qwen2-1.5b": (8, 8256, 4, 64),
                  "long-context": (4, 65536, 64, 128)}


def check_indexer(torch, ref, mod):
    """The indexer at each shape of INDEXER_SHAPES against its plain
    version at TOL_F32, with a general f32 q and with a bf16-exact q as
    the serving path gives it (whose lo products the kernel skips), each
    checked and timed (``ms``, ``ms_bf16_q``), the plain version's time
    and the bound (the function's 2*B*S*H*di FLOPs; no PyTorch call
    computes it).  Returns the record of DeepSeek-V3.2's shape, with the
    worst error of every shape and both kinds of q, and every shape's
    record in ``shapes``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    per_shape = []
    for cell, (B, S, H, di) in INDEXER_SHAPES.items():
        q = torch.randn((B, H, di), generator=g, device=dev)
        w = torch.randn((B, H), generator=g, device=dev)
        keys = torch.randn((B, S, di), generator=g, device=dev).bfloat16()
        q16 = q.bfloat16().float()           # the serving path's q
        errs = []
        for qq in (q, q16):
            got = mod.indexer_scores(qq, w, keys)
            want = torch.stack([ref.indexer_scores_ref(qq[b], w[b], keys[b])
                                for b in range(B)])
            torch.testing.assert_close(got, want, **TOL_F32)
            errs.append((got - want).abs().max().item())
            del got, want

        def plain():
            return torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                                for b in range(B)])
        nb = B * S * di * 2 + B * H * (di + 1) * 4 + B * S * 4
        per_shape.append(dict(
            shape=cell, B=B, S=S, H=H, di=di, key_bytes=B * S * di * 2,
            max_abs_err=errs[0], max_abs_err_bf16_q=errs[1],
            ms=cuda_time_ms(lambda: mod.indexer_scores(q, w, keys)),
            ms_bf16_q=cuda_time_ms(lambda: mod.indexer_scores(q16, w, keys)),
            plain_ms=cuda_time_ms(plain), library_ms=None,
            bound=bound_ms(nb, 2.0 * B * S * H * di)))
        del q, q16, w, keys
    rec = dict(per_shape[0])
    rec["max_abs_err"] = max(max(r["max_abs_err"], r["max_abs_err_bf16_q"])
                             for r in per_shape)
    rec["shapes"] = [dict(r, bound_ms=r["bound"][0], bound_by=r["bound"][1])
                     for r in per_shape]
    for r in rec["shapes"]:
        del r["bound"]
    return rec


def gqa_shapes():
    """(heads, KV heads, head dim) of every dense/MoE and local:global
    config of the registry, Qwen2-1.5B's (the served one) first."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import build_segments
    shapes = []
    for name in ["qwen2-1.5b"] + sorted(ARCHS):
        cfg = ARCHS[name]
        if cfg.enc_dec or not cfg.has_attention:
            continue
        kinds = {s.kind for s in build_segments(cfg)}
        shape = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        if kinds <= {"dense", "moe", "lg_super"} and shape not in shapes:
            shapes.append(shape)
    return shapes


# the attention's cases, each in bf16 and with the fp8 pool's e4m3
# entries: (cell, form, B, heads, then (dc, dr) for MLA or (KV heads,
# head dim) for GQA, then the lanes a local layer's window leaves valid,
# or None for about 10 % invalid at random).  DeepSeek-V3.2's and
# Qwen2-1.5B's serving shapes; Gemma3-12B's heads at B = 8 (126 MB of
# bf16 entries, past the L2) and as it is served (4 slots), a global
# layer and a local one, whose window of 1024 leaves its 1023 latest
# positions valid: the position-sorted top-k puts them first, the other
# 1025 lanes but the own entry are invalid
ATTN_CASES = (("deepseek-v32", "mla", 4, 128, 512, 64, None),
              ("qwen2-1.5b", "gqa", 8, 12, 2, 128, None),
              ("gemma3-12b", "gqa", 8, 16, 8, 240, None),
              ("gemma3-12b served, global", "gqa", 4, 16, 8, 240, None),
              ("gemma3-12b served, local", "gqa", 4, 16, 8, 240, 1023))


def attention_case(torch, ref, mod, g, case, dtype, k: int = 2049):
    """One case of ATTN_CASES (k = top-k + the own entry lanes) with
    entries of ``dtype``: held against the plain version at TOL_F32 and
    timed beside it and SDPA on f32 copies (``library_ms``); e4m3 also
    on the same values in bf16 (``ms_bf16``; e4m3 widens to bf16
    exactly).  The bound counts the valid entry rows at the dtype's
    bytes, q and out in f32 and the mask a byte a lane."""
    from repro_torch.core.pool import E4M3, to_kv_dtype
    cell, form, B, H, a, b, local = case
    dev = torch.device("cuda")
    fp8 = dtype == E4M3
    if local is None:
        valid = torch.rand((B, k), generator=g, device=dev) > 0.1
    else:
        valid = (torch.arange(k, device=dev) < local)[None].repeat(B, 1)
    valid[:, -1] = True                          # the own entry
    n_valid = int(valid.sum().item())
    bias = torch.where(valid, 0.0, ref.NEG_INF).float()[:, None, None]
    if form == "mla":
        dc, dr = a, b
        dq, dv, row, scale = dc + dr, dc, dc + dr, 1.0 / math.sqrt(192)
    else:
        n_kv, hd = a, b
        dq, dv, row, scale = hd, hd, 2 * n_kv * hd, 1.0 / math.sqrt(hd)
    q = torch.randn((B, H, dq), generator=g, device=dev)
    ent = to_kv_dtype(torch.randn((B, k, row), generator=g, device=dev),
                      dtype)
    f = ent.float()
    if form == "mla":
        def kernel(e):
            return mod.sparse_attn(q, e, valid, scale=scale, dv=dc)

        def plain():
            return torch.stack([ref.sparse_mla_attn_ref(
                q[i, :, :dc], q[i, :, dc:], ent[i], valid[i], dc, scale)
                for i in range(B)])
        kf, vf = f[:, None], f[..., :dc][:, None]

        def library():                  # the H heads as one query sequence
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, None], kf, vf, attn_mask=bias, scale=scale)[:, 0]
        flops = 2.0 * n_valid * H * (dq + dv)
        splits = mod.mla_plan(B, H, dc, k, fp8=fp8)[0]
        shape = dict(heads=H, dq=dq, dv=dv)
    else:
        def kernel(e):
            return mod.sparse_attn_gqa(q, e, valid, n_kv=n_kv, scale=scale)

        def plain():
            return torch.stack([ref.sparse_gqa_attn_ref(
                q[i], ent[i], valid[i], n_kv) for i in range(B)])
        kv = f.view(B, k, 2, n_kv, hd)
        kf = kv[:, :, 0].transpose(1, 2).contiguous()  # [B, n_kv, k, hd]
        vf = kv[:, :, 1].transpose(1, 2).contiguous()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kf, vf, attn_mask=bias, scale=scale,
                enable_gqa=True)[:, :, 0]
        flops = 4.0 * n_valid * H * hd
        splits = mod.gqa_plan(B, H, n_kv, hd, k, fp8=fp8)[0]
        shape = dict(heads=H, kv_heads=n_kv, head_dim=hd)
    got, want = kernel(ent), plain()
    torch.testing.assert_close(got, want, **TOL_F32)
    bound, by = bound_ms(n_valid * row * ent.element_size()
                         + B * H * (dq + dv) * 4 + B * k, flops)
    rec = dict(cell=cell, form=form, dtype=str(dtype), B=B, k=k,
               valid_lanes=n_valid, **shape, splits=splits,
               max_abs_err=(got - want).abs().max().item(),
               library_max_abs_diff=(library() - want).abs().max().item(),
               ms=cuda_time_ms(lambda: kernel(ent)),
               plain_ms=cuda_time_ms(plain),
               library_ms=cuda_time_ms(library), bound_ms=bound,
               bound_by=by)
    if fp8:
        e16 = ent.bfloat16()
        # reported, not required: the two dtypes may plan other splits
        rec["equal_to_bf16_launch"] = torch.equal(kernel(e16), got)
        rec["ms_bf16"] = cuda_time_ms(lambda: kernel(e16))
    return rec


def check_attention(torch, ref, mod):
    """Both attention forms at the cases of ATTN_CASES in both dtypes,
    and the GQA form in bf16 at the (heads, KV heads, head dim) of every
    dense/MoE and local:global config of the registry (B = 8).  Returns
    {kernel name: record}: the row's times and bound are the first bf16
    case's (DeepSeek-V3.2's MLA, Qwen2-1.5B's GQA), ``max_abs_err`` the
    worst of the form's cases, ``e4m3`` its e4m3 cases; and every case's
    record."""
    from repro_torch.core.pool import E4M3
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(c, dt) for c in ATTN_CASES for dt in (torch.bfloat16, E4M3)]
    cases += [(("registry", "gqa", 8, *shape, None), torch.bfloat16)
              for shape in gqa_shapes()
              if ("gqa", 8, *shape, None) not in [c[1:] for c in ATTN_CASES]]
    out = [attention_case(torch, ref, mod, g, case, dt)
           for case, dt in cases]
    torch.cuda.empty_cache()
    recs = {}
    for name, form in (("sparse_attn", "mla"), ("sparse_attn_gqa", "gqa")):
        mine = [r for r in out if r["form"] == form]
        first = next(r for r in mine if r["dtype"] == str(torch.bfloat16))
        recs[name] = dict(
            first, bound=(first["bound_ms"], first["bound_by"]),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            e4m3=[r for r in mine if r["dtype"] == str(E4M3)])
    return recs, out


def check_attention_edges(torch, ops, ref, mod):
    """Both attention forms at the edges of the split-k design, with bf16
    and with e4m3 entries (the fp8 pool's), against their plain versions
    at TOL_F32, each case launched twice for equal bits: ragged k (1, 5,
    65, one chunk - 1 and + 1 of the served plan, 2049 and dense
    decode's 8257), a chunk whose lanes are all invalid, no valid lane at
    all, and a single request.  GQA at Qwen2-1.5B's heads (B=8), MLA at
    DeepSeek-V3.2's (B=4); then GQA at head dims 72 and 512 (in e4m3 both
    are refused: 72 is not a multiple of 16, and at 512 the e4m3 ring and
    its bf16 tile overflow shared memory)."""
    from repro_torch.core.pool import E4M3, to_kv_dtype
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    H_g, n_kv, hd, H_m, dc, dr = 12, 2, 128, 128, 512, 64

    def entries(shape, dtype):
        x = torch.randn(shape, generator=g, device=dev)
        return to_kv_dtype(x, E4M3) if dtype == E4M3 else x.to(dtype)

    def twice(fn, what):
        got = fn()
        if not torch.equal(got, fn()):
            raise AssertionError(f"{what}: two launches differ")
        return got

    out_cases = []
    for dtype in (torch.bfloat16, E4M3):
        fp8 = dtype == E4M3
        plans = {"gqa": lambda B, k: mod.gqa_plan(B, H_g, n_kv, hd, k,
                                                  fp8=fp8),
                 "mla": lambda B, k: mod.mla_plan(B, H_m, dc, k, fp8=fp8)}
        for form, B in (("gqa", 8), ("mla", 4)):
            chunk = plans[form](B, 2049)[1]
            runs = ([(B, k, "random")
                     for k in (1, 5, 65, chunk - 1, chunk + 1, 2049, 8257)]
                    + [(B, 2049, "chunk_invalid"), (B, 2049, "all_invalid"),
                       (1, 2049, "random")])
            for Bc, k, pattern in runs:
                splits, ck = plans[form](Bc, k)
                valid = torch.rand((Bc, k), generator=g, device=dev) > 0.1
                valid[:, -1] = True
                if pattern == "chunk_invalid":
                    valid[:, ck:2 * ck] = False
                elif pattern == "all_invalid":
                    valid[:] = False
                what = f"{form} {dtype} B={Bc} k={k} {pattern}"
                if form == "gqa":
                    q = torch.randn((Bc, H_g, hd), generator=g, device=dev)
                    ent = entries((Bc, k, 2 * n_kv * hd), dtype)
                    got = twice(lambda: ops.batched_sparse_gqa(
                        q, ent, valid, n_kv=n_kv), what)
                    want = torch.stack([ref.sparse_gqa_attn_ref(
                        q[b], ent[b], valid[b], n_kv) for b in range(Bc)])
                else:
                    ql = torch.randn((Bc, H_m, dc), generator=g, device=dev)
                    qp = torch.randn((Bc, H_m, dr), generator=g, device=dev)
                    ent = entries((Bc, k, dc + dr), dtype)
                    scale = 1.0 / math.sqrt(192)
                    got = twice(lambda: ops.batched_sparse_mla(
                        ql, qp, ent, valid, dc=dc, scale=scale), what)
                    want = torch.stack([ref.sparse_mla_attn_ref(
                        ql[b], qp[b], ent[b], valid[b], dc, scale)
                        for b in range(Bc)])
                torch.testing.assert_close(got, want, **TOL_F32)
                out_cases.append(dict(form=form, dtype=str(dtype), B=Bc, k=k,
                                      pattern=pattern, splits=splits,
                                      chunk=ck, equal_bits_twice=True,
                                      max_abs_err=(got - want).abs().max()
                                      .item()))
        # GQA head dims off the served ones: 72 (zero-padded to 80
        # columns) and 512 (a one-stage tile ring: two stages overflow
        # shared memory), both refused in e4m3
        for H, kv, d in ((6, 2, 72), (8, 2, 512)):
            q = torch.randn((2, H, d), generator=g, device=dev)
            ent = entries((2, 2049, 2 * kv * d), dtype)
            valid = torch.rand((2, 2049), generator=g, device=dev) > 0.1
            if fp8:
                try:
                    ops.batched_sparse_gqa(q, ent, valid, n_kv=kv)
                except ValueError:
                    out_cases.append(dict(form="gqa", dtype=str(dtype),
                                          heads=H, kv_heads=kv, head_dim=d,
                                          refused=True))
                    continue
                raise AssertionError(f"e4m3 GQA took head dim {d}")
            got = twice(lambda: ops.batched_sparse_gqa(q, ent, valid,
                                                       n_kv=kv),
                        f"gqa hd={d}")
            want = torch.stack([ref.sparse_gqa_attn_ref(
                q[b], ent[b], valid[b], kv) for b in range(2)])
            torch.testing.assert_close(got, want, **TOL_F32)
            out_cases.append(dict(form="gqa", dtype=str(dtype), heads=H,
                                  kv_heads=kv, head_dim=d, B=2, k=2049,
                                  pattern="random",
                                  splits=mod.gqa_plan(2, H, kv, d, 2049)[0],
                                  max_abs_err=(got - want).abs().max()
                                  .item()))
    return out_cases


def check_gather_gemma3(torch, ops, ref):
    """The gather at Gemma3-12B's pool width (a layer's [4, 8256, 3840]
    pool, 2048 lanes a request) in bf16 and in e4m3, bit-exact against
    the plain gather, each timed.  Returns one record per dtype."""
    from repro_torch.core.pool import E4M3, to_kv_dtype
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    B, S, d, k = 4, 8256, 3840, 2048
    x = torch.randn((B, S, d), generator=g, device=dev)
    idx = torch.randint(0, S, (B, k), generator=g, device=dev,
                        dtype=torch.int32)
    recs = []
    for kv in (x.bfloat16(), to_kv_dtype(x, E4M3)):
        def plain():
            return torch.stack([ref.gather_kv_ref(kv[b], idx[b])
                                for b in range(B)])
        got = ops.batched_gather(kv, idx)
        if not torch.equal(got.view(torch.uint8), plain().view(torch.uint8)):
            raise AssertionError(f"gather_kv differs from its plain version "
                                 f"at Gemma3's width ({kv.dtype})")
        raw = kv.view(torch.uint8)           # torch.gather takes no fp8
        idx_l = idx.long()[..., None].expand(-1, -1, raw.shape[-1])
        bound, by = bound_ms(B * k * 4 + 2 * B * k * d * kv.element_size(),
                             0.0)
        recs.append(dict(
            shape="gemma3-12b", dtype=str(kv.dtype), kv=[B, S, d], idx=[B, k],
            max_abs_err=0.0,
            ms=cuda_time_ms(lambda: ops.batched_gather(kv, idx)),
            plain_ms=cuda_time_ms(plain),
            library_ms=cuda_time_ms(lambda: torch.gather(raw, 1, idx_l)),
            bound_ms=bound, bound_by=by))
    del x
    torch.cuda.empty_cache()
    return recs


def check_scatter_gemma3(torch, ref, mod):
    """The pool write at Gemma3-12B's row width in bf16 and in e4m3: the
    flattened pool of 48 layers x 4 slots x 8256 positions ([1, 1585152,
    3840]: 12.2 GB in bf16) takes a decode step's 192 rows (a layer's and
    a slot's each) and a prefill splice (48 x 8256 rows), each bit for
    bit against the plain version on the same bytes (random bits: the
    kernel moves bytes); the decode write is timed.  Returns one record
    per dtype."""
    from repro_torch.core.pool import E4M3
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    L, slots, S, d = 48, 4, 8256, 3840
    n = L * slots * S
    recs = []
    for dtype in (torch.bfloat16, E4M3):
        width = d * dtype.itemsize

        def rand_rows(rows):
            return torch.randint(0, 256, (1, rows, width), generator=g,
                                 device=dev, dtype=torch.uint8).view(dtype)
        pool = rand_rows(n)
        for n_rows in (L * slots, L * S):
            rows = torch.randperm(n, generator=g, device=dev)[:n_rows]
            rows = rows.to(torch.int32)[None]
            e = rand_rows(n_rows)
            got = mod.scatter_kv(pool.clone(), e, rows)
            want = ref.scatter_kv_ref(pool[0].view(torch.uint8).clone(),
                                      e[0].view(torch.uint8), rows[0])
            if not torch.equal(got[0].view(torch.uint8), want):
                raise AssertionError(f"scatter_kv differs from its plain "
                                     f"version at Gemma3's width ({dtype}, "
                                     f"{n_rows} rows)")
            del want
            if n_rows == L * slots:
                raw, e_raw = got[0].view(torch.uint8), e[0].view(torch.uint8)
                rows_l = rows[0].long()
                bound, by = bound_ms(n_rows * 4 + 2 * n_rows * width, 0.0)
                recs.append(dict(
                    shape="gemma3-12b", dtype=str(dtype), pool=[1, n, d],
                    rows=n_rows, splice_rows=L * S, max_abs_err=0.0,
                    ms=cuda_time_ms(lambda: mod.scatter_kv(got, e, rows)),
                    plain_ms=cuda_time_ms(lambda: ref.scatter_kv_ref(
                        raw, e_raw, rows[0])),
                    library_ms=cuda_time_ms(lambda: raw.index_copy_(
                        0, rows_l, e_raw)),
                    bound_ms=bound, bound_by=by))
                del raw
            del got, e
        del pool
        torch.cuda.empty_cache()
    return recs


def check_gather_pages(torch, ref, mod):
    """The page gather (on no path) at one layer of Qwen2-1.5B's serving
    pool, [8 * 8256, 512] bf16 in pages of 16 rows: 1024 page ids, the
    pages of a top-2048 per request."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    B, S, d, page = 8, 8256, 512, 16
    kv = torch.randn((B * S, d), generator=g, device=dev).bfloat16()
    n = B * 2048 // page
    pidx = torch.randint(0, B * S // page, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    out = mod.gather_kv_pages(kv, pidx, page=page)
    if not torch.equal(out, ref.gather_kv_pages_ref(kv, pidx, page)):
        raise AssertionError("gather_kv_pages differs from its plain "
                             "version")
    view = kv.view(B * S // page, page * d)
    pl = pidx.long()
    nb = n * 4 + 2 * n * page * d * 2
    return dict(
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: mod.gather_kv_pages(kv, pidx, page=page)),
        plain_ms=cuda_time_ms(lambda: ref.gather_kv_pages_ref(kv, pidx,
                                                              page)),
        library_ms=cuda_time_ms(lambda: view.index_select(0, pl)),
        bound=bound_ms(nb, 0.0))


def check_indexer_edges(torch, ref, mod):
    """The indexer at the edges of its plan, each launched twice (the two
    results must be equal bit for bit) and held against its plain version
    at TOL_F32: S = 1; the long context's length - 1 tile, + 1 tile and
    + 1 row (a last chunk one tile short, a last chunk of one tile, a
    ragged tile); B = 1; a bf16-exact q at both served shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows = mod.indexer_slots(64, 128)[1]
    S_long = INDEXER_SHAPES["long-context"][1]
    cases = [(4, 1, 64, 128, False), (8, 1, 4, 64, False),
             (4, S_long - rows, 64, 128, False),
             (4, S_long + rows, 64, 128, False),
             (4, S_long + 1, 64, 128, False), (1, 4160, 64, 128, False),
             (1, 8256, 4, 64, False), (4, 4160, 64, 128, True),
             (8, 8256, 4, 64, True)]
    out_cases = []
    for B, S, H, di, bf16_q in cases:
        q = torch.randn((B, H, di), generator=g, device=dev)
        if bf16_q:
            q = q.bfloat16().float()
        w = torch.randn((B, H), generator=g, device=dev)
        keys = torch.randn((B, S, di), generator=g, device=dev).bfloat16()
        got = mod.indexer_scores(q, w, keys)
        if not torch.equal(got, mod.indexer_scores(q, w, keys)):
            raise AssertionError(f"indexer: two launches differ at B={B}, "
                                 f"S={S}, H={H}, di={di}")
        want = torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                            for b in range(B)])
        torch.testing.assert_close(got, want, **TOL_F32)
        slots, rows_k = mod.indexer_slots(H, di)
        chunks, chunk_tiles = mod.indexer_plan(B, S, rows_k, slots)
        out_cases.append(dict(B=B, S=S, H=H, di=di, bf16_q=bf16_q,
                              chunks=chunks, chunk_tiles=chunk_tiles,
                              max_abs_err=(got - want).abs().max().item()))
        del q, w, keys, got, want
    return out_cases


# ---------------------------------------------------------------------------
# phase 4: small input, card vs the plain path on the CPU
# ---------------------------------------------------------------------------


def small_config(name: str, fp8: bool = False):
    """A reduced config the CUDA kernels take: the indexer widened to 32
    dims (the kernel takes d_idx a multiple of 16) and a dense MLP, so that no
    MoE gate sits on a rounding tie between cuBLAS and the CPU (the MoE
    runs on the card in the DeepSeek-V3.2 serve phase); ``fp8``: the fp8
    pool (``kv_quant="fp8"``)."""
    from repro_torch.configs import get_config
    base = get_config(name).reduced()
    return dataclasses.replace(base, n_experts=0, topk_experts=0,
                               sac=dataclasses.replace(
                                   base.sac, d_idx=32,
                                   kv_quant="fp8" if fp8 else None))


def small_check(torch, cfg, *, mode: str = "sac", prompt_len: int = 40,
                pool_len: int = 64, prefetch: bool = False,
                devices=("cpu", "cuda")):
    """``cfg`` on the card against the same weights on the CPU (QKV
    biases, where the config has them, set non-zero): per-request
    relative L2 error of the logits and the pool within 5e-2 (bf16
    activations round at other places in cuBLAS and on the CPU; about
    1e-2 is typical), and in SAC mode the hot-tier integer state exact
    under an injected top-k.  Lane 1 holds the prompt, lane 0 is empty.

    ``prefetch``: the fetch pipeline on, its selections injected too (a
    score-independent speculation of the config's width, per-request
    budgets that change every step as the arbiter's grants do, and a
    warm-up plan for lane 1 applied by ``Engine._warm_apply``), so that
    the hot tier, its ``pf_*`` counters included, must match exactly."""
    from repro_torch.core.pool import pool_write_prefill
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    K = 16
    W = cfg.sac.prefetch_width

    def topk(scores, cache_len):      # score-independent, with invalid lanes
        j = torch.arange(K, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        pos = (j * 7 + 3 * t) % torch.clamp(t, min=1)
        return pos.to(torch.int32), (j < t) & (j % 5 != 3)

    def spec(scores, cache_len):      # the speculation, also injected
        j = torch.arange(W, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        pos = (t - 1 - (j * j) % 11) % torch.clamp(t, min=1)
        return pos.to(torch.int32), (j % 4 != 1).expand(t.shape[0], W)

    opts = (dict(prefetch_width=W, prefetch_fn=spec,
                 score_margin=cfg.sac.score_margin) if prefetch else None)
    runs = []
    params = None
    for dev in devices:
        m = build_model(cfg, mode=mode, topk_fn=topk, opts=opts, device=dev)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(1)
            params = m.init(gen)
            for layer in params["segments"][0]:
                for name in ("bq", "bk", "bv"):
                    if name in layer["attn"]:
                        b = layer["attn"][name]
                        b.copy_(0.5 * torch.randn(b.shape, generator=gen,
                                                  device=dev))
        p = _to(params, dev)
        prompt = torch.arange(3, 3 + prompt_len, dtype=torch.int32,
                              device=dev)[None] % cfg.vocab
        st, first = m.prefill(p, prompt)
        state = m.init_serve_state(2, pool_len, device_buffer=8)
        for key in ("kv_pool", "idx_pool"):
            pool_write_prefill(state[key], st[key], lane=1)
        state["cache_len"][1] = prompt_len
        if prefetch:
            L = m.n_kv
            j = torch.arange(12, dtype=torch.int32, device=dev)
            idx = ((prompt_len - 1 - 5 * j)[None] + torch.arange(
                L, dtype=torch.int32, device=dev)[:, None]) % prompt_len
            Engine._warm_apply(state["hot_buf"], state["kv_pool"], 1, idx,
                               (j % 6 != 2)[None].expand(L, 12))
        logits = [first]
        tok = torch.tensor([5, 7], dtype=torch.int32, device=dev)
        for step in range(4):
            budget = (torch.tensor([step % 3, W - 2 * step], dtype=torch.int32,
                                   device=dev) if prefetch else None)
            state, lg = m.decode(p, state, tok, pf_budget=budget)
            logits.append(lg)
        runs.append(dict(logits=[x.float().cpu() for x in logits],
                         hot=([t.cpu() for t in state["hot_buf"][1:]]
                              if "hot_buf" in state else []),
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
        raise AssertionError(f"{cfg.name} ({mode}): card vs CPU relative "
                             f"L2 error {worst:.4f}")
    if mode == "sac" and not ref_run["hot"]:
        raise AssertionError("no hot tier in the SAC small check")
    if prefetch and not int(dev_run["hot"][-2].sum()):
        raise AssertionError(f"{cfg.name}: nothing was warm-inserted")
    for a, b in zip(ref_run["hot"], dev_run["hot"]):
        if not torch.equal(a, b):
            raise AssertionError(f"{cfg.name}: hot-tier state differs "
                                 "card vs CPU")
    return worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phases 5-6: serving at full width, and where a decode step's time goes
# ---------------------------------------------------------------------------


def serve(torch, ops, cfg, *, slots: int, max_ctx: int, requests: int,
          context: int, output: int, device="cuda"):
    """Serve the trace through the port's Engine; returns the engine, the
    kernels' launch counts during the run, a summary (with the bytes and
    dtypes of the pool, the hot tier's entries and the indexer pool),
    each request's decoded tokens and the first decode step's logits.
    Every logit of every decode step must be finite.  (``device`` lets
    the same phase run reduced on the CPU as a rehearsal.)"""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import sharegpt_trace

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=slots, max_ctx=max_ctx, device=device, seed=0)
    sync()
    init_s = time.perf_counter() - t0
    first, nonfinite = [], []
    plain_decode = eng._decode

    def decode(*args, **kwargs):           # the engine's model.decode
        state, logits = plain_decode(*args, **kwargs)
        if not first:
            first.append(logits.float().cpu())
        nonfinite.append((~torch.isfinite(logits)).sum())
        return state, logits
    eng._decode = decode
    reqs = sharegpt_trace(requests, context_len=context, output_len=output,
                          ctx_jitter=0.0, seed=0, vocab=cfg.vocab)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step_s = []
    for r in reqs:
        eng.submit(r)
    done = []
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    while len(done) < len(reqs) and eng.stats.steps < 20 * requests:
        s0 = eng.stats.steps
        t1 = time.perf_counter()
        done += eng.step()
        sync()
        if eng.stats.steps > s0:
            step_s.append(time.perf_counter() - t1)
    run_s = time.perf_counter() - t_run
    counts = ops.launch_counts()
    steps = eng.stats.steps
    if len(done) != requests or eng.stats.tokens != requests * output:
        raise AssertionError(f"served {len(done)} requests, "
                             f"{eng.stats.tokens} tokens (want {requests}, "
                             f"{requests * output})")
    for r in done:
        if len(r.out_tokens) != output or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens")
    n_nonfinite = int(sum(n.item() for n in nonfinite))
    if n_nonfinite:
        raise AssertionError(f"{cfg.name}: {n_nonfinite} non-finite logits")
    eng._decode = plain_decode
    tensors = dict(kv_pool=eng.state["kv_pool"],
                   hot_tier_entries=eng.state["hot_buf"].entries,
                   idx_pool=eng.state["idx_pool"])
    # wall time of the decode steps alone (steps that also ran a prefill
    # are the slowest; the median is a pure decode step)
    step_sorted = sorted(step_s)
    summary = dict(
        phase="serve", config=(f"{cfg.name} (n_layers={cfg.n_layers}, "
                               f"d_model={cfg.d_model})"),
        slots=slots, context=context, requests=len(done),
        tokens=eng.stats.tokens, steps=steps,
        buffer_hit_rate=eng.stats.hit_rate,
        buffer_hits=eng.stats.buffer_hits,
        buffer_misses=eng.stats.buffer_misses,
        wall_s_per_decode_step_median=step_sorted[len(step_sorted) // 2],
        wall_s_per_step_max=step_sorted[-1],
        run_wall_s=run_s, engine_init_s=init_s,
        max_memory_allocated_bytes=(torch.cuda.max_memory_allocated()
                                    if device == "cuda" else None),
        pool_bytes={k: t.nbytes for k, t in tensors.items()},
        pool_dtypes={k: str(t.dtype) for k, t in tensors.items()},
        logits_finite=True, launches=counts)
    return (eng, counts, summary, {r.request_id: r.out_tokens for r in done},
            first[0])


def profile_decode(torch, eng, *, requests: int, context: int,
                   device_kernels, n_steps: int = 3, top: int = 8):
    """Device busy share and the kernels that take the device time of
    pure decode steps at full width.  ``requests`` more requests (new
    ids, the serving phase's lengths) are admitted and prefilled outside
    the trace; their next ``n_steps`` decode steps run under
    torch.profiler (CUPTI), whose host overhead lowers the busy share a
    little.  Every name in ``device_kernels`` must show on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.request import sharegpt_trace

    reqs = sharegpt_trace(requests, context_len=context,
                          output_len=n_steps + 1, ctx_jitter=0.0, seed=1,
                          vocab=eng.cfg.vocab)
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
    for key in device_kernels:
        hits = [v for name, v in by_name.items() if key in name]
        ours[key] = dict(seconds=sum(t for t, _ in hits),
                         calls=sum(n for _, n in hits))
        if not ours[key]["calls"]:
            raise AssertionError(f"no {key} on the device in the profile")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # where the host's share goes: operators by their own (self) host time
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(
        phase="profile", config=eng.cfg.name, decode_steps=n_steps,
        slots=requests, wall_s=wall_s, device_busy_s=busy_us * 1e-6,
        device_busy_share=busy_us * 1e-6 / wall_s,
        device_s_total=sum(t for t, _ in by_name.values()),
        port_kernels=ours,
        top_kernels=[dict(name=name[:96], seconds=t, calls=n)
                     for name, (t, n) in ranked],
        top_host_ops=[dict(name=e.key[:96],
                           self_seconds=e.self_cpu_time_total * 1e-6,
                           calls=e.count) for e in host])


def check_launches(counts, steps: int, layers: int, attn: str,
                   gathers: int = 1) -> None:
    """Every kernel of the path ran in the serving run: the per-layer
    ones (indexer, the path's attention; the gather ``gathers`` times, 2
    with speculation) at least once per layer per decode step, the pool
    write (one launch writes the new entry of every layer) at least once
    per step."""
    for name, per_layer in (("gather_kv", gathers), ("indexer_scores", 1),
                            (attn, 1)):
        if counts[name] < per_layer * steps * layers:
            raise AssertionError(f"{name}: {counts[name]} launches for "
                                 f"{steps} steps x {layers} layers")
    if counts["scatter_kv"] < steps:
        raise AssertionError(f"scatter_kv: {counts['scatter_kv']} launches "
                             f"for {steps} steps")


def serve_and_profile(torch, ops, name: str):
    """Phases 5-6 and 8-9 for one entry of SERVES; returns the launch
    counts of its serving run, its summary, its decoded tokens and the
    first decode step's logits."""
    from repro_torch.configs import get_config
    spec = SERVES[name]
    cfg = get_config(spec["arch"])
    if spec.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    if spec.get("kv_quant"):
        cfg = dataclasses.replace(cfg, sac=dataclasses.replace(
            cfg.sac, kv_quant=spec["kv_quant"]))
    t0 = time.perf_counter()
    eng, counts, summary, tokens, first = serve(
        torch, ops, cfg, slots=spec["slots"], max_ctx=spec["max_ctx"],
        requests=spec["requests"], context=spec["context"],
        output=spec["output"])
    summary["seconds"] = time.perf_counter() - t0
    summary["run"] = name
    emit(summary)
    check_launches(counts, summary["steps"], cfg.n_layers, spec["attn"])
    t0 = time.perf_counter()
    prof = profile_decode(torch, eng, requests=spec["slots"],
                          context=spec["context"],
                          device_kernels=spec["device_kernels"])
    prof["seconds"] = time.perf_counter() - t0
    prof["run"] = name
    emit(prof)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary, tokens, first


# phase 7's runs of the port's CLI: the whole fetch pipeline (profiled),
# then speculation alone, whose grants are never cut by the arbiter
FETCH_RUNS = {
    "prefetch_arbiter_resize": ["--prefetch", "--arbiter",
                                "--resize-interval", "4"],
    "prefetch": ["--prefetch"],
}


def serve_cli(torch, ops, argv):
    """Serve through the port's CLI (``repro_torch.launch.serve.main``);
    returns the engine, its requests, the CLI's printed JSON, the
    kernels' launch counts, each step's wall time (as serve() takes it:
    the CLI runs Engine.run, whose steps a wrapper times and
    synchronizes) and the entries the prefill warm-up inserted (so the
    speculation's share of ``prefetched_entries`` is known)."""
    from repro_torch.launch import serve as serve_cli_mod
    from repro_torch.serving.engine import Engine
    step_s, warm = [], [0]
    plain_step, plain_warm = Engine.step, Engine._warm_apply

    def timed_step(self, *args, **kwargs):
        s0 = self.stats.steps
        t1 = time.perf_counter()
        finished = plain_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        if self.stats.steps > s0:
            step_s.append(time.perf_counter() - t1)
        return finished

    def counted_warm(*args):
        hot, n_ins = plain_warm(*args)
        warm[0] += int(n_ins)
        return hot, n_ins

    ops.reset_launch_counts()
    Engine.step, Engine._warm_apply = timed_step, staticmethod(counted_warm)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            eng, reqs, _ = serve_cli_mod.main(argv)
    finally:
        Engine.step, Engine._warm_apply = plain_step, staticmethod(plain_warm)
    counts = ops.launch_counts()
    text = printed.getvalue()
    return (eng, reqs, json.loads(text[text.index("{"):]), counts, step_s,
            warm[0])


def fetch_pipeline(torch, ops, off_summary, off_tokens):
    """Phase 7: Qwen2-1.5B's serve trace through the port's CLI, held
    against the prefetch-off run of phase 6 (its summary and tokens):
    first with the fetch pipeline, the arbiter and online resizing on,
    then a profile of its decode steps; then with speculation alone, at
    the grants' full width.  Returns the launch counts of the served
    runs."""
    spec = SERVES["qwen2-1.5b"]
    base = ["--arch", "qwen2-1.5b", "--requests", str(spec["requests"]),
            "--ctx", str(spec["context"]), "--out-len", str(spec["output"]),
            "--slots", str(spec["slots"]), "--max-ctx", str(spec["max_ctx"]),
            "--device", "cuda"]
    total = None
    for run, flags in FETCH_RUNS.items():
        argv = base + flags
        t0 = time.perf_counter()
        eng, reqs, cli_out, counts, step_s, warm_entries = serve_cli(
            torch, ops, argv)
        run_s = time.perf_counter() - t0
        st = eng.stats
        steps, layers = st.steps, eng.cfg.n_layers
        width = eng.cfg.sac.prefetch_width
        tokens = {r.request_id: r.out_tokens for r in reqs}
        # each decoded token after the prefill's first speculated on
        # every layer: the lanes the speculation could fill
        spec_lanes = (st.tokens - len(reqs)) * layers * width
        spec_entries = st.prefetched_entries - warm_entries
        step_sorted = sorted(step_s)
        emit(dict(
            phase="fetch_pipeline", run=run, argv=argv, config=eng.cfg.name,
            n_layers=layers, steps=steps, tokens_equal_prefetch_off=(
                tokens == off_tokens),
            buffer_hit_rate=st.hit_rate,
            buffer_hit_rate_prefetch_off=off_summary["buffer_hit_rate"],
            prefetched_entries=st.prefetched_entries,
            warmup_entries=warm_entries, speculated_entries=spec_entries,
            speculation_lanes=spec_lanes,
            prefetch_useful=st.prefetch_useful,
            prefetch_wasted=st.prefetch_wasted,
            prefetch_precision=st.prefetch_precision,
            arbiter_width_mean=cli_out.get("arbiter_width_mean"),
            resizes=st.resizes, resize_skips=st.resize_skips,
            buffer_sizes_min_max=(eng.buffer_sizes and [
                min(eng.buffer_sizes), max(eng.buffer_sizes)]),
            buffer_width=eng.buffer_width,
            wall_s_per_decode_step_median=step_sorted[len(step_sorted) // 2],
            wall_s_per_decode_step_median_prefetch_off=off_summary[
                "wall_s_per_decode_step_median"],
            wall_s_per_step_max=step_sorted[-1], run_wall_s=run_s,
            launches=counts, cli=cli_out))
        if tokens != off_tokens:
            raise AssertionError(f"{run}: prefetch on and off decoded "
                                 f"different tokens")
        if not 0 < st.prefetched_entries or \
                st.prefetch_useful > st.prefetched_entries:
            raise AssertionError(f"{run}: prefetched "
                                 f"{st.prefetched_entries}, useful "
                                 f"{st.prefetch_useful}")
        check_launches(counts, steps, layers, "sparse_attn_gqa", gathers=2)
        if counts["gather_kv"] > 2 * steps * layers + len(reqs):
            raise AssertionError(f"{run}: gather_kv: {counts['gather_kv']} "
                                 f"launches, more than 2 per layer per step "
                                 f"and one warm-up per prompt")
        if "--resize-interval" in flags and not st.resizes:
            raise AssertionError(f"{run}: no resize in {steps} steps")
        if "--arbiter" not in flags and 10 * spec_entries < spec_lanes:
            # ungated speculation must do real work: at least one in ten
            # of its lanes inserted an entry
            raise AssertionError(f"{run}: {spec_entries} speculated entries "
                                 f"in {spec_lanes} lanes")
        if run == "prefetch_arbiter_resize":
            t0 = time.perf_counter()
            prof = profile_decode(torch, eng, requests=spec["slots"],
                                  context=spec["context"],
                                  device_kernels=spec["device_kernels"])
            prof["seconds"] = time.perf_counter() - t0
            prof["phase"] = "profile_fetch_pipeline"
            emit(prof)
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
        total = counts if total is None else {
            k: total[k] + n for k, n in counts.items()}
    return total


def cli_defaults(torch, ops):
    """Phase 10: ``python -m repro_torch.launch.serve --arch gemma3-12b`` at
    the CLI's defaults (on the card; 4 slots, max_ctx 96, 8 requests of
    48 tokens, 8 output tokens) through its ``main``: every request
    served, every kernel of the path on every layer of every decode
    step.  Returns the launch counts."""
    argv = ["--arch", "gemma3-12b"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, cli_out, counts, step_s, _ = serve_cli(torch, ops, argv)
    st = eng.stats
    emit(dict(phase="cli", argv=argv, config=eng.cfg.name,
              n_layers=eng.cfg.n_layers, slots=eng.slots,
              requests=len(reqs), tokens=st.tokens, steps=st.steps,
              wall_s_per_decode_step_median=sorted(step_s)[len(step_s) // 2],
              max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
              launches=counts, cli=cli_out,
              seconds=time.perf_counter() - t0))
    if cli_out["n_done"] != len(reqs) or any(
            len(r.out_tokens) != r.output_len for r in reqs):
        raise AssertionError(f"the CLI served {cli_out['n_done']} of "
                             f"{len(reqs)} requests")
    check_launches(counts, st.steps, eng.cfg.n_layers, "sparse_attn_gqa")
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def compare_fp8(bf16, fp8) -> None:
    """Phase 9 against phase 8 (each serve_and_profile's result): the
    pool's and the hot tier's entries e4m3 and exactly half the bytes,
    the indexer pool unchanged; the first decode step's largest logit
    difference and the share of equal decoded tokens are reported, not
    gated (quantisation changes results)."""
    (_, s16, t16, l16), (_, s8, t8, l8) = bf16, fp8
    want = {k: v // (1 if k == "idx_pool" else 2)
            for k, v in s16["pool_bytes"].items()}
    pairs = [(a, b) for r, toks in t8.items() for a, b in zip(toks, t16[r])]
    emit(dict(phase="fp8_vs_bf16", config=s8["config"],
              pool_bytes=s8["pool_bytes"], pool_bytes_bf16=s16["pool_bytes"],
              pool_dtypes=s8["pool_dtypes"],
              first_step_max_abs_logit_diff=(l8 - l16).abs().max().item(),
              first_step_max_abs_logit_bf16=l16.abs().max().item(),
              tokens_equal=sum(a == b for a, b in pairs), tokens=len(pairs)))
    e4m3 = "torch.float8_e4m3fn"
    if s8["pool_bytes"] != want or s8["pool_dtypes"] != dict(
            s16["pool_dtypes"], kv_pool=e4m3, hot_tier_entries=e4m3):
        raise AssertionError(f"fp8 pool bytes {s8['pool_bytes']} "
                             f"({s8['pool_dtypes']}), want {want}")


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
    t0 = time.perf_counter()
    mods = {"gather_kv": gather_kv, "scatter_kv": scatter_kv}
    recs = check_mla_path_kernels(torch, ops, ref, mods)
    recs["gather_kv"]["shapes"] = check_fetch_gathers(torch, ops, ref)
    recs["indexer_scores"] = check_indexer(torch, ref, indexer)
    indexer_edges = check_indexer_edges(torch, ref, indexer)
    attn, attn_cases = check_attention(torch, ref, sparse_attn)
    recs.update(attn)
    recs["gather_kv_pages"] = check_gather_pages(torch, ref, gather_kv)
    recs["gather_kv"]["shapes"] += check_gather_gemma3(torch, ops, ref)
    recs["scatter_kv"]["shapes"] = check_scatter_gemma3(torch, ref,
                                                        scatter_kv)
    edges = check_attention_edges(torch, ops, ref, sparse_attn)
    emit(dict(phase="kernels_vs_plain", tolerance_f32=TOL_F32,
              max_abs_err={k: v["max_abs_err"] for k, v in recs.items()},
              attention_cases=attn_cases, attention_edges=edges,
              indexer_edges=indexer_edges,
              seconds=time.perf_counter() - t0))

    launches = None
    if not args.kernels:
        # 4. small inputs: card vs CPU plain path
        path_kernels = {
            "sac": ("gather_kv", "indexer_scores", "scatter_kv"),
            "dense": ("gather_kv", "scatter_kv")}
        # (reduced Gemma3's local window of 32 lies below the context)
        for name, mode, plen, slen, prefetch, fp8 in (
                ("deepseek-v32", "sac", 40, 64, False, False),
                ("qwen2-1.5b", "sac", 40, 64, False, False),
                ("mixtral-8x22b", "sac", 80, 96, False, False),
                ("mixtral-8x22b", "dense", 80, 96, False, False),
                ("deepseek-v32", "sac", 40, 64, True, False),
                ("qwen2-1.5b", "sac", 40, 64, True, False),
                ("gemma3-12b", "sac", 40, 64, False, False),
                ("gemma3-12b", "sac", 40, 64, False, True),
                ("qwen2-1.5b", "sac", 40, 64, False, True),
                ("deepseek-v32", "sac", 40, 64, False, True)):
            t0 = time.perf_counter()
            cfg = small_config(name, fp8)
            ops.reset_launch_counts()
            err = small_check(torch, cfg, mode=mode, prompt_len=plen,
                              pool_len=slen, prefetch=prefetch)
            small_counts = ops.launch_counts()
            emit(dict(phase="small_check", config=name, mode=mode,
                      prefetch=prefetch, kv_quant=cfg.sac.kv_quant,
                      context=plen, window=cfg.sliding_window,
                      local_window=(cfg.local_window
                                    if cfg.local_global_ratio else None),
                      max_rel_l2_err=err, launches=small_counts,
                      seconds=time.perf_counter() - t0))
            attn = "sparse_attn" if cfg.mla else "sparse_attn_gqa"
            missing = [k for k in path_kernels[mode] + (attn,)
                       if not small_counts[k]]
            if missing:
                raise AssertionError(f"small check {name} ({mode}) did not "
                                     f"run {missing}")
        # 5-6. serving at full width, then a profile of its decode steps
        launches = {k: 0 for k in ops.launch_counts()}
        runs = {}
        for name in ("deepseek-v32", "qwen2-1.5b"):
            runs[name] = serve_and_profile(torch, ops, name)
        # 7. the fetch pipeline against phase 6's run
        _, off_summary, off_tokens, _ = runs["qwen2-1.5b"]
        fetch_counts = fetch_pipeline(torch, ops, off_summary, off_tokens)
        # 8-9. Gemma3-12B at full width and depth, bf16 then fp8 pool
        for name in ("gemma3-12b", "gemma3-12b-fp8"):
            runs[name] = serve_and_profile(torch, ops, name)
        compare_fp8(runs["gemma3-12b"], runs["gemma3-12b-fp8"])
        # 10. the CLI at its defaults
        cli_counts = cli_defaults(torch, ops)
        for counts in ([r[0] for r in runs.values()]
                       + [fetch_counts, cli_counts]):
            for k, n in counts.items():
                launches[k] += n

    info = {
        "gather_kv": ("src/repro_torch/csrc/gather_kv.cu",
                      "src/repro/kernels/gather_kv.py:29"),
        "gather_kv_pages": ("src/repro_torch/csrc/gather_kv.cu",
                            "src/repro/kernels/gather_kv.py:56"),
        "indexer_scores": ("src/repro_torch/csrc/indexer.cu",
                           "src/repro/kernels/indexer.py:31"),
        "sparse_attn": ("src/repro_torch/csrc/sparse_attn.cu",
                        "src/repro/kernels/sparse_attn.py:63"),
        "sparse_attn_gqa": ("src/repro_torch/csrc/sparse_attn.cu",
                            "src/repro/kernels/sparse_attn.py:63"),
        "scatter_kv": ("src/repro_torch/csrc/scatter_kv.cu",
                       "src/repro/kernels/scatter_kv.py:25"),
    }
    kernels = []
    for name, (source, replaces) in info.items():
        r = recs[name]
        on_path = launches is not None and name != "gather_kv_pages"
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name] if on_path else None,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("shapes", "ms_one_row", "e4m3")
               if k in r}))
    emit({"kernels": kernels})
    print(smi[0])
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
