"""End-to-end serving driver (``repro/launch/serve.py``): the port's
engine on one CUDA card (the default) or, with ``--device cpu``, on the
CPU with the plain PyTorch versions of the kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --requests 8 --ctx 48 --out-len 8 --backend cxl \
        --device cpu

The flags, their defaults and the printed JSON keys are the
reference's, plus ``--device``.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Parse ``argv`` (default: the command line), serve the trace and
    print the summary as JSON.  Returns ``(engine, requests, summary)``
    for callers that drive the CLI in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=48)
    ap.add_argument("--out-len", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-ctx", type=int, default=96)
    ap.add_argument("--backend", default="cxl",
                    choices=["cxl", "rdma", "dram", "hbm"])
    ap.add_argument("--mode", default="sac", choices=["sac", "dense"])
    ap.add_argument("--no-buffer", action="store_true",
                    help="disable the HiSparse hot buffer (cold-read "
                         "fabric charging)")
    ap.add_argument("--device-buffer", type=int, default=None,
                    help="hot-buffer entries per layer per slot "
                         "(default: cfg.sac.device_buffer_size)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="pool page tokens (default cfg.sac.page_size); "
                         "radix reuse credit is floored to whole pages")
    ap.add_argument("--prefetch-width", type=int, default=None,
                    help="speculative entries/layer/step beyond top-k "
                         "(default cfg.sac.prefetch_width)")
    ap.add_argument("--warmup-entries", type=int, default=None,
                    help="prefill warm-up seeds per layer per request "
                         "(default cfg.sac.warmup_entries)")
    ap.add_argument("--warmup-radix", type=int, default=None,
                    help="trailing radix-prefix tokens seeded per layer "
                         "at prefill (default cfg.sac.warmup_radix)")
    ap.add_argument("--link-budget-frac", type=float, default=None,
                    help="fraction of the pipeline hide window the "
                         "arbiter lets speculation fill per device "
                         "(default cfg.sac.link_budget_frac)")
    ap.add_argument("--min-prefetch-width", type=int, default=None,
                    help="granted-width floor under saturation "
                         "(default cfg.sac.min_prefetch_width)")
    ap.add_argument("--score-margin", type=float, default=None,
                    help="score-threshold speculation margin; < 0 = "
                         "pure rank window (default cfg.sac.score_margin)")
    ap.add_argument("--radix-headroom-frac", type=float, default=None,
                    help="pool free-page fraction below which request "
                         "finish evicts LRU cached prefixes (default "
                         "cfg.sac.radix_headroom_frac)")
    ap.add_argument("--replicate-horizon-steps", type=int, default=None,
                    help="decode steps over which a prefix replica's "
                         "pressure relief must amortize its copy cost "
                         "(default cfg.sac.replicate_horizon_steps)")
    ap.add_argument("--prefetch", action="store_true",
                    help="enable the fetch pipeline (speculative "
                         "prefetch + prefill warm-up + overlap queues; "
                         "serving/prefetch.py)")
    ap.add_argument("--arbiter", action="store_true",
                    help="enable cross-request prefetch budget "
                         "arbitration (serving/arbiter.py); implies "
                         "--prefetch — the arbiter governs speculation")
    ap.add_argument("--layer-sizing", default=None,
                    choices=["uniform", "windowed"],
                    help="hot-tier slot apportioning across layers "
                         "(LayerSizer; default cfg.sac.layer_sizing)")
    ap.add_argument("--placement", default=None,
                    choices=["round_robin", "first_fit", "least_loaded",
                             "pressure_aware", "radix_affinity"],
                    help="pool placement policy (core/placement.py); "
                         "pressure_aware lands new requests on the "
                         "least-pressured fabric link, radix_affinity "
                         "additionally weighs prefix locality (a cached "
                         "prompt prefix's device) against that pressure")
    ap.add_argument("--no-radix", action="store_true",
                    help="disable the radix prefix cache entirely "
                         "(serving/radix.py; the A/B baseline for "
                         "prefix-locality wins)")
    ap.add_argument("--replicate-prefixes", action="store_true",
                    help="hot-prefix replication: copy a matched "
                         "prefix's pages to the least-pressured pool "
                         "device when corrected pressure on the owning "
                         "link covers the one-time copy cost, so "
                         "placement can split a hot prefix's load "
                         "across links (requires the radix cache)")
    ap.add_argument("--dedup-pages", action="store_true",
                    help="refcounted page dedup: a same-device "
                         "prefix match shares the cached pages with the "
                         "new slot instead of booking private copies "
                         "(decode never mutates prefix pages)")
    ap.add_argument("--radix-admission", action="store_true",
                    help="radix-aware admission: admit the "
                         "waiting request with the longest cached-"
                         "prefix match first (FCFS tie-break) instead "
                         "of strict FCFS")
    ap.add_argument("--admission", default=None,
                    choices=["fcfs", "radix", "edf"],
                    help="admission policy (serving/policy/"
                         "admission.py): fcfs = submission order, "
                         "radix = longest cached-prefix match first, "
                         "edf = earliest TTFT deadline (arrival_s + "
                         "--slo-ttft) first with optional load "
                         "shedding; default = radix when "
                         "--radix-admission is set, else fcfs")
    ap.add_argument("--shed-queue-depth", type=int, default=None,
                    help="EDF load shedding: drop the arrived "
                         "backlog beyond this many earliest-deadline "
                         "waiting requests — shed requests never "
                         "decode (default cfg.sac.shed_queue_depth; "
                         "0 = off)")
    ap.add_argument("--topology", default=None,
                    help="CXL fabric topology spec (core/"
                         "fabric.py): e.g. 'tree:4x2' (4 devices "
                         "behind 2 switches), 'multi_switch:8x2', "
                         "'mesh:4x2'; default = flat star (one host "
                         "port per device — flat per-device accounting). "
                         "Traffic is charged per link SEGMENT and "
                         "placement/grants read bottleneck-segment "
                         "pressure along each path")
    ap.add_argument("--warmup-pressure-seed", action="store_true",
                    help="seed the placement pressure feed from BOOKED "
                         "prefill-write demand before the first decode "
                         "step (wave-1 admissions stop herding "
                         "onto a hot prefix's owner)")
    ap.add_argument("--replica-reads", action="store_true",
                    help="replica-aware reads: re-pick the "
                         "least-pressured copy of a cached prefix "
                         "every step instead of freezing the choice "
                         "at placement (requires the radix cache)")
    ap.add_argument("--resize-epsilon", type=float, default=None,
                    help="resize hysteresis: skip the online LayerSizer "
                         "re-apportioning when no layer's per-interval "
                         "miss rate moved more than this (default "
                         "cfg.sac.resize_epsilon)")
    ap.add_argument("--precision-weighted", action="store_true",
                    help="split each device's arbiter grant budget by "
                         "measured per-request prefetch precision "
                         "(implies --arbiter)")
    ap.add_argument("--resize-interval", type=int, default=0,
                    help="decode steps between online LayerSizer "
                         "re-apportionings of the hot tier from "
                         "measured per-layer miss rates (0 = off)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared-prefix workload: requests share their "
                         "first N prompt tokens with probability "
                         "--reuse-p (the radix prefix cache's regime; "
                         "0 = independent ShareGPT-style prompts)")
    ap.add_argument("--reuse-p", type=float, default=0.7,
                    help="prefix-group reuse probability for "
                         "--shared-prefix traces")
    # --- continuous batching + disaggregated prefill ---
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (req/s); 0 = "
                         "closed-loop, every request arrives at t=0. "
                         "Admission into freed slots is gated on the "
                         "virtual clock vs each request's arrival_s")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: splice each prompt in "
                         "over ceil(ctx/chunk) bounded chunks "
                         "interleaved with decode steps instead of "
                         "stalling the batch on the whole prompt "
                         "(0 = monolithic; decoded tokens are "
                         "bit-identical either way)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill: prefill runs on "
                         "separate lanes sharing the virtual clock, "
                         "writes KV to the pool device over the fabric, "
                         "and the decode loop adopts the slot via a "
                         "handoff record")
    ap.add_argument("--prefill-lanes", type=int, default=None,
                    help="concurrent prefill lanes of the disaggregated "
                         "prefill engine (default "
                         "cfg.sac.prefill_lanes)")
    ap.add_argument("--diurnal", action="store_true",
                    help="use the diurnal_trace workload generator "
                         "(diurnal arrival rates around --arrival-rate, "
                         "bursts, heavy-tailed contexts, multi-tenant "
                         "prefix groups; requires --shared-prefix and "
                         "a finite --arrival-rate)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="diurnal_trace tenant count (prefix reuse "
                         "never crosses tenants)")
    ap.add_argument("--burst-p", type=float, default=0.0,
                    help="diurnal_trace per-arrival burst probability")
    ap.add_argument("--ctx-tail-alpha", type=float, default=0.0,
                    help="diurnal_trace Pareto tail index for "
                         "heavy-tailed context lengths (0 = off)")
    ap.add_argument("--slo-ttft", type=float, default=0.0,
                    help="arrival-anchored TTFT SLO target in seconds "
                         "(reported as slo_ttft_attainment; 0 = off)")
    ap.add_argument("--slo-tbt", type=float, default=0.0,
                    help="per-request mean TBT SLO target in seconds "
                         "(reported as slo_tbt_attainment; 0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the serve state "
                         "(cuda: the port's kernels; cpu: their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import (diurnal_trace,
                                             shared_prefix_trace,
                                             sharegpt_trace)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.precision_weighted and not args.arbiter:
        print("--precision-weighted implies --arbiter: enabling the "
              "budget arbiter")
        args.arbiter = True
    if args.arbiter and not args.prefetch:
        # the arbiter governs speculative prefetch; without the pipeline
        # it would be a silent no-op
        print("--arbiter implies --prefetch: enabling the fetch pipeline")
        args.prefetch = True
    overrides = {}
    # sparse SACConfig overrides: None = keep the config default (the
    # flag<->field map is enforced by sacheck's twin-coverage pass)
    for field in ("page_size", "prefetch_width", "warmup_entries",
                  "warmup_radix", "link_budget_frac",
                  "min_prefetch_width", "score_margin",
                  "radix_headroom_frac", "replicate_horizon_steps",
                  "resize_epsilon", "admission", "shed_queue_depth"):
        val = getattr(args, field)
        if val is not None:
            overrides[field] = val
    if args.slo_ttft > 0:
        # the EDF admission deadline and the summarize() attainment
        # target are the same knob — one SLO, consumed once through
        # the shared admission policy
        overrides["slo_ttft_s"] = args.slo_ttft
    if args.precision_weighted or args.resize_interval:
        overrides.update(precision_weighted=args.precision_weighted,
                         resize_interval=args.resize_interval)
    if overrides:
        cfg = dataclasses.replace(
            cfg, sac=dataclasses.replace(cfg.sac, **overrides))
    if cfg.enc_dec:
        raise SystemExit("serve driver targets decoder-only archs; "
                         "whisper decode is exercised in tests")
    if ((args.replicate_prefixes or args.dedup_pages
         or args.radix_admission or args.replica_reads)
            and args.no_radix):
        raise SystemExit("--replicate-prefixes/--dedup-pages/"
                         "--radix-admission/--replica-reads need the "
                         "radix cache (drop --no-radix)")
    eng = Engine(cfg, slots=args.slots, max_ctx=args.max_ctx,
                 backend=args.backend, mode=args.mode, seed=args.seed,
                 track_buffer=not args.no_buffer,
                 device_buffer=args.device_buffer,
                 prefetch=args.prefetch,
                 arbiter=args.arbiter or None,
                 layer_sizing=args.layer_sizing,
                 placement=args.placement,
                 radix=not args.no_radix,
                 replicate_prefixes=args.replicate_prefixes or None,
                 dedup_pages=args.dedup_pages or None,
                 radix_admission=args.radix_admission or None,
                 topology=args.topology,
                 warmup_pressure_seed=args.warmup_pressure_seed or None,
                 replica_reads=args.replica_reads or None,
                 prefill_chunk_tokens=args.prefill_chunk,
                 disagg=args.disagg or None,
                 prefill_lanes=args.prefill_lanes,
                 device=args.device)
    rate = args.arrival_rate if args.arrival_rate > 0 else float("inf")
    if args.diurnal:
        if not args.shared_prefix or not np.isfinite(rate):
            raise SystemExit("--diurnal needs --shared-prefix and a "
                             "finite --arrival-rate")
        if args.shared_prefix >= args.ctx:
            raise SystemExit("--shared-prefix must be below --ctx")
        reqs = diurnal_trace(
            args.requests, prefix_len=args.shared_prefix,
            suffix_len=args.ctx - args.shared_prefix,
            output_len=args.out_len, base_rate=args.arrival_rate,
            reuse_p=args.reuse_p, n_tenants=args.tenants,
            burst_p=args.burst_p, ctx_tail_alpha=args.ctx_tail_alpha,
            seed=args.seed, vocab=cfg.vocab)
    elif args.shared_prefix:
        if args.shared_prefix >= args.ctx:
            raise SystemExit("--shared-prefix must be below --ctx")
        reqs = shared_prefix_trace(
            args.requests, prefix_len=args.shared_prefix,
            suffix_len=args.ctx - args.shared_prefix,
            output_len=args.out_len, reuse_p=args.reuse_p,
            seed=args.seed, arrival_rate=rate, vocab=cfg.vocab)
    else:
        reqs = sharegpt_trace(args.requests, context_len=args.ctx,
                              output_len=args.out_len, seed=args.seed,
                              ctx_jitter=0.0, arrival_rate=rate,
                              vocab=cfg.vocab)
    out = eng.run(reqs, slo_ttft_s=args.slo_ttft, slo_tbt_s=args.slo_tbt)
    out["buffer_hit_rate"] = eng.stats.hit_rate
    print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                      for k, v in out.items()}, indent=1))
    return eng, reqs, out


if __name__ == "__main__":
    main()
