#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and check)
    python3 chip_smoke.py --sharded  # phases 1-3 and 16 (the sharded pool)
    python3 chip_smoke.py --twin     # phases 1-3 and 17 (the simulator twin)
    python3 chip_smoke.py --dryrun   # phases 1-3 and 18 (the dry-run)
    python3 chip_smoke.py --tp       # phases 1-3 and 19 (tensor parallelism)
    python3 chip_smoke.py --fsdp     # phases 1-3 and 20 (rows over ranks)
    python3 chip_smoke.py --families # phases 1-3 and 21 (TP of the
                                     # recurrent and encoder-decoder
                                     # families; with phase 16 (e)-(f))

Phases, each printing one JSON line with its seconds; any failure raises
(exit code != 0):

1. the card: name, count, and ``nvidia-smi`` name and power limit;
2. the build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a
   (one process per source, in parallel) into one library;
3. each kernel against its plain PyTorch version on the card, with
   CUDA-event times of the kernel, the plain version and, where one
   PyTorch call computes the same function, that call (``library_ms``;
   the port never calls it), each taken per call (an event pair around
   each of 20 calls: ``ms``) and, for the row movers, also batched (one
   pair around 200 back-to-back calls, fewer for a call over 0.5 ms:
   ``ms_batched``; the gathers cycle through copies of their inputs so
   that each call reads from HBM), the calls queued behind a busy-wait
   as long as the host takes to queue them (``_queue_behind``).
   The row movers, bit-exact, each form one launch: the gather at
   DeepSeek-V3.2's and Qwen2-1.5B's decode shapes, the fetch pipeline's
   fused demand set and speculation tail (k=2048 plus w=512), the tail
   alone, the prefill warm-up (1536 rows of each of 28 layers in the
   [28, 8 * 8256, 512] view of the pool), Gemma3-12B's width in bf16
   and e4m3, Zamba2-7B's (rows of 14,336 B) and Whisper-small's (8 x
   2048 rows of 3,072 B from its [8, 32768, 1536] encoder pool); the scatter
   kernel in its index form (DeepSeek-V3.2's width: 1 row, 8 rows, a
   layer's splice rows), its decode form (both pools, every layer, one
   launch, at DeepSeek-V3.2's, Qwen2-1.5B's, Gemma3-12B's and Zamba2-7B's
   shapes, Gemma3's in bf16 and e4m3, and Whisper-small's decoder
   self_kv alone) and its splice form (a Gemma3-12B prompt,
   48 x 8192 rows, into the 4-slot pools with the tail zeroed, bf16 and
   e4m3), each beside the port's earlier code for the same write
   (``ms_was``); the indexer at DeepSeek-V3.2's and Qwen2-1.5B's serving
   pools, at a long context past the L2 (B=4, S=65536) and at
   Whisper-small's encoder pool (B=8, S=32768, 4 x 64); both
   attention forms, in bf16 and with the fp8 pool's e4m3 entries, at
   DeepSeek-V3.2's and Qwen2-1.5B's serving shapes (2049 lanes, about
   10% invalid) and at Gemma3-12B's 16 heads over 8 of 240, at B=8 and
   as served (4 slots: a global layer's lanes, and a local layer's,
   whose window leaves 1024 of the 2049 valid), and at Zamba2-7B's 32
   heads over 32 KV heads of 112 (B=8), and the GQA form in bf16 at the
   (heads, KV heads, head dim) of every other dense/MoE, local:global
   and Mamba2-hybrid config of the registry (B=8), and at Whisper-small's
   12 heads over 12 of 64 over 2048 lanes (its cross-attention, no own
   lane) and 449 (its self-attention); the page gather (on no
   path) at Qwen2-1.5B's pool; then both attention forms (each a split-k
   pass and a combine pass), with bf16 and with e4m3 entries, at the
   edges of their split plan, each case launched twice for equal bits:
   k in {1, 5, 65, one chunk - 1 and + 1, 2049, 8257}, a chunk of
   invalid lanes, no valid lane, B = 1, and the GQA form at head dims 72
   and 512 (refused in e4m3); and the indexer at the edges of its plan
   (S = 1, a chunk - 1 and + 1 tile, a ragged tile, B = 1, a bf16-exact
   q), each case launched twice for equal bits; then the row movers'
   shard forms (a rank's slice of a pool split over ranks: the gather,
   zeros for rows outside the slice; the decode write, only where the
   rank owns the position; the splice of a serve state's whole pools
   into the slice) at every shape phase 16 gives them, each with the
   forms its run launches (Qwen2-1.5B's pool over 2 ranks and on 1, the
   tail's 512 rows; Zamba2-7B's and Whisper-small's cross pools on 1;
   the small configs' of (c) and (g) over 2, each rank) and at a 4-card
   host's (Qwen2-1.5B's pool over 4, DeepSeek-V3.2's over 2),
   bf16 and e4m3, bit-exact, timed beside the plain version, a library
   call and the bound; and both attention forms at the heads a
   tensor-parallel rank attends with (phase 19): the MLA form at 8, 32
   and 64 heads (DeepSeek-V3.2 at model 16, 4, 2), the GQA form at 3 and
   6 heads over one KV head's entries (Qwen2-1.5B at model 4, 2);
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
   Gemma3, Qwen2 and DeepSeek-V3.2 with the fp8 pool; reduced Zamba2 in
   SAC mode (its recurrent state ``rec_*`` too), and reduced xLSTM in
   dense mode with no pool (logits and ``rec_*``; no kernel may launch);
   reduced Whisper in SAC and dense mode (logits, self_kv, dec_len; the
   indexer, gather, GQA and decode-write launches); one training step
   (loss and every gradient leaf) of reduced DeepSeek-V3.2 and Whisper;
   every check held to one fixed limit (``SMALL_TOL``), and each also
   runs a control, the card with its weights rounded through e4m3, that
   must exceed that limit;
5. serving DeepSeek-V3.2 through the port's ``Engine`` at full width
   with 2 layers (d=7168, 128 heads, latent 512+64, indexer 64x128,
   top-k 2048, hot tier 6144, 256 experts top-8; random bf16 weights
   from a seed), 4 slots, 8 requests of 4096-token context and 8 output
   tokens; every kernel of the path launched on every layer of every
   decode step; a profile of the run's last two decode steps, pure
   decode steps with every slot full (the device's busy share and the
   kernels that take its time; each kernel of the path, both attention
   passes included, must show on the device);
6. the same for Qwen2-1.5B at full width and full depth (28 layers,
   12 heads over 2 KV heads of 128, QKV bias, top-k 2048, hot tier
   6144): 8 slots, 16 requests of 8192-token context and 16 output
   tokens, then its profile;
7. the fetch pipeline: the same Qwen2-1.5B trace served through the
   port's CLI (``repro_torch.launch.serve.main``) with ``--prefetch
   --arbiter --resize-interval 4`` (the config's prefetch width 512,
   score margin 1.0, warm-up 1024 score + 512 radix seeds): tokens
   equal to phase 6's token for token, entries prefetched (and no more
   useful than prefetched), the gather launched once per layer per
   decode step (the demand set and the speculation tail in one launch)
   plus at most once per admitted prompt (its warm-up), at least one
   online resize; the hit rates with
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
   (reported); then its profile.  Every serve run (phases 5-9, 11, 13)
   checks that every logit of every decode step is finite;
10. ``python -m repro_torch.launch.serve --arch gemma3-12b`` at the
   CLI's defaults (4 slots, max_ctx 96, 8 requests of 48 tokens) through
   its ``main``: every request served, every kernel on every layer;
11. serving Zamba2-7B at full width and depth (81 Mamba2 layers: 13
   super-blocks of 6 and a tail of 3, the one tied shared-attention
   layer after each super-block's sixth, so 13 pool layers; d=3584, 32
   heads over 32 KV heads of 112, d_ff 14336, vocab 32000, SSM state
   64, indexer 4x64, top-k 2048, hot tier 6144): 8 slots, ``max_ctx``
   8256, 16 requests of 8192 tokens and 8 output tokens, every kernel of
   the path on every pool layer of every decode step, the pool's, the
   hot tier's and the recurrent state's bytes, the peak device memory;
   then its profile, whose ``layer_kinds`` split the traced steps into
   the 81 Mamba2 layers and the 13 pool layers (host time, device time
   and launches of each kind, a step and a call; every profile has
   this split);
12. ``python -m repro_torch.launch.serve --arch zamba2-7b`` at the CLI's
   defaults, as phase 10;
13. serving xLSTM-125M at full width and depth (12 layers, d 768, 4
   heads, vocab 50304; no pool): 4 slots, ``max_ctx`` 2112, 8 requests
   of 2048 tokens and 8 output tokens, every request served, no kernel
   launched, every logit finite; then its profile, and the CLI at its
   defaults for ``--arch xlstm-125m`` (no kernel launched);
14. Whisper-small at full width and depth (12 encoder + 12 decoder
   layers, d 768, vocab 51,865, indexer 4x64, top-k 2048) through the
   model facade: 8 requests of 32,768 random frames, each prefilled
   alone and spliced into its lane, then 64 greedy decode steps, each
   launching the indexer 12 times, the gather 12, the GQA attention 24
   and the decode write once; then its profile;
15. ``python -m repro_torch.launch.train --arch qwen2-1.5b --batch 8
   --seq 512 --steps 20 --ckpt-every 10`` through its ``main`` into a
   temporary directory (the loss finite and falling, no kernel
   launched), then ``--resume`` from the step-10 snapshot alone (the
   restored tree equal to the saved one bit for bit, the step-20 loss
   within 1e-2 of the straight run's);
16. the KV pool sharded over a ``torch.distributed`` mesh
   (``make_pooled_fetch``, ``shard_serve_state``), Qwen2-1.5B at full
   width and depth, 8 requests of 8192 tokens, pool 8256, hot tier
   6144: (a) a world of one NCCL rank, mesh (1, 1), through the real
   collectives, 16 decode steps beside the unsharded model on the same
   weights and state (tokens, logits, hot tier, counters and pools
   equal; every layer of every step through the gather's and the decode
   write's shard forms), the median step, device ms and launches a step
   of each; (b) four processes sharing the card over gloo, mesh (data 2,
   model 2), each prefilling its 4 requests and keeping half the pool
   axis, 4 decode steps, tokens, logits and hot tier equal to the
   unsharded run of the same 4 lanes; (c) small DeepSeek-V3.2 (MLA) and
   Gemma3-12B (windowed) at mesh (1, 2) over gloo, bit-equal to their
   unsharded card runs, which hold SMALL_TOL against the CPU beside the
   e4m3 control.  Then, at the NCCL rank of (a), each beside the
   unsharded model on the same weights and state, bit for bit, with
   its launches, median step, device ms and launches a step (profiled)
   and the collectives' host time: (a) extended, (a)'s 8 lanes with
   the fetch pipeline's speculation (width 512) and the hierarchical
   top-k, whose tail (``with_tail``) must equal the fused selection's
   (tokens, logits, hot tier with ``pf_*``); (d) Qwen2-1.5B in ``dense``
   mode, 8 steps, each layer all-gathered (``PoolShard.gather_pool``);
   (e) Zamba2-7B at full width and depth (81 Mamba2 and 13 pool layers),
   4 requests of 8192 tokens, hot tier 6144, 4 steps (``rec_*`` too);
   (f) Whisper-small at full width and depth, 4 requests of 32,768
   frames, 8 steps in ``sac`` and in ``dense`` mode (``self_kv`` whole,
   the cross-attention pools cut), launches a step as phase 14's.  (g)
   four gloo ranks sharing the card, mesh (data 2, model 2), on small
   configs: dense Qwen2, Zamba2, Whisper (``sac`` and ``dense``), a
   batch of one replicated over ``data`` (``batch_axes=()``) and the
   hierarchical top-k with the speculation tail, each rank bit-equal to
   the unsharded card run of its lanes, which holds SMALL_TOL against
   the CPU beside its e4m3 control.  The kernels are built before any
   rank starts; the ranks of (b), (c) and (g) start once (e) is done and
   each group waits for its turn;
17. the simulator twin: the port's ``Engine`` serves Qwen2-1.5B at full
   width and depth in ``replay_engine_timeline``'s parity regime (no
   warm-up, radix seeds or prefetch, no hot tier, overlap off), 8
   requests of 8192 tokens arriving together behind 4 slots, 8 output
   tokens, monolithic, chunked (2048-token chunks) and disaggregated;
   the replay must give every request's dispatch, first-token and
   finish time within 1e-9 s.  Then ``run_backend_sweep`` over
   ``default_backends()`` on the same trace, whose TTFT, TBT and
   throughput are the simulator's modeled clock (8 x H20), not a
   measurement of the card;
18. the dry-run (``repro_torch.launch.dryrun``): first the host's
   mirror of each kernel's shape rule (what ``meta`` calls check) against
   the card's occupancy answer over a grid of shapes; then (a) the one
   production cell that fits one card, Qwen2-1.5B x long_500k x sac (B
   = 1, S = 524,288), built twice by ``build_cell`` at mesh (1, 1): on
   ``meta`` in a subprocess (a ``fake`` group of one) and on the card
   (one NCCL rank, random bf16 weights from seed 0, ``cache_len`` S -
   1), each counted over one decode step by ``StepCost``: FLOPs,
   bytes, collectives and each kernel's calls equal, the meta build's
   calls equal to the card's real launches (``ops.launch_counts()``,
   the shard forms named; nothing launches on ``meta``), the argument
   bytes equal to the bytes the card's
   allocator was asked for the inputs (its blocks beside), beside them the
   launching operators against the profiler's launches a step, the
   meta peak against ``max_memory_allocated``, device ms a step (2
   profiled steps), the median wall step of 5 after 2 warm-ups and the
   roofline share max(compute_s, memory_s) / device time; (b) the
   dry-run CLI, one subprocess a cell on ``meta`` (several at once):
   DRYRUN_CELLS, each ending ``ok`` or ``skipped`` with the reference's
   reasons (a cell still running at DRYRUN_BUDGET_S fails the phase);
   (c) the port's ``examples/torch/quickstart.py`` and
   ``serve_sac.py`` on the card, both at once, exit 0.  (b) and (a)'s
   meta build run on the host beside phases 4-17 (started after phase
   3; alone, with ``--dryrun``, beside (c)); (a)'s card part runs after
   (c), alone;
19. tensor and expert parallelism of the weights (``distributed/tp.py``
   under ``use_rules(SERVE_RULES, mesh)``, over the sharded pool, with
   the hot tier and a score-independent top-k of 2048): (a) Qwen2-1.5B
   at full width and depth, 4 requests of 1024 tokens, 16 decode steps;
   (b) DeepSeek-V3.2 at full width with 2 layers, 4 requests of 1024
   tokens, 4 steps.  The unsharded run (DeepSeek-V3.2's in a child
   process: its 50 GB of weights leave the card before the ranks start)
   beside the TP path at an NCCL world of one, bit for bit (weights drawn
   by ``init_shards``, logits, tokens, hot tier, expert choices); then
   four processes sharing the card over gloo, (a) at meshes (1, 4) and
   (2, 2), (b) at (2, 2), each rank with its blocks of the weights (drawn
   one rank at a time) and its lanes, fed the unsharded run's tokens:
   every request and step within tests/test_torch_tp.py's relative L2
   and element-fraction limits of the unsharded logits (its largest
   element's ratio reported, beside Qwen2-1.5B's unsharded run with its
   row-parallel products in f32 as a rank makes them; DeepSeek-V3.2's
   but where an expert choice of that token
   differs between the runs at a gate near a tie: listed, at most half),
   the hot tier's integer state exact, and a control (model rank 1's
   ``wo`` zeroed) outside both limits; rank 0's weight bytes,
   peak memory, device ms, launches and collectives a step (two
   profiled steps), with the card's name and power limit; (c) MoE
   dispatch groups over the batch axes (``moe_groups=auto``: 2 groups at
   (2, 2)) on (b)'s ranks: DeepSeek-V3.2's prefill on (b)'s blocks,
   each rank routing its own lanes and trading the dispatch slots by
   all-to-all, and 2 decode steps (one group), fed the unsharded run's
   at 2 groups (made in (b)'s child), held as (b); then one
   ``TRAIN_RULES`` step's gradients of Mixtral-8x22B at full width with
   2 layers (4 x 256) against the unsharded step at 2 groups (made by
   the parent meanwhile) in f32, the loss within 1e-4 and each leaf
   within 1e-2 on the ranks' blocks, a control without the batch-axis
   sums outside; each rank's collectives inside its MoE blocks, peak and
   seconds;
20. the d_model rows split across ranks (``distributed/tp.py`` with the
   rows over ``data``): (a) at an NCCL world of one, three training
   steps of Qwen2-1.5B at full width and depth (8 x 512) under
   ``TRAIN_RULES`` beside the unsharded steps (each step's loss and
   gradient norm, and every parameter's and moment's bits by a
   weighted 64-bit sum, equal), and the long_500k decode (one request
   over 524,288 pool rows drawn from a seed, the hot tier, 4 steps) of
   Qwen2-1.5B and of DeepSeek-V3.2 (2 layers, in a child) under
   ``SERVE_RULES`` plus ``D=("data",)`` beside the unsharded decode, bit
   for bit; (b) four gloo ranks sharing the card at (2, 2): the training
   step on each rank's blocks and lanes (its loss and gradient norm
   within 1e-3 of the unsharded step's, each gathered gradient leaf
   within 5e-2, beside a control with every batch-axis gradient sum
   skipped; a step's collectives by kind, wall s a step, rank 0's
   profile), then each long_500k case on the rank's blocks and pool
   slice, fed the unsharded run's tokens (the first step's residual
   stream after the first two pool layers within 1e-2 relative L2 of
   the unsharded run's, the logits within the case's fixed limits, the
   hot tier exact, a control with ``data`` rank 1's ``wo`` zeroed
   outside them); each rank's weight, optimizer, pool and peak bytes,
   with the card's name and power limit;
21. tensor parallelism of the recurrent and encoder-decoder families
   (``models/ssm.py``'s Mamba2, mLSTM and sLSTM and ``models/encdec.py``
   on a rank's blocks): (a) at phase 16's NCCL world of one, a third run
   of its Zamba2-7B and Whisper-small decodes, the sharded model under
   ``SERVE_RULES`` (tokens, logits, hot tier, ``rec_*``, pools,
   ``self_kv`` bit-equal to the unsharded run, the kernels on every pool
   layer of every step), xLSTM-125M at full width and depth (4 requests
   of 2048 tokens, 4 steps: logits and ``rec_*`` bit-equal), and one
   ``TRAIN_RULES`` step of xLSTM-125M and of Zamba2-7B at 2 super-blocks
   plus its tail, bit-equal (loss, gradient norm, parameters and
   moments); (b) in phase 20's spawned world, at meshes (2, 2) and (1, 4)
   over the same four ranks: Zamba2-7B (15 layers), xLSTM-125M and
   Whisper-small (4,096 frames) at full width, each rank's run fed the
   unsharded run's tokens, the residual stream at its first three layer
   norms of the prefill and of the first decode step (up to its first
   pool read) within 1e-2 relative L2, the logits within FAM_LIMITS'
   coarse limits, the kernels on every pool layer of every step; a
   control (the prefill, and Whisper's first step, with model rank 1's
   ``w_out``, Whisper's attention ``wo``, zeroed) outside both; one
   training step of each at (2, 2), the loss and each gathered gradient
   leaf within FAM_LIMITS', a control without the batch-axis sums
   outside.

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
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# a kernel's bound is max(bytes / HBM rate, operations / bf16
# tensor-core peak) of one H100 SXM, from the kernel's analytic cost
# (src/repro_torch/kernels/cost.py, which the dry-run counts too)
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
                      "sparse_attn_combine_kernel", "write_rows_at")
SERVES = {
    "deepseek-v32": dict(arch="deepseek-v32", n_layers=2, slots=4,
                         max_ctx=4160, requests=8, context=4096, output=8,
                         attn="sparse_attn",
                         device_kernels=("gather_rows", "indexer_kernel",
                                         "sparse_mla_partial_kernel",
                                         "sparse_attn_combine_kernel",
                                         "write_rows_at")),
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
# Zamba2-7B at full width and depth: 81 Mamba2 layers (13 super-blocks of
# 6, then 3) and the one tied shared-attention layer after every sixth,
# so 13 pool layers; xLSTM-125M (12 layers, d 768, 4 heads) has no pool
# and runs no kernel of the port
SERVES["zamba2-7b"] = dict(arch="zamba2-7b", slots=8, max_ctx=8256,
                           requests=16, context=8192, output=8,
                           attn="sparse_attn_gqa",
                           device_kernels=GQA_DEVICE_KERNELS)
SERVES["xlstm-125m"] = dict(arch="xlstm-125m", slots=4, max_ctx=2112,
                            requests=8, context=2048, output=8, attn=None,
                            device_kernels=())


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """A record on stdout; on stderr, the script's seconds so far and the
    record's phase (where the time goes between records)."""
    print(json.dumps(obj), flush=True)
    print(f"chip_smoke: {time.perf_counter() - _STARTED:.1f} s "
          f"{obj.get('phase', '')} {obj.get('run', '')}", file=sys.stderr,
          flush=True)


def _warm_host_s(fns, n: int) -> float:
    """Call ``fns`` (cycled) ``n`` times; the host seconds of the last
    call (the earlier ones may load or compile)."""
    host = 0.0
    for i in range(n):
        t0 = time.perf_counter()
        fns[i % len(fns)]()
        host = time.perf_counter() - t0
    return host


def _queue_behind(host_s: float) -> None:
    """Hold the stream with a busy-wait kernel until the host has queued
    the timed calls behind it: thrice ``host_s`` (their host time, as
    the warm-up took it) and 2 ms, at 2 GHz of GPU cycles (longer at the
    card's lower clocks), at most ~50 ms."""
    import torch
    torch.cuda._sleep(int(2e9 * min(0.05, 3 * host_s + 0.002)))


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: a pair of CUDA events around each of
    ``iters`` calls, all queued behind a busy-wait kernel
    (``_queue_behind``) so that the host has enqueued them before the
    first starts (a call that synchronizes the host, as a boolean-mask
    index does, still includes host time).  The inputs stay warm in the
    50 MB L2 between calls (the row movers' ``ms_batched`` reads them
    cold where it says so)."""
    import torch
    host = _warm_host_s([fn], max(warmup, 1))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    _queue_behind(iters * (host + 20e-6))    # the event pairs' own host
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def cuda_batched_ms(fns, n: int = 200, warmup: int = 3) -> float:
    """Device time per call over a run of ``n`` back-to-back calls
    between one pair of CUDA events, queued behind a ~50 ms busy-wait so
    that the host has enqueued them all before the first starts: the
    device time of the kernel alone, free of the cost of an event pair
    around every call (about 5.6 us, which ``cuda_time_ms`` includes).
    ``fns``: one callable, or a list that the run cycles through (the
    same call on copies of its inputs, so that each call finds its inputs
    out of the L2: ``cold_copies``)."""
    import torch
    fns = fns if isinstance(fns, list) else [fns]
    host = _warm_host_s(fns, max(warmup, len(fns)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _queue_behind(n * host)
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# a batched run's calls: 200, or as many as take BATCHED_MS of the
# device (at least 20) where a call takes longer than BATCHED_MS / 200
BATCHED_MS = 100.0


def both_times(fn, rotation=None) -> dict:
    """``ms`` (an event pair around each of 20 calls of ``fn``) and
    ``ms_batched`` (one pair around 200 calls, or fewer where ``ms`` is
    long: BATCHED_MS, cycling through ``rotation`` when given, else of
    ``fn``)."""
    ms = cuda_time_ms(fn)
    n = min(200, max(20, int(BATCHED_MS / max(ms, 1e-6))))
    return dict(ms=ms, ms_batched=cuda_batched_ms(rotation or fn, n=n))


L2_BYTES = 50 * 2 ** 20                    # the H100's L2
MAX_COLD_COPIES = 64


def cold_copies(pairs, read_bytes: int, budget: int = 2 << 30):
    """Copies of a gather's (kv, idx) pairs for a batched run to cycle
    through, so that each call reads its rows from HBM, as on the serving
    path, where a layer's other kernels run between two gathers: enough
    copies of each kv that the rows read across them exceed twice the L2
    (one when a call alone reads that much).  None when the copies would
    take more than ``budget`` bytes or number more than MAX_COLD_COPIES (a
    gather of a few KB, which the batched run then times L2-warm)."""
    n = -(-2 * L2_BYTES // read_bytes)
    kvs = {id(kv): kv for kv, _ in pairs}
    if n > MAX_COLD_COPIES or (n - 1) * sum(kv.nbytes
                                       for kv in kvs.values()) > budget:
        return None
    copies = [pairs]
    for _ in range(n - 1):
        clone = {i: kv.clone() for i, kv in kvs.items()}
        copies.append([(clone[id(kv)], idx) for kv, idx in pairs])
    return copies


def _equal_bits(torch, a, b) -> bool:
    """Equal bytes (the row movers copy bits, also of fp8 entries)."""
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _state_equal(torch, a, b) -> bool:
    """Two tensors, or nested tuples and lists of them (a hot tier, a
    recurrent state, a run's logits), bit for bit; None equals None."""
    if a is None or b is None:
        return a is b
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_state_equal(torch, x, y)
                                        for x, y in zip(a, b))
    return _equal_bits(torch, a, b)


def gather_case(torch, ref, mod, shape: str, pairs, copies=None,
                was=None):
    """One launch of the gather over ``pairs`` [(kv [B,S,d], idx [B,k])],
    bit-exact against the plain version; timed per call and batched (the
    batched run cycling through ``copies`` of the pairs, by default
    ``cold_copies``: ``l2`` says whether each call read from HBM),
    beside the plain version, one ``torch.gather`` over the concatenated
    indices (the same bytes, batched over the same copies), ``was(pairs)``
    (the earlier calls for the same rows: ``ms_was``) and the bound.
    Returns its record."""
    from repro_torch.kernels import cost
    want = ref.gather_kv_many_ref(pairs)
    got = mod.gather_kv_many(pairs)
    if not all(_equal_bits(torch, a, b) for a, b in zip(got, want)):
        raise AssertionError(f"gather_kv differs from its plain version at "
                             f"the {shape} shape")
    del got, want
    rows = [(kv.shape[0] * idx.shape[1], kv.shape[-1] * kv.element_size())
            for kv, idx in pairs]
    bound, by = cost.bound_ms(cost.gather(pairs))
    if copies is None:
        copies = cold_copies(pairs, sum(n * w for n, w in rows))
    rec = dict(shape=shape,
               segments=[dict(kv=list(kv.shape), idx=list(idx.shape))
                         for kv, idx in pairs],
               dtype=str(pairs[0][0].dtype), max_abs_err=0.0,
               l2="cold" if copies else "warm",
               copies=len(copies) if copies else 1,
               bound_ms=bound, bound_by=by)
    rec.update(both_times(
        lambda: mod.gather_kv_many(pairs),
        copies and [lambda c=c: mod.gather_kv_many(c) for c in copies]))
    rec["plain_ms"] = cuda_time_ms(lambda: ref.gather_kv_many_ref(pairs))
    if was is not None:
        rec.update({f"{k}_was": v for k, v in both_times(
            lambda: was(pairs),
            copies and [lambda c=c: was(c) for c in copies]).items()})
    if all(k is pairs[0][0] for k, _ in pairs):
        # torch.gather takes no fp8: gather the bytes
        width = pairs[0][0].view(torch.uint8).shape[-1]
        idx_l = torch.cat([i for _, i in pairs], 1).long().clamp(
            0, pairs[0][0].shape[1] - 1)[..., None].expand(-1, -1, width)
        lib = both_times(
            lambda: torch.gather(pairs[0][0].view(torch.uint8), 1, idx_l),
            copies and [lambda c=c: torch.gather(c[0][0].view(torch.uint8),
                                                 1, idx_l) for c in copies])
        rec["library_ms"], rec["library_ms_batched"] = lib["ms"], \
            lib["ms_batched"]
    return rec


def check_gathers(torch, ref, mod):
    """The gather at every shape the main paths give it, each one launch,
    bit-exact (gather_case): DeepSeek-V3.2's decode (the
    record's own fields); Qwen2-1.5B's decode ([8, 8256, 512], k=2048);
    the fetch pipeline's fused demand set and speculation tail at Qwen2's
    shape (k=2048 plus w=512 from one pool, some tail indices out of
    range: the kernel clamps them), beside the earlier unfused calls (a
    launch each, the tail clamped by ``torch.clamp``: ``ms_was``); the tail alone; the prefill warm-up
    (every layer's 1536 planned rows of the last of 8 slots, addressed in
    the contiguous [28, 8 * 8256, 512] view of the pool with offsets
    lane * S: 1.9 GB, the widest addressing the kernel is given; its
    batched run cycles through the 8 lanes' disjoint rows in place of
    copies of the pool); Gemma3-12B's width ([4, 8256, 3840], k=2048) in
    bf16 and e4m3; Zamba2-7B's ([8, 8256, 7168], k=2048: rows of 14,336
    B); Whisper-small's cross-KV pool ([8, 32768, 1536], k=2048: rows of
    3,072 B).  Returns the gather's record."""
    from repro_torch.core.pool import E4M3, to_kv_dtype
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    def randidx(B, k, S, lo=0, hi=None):
        return torch.randint(lo, S if hi is None else hi, (B, k),
                             generator=g, device=dev, dtype=torch.int32)

    kv = randn(4, 4160, 576)
    rec = gather_case(torch, ref, mod, "deepseek-v32",
                      [(kv, randidx(4, 2048, 4160))])
    rec["bound"] = (rec.pop("bound_ms"), rec.pop("bound_by"))
    shapes = []
    kv = randn(8, 8256, 512)
    demand, tail = randidx(8, 2048, 8256), randidx(8, 512, 8256, -4, 8260)
    shapes.append(gather_case(torch, ref, mod, "qwen2-1.5b",
                              [(kv, demand)]))
    shapes.append(gather_case(
        torch, ref, mod, "fetch_demand_and_tail", [(kv, demand), (kv, tail)],
        was=lambda p: [ops.batched_gather(p[0][0], p[0][1]),
                       ops.batched_gather(p[1][0], torch.clamp(
                           p[1][1], 0, p[1][0].shape[1] - 1))]))
    shapes.append(gather_case(torch, ref, mod, "speculation_tail",
                              [(kv, tail)]))
    L, slots, S, lane = 28, 8, 8256, 7
    pool = randn(L, slots, S, 512).view(L, slots * S, 512)
    plan = randidx(L, 1536, S)
    shapes.append(gather_case(
        torch, ref, mod, "warmup_plan", [(pool, plan + lane * S)],
        copies=[[(pool, plan + b * S)] for b in range(slots)]))
    del kv, pool
    x = torch.randn((4, 8256, 3840), generator=g, device=dev)
    idx = randidx(4, 2048, 8256)
    for kv in (x.bfloat16(), to_kv_dtype(x, E4M3)):
        shapes.append(gather_case(torch, ref, mod, "gemma3-12b",
                                  [(kv, idx)]))
    del x, kv
    kv = randn(8, 8256, 7168)
    shapes.append(gather_case(torch, ref, mod, "zamba2-7b",
                              [(kv, randidx(8, 2048, 8256))]))
    del kv
    kv = randn(8, 32768, 1536)
    shapes.append(gather_case(torch, ref, mod, "whisper-small",
                              [(kv, randidx(8, 2048, 32768))]))
    del kv
    torch.cuda.empty_cache()
    rec["shapes"] = shapes
    return rec


# the decode write's pools (L, B, S, entry width, indexer-key width) at
# each served model's shape (Zamba2-7B: its 13 pool layers; Whisper-small:
# its decoder's self_kv [12, 8, 448, 1536] alone, no indexer pool);
# Gemma3-12B's entries in bf16 and e4m3
WRITE_SHAPES = {"deepseek-v32": (2, 4, 4160, 576, 128),
                "qwen2-1.5b": (28, 8, 8256, 512, 64),
                "gemma3-12b": (48, 4, 8256, 3840, 64),
                "zamba2-7b": (13, 8, 8256, 7168, 64),
                "whisper-small": (12, 8, 448, 1536, None)}


def _rand_pool(torch, g, shape, dtype):
    """Random bits in ``dtype`` (the row movers move bytes)."""
    width = shape[-1] * dtype.itemsize
    return torch.randint(0, 256, (*shape[:-1], width), generator=g,
                         device="cuda", dtype=torch.uint8).view(dtype)


def check_pool_writes(torch, ref, mod):
    """The scatter kernel in its three forms, bit-exact on the card
    against the plain versions on the same bytes:

    - the index form (the TPU kernel's; on no path of the port, held as
      the TPU kernel's counterpart) at DeepSeek-V3.2's width: one
      row (the floor of a launch), a decode step's 8 rows and a layer's
      splice rows, into the flattened [1, 2*4*4160, 576] pool;
    - the decode write (WRITE_SHAPES: both pools, or Whisper-small's
      one, every layer, one launch; positions include out-of-range ones,
      which clamp), beside
      the port's earlier write (the row arithmetic in PyTorch and one
      index-form launch a pool: ``ms_was``) and ``index_copy_`` of both
      pools (the library call);
    - the prefill splice of a Gemma3-12B prompt (48 x 8192 rows, the
      indexer keys too) into the last lane of the 4-slot, 8256-position
      pools with the tail zeroed, in bf16 and e4m3, beside the earlier
      splice (zero padding by torch.cat, then an index-form scatter of
      L*S rows a pool: ``ms_was``) and ``copy_`` + ``zero_`` of the
      lane's slices (the library call).

    The index form and the decode write move kilobytes, so their inputs
    stay in the L2 across a batched run, as the decode write's entries,
    just computed by the layer, are on the serving path (``l2``:
    "warm"); the splice moves 3-6 GB a call, far past the L2 ("cold").
    Returns the scatter's record: the decode write at DeepSeek-V3.2's
    shape in its own fields, every case in ``shapes``."""
    from repro_torch.core.pool import E4M3
    from repro_torch.kernels import cost
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    shapes = []
    # -- the index form
    L, B, S, d = 2, 4, 4160, 576
    pool = _rand_pool(torch, g, (1, L * B * S, d), torch.bfloat16)
    for n_rows in (1, L * B, L * S):
        rows = torch.randperm(L * B * S, generator=g, device=dev)[:n_rows]
        rows = rows.to(torch.int32)[None]
        e = _rand_pool(torch, g, (1, n_rows, d), torch.bfloat16)
        want = ref.scatter_kv_ref(pool[0].clone(), e[0], rows[0])
        got = mod.scatter_kv(pool.clone(), e, rows)
        if not _equal_bits(torch, got[0], want):
            raise AssertionError(f"scatter_kv differs from its plain "
                                 f"version ({n_rows} rows)")
        if n_rows < L * S:
            rows_l = rows[0].long()
            bound, by = cost.bound_ms(cost.rows(n_rows,
                                                d * pool.element_size()))
            shapes.append(dict(
                shape="deepseek-v32", form="index", rows=n_rows,
                max_abs_err=0.0, l2="warm", bound_ms=bound, bound_by=by,
                plain_ms=cuda_time_ms(lambda: ref.scatter_kv_ref(
                    got[0], e[0], rows[0])),
                library_ms=cuda_time_ms(lambda: got[0].index_copy_(
                    0, rows_l, e[0])),
                **both_times(lambda: mod.scatter_kv(got, e, rows))))
    del pool, got, want
    # -- the decode write
    rec = None
    for name, (L, B, S, d, di) in WRITE_SHAPES.items():
        for dtype in ((torch.bfloat16, E4M3) if name == "gemma3-12b"
                      else (torch.bfloat16,)):
            pools = [_rand_pool(torch, g, (L, B, S, d), dtype)]
            if di:
                pools.append(_rand_pool(torch, g, (L, B, S, di),
                                        torch.bfloat16))
            entries = [_rand_pool(torch, g, (L, B, p.shape[-1]), p.dtype)
                       for p in pools]
            pos = torch.randint(-2, S + 2, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            want = [p.clone() for p in pools]
            for p, e in zip(want, entries):
                ref.write_rows_at_ref(p.view(torch.uint8),
                                      e.view(torch.uint8), pos)
            got = pools                # written in place: 12 GB at Zamba2's
            mod.write_rows_at(got, entries, pos)
            if not all(_equal_bits(torch, a, b) for a, b in zip(got, want)):
                raise AssertionError(f"write_rows_at differs from its plain "
                                     f"version at the {name} shape "
                                     f"({dtype})")
            del want
            flat = [p.view(-1, p.shape[-1]) for p in got]
            rows_l = (torch.arange(L * B, device=dev).reshape(L, B) * S
                      + pos.long().clamp(0, S - 1)).reshape(-1)
            e_flat = [e.reshape(L * B, -1) for e in entries]

            def was():            # the port's earlier pool_write, a pool
                for f, e in zip(flat, e_flat):
                    pos_c = torch.clamp(pos.long(), 0, S - 1)
                    lanes = torch.arange(L * B, device=dev).reshape(L, B)
                    r = (lanes * S + pos_c[None, :]).reshape(1, L * B)
                    mod.scatter_kv(f[None], e[None], r.to(torch.int32))

            def library():
                for f, e in zip(flat, e_flat):
                    f.view(torch.uint8).index_copy_(0, rows_l,
                                                    e.view(torch.uint8))
            bound, by = cost.bound_ms(cost.write_rows_at(
                B, [(L, e.shape[-1] * e.element_size()) for e in entries]))
            case = dict(
                shape=name, form="decode", dtype=str(dtype),
                pools=[list(p.shape) for p in pools],
                rows=len(pools) * L * B,
                max_abs_err=0.0, l2="warm", bound_ms=bound, bound_by=by,
                plain_ms=cuda_time_ms(lambda: [ref.write_rows_at_ref(
                    p.view(torch.uint8), e.view(torch.uint8), pos)
                    for p, e in zip(got, entries)]),
                **both_times(lambda: mod.write_rows_at(got, entries, pos)))
            case.update({f"{k}_was": v for k, v in both_times(was).items()})
            lib = both_times(library)
            case["library_ms"], case["library_ms_batched"] = \
                lib["ms"], lib["ms_batched"]
            if name == "deepseek-v32":
                rec = dict(case, bound=(case.pop("bound_ms"),
                                        case.pop("bound_by")))
            else:
                shapes.append(case)
            del pools, got, flat, entries
            torch.cuda.empty_cache()
    # -- the Gemma3-12B prefill splice
    L, slots, S, d, di, T, lane = 48, 4, 8256, 3840, 64, 8192, 3
    for dtype in (torch.bfloat16, E4M3):
        pools = [_rand_pool(torch, g, (L, slots, S, d), dtype),
                 _rand_pool(torch, g, (L, slots, S, di), torch.bfloat16)]
        srcs = [_rand_pool(torch, g, (L, 1, T, d), dtype),
                _rand_pool(torch, g, (L, 1, T, di), torch.bfloat16)]
        want = [p.clone() for p in pools]
        for p, s in zip(want, srcs):
            ref.splice_ref(p.view(torch.uint8), s.view(torch.uint8),
                           lane=lane, zero_tail=True)
        got = [p.clone() for p in pools]
        mod.splice(got, srcs, lane=lane, zero_tail=True)
        if not all(_equal_bits(torch, a, b) for a, b in zip(got, want)):
            raise AssertionError(f"splice differs from its plain version "
                                 f"({dtype})")
        del want, pools

        def was():                # the port's earlier splice, both pools
            for p, s in zip(got, srcs):
                s = torch.cat([s, s.new_zeros(L, 1, S - T, s.shape[3])], 2)
                layer_lane = torch.arange(L, device=dev)[:, None] * slots \
                    + torch.tensor([lane], device=dev)[None, :]
                rows = (layer_lane[..., None] * S
                        + torch.arange(S, device=dev))
                mod.scatter_kv(p.view(1, -1, p.shape[-1]),
                               s.reshape(1, -1, s.shape[-1]),
                               rows.reshape(1, -1).to(torch.int32))

        def library():
            for p, s in zip(got, srcs):
                p = p.view(torch.uint8)
                p[:, lane, :T].copy_(s[:, 0].view(torch.uint8))
                p[:, lane, T:].zero_()
        bound, by = cost.bound_ms(cost.splice_pools(got, srcs, lane=lane,
                                                    zero_tail=True))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        was()
        torch.cuda.synchronize()
        was_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        mod.splice(got, srcs, lane=lane, zero_tail=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        case = dict(
            shape="gemma3-12b", form="splice", dtype=str(dtype),
            pools=[list(p.shape) for p in got],
            srcs=[list(s.shape) for s in srcs], lane=lane, max_abs_err=0.0,
            l2="cold",
            bound_ms=bound, bound_by=by, transient_bytes=peak,
            transient_bytes_was=was_peak,
            plain_ms=cuda_time_ms(lambda: [ref.splice_ref(
                p.view(torch.uint8), s.view(torch.uint8), lane=lane,
                zero_tail=True)
                for p, s in zip(got, srcs)], iters=3, warmup=1),
            ms_was=cuda_time_ms(was, iters=5, warmup=1),
            **both_times(lambda: mod.splice(got, srcs, lane=lane,
                                            zero_tail=True)))
        lib = both_times(library)
        case["library_ms"], case["library_ms_batched"] = \
            lib["ms"], lib["ms_batched"]
        shapes.append(case)
        del got, srcs
        torch.cuda.empty_cache()
    rec["shapes"] = shapes
    return rec


# the indexer's timed shapes (B, S, H, di): DeepSeek-V3.2's and
# Qwen2-1.5B's serving pools, a long context whose 67 MB of keys do
# not fit the 50 MB L2 (so its keys come from HBM on every call), and
# Whisper-small's encoder pool (8 requests of 32,768 frames)
INDEXER_SHAPES = {"deepseek-v32": (4, 4160, 64, 128),
                  "qwen2-1.5b": (8, 8256, 4, 64),
                  "long-context": (4, 65536, 64, 128),
                  "whisper-small": (8, 32768, 4, 64)}


def check_indexer(torch, ref, mod):
    """The indexer at each shape of INDEXER_SHAPES against its plain
    version at TOL_F32, with a general f32 q and with a bf16-exact q as
    the serving path gives it (whose lo products the kernel skips), each
    checked and timed (``ms``, ``ms_bf16_q``), the plain version's time
    and the bound (the function's 2*B*S*H*di FLOPs; no PyTorch call
    computes it).  Returns the record of DeepSeek-V3.2's shape, with the
    worst error of every shape and both kinds of q, and every shape's
    record in ``shapes``."""
    from repro_torch.kernels import cost
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
        per_shape.append(dict(
            shape=cell, B=B, S=S, H=H, di=di, key_bytes=B * S * di * 2,
            max_abs_err=errs[0], max_abs_err_bf16_q=errs[1],
            ms=cuda_time_ms(lambda: mod.indexer_scores(q, w, keys)),
            ms_bf16_q=cuda_time_ms(lambda: mod.indexer_scores(q16, w, keys)),
            plain_ms=cuda_time_ms(plain), library_ms=None,
            bound=cost.bound_ms(cost.indexer(B, S, H, di,
                                             keys.element_size()))))
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
    """(heads, KV heads, head dim) of every dense/MoE, local:global and
    Mamba2-hybrid config of the registry, Qwen2-1.5B's (the served one)
    first."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import build_segments
    shapes = []
    for name in ["qwen2-1.5b"] + sorted(ARCHS):
        cfg = ARCHS[name]
        if cfg.enc_dec or not cfg.has_attention:
            continue
        kinds = {s.kind for s in build_segments(cfg)}
        shape = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        if kinds <= {"dense", "moe", "lg_super", "zamba_super",
                     "mamba_tail"} and shape not in shapes:
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
              ("gemma3-12b served, local", "gqa", 4, 16, 8, 240, 1023),
              ("zamba2-7b", "gqa", 8, 32, 32, 112, None))
# Whisper-small's two GQA calls a decoder layer (12 heads over 12 KV
# heads of 64, B = 8; its pools are bf16): the cross-attention over
# exactly the top-k 2048 fetched lanes (no own lane) and the
# self-attention over the 448 decoder positions and the own entry;
# (case as ATTN_CASES, lanes)
WHISPER_ATTN = ((("whisper-small cross", "gqa", 8, 12, 12, 64, None), 2048),
                (("whisper-small self", "gqa", 8, 12, 12, 64, None), 449))
# the heads a tensor-parallel rank attends with (bf16, as ATTN_CASES):
# DeepSeek-V3.2's MLA at model 16 (the production single pod), 4 and 2
# (phase 19's mesh); Qwen2-1.5B's GQA on the entries cut to a rank's KV
# head, 3 heads to it at model 4 and 6 at model 2 (at model 16 its 96
# q columns are not whole heads: every head attends, as ATTN_CASES')
TP_ATTN_CASES = (("deepseek-v32 rank, model 16", "mla", 4, 8, 512, 64, None),
                 ("deepseek-v32 rank, model 4", "mla", 4, 32, 512, 64, None),
                 ("deepseek-v32 rank, model 2", "mla", 4, 64, 512, 64, None),
                 ("qwen2-1.5b rank, model 4", "gqa", 8, 3, 1, 128, None),
                 ("qwen2-1.5b rank, model 2", "gqa", 8, 6, 1, 128, None))


def attention_case(torch, ref, mod, g, case, dtype, k: int = 2049):
    """One case of ATTN_CASES (k = top-k + the own entry lanes) with
    entries of ``dtype``: held against the plain version at TOL_F32 and
    timed beside it and SDPA on f32 copies (``library_ms``); e4m3 also
    on the same values in bf16 (``ms_bf16``; e4m3 widens to bf16
    exactly).  The bound counts the valid entry rows at the dtype's
    bytes, q and out in f32 and the mask a byte a lane."""
    from repro_torch.core.pool import E4M3, to_kv_dtype
    from repro_torch.kernels import cost
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
        work = cost.mla(B, H, k, dq, dv, row, ent.element_size(), n_valid)
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
        work = cost.gqa(B, H, n_kv, hd, k, ent.element_size(), n_valid)
        splits = mod.gqa_plan(B, H, n_kv, hd, k, fp8=fp8)[0]
        shape = dict(heads=H, kv_heads=n_kv, head_dim=hd)
    got, want = kernel(ent), plain()
    torch.testing.assert_close(got, want, **TOL_F32)
    bound, by = cost.bound_ms(work)
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
    the GQA form in bf16 at the (heads, KV heads, head dim) of every
    dense/MoE and local:global config of the registry (B = 8), at
    Whisper-small's two calls (WHISPER_ATTN) and both forms at a
    tensor-parallel rank's heads (TP_ATTN_CASES).  Returns
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
    out += [attention_case(torch, ref, mod, g, case, torch.bfloat16, k=k)
            for case, k in WHISPER_ATTN]
    out += [attention_case(torch, ref, mod, g, case, torch.bfloat16)
            for case in TP_ATTN_CASES]
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


def check_gather_pages(torch, ref, mod):
    """The page gather (on no path) at one layer of Qwen2-1.5B's serving
    pool, [8 * 8256, 512] bf16 in pages of 16 rows: 1024 page ids, the
    pages of a top-2048 per request."""
    from repro_torch.kernels import cost
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
    return dict(
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: mod.gather_kv_pages(kv, pidx, page=page)),
        plain_ms=cuda_time_ms(lambda: ref.gather_kv_pages_ref(kv, pidx,
                                                              page)),
        library_ms=cuda_time_ms(lambda: view.index_select(0, pl)),
        bound=cost.bound_ms(cost.gather_pages(n, page,
                                              d * kv.element_size())))


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


# small_check's limit on the relative L2 error, card against CPU
SMALL_TOL = 5e-2


def _small_topk(scores, cache_len, K: int = 16):
    """small_check's injected top-k: score-independent, with invalid
    lanes."""
    import torch
    j = torch.arange(K, dtype=torch.int32, device=scores.device)[None]
    t = cache_len[:, None]
    pos = (j * 7 + 3 * t) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def _small_spec(scores, cache_len, W: int):
    """small_check's injected speculation of width W."""
    import torch
    j = torch.arange(W, dtype=torch.int32, device=scores.device)[None]
    t = cache_len[:, None]
    pos = (t - 1 - (j * j) % 11) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j % 4 != 1).expand(t.shape[0], W)


def _small_params(torch, cfg, mode: str):
    """small_check's weights: seed 1 on the CPU, QKV biases (where a
    decoder's config has them) set non-zero."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pool_layer_params
    m = build_model(cfg, mode=mode, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(1)
    params = m.init(gen)
    if cfg.enc_dec:
        return params
    for layer in pool_layer_params(cfg, params):
        for name in ("bq", "bk", "bv"):
            if name in layer["attn"]:
                b = layer["attn"][name]
                b.copy_(0.5 * torch.randn(b.shape, generator=gen))
    return params


def _small_run(torch, cfg, params, dev, *, mode: str, prompt_len=40,
               pool_len: int = 64, prefetch: bool = False,
               degrade: bool = False, mesh=None, lanes=(0, 1),
               batch_axes=("data",), hier_tail: bool = False,
               device_buffer: int = 8):
    """One small_check run on ``dev`` of ``lanes`` (of two), four decode
    steps of tokens 5 and 7 under the injected top-k (the logits of each
    prefill first).  A decoder's lane
    b holds a prompt of ``prompt_len[b]`` tokens, each prefilled alone
    and written into its lane as the engine splices it (an int: lane 1's
    prompt, lane 0 empty); an encoder-decoder's lane b holds ``pool_len -
    24 b`` encoder frames (seed 2).  ``prefetch``: the injected
    speculation too, with per-step budgets and a warm-up plan for lane
    1.  ``hier_tail``: the config's speculation tail and score margin,
    selected by score (sharded: the hierarchical top-k).  ``mesh``: the
    pool sharded over its ``model`` axis (``make_pooled_fetch`` with
    ``batch_axes``, ``shard_serve_state``; the pool returned is this
    rank's slice).  Returns the logits, the hot tier, the pool,
    ``rec_*`` and ``self_kv`` (on the host)."""
    import functools
    from repro_torch.core.pool import make_pooled_fetch, pool_write_prefill
    from repro_torch.core.topk import make_hierarchical_topk
    from repro_torch.distributed.sharding import shard_serve_state
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    W = cfg.sac.prefetch_width
    topk, opts = _small_topk, None
    if prefetch:
        opts = dict(prefetch_width=W, score_margin=cfg.sac.score_margin,
                    prefetch_fn=functools.partial(_small_spec, W=W))
    if hier_tail:
        opts = dict(prefetch_width=W, score_margin=cfg.sac.score_margin)
        topk = (None if mesh is None
                else make_hierarchical_topk(mesh, cfg.sac.topk))
    fetch = ({} if mesh is None else
             dict(fetch_fn=make_pooled_fetch(mesh, batch_axes=batch_axes)))
    m = build_model(cfg, mode=mode, topk_fn=topk, opts=opts, device=dev,
                    **fetch)
    p = _to(params, dev)
    if degrade:
        p = e4m3_weights(torch, p)
    sel = torch.as_tensor(lanes)
    logits = []          # each prompt's prefill, then each decode step
    if cfg.enc_dec:
        g = torch.Generator(device="cpu").manual_seed(2)
        frames = torch.randn((2, pool_len, cfg.d_model),
                             generator=g).bfloat16()
        state, _ = m.prefill(p, frames[sel].to(dev), torch.tensor(
            [pool_len, pool_len - 24], dtype=torch.int32)[sel].to(dev))
    else:
        lens = ((0, prompt_len) if isinstance(prompt_len, int)
                else prompt_len)
        state = m.init_serve_state(len(lanes), pool_len,
                                   device_buffer=device_buffer)
        for i, lane in enumerate(lanes):
            if not lens[lane]:
                continue
            # lane 1: tokens 3, 4, ...; lane 0 from 20
            prompt = (torch.arange(lens[lane], dtype=torch.int32,
                                   device=dev) + 20 - 17 * lane) % cfg.vocab
            st, first = m.prefill(p, prompt[None])
            logits.append(first.float().cpu())
            for key in ("kv_pool", "idx_pool"):
                if key in state:
                    pool_write_prefill(state[key], st[key], lane=i)
            state["cache_len"][i] = lens[lane]
            if prefetch:
                L = m.n_kv
                j = torch.arange(12, dtype=torch.int32, device=dev)
                T = lens[lane]
                idx = ((T - 1 - 5 * j)[None] + torch.arange(
                    L, dtype=torch.int32, device=dev)[:, None]) % T
                Engine._warm_apply(state["hot_buf"], state["kv_pool"], i,
                                   idx, (j % 6 != 2)[None].expand(L, 12))
    if mesh is not None:
        state = shard_serve_state(state, mesh)
    tok = torch.tensor([5, 7], dtype=torch.int32)[sel].to(dev)
    for step in range(4):
        budget = (torch.tensor([step % 3, W - 2 * step], dtype=torch.int32,
                               device=dev)[sel] if prefetch else None)
        state, lg = m.decode(p, state, tok, **(
            dict(pf_budget=budget) if prefetch else {}))
        logits.append(lg.float().cpu())
    return dict(lanes=list(lanes), logits=logits,
                hot=([t.cpu() for t in state["hot_buf"]]
                     if "hot_buf" in state else []),
                pool=(state["kv_pool"].float().cpu()
                      if "kv_pool" in state else None),
                rec=[t.float().cpu() for t in _rec_leaves(state)],
                self_kv=(state["self_kv"].float().cpu()
                         if "self_kv" in state else None))


def small_runs(torch, cfg, *, mode: str = "sac", devices=("cpu", "cuda"),
               **kw):
    """small_check's three runs on the same weights: ``devices[0]`` (the
    CPU's plain path), ``devices[1]`` (the card) and the card with the
    weights rounded through e4m3 (the control); ``kw``: ``_small_run``'s
    options."""
    params = _small_params(torch, cfg, mode)
    return [_small_run(torch, cfg, params, dev, mode=mode, degrade=degrade,
                       **kw)
            for dev, degrade in [(d, False) for d in devices]
            + [(devices[1], True)]]


def small_check(torch, cfg, *, mode: str = "sac", prompt_len=40,
                pool_len: int = 64, prefetch: bool = False,
                devices=("cpu", "cuda"), runs=None,
                injected: bool = True):
    """``cfg`` on the card against the same weights on the CPU (QKV
    biases, where the config has them, set non-zero): per-request
    relative L2 error of the logits, the pool (where the model has one),
    ``self_kv`` (where it has one) and each leaf of the recurrent state
    ``rec_*`` (where it has one) within SMALL_TOL (bf16 activations round
    at other places in cuBLAS and on the CPU; about 1e-2 is typical),
    and in a decoder's SAC mode the hot-tier integer state exact under
    an injected top-k (``injected``).  Lane 1 holds the prompt, lane 0
    is empty; the recurrent state starts from zeros, as the engine's
    splice of a prefill leaves it.

    A control: the card runs again with the weights rounded through
    e4m3 (``e4m3_weights``), and that run's error against the CPU must
    exceed SMALL_TOL, or the limit could not tell a lower-precision run
    from a sound one.  Returns the worst error and the control's.

    ``prefetch``: the fetch pipeline on, its selections injected too (a
    score-independent speculation of the config's width, per-request
    budgets that change every step as the arbiter's grants do, and a
    warm-up plan for lane 1 applied by ``Engine._warm_apply``), so that
    the hot tier, its ``pf_*`` counters included, must match exactly.
    ``runs``: ``small_runs``' result, made by the caller (its options
    then stand in for these)."""
    if runs is None:
        runs = small_runs(torch, cfg, mode=mode, prompt_len=prompt_len,
                          pool_len=pool_len, prefetch=prefetch,
                          devices=devices)
    ref_run, dev_run = runs[:2]
    worst = 0.0
    for want, got in _run_pairs(ref_run, dev_run):
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite values on the card")
        worst = max(worst, _rel_l2(got, want))
    if worst > SMALL_TOL:
        raise AssertionError(f"{cfg.name} ({mode}): card vs CPU relative "
                             f"L2 error {worst:.4f} > {SMALL_TOL}")
    control_err = max(_rel_l2(got, want) for want, got in
                      _run_pairs(ref_run, runs[2]))
    if control_err <= SMALL_TOL:
        raise AssertionError(f"{cfg.name} ({mode}): the e4m3 control's "
                             f"error {control_err:.4f} is within "
                             f"{SMALL_TOL}")
    if mode == "sac" and not cfg.enc_dec and not ref_run["hot"]:
        raise AssertionError("no hot tier in the SAC small check")
    if prefetch and not int(dev_run["hot"][-2].sum()):
        raise AssertionError(f"{cfg.name}: nothing was warm-inserted")
    if injected and not _state_equal(torch, ref_run["hot"][1:],
                                     dev_run["hot"][1:]):
        raise AssertionError(f"{cfg.name}: hot-tier state differs "
                             "card vs CPU")
    return worst, control_err


def e4m3_weights(torch, params):
    """A copy of ``params`` with every bf16 tensor rounded through e4m3
    and back (3 mantissa bits in place of 7): small_check's
    lower-precision control."""
    from repro_torch.core.pool import E4M3
    if isinstance(params, dict):
        return {k: e4m3_weights(torch, v) for k, v in params.items()}
    if isinstance(params, list):
        return [e4m3_weights(torch, v) for v in params]
    if params.dtype != torch.bfloat16:
        return params
    return params.to(E4M3).to(torch.bfloat16)


def _rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _run_pairs(want, got):
    """(want, got) pairs of two small-check runs: each request's logits
    at each step, each lane of the pool and of ``self_kv``, each
    ``rec_*`` leaf."""
    pairs = [(a[i], b[i]) for a, b in zip(want["logits"], got["logits"])
             for i in range(a.shape[0])]
    for key in ("pool", "self_kv"):
        if want.get(key) is not None:
            pairs += [(want[key][:, i], got[key][:, i])
                      for i in range(want[key].shape[1])]
    return pairs + list(zip(want["rec"], got["rec"]))


def _rec_leaves(state):
    """The leaves of every ``rec_*`` of a serve state, in order."""
    out = []

    def walk(x):
        if isinstance(x, tuple):
            for y in x:
                walk(y)
        else:
            out.append(x)
    for key in sorted(k for k in state if k.startswith("rec_")):
        walk(state[key])
    return out


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
          context: int, output: int, device="cuda", device_kernels=None):
    """Serve the trace through the port's Engine; returns the engine, the
    kernels' launch counts during the run, a summary (with the bytes and
    dtypes of the pool, the hot tier's entries and the indexer pool),
    each request's decoded tokens, the first decode step's logits and,
    with ``device_kernels``, the profile of the run's last
    PROFILED_STEPS decode steps (``profile_in_run``; their wall times
    are the profile's, not in the summary's).  Every logit of every
    decode step must be finite.  (``device`` lets the same phase run
    reduced on the CPU as a rehearsal.)  The summary also gives the pool
    layers and the bytes of the recurrent state ``rec_*`` (Mamba2,
    xLSTM)."""
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
    done, prof, held = [], None, []

    def kept(*args, **kwargs):             # no operator in the trace
        state, logits = plain_decode(*args, **kwargs)
        held.append(logits)
        return state, logits
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    while len(done) < len(reqs) and eng.stats.steps < 20 * requests:
        if device_kernels is not None and prof is None and \
                last_wave_ready(eng):
            eng._decode = kept
            prof, finished = profile_in_run(torch, eng, eng.step,
                                            device_kernels=device_kernels)
            eng._decode = decode
            nonfinite += [(~torch.isfinite(lg)).sum() for lg in held]
            done += finished
            # the run's wall holds the traced steps, not their analysis
            t_run += prof["seconds"] - prof["wall_s"]
            continue
        s0 = eng.stats.steps
        t1 = time.perf_counter()
        done += eng.step()
        sync()
        if eng.stats.steps > s0:
            step_s.append(time.perf_counter() - t1)
    run_s = time.perf_counter() - t_run
    if device_kernels is not None and prof is None:
        raise AssertionError(f"{cfg.name}: no last wave to profile")
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
    tensors = {k: eng.state[key] for k, key in (
        ("kv_pool", "kv_pool"), ("hot_tier_entries", "hot_buf"),
        ("idx_pool", "idx_pool")) if key in eng.state}
    if "hot_tier_entries" in tensors:
        tensors["hot_tier_entries"] = tensors["hot_tier_entries"].entries
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
        pool_layers=eng.model.n_kv,
        pool_bytes={k: t.nbytes for k, t in tensors.items()},
        pool_dtypes={k: str(t.dtype) for k, t in tensors.items()},
        rec_bytes=sum(t.nbytes for t in _rec_leaves(eng.state)),
        logits_finite=True, launches=counts)
    return (eng, counts, summary, {r.request_id: r.out_tokens for r in done},
            first[0], prof)


# the profiler's own utility events, which its event list leaves out too
# (torch.autograd.profiler_util._filter_name)
_PROFILER_UTILITY = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"))


def _trace_facts(torch, prof, spans=()):
    """What ``profile_steps`` reads of a trace, straight from kineto's
    events: the profiler's Python event list (``prof.events()``,
    ``key_averages()``) would build an object and a tree node for each of
    the trace's tens of thousands of events, seconds of host time for two
    decode steps of a full-depth model, and these few sums need neither.
    The same definitions as that list's:

    - ``device``: (start ns, end ns from the trace's start, name) of each
      device activity (kernels and copies), the ranges' device-side
      annotations left out;
    - ``keys``: by host event name, [calls, inclusive host us, own host
      us], as ``key_averages`` gives ``count``, ``cpu_time_total`` and
      ``self_cpu_time_total`` for its host entries (a range's device-side
      annotation has an entry of its own, which is left out): a host
      event's own time is its time less
      its children's, nesting by interval on its thread (a device
      runtime call on the thread of the operator that made it), an
      asynchronous event counting no own time and holding no children,
      and a child that is its same-named parent's only child merged
      into it;
    - ``spans``: for each host range named in ``spans``, [name, host us,
      device us of the activities launched by the operators inside it,
      ``cudaLaunchKernel`` calls inside it]."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    cpu, device, names = [], [], {}
    for e in results.events():
        raw = e.name()
        if raw in _PROFILER_UTILITY or (hasattr(e, "is_hidden_event")
                                        and e.is_hidden_event()):
            continue
        name = names.get(raw)
        if name is None:             # demangled, as the event list names it
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        if e.device_type() == DeviceType.CPU:
            cpu.append((e.start_ns(), e.end_ns(), name, e.start_thread_id(),
                        e.is_async() or e.start_thread_id()
                        != e.end_thread_id(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns() - t0, e.end_ns() - t0, name,
                           e.linked_correlation_id(),
                           e.is_user_annotation()))
    # a runtime call (linked to its operator) runs on that operator's thread
    thread_of = {c[5]: c[3] for c in cpu if c[6] == 0 and not c[4]}
    threads = {}
    for i, c in enumerate(cpu):
        if not c[4]:
            t = thread_of.get(c[6], c[3]) if c[6] else c[3]
            threads.setdefault(t, []).append(i)
    parent = [None] * len(cpu)
    children = [[] for _ in cpu]
    where = {}                       # thread -> its events in start order
    for t, idx in threads.items():
        idx.sort(key=lambda i: (cpu[i][0], -cpu[i][1]))
        where[t] = idx
        stack = []
        for i in idx:
            while stack and (cpu[i][0] >= cpu[stack[-1]][1]
                             or cpu[i][1] > cpu[stack[-1]][1]):
                stack.pop()
            if stack:
                parent[i] = stack[-1]
                children[stack[-1]].append(i)
            stack.append(i)
    gone = set()
    while True:                      # merge same-named only children
        merged = False
        for i, c in enumerate(cpu):
            p = parent[i]
            if i in gone or p is None or cpu[p][2] != c[2] \
                    or len(children[p]) != 1:
                continue
            children[p] = children[i]
            for ch in children[i]:
                parent[ch] = p
            gone.add(i)
            merged = True
        if not merged:
            break
    keys = {}
    for i, c in enumerate(cpu):
        if i in gone:
            continue
        dur = (c[1] - c[0]) * 1e-3
        own = 0.0 if c[4] else dur - sum((cpu[ch][1] - cpu[ch][0]) * 1e-3
                                         for ch in children[i])
        k = keys.setdefault(c[2], [0, 0.0, 0.0])
        k[0] += 1
        k[1] += dur
        k[2] += own
    # the ranges: the operators and runtime calls on their thread between
    # their ends, and the device activities those operators launched
    out, launched = [], {}
    for a, b, name, linked, _ in device:
        if linked:
            launched[linked] = launched.get(linked, 0) + (b - a)
    import bisect
    for t, idx in where.items():
        starts = [cpu[i][0] for i in idx]
        for j, i in enumerate(idx):
            a, b, name = cpu[i][0], cpu[i][1], cpu[i][2]
            if name not in spans or i in gone:
                continue
            dev_ns, n = 0, 0
            for k in idx[j + 1:bisect.bisect_left(starts, b, lo=j + 1)]:
                if cpu[k][1] > b:
                    continue
                n += cpu[k][2] == "cudaLaunchKernel"
                if cpu[k][6] == 0:
                    dev_ns += launched.get(cpu[k][5], 0)
            out.append([name, (b - a) * 1e-3, dev_ns * 1e-3, n])
    device = sorted((a, b, name) for a, b, name, _, note in device
                    if name not in spans and not note)
    return dict(device=device, keys=keys, spans=out)


# the host operators of the collectives (phase 16 (a) reads them): c10d's
# dispatcher ops and the process group's own records
COLLECTIVE_OPS = ("c10d::", "nccl:")


def profile_steps(torch, step, *, n_steps: int, device_kernels, spans,
                  top: int = 8, report=()):
    """Device busy share and the kernels that take the device time of
    ``n_steps`` calls of ``step()`` under torch.profiler (CUPTI), whose
    host overhead lowers the busy share a little.  Every name in
    ``device_kernels`` must show on the device.

    ``layer_kinds`` splits the steps by the decode's ranges
    (``transformer.DECODE_SPANS``: pool layers, Mamba2 layers, xLSTM
    super-blocks): host time inside the ranges (under the profiler),
    device time of the kernels launched inside them and those launches,
    a step and a call; each kind must open its ranges ``spans[kind]``
    times a step.  ``report``: names whose device kernels are totalled
    too, where any ran (``reported``; none is required).  ``host_ops``:
    the collectives' host operators (COLLECTIVE_OPS), where any ran, by
    name: calls and host time under the profiler, inclusive and own."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import DECODE_SPANS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    facts = _trace_facts(torch, prof, DECODE_SPANS)
    events = facts["device"]
    if not events:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end_us, by_name = 0.0, -math.inf, {}
    for a, b, name in events:                    # union of the intervals
        a, b = a * 1e-3, b * 1e-3
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
        ours[key]["us_per_call"] = (ours[key]["seconds"] * 1e6
                                    / ours[key]["calls"])
    # by event name: calls, inclusive and own host us (key_averages')
    averages = facts["keys"]
    # kernel launches the host made through cudaLaunchKernel (the count
    # earlier records give; cuBLAS's cudaLaunchKernelExC apart)
    launches = {k: averages.get(k, (0,))[0]
                for k in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
    kinds = {k: dict(calls=0, host_s=0.0, device_s=0.0, launches=0)
             for k in DECODE_SPANS}
    for name, host_us, dev_us, n in facts["spans"]:
        k = kinds[name]
        k["calls"] += 1
        k["host_s"] += host_us * 1e-6
        k["device_s"] += dev_us * 1e-6
        k["launches"] += n
    layer_kinds = {}
    for name, k in kinds.items():
        want = spans.get(name, 0)
        if k["calls"] != want * n_steps:
            raise AssertionError(f"{k['calls']} {name} ranges in "
                                 f"{n_steps} steps, want {want} a step")
        if k["calls"]:
            calls = k["calls"]
            layer_kinds[name] = dict(
                per_step=want,
                host_ms_per_step=k["host_s"] * 1e3 / n_steps,
                device_ms_per_step=k["device_s"] * 1e3 / n_steps,
                launches_per_step=k["launches"] / n_steps,
                host_us_per_call=k["host_s"] * 1e6 / calls,
                device_us_per_call=k["device_s"] * 1e6 / calls,
                launches_per_call=k["launches"] / calls)
    reported = {}
    for key in report:
        hits = [v for name, v in by_name.items() if key in name.lower()]
        reported[key] = dict(seconds=sum(t for t, _ in hits),
                             calls=sum(n for _, n in hits))
    host_ops = {key: dict(calls=n, host_s=total * 1e-6,
                          self_host_s=own * 1e-6)
                for key, (n, total, own) in averages.items()
                if key.startswith(COLLECTIVE_OPS)}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # where the host's share goes: operators by their own (self) host time
    host = sorted(((key, n, own) for key, (n, _, own) in averages.items()
                   if own > 0), key=lambda e: -e[2])[:top]
    return dict(
        decode_steps=n_steps, wall_s=wall_s, device_busy_s=busy_us * 1e-6,
        device_busy_share=busy_us * 1e-6 / wall_s,
        device_s_total=sum(t for t, _ in by_name.values()),
        launches_per_step=launches["cudaLaunchKernel"] / n_steps,
        launches_ex_per_step=launches["cudaLaunchKernelExC"] / n_steps,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        port_kernels=ours, layer_kinds=layer_kinds, reported=reported,
        host_ops=host_ops,
        top_kernels=[dict(name=name[:96], seconds=t, calls=n)
                     for name, (t, n) in ranked],
        top_host_ops=[dict(name=key[:96], self_seconds=own * 1e-6,
                           calls=n) for key, n, own in host])


PROFILED_STEPS = 2


def last_wave_ready(eng, n_steps: int = PROFILED_STEPS) -> bool:
    """Whether the engine's next ``n_steps`` steps are pure decode steps
    at full width that finish its last wave: no request waits, every
    slot holds one, and each has ``n_steps`` tokens left."""
    reqs = eng.slot_req
    return (not eng.queue and all(r is not None for r in reqs)
            and all(r.output_len - r.generated == n_steps
                    for r in reqs))


def profile_in_run(torch, eng, step, *, device_kernels,
                   n_steps: int = PROFILED_STEPS):
    """``profile_steps`` over the serving run's own last ``n_steps``
    decode steps (``step()`` runs one and returns the requests it
    finished), once ``last_wave_ready``: every slot full, no prefill in
    them, and the wave done by their end.  Each model layer kind (pool
    layers, Mamba2 layers, xLSTM super-blocks) must open its range once
    per such layer a step.  Returns the profile's record and the
    finished requests."""
    done = []
    cfg = eng.cfg
    spans = dict(pool_layer=eng.model.n_kv,
                 mamba2_layer=cfg.n_layers if cfg.ssm_state else 0,
                 xlstm_super=sum(seg.n for seg in eng.model.segments
                                 if seg.kind == "xlstm_super"))
    slots = sum(r is not None for r in eng.slot_req)
    t0 = time.perf_counter()
    rec = profile_steps(torch, lambda: done.extend(step()),
                        n_steps=n_steps, device_kernels=device_kernels,
                        spans=spans)
    if len(done) != slots:
        raise AssertionError(f"profiled steps finished {len(done)} of "
                             f"{slots} requests")
    return dict(phase="profile", config=cfg.name, slots=slots, **rec,
                seconds=time.perf_counter() - t0), done


def check_launches(counts, steps: int, layers: int, attn, prompts: int,
                   warmups: int = 0) -> None:
    """Every kernel of the path ran in the serving run: the per-layer
    ones (the gather, the indexer, the path's attention) at least once
    per pool layer (``layers``) per decode step, the gather exactly once
    per pool layer per step (the fetch pipeline's speculation tail rides
    on the demand set's launch) plus at most ``warmups`` launches (the
    prefill warm-up, one a prompt); the scatter kernel's decode write
    exactly once per step (every layer of both pools in one launch) and
    its splice exactly once per admitted prompt (``prompts``).  A model
    with no pool layer (``attn`` None: xLSTM) launches no kernel."""
    if attn is None:
        if layers or any(counts.values()):
            raise AssertionError(f"a model without a pool launched "
                                 f"{counts}")
        return
    for name in ("gather_kv", "indexer_scores", attn):
        if counts[name] < steps * layers:
            raise AssertionError(f"{name}: {counts[name]} launches for "
                                 f"{steps} steps x {layers} layers")
    if counts["gather_kv"] > steps * layers + warmups:
        raise AssertionError(f"gather_kv: {counts['gather_kv']} launches, "
                             f"more than one a layer a step for {steps} "
                             f"steps x {layers} layers and {warmups} "
                             f"warm-ups")
    for form, want in (("rows_at", steps), ("splice", prompts)):
        if counts[f"scatter_kv.{form}"] != want:
            raise AssertionError(f"scatter_kv ({form}): "
                                 f"{counts[f'scatter_kv.{form}']} launches, "
                                 f"want {want}")


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
    eng, counts, summary, tokens, first, prof = serve(
        torch, ops, cfg, slots=spec["slots"], max_ctx=spec["max_ctx"],
        requests=spec["requests"], context=spec["context"],
        output=spec["output"], device_kernels=spec["device_kernels"])
    summary["seconds"] = time.perf_counter() - t0
    summary["run"] = name
    emit(summary)
    check_launches(counts, summary["steps"], summary["pool_layers"],
                   spec["attn"], prompts=spec["requests"])
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


def serve_cli(torch, ops, argv, device_kernels=None):
    """Serve through the port's CLI (``repro_torch.launch.serve.main``);
    returns the engine, its requests, the CLI's printed JSON, the
    kernels' launch counts, each step's wall time (as serve() takes it:
    the CLI runs Engine.run, whose steps a wrapper times and
    synchronizes), the entries the prefill warm-up inserted (so the
    speculation's share of ``prefetched_entries`` is known) and, with
    ``device_kernels``, the profile of the run's last PROFILED_STEPS
    decode steps (``profile_in_run``; their wall times are the
    profile's)."""
    from repro_torch.launch import serve as serve_cli_mod
    from repro_torch.serving.engine import Engine
    step_s, warm, prof = [], [0], []
    plain_step, plain_warm = Engine.step, Engine._warm_apply

    def timed_step(self, *args, **kwargs):
        if device_kernels is not None and not prof and \
                last_wave_ready(self):
            rec, finished = profile_in_run(
                torch, self, lambda: plain_step(self, *args, **kwargs),
                device_kernels=device_kernels)
            prof.append(rec)
            return finished
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
    if device_kernels is not None and not prof:
        raise AssertionError(f"{argv}: no last wave to profile")
    return (eng, reqs, json.loads(text[text.index("{"):]), counts, step_s,
            warm[0], prof[0] if prof else None)


def fetch_pipeline(torch, ops, off_summary, off_tokens):
    """Phase 7: Qwen2-1.5B's serve trace through the port's CLI, held
    against the prefetch-off run of phase 6 (its summary and tokens):
    first with the fetch pipeline, the arbiter and online resizing on,
    with a profile of its last decode steps; then with speculation
    alone, at the grants' full width.  Returns the launch counts of the
    served runs."""
    spec = SERVES["qwen2-1.5b"]
    base = ["--arch", "qwen2-1.5b", "--requests", str(spec["requests"]),
            "--ctx", str(spec["context"]), "--out-len", str(spec["output"]),
            "--slots", str(spec["slots"]), "--max-ctx", str(spec["max_ctx"]),
            "--device", "cuda"]
    total = None
    for run, flags in FETCH_RUNS.items():
        argv = base + flags
        t0 = time.perf_counter()
        eng, reqs, cli_out, counts, step_s, warm_entries, prof = serve_cli(
            torch, ops, argv, device_kernels=(
                spec["device_kernels"] if run == "prefetch_arbiter_resize"
                else None))
        run_s = time.perf_counter() - t0 - (
            prof["seconds"] - prof["wall_s"] if prof else 0.0)
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
        check_launches(counts, steps, layers, "sparse_attn_gqa",
                       prompts=len(reqs), warmups=len(reqs))
        if "--resize-interval" in flags and not st.resizes:
            raise AssertionError(f"{run}: no resize in {steps} steps")
        if "--arbiter" not in flags and 10 * spec_entries < spec_lanes:
            # ungated speculation must do real work: at least one in ten
            # of its lanes inserted an entry
            raise AssertionError(f"{run}: {spec_entries} speculated entries "
                                 f"in {spec_lanes} lanes")
        if prof:
            prof["phase"] = "profile_fetch_pipeline"
            emit(prof)
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
        total = counts if total is None else {
            k: total[k] + n for k, n in counts.items()}
    return total


def cli_defaults(torch, ops, arch: str):
    """``python -m repro_torch.launch.serve --arch <arch>`` at the CLI's
    defaults (on the card; 4 slots, max_ctx 96, 8 requests of 48 tokens,
    8 output tokens) through its ``main``: every request served, every
    kernel of the path on every pool layer of every decode step (none
    without a pool).  Returns the launch counts."""
    argv = ["--arch", arch]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, cli_out, counts, step_s, _, _ = serve_cli(torch, ops, argv)
    st = eng.stats
    emit(dict(phase="cli", argv=argv, config=eng.cfg.name,
              n_layers=eng.cfg.n_layers, pool_layers=eng.model.n_kv,
              slots=eng.slots,
              requests=len(reqs), tokens=st.tokens, steps=st.steps,
              wall_s_per_decode_step_median=sorted(step_s)[len(step_s) // 2],
              max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
              launches=counts, cli=cli_out,
              seconds=time.perf_counter() - t0))
    if cli_out["n_done"] != len(reqs) or any(
            len(r.out_tokens) != r.output_len for r in reqs):
        raise AssertionError(f"the CLI served {cli_out['n_done']} of "
                             f"{len(reqs)} requests")
    check_launches(counts, st.steps, eng.model.n_kv,
                   "sparse_attn_gqa" if eng.model.n_kv else None,
                   prompts=len(reqs))
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


# ---------------------------------------------------------------------------
# phase 4 (continued): the encoder-decoder and one training step, small
# ---------------------------------------------------------------------------


def small_check_encdec(torch, cfg, *, mode: str, frames: int = 64,
                       steps: int = 4, devices=("cpu", "cuda")):
    """Reduced Whisper (``cfg``: small_config's widened indexer) on the
    card against the same weights on the CPU: 2 requests of ``frames``
    encoder frames (lengths ``frames`` and ``frames - 24``), ``steps``
    teacher-forced decode steps under an injected score-independent top-k
    (``sac``) or over the whole pool (``dense``).  Per-request logits of
    every step and each lane of ``self_kv`` within SMALL_TOL, ``dec_len``
    exact; the e4m3-weights control must exceed SMALL_TOL.  Returns the
    worst error and the control's."""
    from repro_torch.models.model import build_model
    K = 16

    def topk(scores, cache_len):
        j = torch.arange(K, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        pos = (j * 7 + 3) % torch.clamp(t, min=1)
        return pos.to(torch.int32), (j < t) & (j % 5 != 3)

    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, frames, cfg.d_model), generator=gen).bfloat16()
    toks = torch.randint(0, cfg.vocab, (steps, 2), generator=gen,
                         dtype=torch.int32)
    runs, params = [], None
    for dev, degrade in [(d, False) for d in devices] + [(devices[1], True)]:
        m = build_model(cfg, mode=mode, topk_fn=topk, device=dev)
        if params is None:
            params = m.init(torch.Generator(device=dev).manual_seed(1))
        p = _to(params, dev)
        if degrade:
            p = e4m3_weights(torch, p)
        st, _ = m.prefill(p, x.to(dev), lengths=torch.tensor(
            [frames, frames - 24], dtype=torch.int32, device=dev))
        logits = []
        for step in range(steps):
            st, lg = m.decode(p, st, toks[step].to(dev))
            logits.append(lg.float().cpu())
        if st["dec_len"].tolist() != [steps, steps]:
            raise AssertionError(f"dec_len {st['dec_len'].tolist()}")
        runs.append(dict(logits=logits, pool=st["self_kv"].float().cpu(),
                         rec=[]))
    worst = max(_rel_l2(got, want) for want, got in
                _run_pairs(runs[0], runs[1]))
    if not all(torch.isfinite(t).all() for t in runs[1]["logits"]):
        raise AssertionError("non-finite logits on the card")
    if worst > SMALL_TOL:
        raise AssertionError(f"{cfg.name} ({mode}): card vs CPU relative "
                             f"L2 error {worst:.4f} > {SMALL_TOL}")
    control = max(_rel_l2(got, want) for want, got in
                  _run_pairs(runs[0], runs[2]))
    if control <= SMALL_TOL:
        raise AssertionError(f"{cfg.name} ({mode}): the e4m3 control's "
                             f"error {control:.4f} is within {SMALL_TOL}")
    return worst, control


def train_small_check(torch, cfg, *, batch: int = 2, seq: int = 32,
                      devices=("cpu", "cuda")):
    """One training step's loss and gradients (``make_grad_fn``: the
    forward under autograd with activation checkpointing, no kernel of
    the port) of reduced ``cfg`` on the card against the CPU, on the same
    weights and synthetic batch (Whisper: ``seq`` frames and 448 decoder
    tokens): the loss and every gradient leaf within SMALL_TOL relative
    L2 (a leaf the loss does not use, the indexer's, must be zero on
    both); the e4m3-weights control must exceed SMALL_TOL.  Returns the
    worst error, the control's, the loss and the leaves compared."""
    from repro_torch.models.model import build_model
    from repro_torch.training.data import synthetic_batch
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import make_grad_fn

    data = synthetic_batch(cfg, batch, seq, seed=3)
    runs, params = [], None
    for dev, degrade in [(d, False) for d in devices] + [(devices[1], True)]:
        m = build_model(cfg, device=dev)
        if params is None:
            params = m.init(torch.Generator(device=dev).manual_seed(1))
        p = _to(params, dev)
        if degrade:
            p = e4m3_weights(torch, p)
        metrics, grads = make_grad_fn(m)(
            p, {k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        runs.append([metrics["loss"].float().cpu().reshape(1)]
                    + [g.float().cpu() for g in tree_leaves(grads)])
    want, got, control = runs
    worst, ctrl, used = 0.0, 0.0, 0
    for w, g, c in zip(want, got, control):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{cfg.name}: non-finite gradients")
        if not w.any():
            if g.any():
                raise AssertionError(f"{cfg.name}: a gradient zero on the "
                                     "CPU is not zero on the card")
            continue
        used += 1
        worst = max(worst, _rel_l2(g, w))
        ctrl = max(ctrl, _rel_l2(c, w))
    if worst > SMALL_TOL:
        raise AssertionError(f"{cfg.name} training step: card vs CPU "
                             f"relative L2 error {worst:.4f} > {SMALL_TOL}")
    if ctrl <= SMALL_TOL:
        raise AssertionError(f"{cfg.name} training step: the e4m3 "
                             f"control's error {ctrl:.4f} is within "
                             f"{SMALL_TOL}")
    return worst, ctrl, float(want[0][0]), used


# ---------------------------------------------------------------------------
# phase 14: Whisper-small served at full width and depth
# ---------------------------------------------------------------------------

# 8 requests of 32,768 frames (decode_32k's context, longer than the
# top-k of 2048, so the selection is sparse), 64 decode steps
WHISPER = dict(arch="whisper-small", requests=8, frames=32768, steps=64)


def serve_whisper(torch, ops, cfg=None, *, device="cuda", **sizes):
    """Whisper-small at full width and depth (12 encoder + 12 decoder
    layers, d 768, 12 heads of 64, vocab 51,865, indexer 4 x 64, top-k
    2048; random bf16 weights from seed 0) through the model facade, as
    the reference serves it (its engine and CLI take no encoder-decoder):
    each request's random frames (``torch.Generator`` seed 0) prefilled
    alone (``prefill``) and spliced into lane b of an 8-lane serve state
    (one splice launch a request), then ``steps`` greedy decode steps of
    all 8.  Every step must launch the indexer 12 times, the gather 12,
    the GQA attention 24 (cross over the 2048 fetched lanes and self over
    449) and the decode write once; every logit finite; ``dec_len`` =
    steps and ``self_kv`` written in rows [0, steps) only.  Then a
    profile of two more decode steps.  Returns the decode steps'
    launch counts.  (``cfg``, ``device`` and ``sizes`` -- requests,
    frames, steps -- let the same phase run reduced on the CPU as a
    rehearsal, with no profile.)"""
    from repro_torch.configs import get_config
    from repro_torch.core.pool import pool_splice_lane
    from repro_torch.models.model import build_model
    cfg = cfg or get_config(WHISPER["arch"])
    sizes = dict(WHISPER, **sizes)
    B, S, steps = sizes["requests"], sizes["frames"], sizes["steps"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = model.init_serve_state(B, S)
    pools = ["kv_pool", "idx_pool"]
    g = torch.Generator(device=device).manual_seed(0)
    prefill_s = []
    for b in range(B):
        frames = torch.randn((1, S, cfg.d_model), generator=g,
                             device=device).bfloat16()
        sync()
        t1 = time.perf_counter()
        st, _ = model.prefill(params, frames)
        pool_splice_lane([state[k] for k in pools], [st[k] for k in pools],
                         lane=b)
        state["cache_len"][b] = st["cache_len"][0]
        sync()
        prefill_s.append(time.perf_counter() - t1)
        del st, frames
    tok = torch.arange(B, dtype=torch.int32, device=device)
    ops.reset_launch_counts()
    step_s, nonfinite = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, logits = model.decode(params, state, tok)
        tok = logits.argmax(-1).to(torch.int32)
        sync()
        step_s.append(time.perf_counter() - t1)
        nonfinite.append((~torch.isfinite(logits)).sum())
    counts = ops.launch_counts()
    n_nonfinite = int(sum(n.item() for n in nonfinite))
    if n_nonfinite or tuple(logits.shape) != (B, cfg.vocab):
        raise AssertionError(f"whisper: {n_nonfinite} non-finite logits of "
                             f"shape {tuple(logits.shape)}")
    L = cfg.n_layers
    want = {"indexer_scores": L * steps, "gather_kv": L * steps,
            "sparse_attn_gqa": 2 * L * steps, "scatter_kv.rows_at": steps}
    if cuda and (any(counts[k] != n for k, n in want.items())
                 or counts["sparse_attn"]):
        raise AssertionError(f"whisper launches {counts}, want {want} for "
                             f"{steps} steps")
    if state["dec_len"].tolist() != [steps] * B:
        raise AssertionError(f"dec_len {state['dec_len'].tolist()}")
    written = state["self_kv"].flatten(3).abs().amax(-1) > 0  # [L, B, 448]
    if not written[:, :, :steps].all() or written[:, :, steps:].any():
        raise AssertionError("self_kv rows written outside [0, steps)")
    step_sorted = sorted(step_s)
    emit(dict(phase="serve", run="whisper-small", config=(
        f"{cfg.name} (n_enc_layers={cfg.n_enc_layers}, n_layers="
        f"{cfg.n_layers}, d_model={cfg.d_model})"), requests=B, frames=S,
        decode_steps=steps, topk=cfg.sac.topk,
        prefill_s_per_request=prefill_s,
        wall_s_per_decode_step_median=step_sorted[len(step_sorted) // 2],
        wall_s_per_step_max=step_sorted[-1],
        max_memory_allocated_bytes=(torch.cuda.max_memory_allocated()
                                    if cuda else None),
        pool_bytes={k: state[k].nbytes
                    for k in ("kv_pool", "idx_pool", "self_kv")},
        logits_finite=True, launches=counts,
        launches_per_step={k: counts[k] / steps for k in want},
        seconds=time.perf_counter() - t0))
    if not cuda:
        return counts
    t0 = time.perf_counter()

    def step():
        nonlocal state, tok
        state, logits = model.decode(params, state, tok)
        tok = logits.argmax(-1).to(torch.int32)
    prof = profile_steps(torch, step, n_steps=2,
                         device_kernels=GQA_DEVICE_KERNELS,
                         spans=dict(pool_layer=cfg.n_layers))
    emit(dict(phase="profile", run="whisper-small", config=cfg.name,
              slots=B, seconds=time.perf_counter() - t0, **prof))
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 15: training Qwen2-1.5B at full width and depth, and its resume
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "qwen2-1.5b", "--batch", "8", "--seq", "512",
              "--steps", "20", "--ckpt-every", "10"]
# the resumed run's step-20 loss against the straight run's: not bit-exact
# on the card (the embedding's backward adds with atomics)
RESUME_REL_TOL = 1e-2


def train_phase(torch, ops, argv=TRAIN_ARGV, device="cuda"):
    """``python -m repro_torch.launch.train`` (TRAIN_ARGV: Qwen2-1.5B at
    full width and depth, 8 x 512 tokens a step, 20 steps, a checkpoint
    every 10) through its ``main`` into a temporary directory: every loss
    finite, the last 5 steps' mean below the first 5's, no kernel of the
    port launched (training runs the plain layers).  Then ``--resume``
    from the step-10 snapshot alone: the restored tree equal to the saved
    one bit for bit, steps 10-19 run again, the step-20 loss within
    RESUME_REL_TOL of the straight run's.  Reports s/step, tokens/s, peak
    memory and each checkpoint's bytes and seconds.  (``argv`` with
    ``--reduced`` and ``device`` "cpu" rehearse the phase on the CPU.)"""
    import os
    import shutil
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import tree_leaves

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    argv = argv + ["--device", device]
    tokens = (int(argv[argv.index("--batch") + 1])
              * int(argv[argv.index("--seq") + 1]))
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    straight = os.path.join(root, "straight")
    resumed = os.path.join(root, "resumed")
    snap, saves, restores = {}, [], []
    save, restore = ckpt.save, ckpt.restore

    def timed_save(directory, step, tree, extras=None):
        sync()
        t = time.perf_counter()
        path = save(directory, step, tree, extras)
        leaves = tree_leaves(tree)
        saves.append(dict(step=step, seconds=time.perf_counter() - t,
                          bytes=sum(x.nbytes for x in leaves)))
        if directory == straight and step == 10:
            snap["leaves"] = [x.clone() for x in leaves]
        return path

    def checked_restore(directory, like, **kw):
        t = time.perf_counter()
        tree, step, extras = restore(directory, like, **kw)
        sync()
        got = tree_leaves(tree)
        equal = len(got) == len(snap["leaves"]) and all(
            a.dtype == b.dtype and _equal_bits(torch, a, b)
            for a, b in zip(got, snap.pop("leaves")))
        restores.append(dict(step=step, seconds=time.perf_counter() - t,
                             equal_to_saved=equal))
        return tree, step, extras

    def run(argv):
        out = io.StringIO()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, _, hist = launch_train.main(argv)
        sync()
        wall = time.perf_counter() - t
        if any(ops.launch_counts().values()):
            raise AssertionError(f"training launched {ops.launch_counts()}")
        secs = sorted(h["seconds"] for h in hist[1:])
        return dict(argv=argv, steps=len(hist), wall_s=wall,
                    s_per_step_median=secs[len(secs) // 2],
                    first_step_s=hist[0]["seconds"],
                    tokens_per_s=tokens / secs[len(secs) // 2],
                    peak_memory_bytes=(torch.cuda.max_memory_allocated()
                                       if cuda else None),
                    losses=[h["loss"] for h in hist],
                    grad_norms=[h["grad_norm"] for h in hist],
                    log=out.getvalue().splitlines()), hist

    ckpt.save, ckpt.restore = timed_save, checked_restore
    try:
        free = shutil.disk_usage(root).free
        first, hist = run(argv + ["--ckpt-dir", straight])
        losses = first["losses"]
        if not all(math.isfinite(x) for x in losses) or len(losses) != 20:
            raise AssertionError(f"training losses {losses}")
        if not sum(losses[-5:]) < sum(losses[:5]):
            raise AssertionError(f"the loss did not fall: {losses}")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        os.makedirs(resumed)
        os.rename(os.path.join(straight, "step_000000010"),
                  os.path.join(resumed, "step_000000010"))
        shutil.rmtree(straight)
        second, hist2 = run(argv + ["--ckpt-dir", resumed, "--resume"])
        if "[train] resumed from step 10" not in second["log"]:
            raise AssertionError(f"no resume: {second['log'][:3]}")
        if len(restores) != 1 or not restores[0]["equal_to_saved"]:
            raise AssertionError(f"the restored tree differs: {restores}")
        if [h["step"] for h in hist2] != list(range(10, 20)):
            raise AssertionError(f"resumed steps {[h['step'] for h in hist2]}")
        rel = abs(hist2[-1]["loss"] - hist[-1]["loss"]) / abs(hist[-1]["loss"])
        if rel > RESUME_REL_TOL:
            raise AssertionError(f"resumed step-20 loss {hist2[-1]['loss']} "
                                 f"vs {hist[-1]['loss']}")
    finally:
        ckpt.save, ckpt.restore = save, restore
        shutil.rmtree(root, ignore_errors=True)
    emit(dict(phase="train", arch=argv[argv.index("--arch") + 1],
              straight=first, resumed=second, checkpoints=saves,
              restores=restores, disk_free_bytes=free,
              resumed_step20_loss_rel_diff=rel,
              resumed_step10_loss_equal=hist2[0]["loss"] == hist[10]["loss"],
              tolerance=RESUME_REL_TOL))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3 (continued): the row movers' shard forms
# ---------------------------------------------------------------------------

# the sharded pools (name, L, B, S, d, d_idx or None, model ranks, rank,
# top-k, forms: "g" the gather, "w" the decode write, "s" the splice),
# each case one rank's slice.  First the shapes phase 16 hands the
# kernels at Qwen2-1.5B's full width: (b) a data slice's 4 lanes over 2
# model ranks, each rank; (a) and (d) 8 lanes on one rank, base 0; (a)
# extended's second gather, the speculation tail's 512 rows.  Then two
# shapes no path on one card runs, those of a 4-card host: Qwen2-1.5B's
# pool over 4 model ranks and DeepSeek-V3.2's (entries of 576) over 2.
# ``shard_shapes`` adds phase 16's other runs, read from their serve
# states.
SHARD_SHAPES = (
    ("qwen2-1.5b/2 (16b)", 28, 4, 8256, 512, 64, 2, 1, 2048, "gws"),
    ("qwen2-1.5b/2 (16b)", 28, 4, 8256, 512, 64, 2, 0, 2048, "gws"),
    ("qwen2-1.5b/1 (16a, 16d)", 28, 8, 8256, 512, 64, 1, 0, 2048, "gws"),
    ("qwen2-1.5b/1 tail (16a ext)", 28, 8, 8256, 512, 64, 1, 0, 512, "g"),
    ("qwen2-1.5b/4", 28, 8, 8256, 512, 64, 4, 1, 2048, "gws"),
    ("deepseek-v32/2", 2, 4, 4160, 576, 128, 2, 1, 2048, "gws"))


def shard_shapes(torch):
    """SHARD_SHAPES, then the pools of phase 16's other runs, each read
    from the run's serve state (``init_serve_state`` on the ``meta``
    device) with the forms the run launches (SAC: the gather; a decoder's
    pool: the decode write; every sharded state: the splice): (e)
    Zamba2-7B (4 lanes of 8256, one rank); (f) Whisper-small's cross
    pools (4 lanes of 32,768 frames, one rank; in ``dense`` mode the kv
    pool alone, spliced, never gathered); (c) SHARDED_SMALL's small
    configs (2 lanes, pool 64, top-k 16 over 2 model ranks, each rank);
    (g) each FAMILY_SMALL case (one lane, pool 64, over 2 model ranks,
    each rank; top-k 16, and the hierarchical top-k's speculation tail
    of the small config's width)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    out = list(SHARD_SHAPES)

    def add(name, cfg, mode, B, S, n, ks):
        st = build_model(cfg, mode=mode, device="meta").init_serve_state(
            B, S, device_buffer=0)
        L, _, _, d = st["kv_pool"].shape
        di = st["idx_pool"].shape[-1] if "idx_pool" in st else None
        forms = (("g" if mode == "sac" else "")
                 + ("" if cfg.enc_dec else "w") + "s")
        for rank in range(n):
            out.append((name, L, B, S, d, di, n, rank, ks[0], forms))
            out.extend((f"{name} tail", L, B, S, d, di, n, rank, w, "g")
                       for w in ks[1:])
    spec = SHARDED_FAMILIES["zamba"]
    cfg = get_config(spec["arch"])
    add(f"{cfg.name}/1 (16e)", cfg, "sac", spec["requests"],
        SHARDED["max_ctx"], 1, [cfg.sac.topk])
    spec = SHARDED_FAMILIES["whisper"]
    cfg = get_config(spec["arch"])
    for mode in ("sac", "dense"):
        add(f"{cfg.name}/1 (16f {mode})", cfg, mode, spec["requests"],
            spec["frames"], 1, [cfg.sac.topk])
    for name in SHARDED_SMALL:
        add(f"{name} small/2 (16c)", small_config(name), "sac", 2, 64, 2,
            [16])
    for case, kw in FAMILY_SMALL.items():
        cfg = small_config(kw["arch"])
        add(f"{case} small/2 (16g)", cfg, kw["mode"], 1, 64, 2,
            [16] + ([cfg.sac.prefetch_width] if kw.get("hier_tail")
                    else []))
    return tuple(out)


def check_shard_forms(torch, ref, gather_mod, scatter_mod):
    """The three shard forms at ``shard_shapes``' shapes (each the forms
    phase 16 gives it) in bf16 and with e4m3 entries, bit-exact against
    their plain versions (``ref``), each timed per call and batched,
    beside its plain version, one library call for the same result and
    its bound (the bytes this case's data moves: only the rows the slice
    holds are read or written):

    - the gather's shard form (top-k rows a request, global indices over
      the whole pool, about 1/ranks of them in the slice; the batched run
      cycles through copies of the slice so each call reads from HBM),
      beside the row form on the same slice at equal rows (``ms_rows``:
      every row read) and ``torch.where`` over ``torch.gather``;
    - the decode write's shard form (the run's pools: the kv pool and,
      where it has one, the indexer pool; every layer, one launch;
      positions at the slice's edges and past the pool), beside
      ``index_copy_`` of the rows the slice owns;
    - the splice's shard form (a serve state's whole pools [L, B, S, d]
      into the slice, the run's pools), beside ``copy_``; also checked (not
      timed) with a prompt that ends inside the last slice (zeros past
      it).

    Returns the three records (the first shape, bf16, in each record's
    own fields; every case in ``shapes``)."""
    from repro_torch.core.pool import E4M3
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    recs = {}
    gathers, writes, splices = [], [], []
    for name, L, B, S, d, di, n, rank, k, forms in shard_shapes(torch):
        S_l = S // n
        base = rank * S_l
        idx_pool = [] if di is None else [(L, B, S_l, di)]
        for dtype in (torch.bfloat16, E4M3) if "g" in forms else ():
            kv = _rand_pool(torch, g, (B, S_l, d), dtype)
            idx = torch.randint(0, S, (B, k), generator=g, device=dev,
                                dtype=torch.int32)
            idx[:, :4] = torch.tensor([base - 1, base, base + S_l - 1,
                                       base + S_l], device=dev)
            gathers.append(_gather_shard_case(torch, ref, gather_mod, name,
                                              kv, idx, base))
            del kv
        for dtype in (torch.bfloat16, E4M3) if "w" in forms else ():
            pools = [_rand_pool(torch, g, shape, dt) for shape, dt in
                     [((L, B, S_l, d), dtype)]
                     + [(sh, torch.bfloat16) for sh in idx_pool]]
            writes.append(_write_shard_case(torch, ref, scatter_mod, name,
                                            pools, base, S))
            del pools
        for dtype in (torch.bfloat16, E4M3) if "s" in forms else ():
            srcs = [_rand_pool(torch, g, shape, dt) for shape, dt in
                    [((L, B, S, d), dtype)]
                    + [((L, B, S, di), torch.bfloat16)] * bool(idx_pool)]
            splices.append(_splice_shard_case(torch, ref, scatter_mod, name,
                                              srcs, base, S_l))
            # a prompt that ends inside the last slice: the serve
            # trace's 8192 tokens in a pool of 8256; small, 40 of 64
            T = S - 64 if S > 128 else S * 5 // 8
            tail = [x[:, :, :T].contiguous() for x in srcs]
            _splice_shard_case(torch, ref, scatter_mod, name, tail,
                               (n - 1) * S_l, S_l, timed=False)
            del srcs, tail
        torch.cuda.empty_cache()
    for key, cases in (("gather_kv_shard", gathers),
                       ("scatter_kv_rows_at_shard", writes),
                       ("scatter_kv_splice_shard", splices)):
        head = dict(cases[0])
        head["bound"] = (head.pop("bound_ms"), head.pop("bound_by"))
        head["shapes"] = cases
        recs[key] = head
    return recs


def _gather_shard_case(torch, ref, mod, name, kv, idx, base):
    from repro_torch.kernels import cost
    want = torch.stack([ref.gather_kv_shard_ref(kv[b].view(torch.uint8),
                                                idx[b], base)
                        for b in range(kv.shape[0])])
    got = mod.gather_kv_shard([(kv, idx)], base)[0]
    if not _equal_bits(torch, got, want):
        raise AssertionError(f"gather_kv_shard differs from its plain "
                             f"version at the {name} shape ({kv.dtype})")
    del got, want
    B, S_l, d = kv.shape
    w, n = d * kv.element_size(), idx.numel()
    inside = (idx >= base) & (idx < base + S_l)
    n_in = int(inside.sum())
    bound, by = cost.bound_ms(cost.rows(n, w, n_in))
    copies = cold_copies([(kv, idx)], n_in * w)
    local = torch.clamp(idx - base, 0, S_l - 1)
    u8 = kv.view(torch.uint8)
    gidx = local.long()[..., None].expand(-1, -1, w)
    keep = inside[..., None]

    def library(kv_u8):
        return torch.where(keep, torch.gather(kv_u8, 1, gidx), 0)
    rec = dict(shape=name, form="gather_shard", dtype=str(kv.dtype),
               kv=list(kv.shape), idx=list(idx.shape), base=base,
               rows_in_slice=n_in, max_abs_err=0.0,
               l2="cold" if copies else "warm", bound_ms=bound, bound_by=by,
               plain_ms=cuda_time_ms(lambda: [ref.gather_kv_shard_ref(
                   u8[b], idx[b], base) for b in range(B)]))
    rec.update(both_times(
        lambda: mod.gather_kv_shard([(kv, idx)], base),
        copies and [lambda c=c: mod.gather_kv_shard(c, base)
                    for c in copies]))
    rows = both_times(
        lambda: mod.gather_kv_many([(kv, local)]),
        copies and [lambda c=c: mod.gather_kv_many([(c[0][0], local)])
                    for c in copies])
    rec["ms_rows"], rec["ms_batched_rows"] = rows["ms"], rows["ms_batched"]
    lib = both_times(lambda: library(u8), copies and [
        lambda c=c: library(c[0][0].view(torch.uint8)) for c in copies])
    rec["library_ms"], rec["library_ms_batched"] = lib["ms"], \
        lib["ms_batched"]
    return rec


def _write_shard_case(torch, ref, mod, name, pools, base, S):
    from repro_torch.kernels import cost
    dev = pools[0].device
    L, B, S_l = pools[0].shape[:3]
    g = torch.Generator(device=dev).manual_seed(S_l)
    entries = [_rand_pool(torch, g, (L, B, p.shape[-1]), p.dtype)
               for p in pools]
    # the slice's first row first: a lane of one writes into the slice
    edges = [base, base - 1, base + S_l - 1, base + S_l, S + 3, -1]
    pos = torch.randint(0, S, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[:min(B, len(edges))] = torch.tensor(edges[:B], device=dev)
    want = [p.clone() for p in pools]
    for p, e in zip(want, entries):
        ref.write_rows_at_ref(p.view(torch.uint8), e.view(torch.uint8), pos,
                              base, S)
    mod.write_rows_at_shard(pools, entries, pos, base, S)
    if not all(_equal_bits(torch, a, b) for a, b in zip(pools, want)):
        raise AssertionError(f"write_rows_at_shard differs from its plain "
                             f"version at the {name} shape "
                             f"({pools[0].dtype})")
    del want
    local = pos.long().clamp(0, S - 1) - base
    owned = (local >= 0) & (local < S_l)
    lanes = torch.arange(L * B, device=dev).reshape(L, B)
    rows = (lanes * S_l + local.clamp(0, S_l - 1))[:, owned].reshape(-1)
    flat = [p.view(-1, p.shape[-1]).view(torch.uint8) for p in pools]
    e_own = [e[:, owned].reshape(-1, e.shape[-1]).view(torch.uint8)
             for e in entries]
    n_own = rows.shape[0]
    bound, by = cost.bound_ms(cost.write_rows_at(
        B, [(L, e.shape[-1] * e.element_size()) for e in entries],
        lanes=int(owned.sum())))
    rec = dict(shape=name, form="decode_write_shard",
               dtype=str(pools[0].dtype), pools=[list(p.shape) for p in pools],
               base=base, seq_len=S, rows=len(pools) * n_own,
               max_abs_err=0.0, l2="warm", bound_ms=bound, bound_by=by,
               plain_ms=cuda_time_ms(lambda: [ref.write_rows_at_ref(
                   p.view(torch.uint8), e.view(torch.uint8), pos, base, S)
                   for p, e in zip(pools, entries)]),
               **both_times(lambda: mod.write_rows_at_shard(
                   pools, entries, pos, base, S)))
    lib = both_times(lambda: [f.index_copy_(0, rows, e)
                              for f, e in zip(flat, e_own)])
    rec["library_ms"], rec["library_ms_batched"] = lib["ms"], \
        lib["ms_batched"]
    return rec


def _splice_shard_case(torch, ref, mod, name, srcs, base, S_l, timed=True):
    from repro_torch.kernels import cost
    L, B, T = srcs[0].shape[:3]
    pools = [torch.full((L, B, S_l, s.shape[-1] * s.element_size()), 7,
                        dtype=torch.uint8, device=s.device).view(s.dtype)
             for s in srcs]
    want = [p.clone() for p in pools]
    for p, s in zip(want, srcs):
        ref.splice_ref(p.view(torch.uint8), s.view(torch.uint8),
                       zero_tail=True, src_row0=base)
    mod.splice_shard(pools, srcs, base)
    if not all(_equal_bits(torch, a, b) for a, b in zip(pools, want)):
        raise AssertionError(f"splice_shard differs from its plain version "
                             f"at the {name} shape, base {base}, {T} rows "
                             f"({srcs[0].dtype})")
    del want
    if not timed:
        return None
    n = min(max(T - base, 0), S_l)
    bound, by = cost.bound_ms(cost.splice_pools(pools, srcs, zero_tail=True,
                                                src_row0=base))

    def library():
        for p, s in zip(pools, srcs):
            p.view(torch.uint8)[:, :, :n].copy_(
                s.view(torch.uint8)[:, :, base:base + n])
            p.view(torch.uint8)[:, :, n:].zero_()
    rec = dict(shape=name, form="splice_shard", dtype=str(srcs[0].dtype),
               srcs=[list(s.shape) for s in srcs], base=base, rows=n,
               max_abs_err=0.0, l2="cold", bound_ms=bound, bound_by=by,
               plain_ms=cuda_time_ms(lambda: [ref.splice_ref(
                   p.view(torch.uint8), s.view(torch.uint8), zero_tail=True,
                   src_row0=base) for p, s in zip(pools, srcs)],
                   iters=3, warmup=1),
               **both_times(lambda: mod.splice_shard(pools, srcs, base)))
    lib = both_times(library)
    rec["library_ms"], rec["library_ms_batched"] = lib["ms"], \
        lib["ms_batched"]
    return rec


# ---------------------------------------------------------------------------
# phase 16: the KV pool sharded over a torch.distributed mesh
# ---------------------------------------------------------------------------

# Qwen2-1.5B at full width and depth: 8 requests of 8192 tokens (the
# serve phases' trace), pool S = 8256, hot tier 6144, top-k 2048; phase
# (a) decodes 16 steps, phase (b) 4 steps at mesh (data 2, model 2)
SHARDED = dict(arch="qwen2-1.5b", requests=8, context=8192, max_ctx=8256,
               steps_nccl=16, steps_gloo=4, mesh_gloo=(2, 2))
# the small sharded checks at mesh (data 1, model 2): MLA and windowed
SHARDED_SMALL = ("deepseek-v32", "gemma3-12b")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _sharded_prompts(cfg):
    from repro_torch.serving.request import sharegpt_trace
    reqs = sharegpt_trace(SHARDED["requests"],
                          context_len=SHARDED["context"], output_len=16,
                          ctx_jitter=0.0, seed=0, vocab=cfg.vocab)
    return [r.prompt_tokens for r in reqs]


def _sharded_state(torch, m, params, prompts, lanes):
    """A serve state of ``lanes`` (pool S = max_ctx, the config's hot
    tier): each prompt prefilled alone and spliced into its lane, as the
    engine admits it; returns it and each lane's first token (the
    prefill's greedy pick)."""
    from repro_torch.core.pool import pool_splice_lane
    state = m.init_serve_state(len(lanes), SHARDED["max_ctx"],
                               device_buffer=m.cfg.sac.device_buffer_size)
    first = []
    for i, lane in enumerate(lanes):
        toks = torch.as_tensor(prompts[lane], dtype=torch.int32,
                               device=m.device)[None]
        st, logits = m.prefill(params, toks)
        pool_splice_lane([state["kv_pool"], state["idx_pool"]],
                         [st["kv_pool"], st["idx_pool"]], i)
        state["cache_len"][i] = toks.shape[1]
        first.append(logits.argmax(-1))
        del st
    return state, torch.cat(first).to(torch.int32)


def _decode_steps(torch, m, params, state, tok, n: int):
    """``n`` greedy decode steps; the logits and tokens of each (on the
    host) and each step's wall time (ending in a synchronize)."""
    logits, toks, step_s = [], [], []
    sync = (torch.cuda.synchronize if m.device.type == "cuda"
            else (lambda: None))
    for _ in range(n):
        t1 = time.perf_counter()
        state, lg = m.decode(params, state, tok)
        sync()
        step_s.append(time.perf_counter() - t1)
        tok = lg.argmax(-1).to(torch.int32)
        logits.append(lg.cpu())
        toks.append(tok.cpu())
    return state, tok, logits, toks, step_s


def _state_lanes(torch, state, lanes, segments=()):
    """A copy of a serve state's ``lanes`` (the hot tier's and the
    per-layer counters' lane axis is 1; a Mamba2 state ``rec_{si}``'s is
    2 in a ``zamba_super`` segment, [n, a, B, ...], and 1 in a
    ``mamba_tail``, [n, B, ...]: ``segments``, the model's)."""
    from repro_torch.core.hisparse import BufferState
    idx = torch.as_tensor(lanes, device=state["cache_len"].device)
    out = {}
    for k, v in state.items():
        if k == "hot_buf":
            out[k] = BufferState(*(t.index_select(1, idx) for t in v))
        elif k.startswith("rec_"):
            kind = segments[int(k[4:])].kind
            if kind not in ("zamba_super", "mamba_tail"):
                raise ValueError(f"no lane copy of a {kind} state")
            axis = 2 if kind == "zamba_super" else 1
            out[k] = tuple(t.index_select(axis, idx) for t in v)
        else:
            out[k] = v.index_select(1 if v.dim() > 1 else 0, idx)
    return out


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _collective_facts(torch, dist, group):
    """What a backend's collectives do with the pool's dtypes, on CUDA
    tensors (reported, not gated: the port's fetch needs neither, as it
    all-reduces bytes with MAX): whether a float8 sum runs, and whether a
    bf16 sum keeps a -0 (rank 0 gives -0, the others +0).  Every rank of
    ``group`` calls it."""
    facts = {}
    f8 = torch.ones(4, device="cuda").to(torch.float8_e4m3fn)
    try:
        dist.all_reduce(f8, group=group)
        facts["float8_sum"] = "ran"
    except RuntimeError as e:              # the backend refuses the dtype
        facts["float8_sum"] = f"refused: {str(e)[:80]}"
    zero = -0.0 if dist.get_rank(group) == 0 else 0.0
    b = torch.tensor([zero], dtype=torch.bfloat16, device="cuda")
    dist.all_reduce(b, group=group)
    facts["bf16_sum_keeps_minus_zero"] = bool(torch.signbit(b).item())
    return facts


def sharded_nccl(torch, ops, families=False, then=None):
    """Phase 16 (a): Qwen2-1.5B at full width and depth over a world of
    one NCCL rank, mesh (1, 1), through the real collectives (the scores'
    all-gather and the fetch's byte all-reduce): 16 decode steps beside
    the unsharded model on the same weights and serve state; tokens and
    logits bit-equal, the hot tier (page table, slots, LRU clocks,
    ``pf_*``) and the hit counts equal; every layer of every step through
    the gather's and the decode write's shard forms; a profile of two
    more steps of each (NCCL's kernels, where any ran, reported), all by
    ``_twin_runs``.  Then, for phase (b), each data
    slice's 4 lanes alone, unsharded, 4 steps (the batch of a GEMM
    changes its bits on the card).  Returns the record, phase (b)'s
    references and the shard forms' launches.  In the same NCCL world it
    then runs (a) extended, (d), (e) and (f), and with ``families`` phase
    21 (a) (the third runs of (e) and (f), ``families_world_of_one``);
    the launches returned are a list, one dict each run.  ``then()``
    runs once (e) has left the card (the script starts the gloo ranks of
    (b), (c) and (g) there, to wait for their turn)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    cfg = get_config(SHARDED["arch"])
    L, n = cfg.n_layers, SHARDED["steps_nccl"]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        facts = _collective_facts(torch, dist, mesh.get_group("model"))
        m = build_model(cfg)
        params = m.init(torch.Generator(device="cuda").manual_seed(0))
        ms = build_model(cfg, fetch_fn=make_pooled_fetch(mesh))
        prompts = _sharded_prompts(cfg)
        t0 = time.perf_counter()
        s0, tok0 = _sharded_state(torch, m, params, prompts,
                                  range(SHARDED["requests"]))
        prefill_s = time.perf_counter() - t0
        lanes = list(range(SHARDED["requests"]))
        rec, lg_u = _twin_runs(
            torch, ops, "nccl_world_1", mesh, (m, ms), params,
            [_state_lanes(torch, s0, lanes) for _ in range(2)], tok0, n,
            spans={"pool_layer": L}, kernels=GQA_DEVICE_KERNELS,
            want={"gather_kv.shard": n * L, "gather_kv.rows": 0,
                  "indexer_scores": n * L, "sparse_attn_gqa": n * L,
                  "scatter_kv.rows_at_shard": n, "scatter_kv.rows_at": 0},
            keys=("hot_buf", "buf_hits", "buf_misses", "buf_hits_l",
                  "buf_misses_l", "pf_inserted", "pf_useful", "kv_pool",
                  "idx_pool"),
            extra=dict(config=f"{cfg.name} (n_layers={L}, d_model="
                       f"{cfg.d_model})", requests=SHARDED["requests"],
                       context=SHARDED["context"],
                       pool_len=SHARDED["max_ctx"], prefill_s=prefill_s,
                       collectives=facts), t0=t0)
        refs = []
        nd = SHARDED["mesh_gloo"][0]
        per = SHARDED["requests"] // nd
        for d in range(nd):
            group = list(range(d * per, (d + 1) * per))
            st, _, lg, tk, _ = _decode_steps(
                torch, m, params, _state_lanes(torch, s0, group),
                tok0[d * per:(d + 1) * per].contiguous(),
                SHARDED["steps_gloo"])
            refs.append(dict(lanes=group, logits=lg, tokens=tk,
                             hot=[t.cpu() for t in st["hot_buf"]],
                             same_as_8_lanes=all(
                                 _equal_bits(torch, a, b[d * per:
                                                         (d + 1) * per])
                                 for a, b in zip(lg, lg_u))))
            del st
        # (a) extended, then (d): the same weights and prefilled lanes
        more = [sharded_prefetch_hier(torch, ops, mesh, cfg, params, s0,
                                      tok0),
                sharded_dense(torch, ops, mesh, cfg, params, s0, tok0)]
        del s0, m, ms, params
        gc.collect()
        torch.cuda.empty_cache()
        # (e), (f); past (e), the card's peak, ``then()``
        more.append(sharded_zamba(torch, ops, mesh, tp=families))
        if then is not None:
            then()
        more += sharded_whisper(torch, ops, mesh, tp=families)
        if families:
            more.append(families_world_of_one(torch, ops, mesh))
        return rec, dict(refs=refs, tok0=tok0.cpu()), [rec["launches"]] + more
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def _sharded_rank(rank, world, port, out_dir):
    """Phase 16 (b), one of four ranks sharing card 0 over gloo, mesh
    (data 2, model 2): its data slice's 4 requests prefilled whole, the
    serve state cut to its half of the pool axis (4128 rows), 4 decode
    steps; saves its tokens, logits, hot tier, launches and times."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed.sharding import shard_serve_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _wait_file(Path(out_dir) / "go")
        mesh = make_mesh(SHARDED["mesh_gloo"], ("data", "model"))
        facts = _collective_facts(torch, dist, mesh.get_group("model"))
        cfg = get_config(SHARDED["arch"])
        m = build_model(cfg, fetch_fn=make_pooled_fetch(mesh))
        params = m.init(torch.Generator(device="cuda").manual_seed(0))
        d = mesh.get_local_rank("data")
        per = SHARDED["requests"] // mesh.size(0)
        lanes = list(range(d * per, (d + 1) * per))
        state, tok0 = _sharded_state(torch, m, params,
                                     _sharded_prompts(cfg), lanes)
        ops.reset_launch_counts()
        state = shard_serve_state(state, mesh)
        gc.collect()
        state, _, logits, toks, step_s = _decode_steps(
            torch, m, params, state, tok0, SHARDED["steps_gloo"])
        torch.save(dict(
            lanes=lanes, model_rank=mesh.get_local_rank("model"),
            tok0=tok0.cpu(), logits=logits, tokens=toks, step_s=step_s,
            hot=[t.cpu() for t in state["hot_buf"]],
            pool_rows=state["kv_pool"].shape[2],
            launches=ops.launch_counts(), collectives=facts,
            peak_bytes=torch.cuda.max_memory_allocated()),
            Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _small_sharded_rank(rank, world, port, out_dir):
    """Phase 16 (c), one of two ranks sharing card 0 over gloo, mesh
    (data 1, model 2): small_check's SAC run of SHARDED_SMALL's small
    configs with the pool split over the model axis."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _wait_file(Path(out_dir) / "go")
        mesh = make_mesh((1, 2), ("data", "model"))
        out = {}
        for name in SHARDED_SMALL:
            cfg = small_config(name)
            params = _small_params(torch, cfg, "sac")
            out[name] = _small_run(torch, cfg, params, "cuda", mode="sac",
                                   prompt_len=40, pool_len=64,
                                   prefetch=False, mesh=mesh)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _started_ranks(fn, out_dir, world: int = 4):
    """``fn(rank, world, port, out_dir)`` in ``world`` processes, started
    now (imports, the card's context, their gloo group) so that they
    start while the caller makes their inputs, which they wait for;
    yields their context (join it), and kills any still running on the
    way out (the caller failed first)."""
    import torch.multiprocessing as mp
    spawned = mp.start_processes(fn, args=(world, _free_port(),
                                           str(out_dir)),
                                 nprocs=world, start_method="spawn",
                                 join=False)
    try:
        yield spawned
    finally:
        for proc in spawned.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()


def _go(started):
    """Let ranks started (``_started_ranks``: (directory, context)) and
    waiting for their ``go`` run; their results, joined."""
    import torch
    tmp, spawned = started
    (Path(tmp) / "go").touch()
    while not spawned.join():
        pass
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
            for r in range(len(spawned.processes))]


def start_sharded_ranks(stack) -> dict:
    """The ranks of phase 16 (b), (c) and (g), started (imports, the
    card's context, their gloo groups) while (a)-(f) end, each group
    waiting for its ``go`` (``_go``); ``stack`` (an ExitStack) kills any
    still running when it closes and removes their directories."""
    import tempfile
    out = {}
    for key, fn, world in (("b", _sharded_rank, 4),
                           ("c", _small_sharded_rank, 2),
                           ("g", _family_sharded_rank, 4)):
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        out[key] = (tmp, stack.enter_context(_started_ranks(fn, tmp,
                                                            world)))
    return out


def sharded_gloo(torch, refs, started):
    """Phase 16 (b): four ranks on card 0 over gloo, mesh (2, 2), against
    phase (a)'s unsharded runs of the same 4 lanes: tokens, logits and the
    hot tier bit for bit.  ``started``: the ranks (``start_sharded_ranks``).
    Returns the record and the shard forms' launches summed over the
    ranks."""
    from repro_torch.configs import get_config
    L = get_config(SHARDED["arch"]).n_layers
    steps = SHARDED["steps_gloo"]
    t0 = time.perf_counter()
    ranks = _go(started)
    seconds = time.perf_counter() - t0
    per = SHARDED["requests"] // SHARDED["mesh_gloo"][0]
    checks = []
    for r, res in enumerate(ranks):
        ref = refs["refs"][res["lanes"][0] // per]
        checks.append(dict(
            rank=r, lanes=res["lanes"], model_rank=res["model_rank"],
            pool_rows=res["pool_rows"],
            first_tokens=torch.equal(res["tok0"], refs["tok0"][
                res["lanes"][0]:res["lanes"][-1] + 1]),
            tokens=all(torch.equal(a, b) for a, b in zip(res["tokens"],
                                                         ref["tokens"])),
            logits=all(_equal_bits(torch, a, b) for a, b in zip(
                res["logits"], ref["logits"])),
            hot_tier=_state_equal(torch, res["hot"], ref["hot"]),
            wall_s_per_decode_step_median=_median(res["step_s"]),
            peak_bytes=res["peak_bytes"]))
    launches = {k: sum(res["launches"][k] for res in ranks)
                for k in ranks[0]["launches"]}
    want = {"gather_kv.shard": 4 * steps * L, "gather_kv.rows": 0,
            "scatter_kv.rows_at_shard": 4 * steps,
            "scatter_kv.splice_shard": 4}
    bad = {k: launches[k] for k, v in want.items() if launches[k] != v}
    rec = dict(phase="sharded", run="gloo_4_ranks_one_card", mesh=[2, 2],
               backend="gloo", config=SHARDED["arch"], decode_steps=steps,
               ranks=checks, launches=launches,
               lane_groups_same_as_8_lanes=[r["same_as_8_lanes"]
                                            for r in refs["refs"]],
               collectives=ranks[0]["collectives"], seconds=seconds)
    emit(rec)
    failed = [c for c in checks
              if not all(c[k] for k in ("first_tokens", "tokens", "logits",
                                        "hot_tier"))]
    if failed or bad:
        raise AssertionError(f"sharded (gloo, 4 ranks): {failed} {bad}")
    return rec, launches


def sharded_small(torch, started):
    """Phase 16 (c): small DeepSeek-V3.2 (MLA) and Gemma3-12B (windowed)
    at mesh (1, 2) over gloo (``started``: the two ranks): logits, hot
    tier and pool (the two slices side by side) bit-equal to the
    unsharded card run, which is held to SMALL_TOL against the CPU beside
    its e4m3 control."""
    ranks = _go(started)
    for name in SHARDED_SMALL:
        t0 = time.perf_counter()
        cfg = small_config(name)
        runs = small_runs(torch, cfg)
        err, control_err = small_check(torch, cfg, runs=runs)
        card = runs[1]
        got = [r[name] for r in ranks]
        equal = dict(
            logits=all(all(torch.equal(a, b) for a, b in zip(
                g["logits"], card["logits"])) for g in got),
            hot_tier=all(_state_equal(torch, g["hot"], card["hot"])
                         for g in got),
            pool=torch.equal(torch.cat([g["pool"] for g in got], 2),
                             card["pool"]))
        emit(dict(phase="sharded", run="small", config=name, mesh=[1, 2],
                  backend="gloo", equal_unsharded_card=equal,
                  max_rel_l2_err=err, tolerance=SMALL_TOL,
                  control_e4m3_rel_l2_err=control_err,
                  seconds=time.perf_counter() - t0))
        if not all(equal.values()):
            raise AssertionError(f"small {name} sharded differs: {equal}")


# ---------------------------------------------------------------------------
# phase 16 (a)-(f): the sharded pool's other paths at one NCCL rank
# ---------------------------------------------------------------------------

# the paths' device kernels, dense mode's (attention and decode write)
DENSE_DEVICE_KERNELS = ("sparse_gqa_partial_kernel",
                        "sparse_attn_combine_kernel", "write_rows_at")
# (a) extended: the fetch pipeline's speculation width, 4 steps; (d)
# Qwen2-1.5B in dense mode, 8 steps; (e) Zamba2-7B, 4 requests of 8192
# (hot tier 6144), 4 steps; (f) Whisper-small, 4 requests of 32,768
# frames, 8 steps in sac and in dense mode
SHARDED_FAMILIES = dict(prefetch_steps=4, dense_steps=8,
                        zamba=dict(arch="zamba2-7b", requests=4, steps=4),
                        whisper=dict(arch="whisper-small", requests=4,
                                     frames=32768, steps=8))


def _twin_runs(torch, ops, run, mesh, models, params, states, tok0, n, *,
               spans, kernels, want, keys, t0, extra=None, post=None,
               tp=False):
    """Phase 16's comparison at one NCCL rank: ``n`` greedy decode steps
    of the unsharded model ``models[0]`` on ``states[0]`` and of the
    sharded one on ``states[1]`` (a copy of the same lanes, its pools cut
    by ``shard_serve_state`` inside the sharded run's count: one splice
    launch): tokens, logits and the state entries ``keys`` bit-equal,
    the sharded run's launches at ``want``; then a profile of two more
    steps of each (median step, device ms and launches a step, the
    collectives' host time).  ``post(state)`` adds
    facts of the sharded run's state after its steps to the record;
    ``t0`` is when the caller began the run (its seconds, set-up
    included).  With ``tp`` (phase 21 (a)) a third run, the sharded model
    under ``use_rules(SERVE_RULES, mesh)`` on ``states[2]``: at a world of
    one every block whole and every collective the identity, so tokens,
    logits and ``keys`` bit-equal to the unsharded run, launches at
    ``want`` (``tp_world_1`` in the record).  Returns the record
    (``launches``: the sharded runs') and the unsharded run's logits."""
    from repro_torch.distributed.sharding import shard_serve_state
    ops.reset_launch_counts()
    st_u, tok_u, lg_u, tk_u, wall_u = _decode_steps(
        torch, models[0], params, states[0], tok0, n)
    counts_u = ops.launch_counts()
    ops.reset_launch_counts()
    st_s, tok_s, lg_s, tk_s, wall_s = _decode_steps(
        torch, models[1], params, shard_serve_state(states[1], mesh), tok0,
        n)
    counts_s = ops.launch_counts()
    equal = dict(
        tokens=all(torch.equal(a, b) for a, b in zip(tk_u, tk_s)),
        logits=all(_equal_bits(torch, a, b) for a, b in zip(lg_u, lg_s)),
        **{k: _state_equal(torch, st_u[k], st_s[k]) for k in keys})
    want = dict(want, **{"scatter_kv.splice_shard": 1})
    bad = {k: counts_s[k] for k, v in want.items() if counts_s[k] != v}
    after = post(st_s) if post is not None else {}
    if tp:
        from repro_torch.distributed import sharding as shd
        ops.reset_launch_counts()
        with shd.use_rules(shd.SERVE_RULES, mesh):
            st_t, _, lg_t, tk_t, wall_t = _decode_steps(
                torch, models[1], params, shard_serve_state(states[2], mesh),
                tok0, n)
        counts_t = ops.launch_counts()
        tp_equal = dict(
            tokens=all(torch.equal(a, b) for a, b in zip(tk_u, tk_t)),
            logits=all(_equal_bits(torch, a, b) for a, b in zip(lg_u, lg_t)),
            **{k: _state_equal(torch, st_u[k], st_t[k]) for k in keys})
        tp_bad = {k: counts_t[k] for k, v in want.items() if counts_t[k] != v}
        after["tp_world_1"] = dict(
            rules="SERVE_RULES", equal=tp_equal, launches=counts_t,
            wall_s_per_decode_step_median=_median(wall_t))
        del st_t
        if not all(tp_equal.values()) or tp_bad:
            raise AssertionError(f"{run} under SERVE_RULES at one rank: "
                                 f"{tp_equal}, launches {tp_bad}")
        counts_s = {k: v + counts_t[k] for k, v in counts_s.items()}
    state = {"u": st_u, "s": st_s}
    tok = {"u": tok_u, "s": tok_s}

    def step(key, model):
        state[key], lg = model.decode(params, state[key], tok[key])
        tok[key] = lg.argmax(-1).to(torch.int32)
    t_prof = time.perf_counter()
    n_prof = 2
    prof = {key: profile_steps(torch, lambda key=key, mm=mm: step(key, mm),
                               n_steps=n_prof, device_kernels=kernels,
                               spans=spans, report=("nccl",))
            for key, mm in (("u", models[0]), ("s", models[1]))}
    rec = dict(
        phase="sharded", run=run, mesh=[1, 1], backend="nccl",
        decode_steps=n, equal=equal,
        wall_s_per_decode_step_median=_median(wall_s),
        wall_s_per_decode_step_median_unsharded=_median(wall_u),
        launches=counts_s, launches_unsharded=counts_u,
        profiled_steps=n_prof,
        device_ms_per_step=prof["s"]["device_busy_s"] * 1e3 / n_prof,
        device_ms_per_step_unsharded=(prof["u"]["device_busy_s"] * 1e3
                                      / n_prof),
        launches_per_step=prof["s"]["launches_per_step"],
        launches_per_step_unsharded=prof["u"]["launches_per_step"],
        launches_ex_per_step=prof["s"]["launches_ex_per_step"],
        launches_ex_per_step_unsharded=prof["u"]["launches_ex_per_step"],
        device_busy_share=prof["s"]["device_busy_share"],
        device_busy_share_unsharded=prof["u"]["device_busy_share"],
        nccl_kernels=prof["s"]["reported"]["nccl"],
        collective_host_ops=prof["s"]["host_ops"],
        port_kernels=prof["s"]["port_kernels"],
        port_kernels_unsharded=prof["u"]["port_kernels"],
        top_kernels=prof["s"]["top_kernels"],
        layer_kinds=prof["s"]["layer_kinds"],
        layer_kinds_unsharded=prof["u"]["layer_kinds"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        profile_s=time.perf_counter() - t_prof,
        seconds=time.perf_counter() - t0, **after, **(extra or {}))
    emit(rec)
    if not all(equal.values()):
        raise AssertionError(f"sharded {run} differs from the unsharded "
                             f"decode: {equal}")
    if bad:
        raise AssertionError(f"sharded {run} launches {bad}, want {want}")
    return rec, lg_u


def sharded_prefetch_hier(torch, ops, mesh, cfg, params, s0, tok0):
    """Phase 16 (a) extended: Qwen2-1.5B's 8 lanes with the fetch
    pipeline's speculation (w = the config's 512, its score margin) and
    the hierarchical top-k at one NCCL rank, against the unsharded fused
    selection: tokens, logits, hot tier (``pf_*`` included) and counters
    bit-equal; the speculation must warm-insert.  The sharded fetch is
    two shard-form gathers a layer (the demand set, then the tail)."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.core.topk import make_hierarchical_topk
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    L, n = cfg.n_layers, SHARDED_FAMILIES["prefetch_steps"]
    opts = dict(prefetch_width=cfg.sac.prefetch_width,
                score_margin=cfg.sac.score_margin)
    m_u = build_model(cfg, opts=opts)
    m_s = build_model(cfg, fetch_fn=make_pooled_fetch(mesh), opts=opts,
                      topk_fn=make_hierarchical_topk(mesh, cfg.sac.topk))
    lanes = list(range(SHARDED["requests"]))
    rec, _ = _twin_runs(
        torch, ops, "nccl_world_1_prefetch_hier", mesh, (m_u, m_s), params,
        [_state_lanes(torch, s0, lanes) for _ in range(2)], tok0, n,
        spans={"pool_layer": L},
        kernels=GQA_DEVICE_KERNELS,
        want={"gather_kv.shard": 2 * n * L, "gather_kv.rows": 0,
              "indexer_scores": n * L, "sparse_attn_gqa": n * L,
              "scatter_kv.rows_at_shard": n, "scatter_kv.rows_at": 0},
        keys=("hot_buf", "buf_hits", "buf_misses", "buf_hits_l",
              "buf_misses_l", "pf_inserted", "pf_useful", "kv_pool",
              "idx_pool"),
        extra=dict(config=cfg.name, prefetch_width=opts["prefetch_width"],
                   score_margin=opts["score_margin"]), t0=t0,
        post=lambda st: dict(pf_inserted=int(st["hot_buf"].pf_inserted.sum()),
                             pf_used=int(st["hot_buf"].pf_used.sum())))
    if not rec["pf_inserted"]:
        raise AssertionError("(a) extended: nothing was warm-inserted")
    return rec["launches"]


def sharded_dense(torch, ops, mesh, cfg, params, s0, tok0):
    """Phase 16 (d): Qwen2-1.5B in ``dense`` mode, 8 lanes of 8192 in a
    pool of 8256, at one NCCL rank: each layer all-gathered
    (``PoolShard.gather_pool``: at one rank a copy) before the unsharded
    dense attention; tokens, logits and pools bit-equal to the unsharded
    dense decode; no gather or indexer launch, one decode write (shard
    form) a step."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    L, n = cfg.n_layers, SHARDED_FAMILIES["dense_steps"]
    m_u = build_model(cfg, mode="dense")
    m_s = build_model(cfg, mode="dense", fetch_fn=make_pooled_fetch(mesh))
    keep = ("kv_pool", "idx_pool", "cache_len")
    lanes = list(range(SHARDED["requests"]))

    rec, _ = _twin_runs(
        torch, ops, "nccl_world_1_dense", mesh, (m_u, m_s), params,
        [_state_lanes(torch, {k: s0[k] for k in keep}, lanes)
         for _ in range(2)], tok0, n, spans={"pool_layer": L},
        kernels=DENSE_DEVICE_KERNELS,
        want={"gather_kv": 0, "indexer_scores": 0, "sparse_attn_gqa": n * L,
              "scatter_kv.rows_at_shard": n, "scatter_kv.rows_at": 0},
        keys=("kv_pool", "idx_pool", "cache_len"),
        extra=dict(config=cfg.name, mode="dense",
                   gathered_bytes_per_layer=s0["kv_pool"][0].nbytes), t0=t0)
    return rec["launches"]


def sharded_zamba(torch, ops, mesh, tp=False):
    """Phase 16 (e): Zamba2-7B at full width and depth (81 Mamba2 and 13
    pool layers), 4 requests of 8192 tokens, hot tier 6144, at one NCCL
    rank: tokens, logits, hot tier, counters, ``rec_*`` and pools
    bit-equal to the unsharded run; every pool layer of every step
    through the gather's and the decode write's shard forms.  With
    ``tp``, phase 21 (a)'s third run (``_twin_runs``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.models.model import build_model
    spec = SHARDED_FAMILIES["zamba"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(spec["arch"])
    m_u = build_model(cfg)
    params = m_u.init(torch.Generator(device="cuda").manual_seed(0))
    m_s = build_model(cfg, fetch_fn=make_pooled_fetch(mesh))
    lanes = list(range(spec["requests"]))
    s0, tok0 = _sharded_state(torch, m_u, params, _sharded_prompts(cfg),
                              lanes)
    L, n = m_u.n_kv, spec["steps"]
    recs = tuple(k for k in s0 if k.startswith("rec_"))
    rec, _ = _twin_runs(
        torch, ops, "nccl_world_1_zamba2", mesh, (m_u, m_s), params,
        [s0] + [_state_lanes(torch, s0, lanes, m_u.segments)
                for _ in range(2 if tp else 1)], tok0, n,
        spans={"pool_layer": L, "mamba2_layer": cfg.n_layers},
        kernels=GQA_DEVICE_KERNELS,
        want={"gather_kv.shard": n * L, "gather_kv.rows": 0,
              "indexer_scores": n * L, "sparse_attn_gqa": n * L,
              "scatter_kv.rows_at_shard": n, "scatter_kv.rows_at": 0},
        keys=("hot_buf", "buf_hits", "buf_misses", "kv_pool", "idx_pool")
        + recs,
        extra=dict(config=f"{cfg.name} (n_layers={cfg.n_layers}, pool "
                   f"layers {L}, d_model={cfg.d_model})",
                   requests=spec["requests"], context=SHARDED["context"],
                   rec_keys=list(recs)), t0=t0, tp=tp)
    del s0, m_u, m_s, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec["launches"]


def sharded_whisper(torch, ops, mesh, tp=False):
    """Phase 16 (f): Whisper-small at full width and depth, 4 requests of
    32,768 frames each prefilled alone and spliced into its lane, at one
    NCCL rank, 8 decode steps in ``sac`` and in ``dense`` mode: tokens,
    logits, ``self_kv``, ``dec_len`` and pools bit-equal to the unsharded
    facade run; launches a step as phase 14's (the gather in its shard
    form in SAC mode; dense mode no indexer and no gather).  With ``tp``,
    phase 21 (a)'s third run (``_twin_runs``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pool import make_pooled_fetch, pool_splice_lane
    from repro_torch.models.model import build_model
    spec = SHARDED_FAMILIES["whisper"]
    t0 = time.perf_counter()
    cfg = get_config(spec["arch"])
    B, S, n, L = spec["requests"], spec["frames"], spec["steps"], cfg.n_layers
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    s0 = model.init_serve_state(B, S)
    pools = ["kv_pool", "idx_pool"]
    g = torch.Generator(device="cuda").manual_seed(0)
    for b in range(B):
        frames = torch.randn((1, S, cfg.d_model), generator=g,
                             device="cuda").bfloat16()
        st, _ = model.prefill(params, frames)
        pool_splice_lane([s0[k] for k in pools], [st[k] for k in pools],
                         lane=b)
        s0["cache_len"][b] = st["cache_len"][0]
        del st, frames
    prefill_s = time.perf_counter() - t0
    tok0 = torch.arange(B, dtype=torch.int32, device="cuda")
    lanes = list(range(B))
    counts = []
    for mode in ("sac", "dense"):
        t1 = time.perf_counter()
        keep = [k for k in s0 if mode == "sac" or k != "idx_pool"]
        m_u = build_model(cfg, mode=mode)
        m_s = build_model(cfg, mode=mode, fetch_fn=make_pooled_fetch(mesh))
        sac = mode == "sac"
        rec, _ = _twin_runs(
            torch, ops, f"nccl_world_1_whisper_{mode}", mesh, (m_u, m_s),
            params, [_state_lanes(torch, {k: s0[k] for k in keep}, lanes)
                     for _ in range(3 if tp else 2)], tok0, n,
            spans={"pool_layer": L},
            kernels=(GQA_DEVICE_KERNELS if sac else DENSE_DEVICE_KERNELS),
            want={"indexer_scores": L * n if sac else 0,
                  "gather_kv.shard": L * n if sac else 0,
                  "gather_kv.rows": 0, "sparse_attn_gqa": 2 * L * n,
                  "scatter_kv.rows_at": n, "scatter_kv.rows_at_shard": 0},
            keys=("self_kv", "dec_len", "cache_len") + tuple(
                k for k in pools if k in keep),
            extra=dict(config=f"{cfg.name} (n_enc_layers="
                       f"{cfg.n_enc_layers}, n_layers={L})", mode=mode,
                       requests=B, frames=S, prefill_s=prefill_s), t0=t1,
            tp=tp)
        counts.append(rec["launches"])
    del s0, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 16 (g): the sharded families, small, four gloo ranks on the card
# ---------------------------------------------------------------------------

# case -> the small config and ``_small_run``'s options: mesh (data 2,
# model 2), one lane a data rank (Qwen2-1.5B's B = 1 replicated over
# data: the same lane 0 on every rank, ``batch_axes=()``), prompts of 40
# and 31 tokens in a pool of 64 (encoder 64 and 40 frames), hot tier 24
# (room beside a top-k of 16 for the tail), 4 decode steps; the
# hierarchical top-k with the speculation tail selects by score, every
# other SAC case by small_check's injected top-k
FAMILY_SMALL = {"qwen2-dense": dict(arch="qwen2-1.5b", mode="dense"),
                "zamba2": dict(arch="zamba2-7b", mode="sac"),
                "whisper-sac": dict(arch="whisper-small", mode="sac"),
                "whisper-dense": dict(arch="whisper-small", mode="dense"),
                "qwen2-replicated": dict(arch="qwen2-1.5b", mode="sac",
                                         batch_axes=()),
                "qwen2-hier-tail": dict(arch="qwen2-1.5b", mode="sac",
                                        hier_tail=True)}


def _family_case(case):
    """A FAMILY_SMALL case's small config and ``_small_run`` options."""
    kw = dict(FAMILY_SMALL[case])
    cfg = small_config(kw.pop("arch"))
    kw.update(prompt_len=(40, 31), pool_len=64,
              device_buffer=24 if kw["mode"] == "sac" else 0)
    return cfg, kw


def sharded_small_cases(torch, dev, mesh):
    """Phase 16 (g), one rank: every FAMILY_SMALL case on this rank's
    lanes (lane d of data rank d; lane 0 everywhere for the replicated
    batch) with the pool sharded over ``mesh``'s model axis."""
    d = mesh.get_local_rank("data")
    out = {}
    for case in FAMILY_SMALL:
        cfg, kw = _family_case(case)
        lanes = [0] if case == "qwen2-replicated" else [d]
        out[case] = _small_run(torch, cfg,
                               _small_params(torch, cfg, kw["mode"]), dev,
                               lanes=lanes, mesh=mesh, **kw)
    return out


def check_small_cases(torch, ranks, dev, control: bool = False):
    """Phase 16 (g), the parent: each rank's result of each case (``ranks``
    in rank order on mesh (2, 2): data-major) against the unsharded run
    of the same lanes on ``dev``: logits, hot tier, ``rec_*`` and
    ``self_kv`` bit for bit, the two model ranks' pool slices side by
    side equal to the unsharded pool.  With ``control`` the unsharded
    card run is also held by ``small_check`` against the CPU (the hot
    tier's integer state exact where the selection is injected), beside
    its e4m3-weights control.  Returns a record a case and lane group;
    raises on a difference."""
    report = []
    for case in FAMILY_SMALL:
        cfg, kw = _family_case(case)
        groups = {}
        for res in ranks:
            groups.setdefault(tuple(res[case]["lanes"]), []).append(
                res[case])
        for lanes, group in groups.items():
            t0 = time.perf_counter()
            runs = (small_runs(torch, cfg, devices=("cpu", dev),
                               lanes=lanes, **kw) if control else
                    [None, _small_run(torch, cfg,
                                      _small_params(torch, cfg, kw["mode"]),
                                      dev, lanes=lanes, **kw)])
            want = runs[1]
            # each data rank's two model ranks, in model order
            halves = [group[i:i + 2] for i in range(0, len(group), 2)]
            equal = {k: all(_state_equal(torch, g[k], want[k])
                            for g in group)
                     for k in ("logits", "hot", "rec", "self_kv")}
            equal["pool"] = all(_equal_bits(torch, torch.cat(
                [h["pool"] for h in half], 2), want["pool"])
                for half in halves)
            if kw.get("hier_tail"):      # the tail was warm-inserted
                equal["speculated"] = bool(want["hot"][6].sum() > 0)
            rec = dict(phase="sharded", run="small_family", case=case,
                       config=cfg.name, mode=kw["mode"], mesh=[2, 2],
                       backend="gloo", lanes=list(lanes), ranks=len(group),
                       equal_unsharded=equal)
            if control:
                err, ctl = small_check(torch, cfg, mode=kw["mode"],
                                       runs=runs,
                                       injected=not kw.get("hier_tail"))
                rec.update(max_rel_l2_err=err, control_e4m3_rel_l2_err=ctl,
                           tolerance=SMALL_TOL)
            rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            report.append(rec)
            if not all(equal.values()):
                raise AssertionError(f"small {case} lanes {lanes}: {equal}")
    return report


def _family_sharded_rank(rank, world, port, out_dir):
    """Phase 16 (g), one of four ranks sharing card 0 over gloo, mesh
    (data 2, model 2): ``sharded_small_cases``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _wait_file(Path(out_dir) / "go")
        mesh = make_mesh((2, 2), ("data", "model"))
        torch.save(sharded_small_cases(torch, "cuda", mesh),
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def sharded_families_small(torch, started):
    """Phase 16 (g): FAMILY_SMALL on four gloo ranks sharing the card
    (``started``), each rank bit-equal to the unsharded card run of its
    lanes, which holds SMALL_TOL against the CPU beside its e4m3
    control."""
    t0 = time.perf_counter()
    ranks = _go(started)
    spawn_s = time.perf_counter() - t0
    report = check_small_cases(torch, ranks, "cuda", control=True)
    emit(dict(phase="sharded", run="small_families_total",
              cases=len(report), ranks_seconds=spawn_s,
              seconds=time.perf_counter() - t0))


# ---------------------------------------------------------------------------
# phase 17: the simulator twin on the card
# ---------------------------------------------------------------------------

# the replay's parity regime (no warm-up, radix seeds or prefetch; no hot
# tier; overlap off; rolling admission): Qwen2-1.5B at full width and
# depth, 8 requests of 8192 tokens arriving together (they queue behind
# the 4 slots), 8 output tokens; monolithic, chunked (2048) and
# disaggregated prefill
TWIN = dict(arch="qwen2-1.5b", slots=4, max_ctx=8256, requests=8,
            context=8192, output=8, arrival_rate=2000.0, seed=7,
            modes=(("monolithic", 0, False), ("chunked", 2048, False),
                   ("disagg", 0, True)))
TWIN_TOL_S = 1e-9


def _twin_trace(cfg):
    from repro_torch.serving.request import sharegpt_trace
    return sharegpt_trace(TWIN["requests"], context_len=TWIN["context"],
                          output_len=TWIN["output"], seed=TWIN["seed"],
                          arrival_rate=TWIN["arrival_rate"], ctx_jitter=0.0,
                          vocab=cfg.vocab)


def simulator_twin(torch, ops):
    """Phase 17: the port's Engine serves TWIN's trace on the card in the
    replay's parity regime three ways; ``replay_engine_timeline`` must
    reproduce every request's dispatch, first-token and finish times
    within TWIN_TOL_S.  Then ``run_backend_sweep`` over
    ``default_backends()`` on the same trace: TTFT, TBT and throughput on
    the simulator's modeled clock (8 x H20, the paper's server), not a
    measurement of this card.  Returns the serving runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.simulator import (SimConfig, default_backends,
                                               profile_from_config,
                                               replay_engine_timeline,
                                               run_backend_sweep)
    base = get_config(TWIN["arch"])
    cfg = dataclasses.replace(base, sac=dataclasses.replace(
        base.sac, warmup_entries=0, warmup_radix=0, prefetch_width=0))
    launches = None
    for name, chunk, disagg in TWIN["modes"]:
        t0 = time.perf_counter()
        eng = Engine(cfg, slots=TWIN["slots"], max_ctx=TWIN["max_ctx"],
                     device_buffer=0, overlap=False, seed=0,
                     prefill_chunk_tokens=chunk, disagg=disagg)
        reqs = _twin_trace(cfg)
        ops.reset_launch_counts()
        out = eng.run(reqs)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        rep = replay_engine_timeline(eng, reqs)
        worst, queued = 0.0, 0
        for r, q in zip(sorted(reqs, key=lambda r: r.request_id), rep):
            if r.request_id != q.request_id:
                raise AssertionError("replay request order differs")
            worst = max(worst, abs(r.dispatch_s - q.dispatch_s),
                        abs(r.first_token_s - q.first_token_s),
                        abs(r.finish_s - q.finish_s))
            queued += r.dispatch_s > r.arrival_s + 1e-12
        rec = dict(phase="simulator_twin", run=name,
                   config=f"{cfg.name} (n_layers={cfg.n_layers}, "
                   f"d_model={cfg.d_model})", slots=TWIN["slots"],
                   requests=TWIN["requests"], context=TWIN["context"],
                   output=TWIN["output"], prefill_chunk_tokens=chunk,
                   disagg=disagg, n_done=out["n_done"], steps=eng.stats.steps,
                   queued_requests=queued,
                   replay_max_abs_diff_s=worst, tolerance_s=TWIN_TOL_S,
                   modeled_clock_ttft_mean_s=out["ttft_mean_s"],
                   modeled_clock_tbt_mean_s=out["tbt_mean_s"],
                   wall_s=run_s, launches=counts)
        emit(rec)
        if out["n_done"] != TWIN["requests"] or worst >= TWIN_TOL_S:
            raise AssertionError(f"simulator twin ({name}): served "
                                 f"{out['n_done']}, replay differs by "
                                 f"{worst} s")
        if not queued:
            raise AssertionError(f"simulator twin ({name}): no request "
                                 "queued behind the slots")
        launches = (counts if launches is None else
                    {k: launches[k] + v for k, v in counts.items()})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sweep = run_backend_sweep(_twin_trace(cfg), profile_from_config(cfg),
                              default_backends(),
                              SimConfig(concurrency=TWIN["slots"]))
    keys = ("ttft_mean_s", "ttft_p99_s", "tbt_mean_s", "tbt_p99_s",
            "throughput_tok_s", "n_done")
    emit(dict(phase="simulator_twin", run="backend_sweep",
              clock="modeled virtual clock (8 x H20 server, the paper's "
              "testbed): not measured on this card",
              config=cfg.name, requests=TWIN["requests"],
              context=TWIN["context"],
              backends={name: {k: v for k, v in s.items() if k in keys}
                        for name, s in sweep.items()},
              seconds=time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# phase 18: the dry-run, and the one production cell that fits a card
# ---------------------------------------------------------------------------

# (a): the cell built on meta and on the card; its decode steps
DRYRUN_CELL = dict(arch="qwen2-1.5b", shape="long_500k", mode="sac")
DRYRUN_STEPS = dict(warmup=2, timed=5, profiled=2)
# (b): one arch of each family at every shape on the single pod, and
# DeepSeek-V3.2 at decode_32k on both meshes, each on meta in its own
# process (DRYRUN_WORKERS at once), the quick shapes first.  A cell's
# step runs every operator on meta, at tens to hundreds of microseconds
# of host each: a decode cell takes 18-30 s of its process on the card's
# host (6 at once; 8 on its 8 cores since tensor parallelism, two
# waves of the 16 cells), a train cell minutes (the CPU sweep, ``python -m
# repro_torch.launch.dryrun --all``, runs them).  So the phase cuts up
# front, and only here, every train_4k cell and the prefill_32k cells
# but Qwen2-1.5B's and Whisper-small's (xLSTM-125M's sLSTM steps one
# token at a time: 32,768 times a token's operators).  The 16 cells that
# stay took 66-77 s on the card's host with (c) and (a)'s meta build beside
# them; DRYRUN_BUDGET_S is a hang guard: a cell still running then, or
# not yet started, fails the phase.  In the whole script (b) and (a)'s
# meta build start after phase 3 and run beside phases 4-17, which keep
# one host core busy each, on DRYRUN_WORKERS_BESIDE cores; phase 18 then
# collects them
DRYRUN_ARCHS = ("qwen2-1.5b", "mixtral-8x22b", "gemma3-12b", "zamba2-7b",
                "xlstm-125m", "whisper-small")
DRYRUN_SHAPES = ("decode_32k", "long_500k", "prefill_32k", "train_4k")
DRYRUN_CUT = ({(a, "train_4k") for a in DRYRUN_ARCHS}
              | {(a, "prefill_32k") for a in ("mixtral-8x22b", "gemma3-12b",
                                              "zamba2-7b", "xlstm-125m")})
DRYRUN_CELLS = ([("deepseek-v32", "decode_32k", m)
                 for m in ("single", "multi")]
                + [(a, s, "single") for s in DRYRUN_SHAPES
                   for a in DRYRUN_ARCHS if (a, s) not in DRYRUN_CUT])
DRYRUN_WORKERS = 8
DRYRUN_WORKERS_BESIDE = 4
DRYRUN_BUDGET_S = 300
# the port's examples run on the card in (c)
DRYRUN_EXAMPLES = ("quickstart", "serve_sac")

# the meta build of (a), in its own process: a fake group of one rank
_META_CELL = """
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
arch, shape, mode = sys.argv[1:4]
with dryrun.fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    step, in_sh, in_spec, meta = dryrun.build_cell(arch, shape, mesh, mode)
    counts = dryrun.count_step(step, in_spec)
    layout = dryrun.layout_bytes(in_sh, meta, mesh)
from repro_torch.configs import SHAPES_BY_NAME, get_config
rec = dryrun.record(meta, counts, layout, get_config(arch),
                    SHAPES_BY_NAME[shape], chips=1, t_build=0.0)
print("META " + json.dumps(rec))
"""


def _sub_env(**extra):
    """A subprocess's environment: the checkout's ``src`` on the path."""
    import os
    return dict(os.environ, PYTHONPATH=str(SRC), **extra)


# a meta process: no card, one intra-op thread (several run at once)
META_ENV = dict(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1")


def start_meta_cell():
    """Phase 18 (a)'s meta build, started in its own process (it runs
    while (b) and (c) do; ``dryrun_cell_on_card`` reads it)."""
    c = DRYRUN_CELL
    return subprocess.Popen([sys.executable, "-c", _META_CELL, c["arch"],
                             c["shape"], c["mode"]], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_sub_env(**META_ENV))


def check_host_rules(torch, indexer, sparse_attn) -> dict:
    """The host's mirror of each kernel's shape rule (what a ``meta``
    call checks: ``indexer_accepts``, ``gqa_accepts``, ``mla_accepts``)
    against the card's occupancy answer (slots 0: refused) over a grid of
    shapes; every disagreement fails."""
    bad, n = [], 0
    for H in (1, 4, 64, 128, 129):
        for di in (8, 16, 24, 64, 128, 256, 272):
            n += 1
            if indexer.indexer_accepts(H, di) != bool(
                    indexer.indexer_slots(H, di)[0]):
                bad.append(("indexer", H, di))
    for fp8 in (False, True):
        for n_rep in (1, 2, 4, 6, 8, 16, 32, 64):
            for hd in (8, 16, 64, 72, 112, 128, 240, 256, 512, 520):
                n += 1
                if sparse_attn.gqa_accepts(n_rep, hd, fp8) != bool(
                        sparse_attn.gqa_slots(n_rep, hd, fp8=fp8)):
                    bad.append(("gqa", n_rep, hd, fp8))
        for dq, st_w in ((576, 576), (48, 48), (192, 192), (576, 1024),
                         (1024, 1024), (64, 32)):
            n += 1
            if sparse_attn.mla_accepts(dq, st_w, fp8) != bool(
                    sparse_attn.mla_slots(dq, st_w, fp8=fp8)):
                bad.append(("mla", dq, st_w, fp8))
    rec = dict(phase="dryrun_host_rules", shapes=n, disagree=bad)
    emit(rec)
    if bad:
        raise AssertionError(f"host shape rules disagree with the card: "
                             f"{bad}")
    return rec


def dryrun_cell_on_card(torch, smi: str, meta_proc) -> dict:
    """Phase 18 (a): DRYRUN_CELL on meta (``meta_proc``, from
    ``start_meta_cell``) and on the card (one NCCL rank, mesh (1, 1)),
    counted over one decode step each."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import n_kv_layers
    c = DRYRUN_CELL
    t0 = time.perf_counter()
    stdout, stderr = meta_proc.communicate(timeout=600)
    lines = [ln for ln in stdout.splitlines() if ln.startswith("META ")]
    if meta_proc.returncode or not lines:
        raise AssertionError(f"the meta build failed:\n{stderr[-3000:]}")
    meta = json.loads(lines[-1][5:])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
        t1 = time.perf_counter()
        step, in_sh, in_spec, info = dryrun.build_cell(
            c["arch"], c["shape"], mesh, c["mode"], device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        allocated = torch.cuda.memory_allocated() - base
        requested = (torch.cuda.memory_stats()["requested_bytes.all.current"]
                     - base_req)
        torch.cuda.reset_peak_memory_stats()
        card = dryrun.count_step(step, in_spec)
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated() - base
        params, state, tokens = in_spec

        def one():
            nonlocal state
            state, logits = step(params, state, tokens)
            return logits
        for _ in range(DRYRUN_STEPS["warmup"]):
            logits = one()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("the long_500k decode gave non-finite "
                                 "logits")
        walls = []
        for _ in range(DRYRUN_STEPS["timed"]):
            t2 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t2)
        n = DRYRUN_STEPS["profiled"]
        prof = profile_steps(torch, one, n_steps=n,
                             device_kernels=GQA_DEVICE_KERNELS,
                             spans={"pool_layer": n_kv_layers(
                                 get_config(c["arch"]))})
    finally:
        dist.destroy_process_group()
    device_s = prof["device_busy_s"] / n
    roof_s = max(meta["compute_s"], meta["memory_s"])
    keys = ("flops", "bytes", "collective_bytes", "collective_breakdown",
            "collective_counts", "ops", "kernels")
    rec = dict(
        phase="dryrun_cell", card=smi, cell=c, lanes=info["lanes_per_rank"],
        pool_rows=info["pool_rows_per_rank"],
        meta={k: meta[k] for k in keys}, card_counts={k: card[k]
                                                     for k in keys},
        card_launches=card["launches"],
        argument_bytes=meta["mem_per_device"]["argument_bytes"],
        step_argument_bytes=meta["mem_per_device"]["step_argument_bytes"],
        card_requested_bytes=requested, card_allocated_bytes=allocated,
        meta_peak_bytes=meta["mem_per_device"]["peak_bytes"],
        card_max_memory_allocated=card_peak,
        card_count_peak_bytes=card["peak_bytes"],
        launching_ops=meta["ops"],
        profiler_launches_per_step=prof["launches_per_step"],
        profiler_launches_ex_per_step=prof["launches_ex_per_step"],
        device_ms_per_step=device_s * 1e3,
        wall_s_median=_median(walls), wall_s=walls,
        compute_s=meta["compute_s"], memory_s=meta["memory_s"],
        collective_s=meta["collective_s"], dominant=meta["dominant"],
        roofline_share=roof_s / device_s, model_flops=meta["model_flops"],
        useful_flops_ratio=meta["useful_flops_ratio"],
        port_kernels_us=prof["port_kernels"], meta_count_s=meta["compile_s"],
        build_s=build_s, seconds=time.perf_counter() - t0)
    emit(rec)
    want = {"gather_kv.shard": 28, "gather_kv": 28, "indexer_scores": 28,
            "sparse_attn_gqa": 28, "scatter_kv.rows_at_shard": 1,
            "scatter_kv": 1}
    diff = [k for k in keys if meta[k] != card[k]]
    if diff:
        raise AssertionError(f"meta and card counts differ in {diff}")
    if card["launches"] != want:
        raise AssertionError(f"launches a step {card['launches']}, want "
                             f"{want}")
    # the meta build's calls against what the card launched, by form
    forms = {k: n for k, n in card["launches"].items()
             if k not in ("gather_kv", "scatter_kv")}
    if meta["kernels"] != forms:
        raise AssertionError(f"the meta build's kernel calls "
                             f"{meta['kernels']} differ from the card's "
                             f"launches {forms}")
    if not (meta["mem_per_device"]["argument_bytes"]
            == meta["mem_per_device"]["step_argument_bytes"] == requested):
        raise AssertionError(
            f"argument bytes differ: meta {meta['mem_per_device']}, the "
            f"card's requests {requested}")
    return rec


def dryrun_cli_cells(lines: list, workers: int | None = None,
                     procs: list | None = None) -> list:
    """Phase 18 (b): the dry-run CLI, one process a cell of DRYRUN_CELLS
    (``workers`` at once, DRYRUN_WORKERS by default; none on the card).
    Every cell must end ``ok`` or ``skipped``; one still running at
    DRYRUN_BUDGET_S is killed and reported ``timeout`` with its stderr's
    tail, and one not started by then ``not_started``.  Runs in a thread
    (``start_dryrun_cells``): its records go to ``lines`` (emitted by
    the caller after the join), each process it starts to ``procs`` (so
    that the script can stop them if it fails first), and the cells'
    records are returned."""
    import os
    import tempfile
    workers = DRYRUN_WORKERS if workers is None else workers
    procs = [] if procs is None else procs
    t0 = time.perf_counter()
    recs = []
    with tempfile.TemporaryDirectory() as out:
        pending = list(DRYRUN_CELLS)
        running = []
        env = _sub_env(**META_ENV)
        while pending or running:
            late = time.perf_counter() - t0 > DRYRUN_BUDGET_S
            while pending and len(running) < workers and not late:
                arch, shape, mesh = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", out]
                procs.append(subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True, env=env))
                running.append(((arch, shape, mesh), time.perf_counter(),
                                procs[-1]))
            time.sleep(0.2)
            late = time.perf_counter() - t0 > DRYRUN_BUDGET_S
            still = []
            for cell, start, proc in running:
                rec = dict(arch=cell[0], shape=cell[1], mesh=cell[2])
                if proc.poll() is None:
                    if not late:
                        still.append((cell, start, proc))
                        continue
                    proc.kill()
                    rec.update(status="timeout",
                               seconds=time.perf_counter() - start,
                               error=(proc.communicate()[1] or "")[-2000:])
                else:
                    err = proc.communicate()[1]
                    files = [f for f in os.listdir(out) if f.startswith(
                        f"{cell[0]}__{cell[1]}__{cell[2]}")]
                    r = (json.load(open(os.path.join(out, files[0])))
                         if files else {})
                    rec.update(status=r.get("status", "failed"),
                               rc=proc.returncode,
                               seconds=time.perf_counter() - start)
                    if r.get("status") == "ok":
                        mem = r["mem_per_device"]
                        rec.update({k: r[k] for k in (
                            "mode", "flops", "bytes", "ops",
                            "collective_counts", "compute_s", "memory_s",
                            "collective_s", "dominant", "useful_flops_ratio",
                            "kernels")},
                            argument_bytes=mem["argument_bytes"],
                            step_argument_bytes=mem["step_argument_bytes"],
                            peak_bytes=mem["peak_bytes"],
                            build_s=r["lower_s"], count_s=r["compile_s"])
                    elif r.get("status") == "skipped":
                        rec["skip"] = r["skip"]
                    else:
                        rec["error"] = (err or "")[-2000:]
                recs.append(rec)
                lines.append(dict(phase="dryrun_cli", **rec))
            running = still
            if late:
                for arch, shape, mesh in pending:
                    rec = dict(arch=arch, shape=shape, mesh=mesh,
                               status="not_started")
                    recs.append(rec)
                    lines.append(dict(phase="dryrun_cli", **rec))
                pending = []
    lines.append(dict(phase="dryrun_cli_total", cells=len(recs),
              ok=sum(r["status"] == "ok" for r in recs),
              skipped=sum(r["status"] == "skipped" for r in recs),
              failed=[(r["arch"], r["shape"], r["mesh"], r["status"])
                      for r in recs if r["status"] not in ("ok", "skipped")],
              cut_up_front=sorted(DRYRUN_CUT), budget_s=DRYRUN_BUDGET_S,
              workers=workers, seconds=time.perf_counter() - t0))
    return recs


def start_dryrun_cells(workers: int | None = None) -> dict:
    """Phase 18's host work, started: (a)'s meta build in its own
    process and (b) in a thread of subprocesses (``workers`` at once).
    Every process is stopped when the script exits, whether or not the
    phase collected it (``dryrun_phase``)."""
    import atexit
    import threading
    started = dict(meta=start_meta_cell(), lines=[], recs=[], procs=[],
                   t0=time.perf_counter())
    started["procs"].append(started["meta"])
    started["thread"] = threading.Thread(
        target=lambda: started["recs"].extend(dryrun_cli_cells(
            started["lines"], workers, started["procs"])), daemon=True)
    started["thread"].start()

    def stop():
        for proc in started["procs"]:
            if proc.poll() is None:
                proc.kill()
    atexit.register(stop)
    return started


def dryrun_phase(torch, indexer, sparse_attn, smi: str,
                 started: dict | None = None) -> None:
    """Phase 18: the host's shape rules; (c) on the card beside (b) and
    (a)'s meta build (``started`` earlier by the caller, else now); then
    (a) on the card alone (its wall and device times uncontended)."""
    check_host_rules(torch, indexer, sparse_attn)
    started = started or start_dryrun_cells()
    try:
        dryrun_examples(torch)
    finally:
        started["thread"].join()
        for line in started["lines"]:
            emit(line)
    recs = started["recs"]
    bad = [r for r in recs if r["status"] not in ("ok", "skipped")]
    if bad or len(recs) != len(DRYRUN_CELLS):
        raise AssertionError(f"dry-run cells failed: {bad}")
    dryrun_cell_on_card(torch, smi, started["meta"])


def dryrun_examples(torch) -> None:
    """Phase 18 (c): the port's examples on the card, both at once, each
    to exit 0."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_sub_env()) for name in DRYRUN_EXAMPLES}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            emit(dict(phase="dryrun_example", example=name,
                      rc=proc.returncode,
                      tail=out.strip().splitlines()[-3:],
                      seconds=time.perf_counter() - t0))
            if proc.returncode:
                raise AssertionError(f"examples/torch/{name}.py failed:\n"
                                     f"{err[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ---------------------------------------------------------------------------
# phase 19: tensor and expert parallelism of the weights
# ---------------------------------------------------------------------------

# the cases: arch, depth (None: the config's), requests of ``context``
# tokens in a pool of ``max_ctx`` rows (the config's hot tier), decode
# steps (the unsharded run's greedy ones; the TP ranks are fed its
# tokens), and the meshes the four gloo ranks run.  Qwen2-1.5B
# at model 4 holds 3 q heads and half a KV head a rank, at model 2 six q
# heads over one KV head; DeepSeek-V3.2 at (2, 2) 64 heads, 32 indexer
# heads and 64 experts a rank.  Its prompts are 1024 tokens: the whole
# model prefills the 4 prompts at once (as the ranks' expert dispatch
# sees them), which took 72.9 GB of the card at 2048.  The ranks run it
# first, while their allocators are fresh: its four ranks' 54 GB of
# blocks and one rank's 7.5 GB leaf being cut leave little of the card
TP_CASES = {
    "deepseek-v32": dict(arch="deepseek-v32", n_layers=2, requests=4,
                         context=1024, max_ctx=1088, steps=4,
                         meshes=((2, 2),), grouped=True),
    "qwen2-1.5b": dict(arch="qwen2-1.5b", n_layers=None, requests=4,
                       context=1024, max_ctx=1088, steps=16,
                       meshes=((1, 4), (2, 2))),
}
# tests/test_torch_tp.py's limits, a request and a step: relative L2,
# and BF16_TOL (rtol = atol) element by element, which up to TP_MISS_FRAC
# of the logits may miss.  Its third, the largest element's ratio to
# BF16_TOL (TP_MISS_FACTOR, 3.0 over 256 logits), is a maximum over the
# vocabulary that grows with it: here (151,936 and 129,280 logits) it is
# reported, not held, beside the same three figures of Qwen2-1.5B's
# unsharded run with its row-parallel products in f32 as a rank makes
# them (against the unsharded run itself: cuBLAS rounds a bf16 GEMM's
# f32 sums in another order, and 28 random layers amplify an ulp).  A request and step whose token's
# experts differ between the runs at a gate within TP_GATE_TIE of a tie
# (log-probability; bf16 router logits tie often among 256 experts) is
# listed instead of held, at most half of them: the runs' hidden states
# differ by rounding (phase 19's NCCL world of one computes the same
# function bit for bit), so a router logit can move by a few bf16 ulps
# (2^-6 in [2, 4)), and DeepSeek-V3.2's top 8 of 256 sit that close at
# one token in four or so
TP_REL_L2, TP_BF16_TOL, TP_MISS_FRAC, TP_MISS_FACTOR = 3e-2, 2e-2, 0.1, 3.0
TP_GATE_TIE = 0.0625
# the device of phase 19's runs: the card, or with CHIP_SMOKE_TP_DEVICE
# set to "cpu" a rehearsal on the CPU at the reduced configs and small
# sizes (tests/test_torch_tp_chip.py; its ranks inherit the setting)
TP_DEV = os.environ.get("CHIP_SMOKE_TP_DEVICE", "cuda")
# (c): MoE dispatch groups over the batch axes, ``moe_groups=auto`` (the
# batch ranks' product: 2 groups at (2, 2)), on (b)'s four ranks.
# Serving: (b)'s DeepSeek-V3.2 blocks and lanes prefilled again with the
# groups (each rank routes its own lanes, the slots cross by all-to-all)
# and TP_GROUPED["steps"] decode steps (one group, as the reference
# decodes), fed the unsharded run's at the same groups (made in (b)'s
# child), held as (b) is.  Training: one TRAIN_RULES step's gradients of
# Mixtral-8x22B at full width with 2 layers (a rank holds 2 of its 8
# experts, 1.2 GB a layer), batch 4 x 256, against the unsharded step at
# the same groups (made by the parent while the ranks run (b)'s other
# cases, once DeepSeek-V3.2's blocks have left the card: 43 GB in f32),
# on the ranks' blocks as phase 21's steps are: the loss
# and each leaf within ``limits``, the control without the batch-axis
# sums outside.  The step runs in f32 without activation checkpointing,
# as phase 21's Zamba2-7B step: in bf16 a router logit moves by a
# rounding, and a token whose top 2 of 8 then differ moves its experts'
# and the router's gradient leaves by several per cent (the bf16 step's
# median leaf was 5.5 % from the unsharded step, its worst the router's
# at 10.6 % on an H100: PERF.md §6)
# rank 0's peak bytes on the card in each attention-family record of
# phases 19 and 20 as the tree before the sequence-parallel residual
# made them (NVIDIA H100 80GB HBM3, 700.00 W; the same script, the same
# cases), printed beside this run's as ``peak_bytes_was``
PEAK_WAS = {("tp", "deepseek-v32", (2, 2)): 20246511616,
            ("tp", "qwen2-1.5b", (1, 4)): 2482795520,
            ("tp", "qwen2-1.5b", (2, 2)): 2651998720,
            ("grouped_serve",): 16121582080,
            ("grouped_train",): 13314556928,
            ("fsdp_train",): 10025098752,
            ("fsdp_serve", "qwen2-1.5b"): 9923231744,
            ("fsdp_serve", "deepseek-v32"): 19641073664}
TP_GROUPED = dict(groups=2, steps=2,
                  train=dict(arch="mixtral-8x22b", n_layers=2, batch=4,
                             seq=256, f32=True),
                  limits=dict(loss_rel=1e-4, grad_rel_l2=1e-2))
if TP_DEV == "cpu":
    TP_CASES = {k: dict(v, requests=4, context=24, max_ctx=32, steps=2)
                for k, v in TP_CASES.items()}
    TP_GROUPED["train"] = dict(TP_GROUPED["train"], seq=8)


def _tp_sync(torch):
    if TP_DEV == "cuda":
        torch.cuda.synchronize()


def _tp_peak(torch) -> int:
    return torch.cuda.max_memory_allocated() if TP_DEV == "cuda" else 0


def _tp_world_of_one(torch, dist, port: int):
    """A process group of this process alone: NCCL on the card."""
    if TP_DEV == "cuda":
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)


def _tp_topk(scores, cache_len):
    """Phase 19's injected top-k (``_small_topk``'s formula at the
    config's k): the runs' indexer scores round differently, and a
    near-tie would select differently."""
    return _small_topk(scores, cache_len, 2048 if TP_DEV == "cuda" else 16)


def _tp_opts(cfg):
    """The serving models' opts: the prefill's warm-up plan at the
    engine's width (the indexer kernel on the rank's slice of the
    positions, where the residual is split over the sequence)."""
    return dict(warmup_w=int(cfg.sac.warmup_entries))


def _tp_cfg(case):
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"])
    if TP_DEV == "cpu":
        return cfg.reduced()
    if case["n_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=case["n_layers"])
    return cfg


def _tp_prompts(torch, cfg, case):
    from repro_torch.serving.request import sharegpt_trace
    reqs = sharegpt_trace(case["requests"], context_len=case["context"],
                          output_len=case["steps"], ctx_jitter=0.0, seed=0,
                          vocab=cfg.vocab)
    return torch.tensor([r.prompt_tokens for r in reqs], dtype=torch.int32,
                        device=TP_DEV)


def _tp_state(torch, m, params, prompts, case, mesh=None):
    """The lanes' prompts prefilled in one call (the expert dispatch sees
    them together, as the ranks' does), written into a serve state of
    ``max_ctx`` rows with the config's hot tier; with ``mesh`` (the rules
    set, the model over the sharded pool) the prefill's residual is split
    over the sequence and its pools are the rank's slices, written into
    the serve state's slices; returns it and the prefill's logits."""
    from repro_torch.core.pool import pool_write_prefill
    from repro_torch.distributed.sharding import (shard_serve_state,
                                                  write_prefill_shard)
    st, logits = m.prefill(params, prompts)
    state = m.init_serve_state(prompts.shape[0], case["max_ctx"],
                               device_buffer=m.cfg.sac.device_buffer_size)
    state["cache_len"] = st["cache_len"].clone()
    if mesh is None:
        for k in ("kv_pool", "idx_pool"):
            pool_write_prefill(state[k], st[k])
    else:
        state = shard_serve_state(state, mesh)
        write_prefill_shard(state, st, mesh)
    del st
    return state, logits


@contextlib.contextmanager
def _tp_gates(record):
    """Each MoE dispatch's chosen experts and the gap between the K-th and
    the next log-probability, token by token (``moe.top_k``'s calls);
    nothing with ``record`` None."""
    import torch
    from repro_torch.models import moe
    if record is None:
        yield
        return
    orig = moe.top_k

    def top_k(probs, k):
        vals, ids = orig(probs, k + 1)
        lp = torch.log(vals.double())
        record.append((ids[..., :k].sort(-1)[0].cpu(),
                       (lp[..., k - 1] - lp[..., k]).cpu()))
        return orig(probs, k)
    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = orig


@contextlib.contextmanager
def _f32_row_products(torch):
    """The unsharded path's row-parallel products (``wo``, ``w_down``:
    the weights whose first dim is ``H`` or ``F``, through
    ``tp.Whole.matmul``) in f32, rounded once, as a TP rank's."""
    from repro_torch.distributed import tp
    orig = tp.Whole.matmul

    def matmul(self, x, w, dims, shape, axes=(), scatter=False):
        if dims[0] in ("H", "F"):
            return torch.matmul(x.float(), w.float()).to(x.dtype)
        return x @ w
    tp.Whole.matmul = matmul
    try:
        yield
    finally:
        tp.Whole.matmul = orig


@contextlib.contextmanager
def _rank_rounding(torch, m: int):
    """The unsharded path rounded as a rank of ``m`` model ranks rounds
    (the like-for-like control of the families' TP gaps): a row-parallel
    product (``tp.Whole.matmul`` of a weight whose first dim is ``H`` or
    ``F``: Mamba2's, the mLSTM's and the sLSTM's ``w_out``, Whisper's
    ``wo`` and ``w_down``) in f32, rounded once; ``tp.Whole.rms_norm``'s
    squared sums made on ``m`` blocks of the vector and added in f32; and
    a column-parallel product's input gradient (a weight whose second dim
    is ``H``, ``KV``, ``F``, ``Hm`` or ``V``) the f32 sum of its ``m``
    column blocks' products, each rounded to the input's dtype first, as
    the ranks' partial gradients are before ``tp.enter`` sums them."""
    from repro_torch.distributed import tp

    class ColumnBlocks(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return x @ w

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            n = w.shape[1] // m
            dx = sum((g[..., i * n:(i + 1) * n]
                      @ w[:, i * n:(i + 1) * n].T).float()
                     for i in range(m)).to(x.dtype)
            dw = (x.reshape(-1, x.shape[-1]).T
                  @ g.reshape(-1, g.shape[-1])).to(w.dtype)
            return dx, dw

    orig_mm, orig_norm = tp.Whole.matmul, tp.Whole.rms_norm

    def matmul(self, x, w, dims, shape, axes=(), scatter=False):
        if dims[0] in ("H", "F"):
            return torch.matmul(x.float(), w.float()).to(x.dtype)
        if dims[1] in ("H", "KV", "F", "Hm", "V") and w.shape[1] % m == 0:
            return ColumnBlocks.apply(x, w)
        return x @ w

    def rms_norm(self, x, gamma, axes, width, eps=1e-6):
        xf = x.float()
        ss = xf.square().reshape(*xf.shape[:-1], m, -1).sum(-1).sum(
            -1, keepdim=True)
        return (xf * torch.rsqrt(ss / width + eps)).to(x.dtype) * gamma
    tp.Whole.matmul, tp.Whole.rms_norm = matmul, rms_norm
    try:
        yield
    finally:
        tp.Whole.matmul, tp.Whole.rms_norm = orig_mm, orig_norm


def _tp_hot(state):
    """A copy of the hot tier's integer state on the host."""
    return [t.to("cpu", copy=True) for t in state["hot_buf"]
            if not t.is_floating_point()]


def _tp_greedy(torch, m, params, state, logits0, steps: int, gates=None):
    """``steps`` greedy decode steps from the prefill's logits: each
    step's logits and fed tokens (on the host) and wall seconds; with
    ``gates`` (a list) the decode steps' expert choices are recorded."""
    tok = logits0.argmax(-1).to(torch.int32)
    logits, fed, wall = [logits0.cpu()], [], []
    with _tp_gates(gates):
        for _ in range(steps):
            fed.append(tok.cpu())
            _tp_sync(torch)
            t1 = time.perf_counter()
            state, lg = m.decode(params, state, tok)
            _tp_sync(torch)
            wall.append(time.perf_counter() - t1)
            logits.append(lg.cpu())
            tok = lg.argmax(-1).to(torch.int32)
    return state, logits, fed, wall


def _tp_reference(torch, ops, case, mesh):
    """The unsharded run of a case's requests (prefill, greedy steps, the
    hot tier's integer state, the decode steps' expert choices), then the
    TP path at ``mesh``, a world of one rank: its weights drawn by
    ``init_shards`` (Qwen2-1.5B; DeepSeek-V3.2's 50 GB are the unsharded
    run's, whose blocks are whole at one rank) and its steps under
    ``use_rules(SERVE_RULES, mesh)`` over the sharded pool, which must
    equal the unsharded run bit for bit: weights, logits, tokens, hot
    tier, expert choices."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    cfg = _tp_cfg(case)
    prompts = _tp_prompts(torch, cfg, case)
    m = build_model(cfg, topk_fn=_tp_topk, device=TP_DEV, opts=_tp_opts(cfg))
    params = m.init(torch.Generator(device=TP_DEV).manual_seed(0))
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    gates = [] if cfg.n_experts else None
    with _tp_gates(gates):
        state, lg0 = _tp_state(torch, m, params, prompts, case)
    state, logits, fed, wall = _tp_greedy(torch, m, params, state, lg0,
                                          case["steps"], gates)
    ref = dict(logits=logits, tokens=fed, hot=_tp_hot(state), gates=gates,
               launches=ops.launch_counts(), wall_s=wall,
               seconds=time.perf_counter() - t0, peak_bytes=_tp_peak(torch))
    del state
    if case.get("grouped"):         # (c)'s reference: the same weights
        ref["grouped"] = _tp_grouped_serve(torch, ops, _tp_grouped_model(
            cfg), params, prompts, case)
    if not cfg.n_experts:
        # the unsharded run with its row-parallel products (``wo``,
        # ``w_down``) made as the TP ranks make them: in f32, rounded once
        with _f32_row_products(torch):
            st, lg = _tp_state(torch, m, params, prompts, case)
            got = [lg.cpu()]
            for tok in fed:
                st, lg = m.decode(params, st, tok.to(TP_DEV))
                got.append(lg.cpu())
        del st
        near = [_tp_near(a[i], b[i]) for a, b in zip(got, logits)
                for i in range(a.shape[0])]
        ref["f32_products"] = [max(x[j] for x in near) for j in range(3)]
    mt = build_model(cfg, fetch_fn=make_pooled_fetch(mesh), topk_fn=_tp_topk,
                     device=TP_DEV, opts=_tp_opts(cfg))
    with shd.use_rules(shd.SERVE_RULES, mesh):
        if cfg.n_experts:
            same_weights, tp_params = True, params
        else:
            tp_params = shd.init_shards(
                mt.specs, torch.Generator(device=TP_DEV).manual_seed(0),
                TP_DEV)
            same_weights = _state_equal(torch, _tree_tensors(params),
                                        _tree_tensors(tp_params))
            del params
        ops.reset_launch_counts()
        tgates = [] if cfg.n_experts else None
        with _tp_gates(tgates):
            state, lg0 = _tp_state(torch, mt, tp_params, prompts, case, mesh)
        state, logits, fed, wall = _tp_greedy(torch, mt, tp_params, state,
                                              lg0, case["steps"], tgates)
        ref["world_of_one"] = dict(
            weights=same_weights,
            logits=_state_equal(torch, logits, ref["logits"]),
            tokens=_state_equal(torch, fed, ref["tokens"]),
            hot_tier=_state_equal(torch, _tp_hot(state), ref["hot"]),
            gates=(tgates is None or all(
                torch.equal(a[0], b[0]) for a, b in zip(tgates, gates))),
            launches=ops.launch_counts(),
            wall_s_per_decode_step_median=_median(wall))
    return ref


def _tp_deepseek_child(rank, world, port, out_dir):
    """Phase 19 (b)'s unsharded DeepSeek-V3.2 run in a process of its own
    (its 50 GB of weights leave the card when it exits, before the TP
    ranks start), with the TP path at an NCCL world of one beside it."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if TP_DEV == "cuda":
        torch.cuda.set_device(0)
    _wait_file(Path(out_dir) / "go")
    _tp_world_of_one(torch, dist, port)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=TP_DEV)
        ref = _tp_reference(torch, ops, TP_CASES["deepseek-v32"], mesh)
        torch.save(ref, Path(out_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()


def _wait_file(path, spawned=None, timeout_s: float = 900.0):
    """Wait until ``path`` exists (another process of the phase made it);
    with ``spawned`` (the ranks' context) fail as soon as a rank does."""
    t0 = time.perf_counter()
    while not path.exists():
        if spawned is not None and spawned.join(timeout=0.05):
            raise RuntimeError(f"the ranks ended before {path.name}")
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"no {path.name} after {timeout_s} s")
        time.sleep(0.05)


def _tp_grouped_model(cfg, mesh=None):
    """A model at TP_GROUPED's groups (over the sharded pool with
    ``mesh``)."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.models.model import build_model
    fetch = {} if mesh is None else dict(fetch_fn=make_pooled_fetch(mesh))
    return build_model(cfg, topk_fn=_tp_topk, device=TP_DEV,
                       opts={"moe_groups": TP_GROUPED["groups"]}, **fetch)


@contextlib.contextmanager
def _moe_collectives(kinds):
    """While open, the collectives inside each ``moe_block`` call are
    counted by kind on ``kinds`` (a ``_CollectiveKinds``)."""
    from repro_torch.models import moe
    orig = moe.moe_block

    def counted(*a, **kw):
        with kinds:
            return orig(*a, **kw)
    moe.moe_block = counted
    try:
        yield
    finally:
        moe.moe_block = orig


def _tp_grouped_serve(torch, ops, m, params, prompts, case, mesh=None,
                      fed=None):
    """(c)'s serve run: ``prompts`` prefilled at TP_GROUPED's groups (the
    pool cut to the rank's slice with ``mesh``), then TP_GROUPED["steps"]
    decode steps, greedy or fed ``fed``'s tokens: the logits, the fed
    tokens, the expert choices, the MoE blocks' collectives by kind (the
    prefill's, then the whole run's), the launches, wall s and peak."""
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    kinds, gates, logits, toks = _CollectiveKinds(), [], [], []
    t0 = time.perf_counter()
    with _moe_collectives(kinds), _tp_gates(gates):
        state, lg = _tp_state(torch, m, params, prompts, case, mesh)
        prefill = dict(kinds.counts)
        logits.append(lg.cpu())
        for i in range(TP_GROUPED["steps"]):
            tok = (lg.argmax(-1).to(torch.int32) if fed is None
                   else fed[i].to(TP_DEV))
            toks.append(tok.cpu())
            state, lg = m.decode(params, state, tok)
            logits.append(lg.cpu())
    _tp_sync(torch)
    return dict(logits=logits, tokens=toks, gates=gates,
                moe_collectives_prefill=prefill,
                moe_collectives=dict(kinds.counts),
                launches=ops.launch_counts(),
                seconds=time.perf_counter() - t0, peak_bytes=_tp_peak(torch))


def _tp_grouped_batch(torch, cfg, lanes=slice(None)):
    g = torch.Generator().manual_seed(1)
    case = TP_GROUPED["train"]
    t = torch.randint(0, cfg.vocab, (case["batch"], case["seq"] + 1),
                      generator=g, dtype=torch.int32)[lanes]
    return {"tokens": t[:, :-1].to(TP_DEV), "labels": t[:, 1:].to(TP_DEV)}


def _tp_grouped_train_reference(torch, path):
    """(c)'s unsharded training step at TP_GROUPED's groups, made by the
    phase's parent: its loss, ``aux`` and gradients saved on the host at
    ``path`` (phase 21's layout); returns the loss, wall s and peak."""
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import make_grad_fn
    from repro_torch.training.optimizer import tree_map
    case = TP_GROUPED["train"]
    cfg = _tp_cfg(case)
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = build_model(cfg, device=TP_DEV, remat=not case["f32"],
                    opts={"moe_groups": TP_GROUPED["groups"]})
    params = m.init(torch.Generator(device=TP_DEV).manual_seed(0))
    if case["f32"]:
        params = tree_map(lambda t: t.float(), params)
    with _fam_precision(torch, case):
        metrics, grads = make_grad_fn(m)(params, _tp_grouped_batch(torch,
                                                                   cfg))
    del params
    out = dict(loss=float(metrics["loss"]), aux=float(metrics["aux"]),
               peak_bytes=_tp_peak(torch))
    torch.save(dict(out, paths=_tree_paths(grads),
                    grads=[g.cpu() for g in _tree_tensors(grads)]), path)
    del grads
    out["seconds"] = time.perf_counter() - t0
    return out


def _block_rel_l2(torch, plan, mesh, specs, got, ref_grads, leaves) -> list:
    """Each of ``leaves``' relative L2 from the reference's gradient, from
    the rank's blocks alone (``got``): the squared sums of its difference
    from the reference's block and of that block, summed over the mesh
    with one replica of each block (``block_sums``)."""
    from repro_torch.distributed import sharding as shd
    diff, norm = [], []
    for i in leaves:
        w = shd._cut(ref_grads[i], shd.spec_for(
            specs[i].dims, specs[i].shape), mesh).to(TP_DEV).float()
        diff.append((got[i].float() - w).square().sum())
        norm.append(w.square().sum())
    sums = plan.block_sums(torch.stack(diff + norm), [
        (specs[i].dims, specs[i].shape) for i in leaves] * 2)
    n = len(leaves)
    return [float((sums[k] / sums[n + k]).sqrt()) for k in range(n)]


def _tp_rank_grouped_train(torch, mesh, path):
    """(c)'s training step on one rank at (2, 2): its blocks of the
    weights under TRAIN_RULES (drawn by ``init_shards``) and its lanes,
    the step's gradients at TP_GROUPED's groups; each leaf's relative L2
    from the unsharded step's on the rank's blocks; the control, before
    the batch-axis sums; the collectives of the step and those inside
    its MoE blocks (the forward's, and the recompute's where the step
    checkpoints), wall s and peak."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import tree_map
    ref = torch.load(path, mmap=True, weights_only=False)
    case = TP_GROUPED["train"]
    cfg = _tp_cfg(case)
    m = build_model(cfg, device=TP_DEV, remat=not case["f32"],
                    opts={"moe_groups": TP_GROUPED["groups"]})
    nd, d = mesh.size(0), mesh.get_local_rank("data")
    rows = TP_GROUPED["train"]["batch"] // nd
    batch = _tp_grouped_batch(torch, cfg, slice(d * rows, (d + 1) * rows))
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shd.use_rules(shd.TRAIN_RULES, mesh), _fam_precision(torch, case):
        params = shd.init_shards(m.specs, torch.Generator(
            device=TP_DEV).manual_seed(0), TP_DEV)
        if case["f32"]:
            params = tree_map(lambda t: t.float(), params)
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _tree_tensors(params))
        kept, reduce = {}, train_loop.reduce_grads

        def keep_local(grads, specs, plan):
            kept["local"] = grads
            return reduce(grads, specs, plan)
        train_loop.reduce_grads = keep_local
        moe_kinds = _CollectiveKinds()
        try:
            with _CollectiveKinds() as kinds, _moe_collectives(moe_kinds):
                _tp_sync(torch)
                t1 = time.perf_counter()
                metrics, grads = train_loop.make_step_grads(m)(params, batch)
                _tp_sync(torch)
                wall = time.perf_counter() - t1
        finally:
            train_loop.reduce_grads = reduce
        specs = _tree_tensors(m.specs)
        plan = train_loop.plan_of(m)
        live = [i for i, g in enumerate(ref["grads"]) if bool(g.any())]
        grad_rel = _block_rel_l2(torch, plan, mesh, specs,
                                 _tree_tensors(grads), ref["grads"], live)
        summed = [i for i in live
                  if plan.grad_sum_axes(specs[i].dims, specs[i].shape)]
        control = _block_rel_l2(torch, plan, mesh, specs,
                                _tree_tensors(kept.pop("local")),
                                ref["grads"], summed)
    return dict(loss=float(metrics["loss"]), aux=float(metrics["aux"]),
                grad_rel_l2=grad_rel, leaves=[ref["paths"][i] for i in live],
                control_grad_rel_l2=control, grads_wall_s=wall,
                weight_bytes=weight_bytes, collectives=dict(kinds.counts),
                moe_collectives=dict(moe_kinds.counts),
                peak_bytes=_tp_peak(torch), seconds=time.perf_counter() - t0)


def _tp_rank_case(torch, dist, ops, case, mesh, tokens, rank, world,
                  grouped_tokens=None):
    """One TP case on one of the four gloo ranks: the rank's blocks of the
    weights (drawn leaf by leaf, one rank at a time: a whole expert stack
    is 7.5 GB), its lanes prefilled, the unsharded run's tokens fed for
    the case's steps; then two profiled steps (on rank 0; the others run
    them), and the control: the last step again from a copy of its state
    with model rank 1's ``wo`` blocks zeroed."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pool_layer_params
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg = _tp_cfg(case)
    per = case["requests"] // mesh.size(0)
    d = mesh.get_local_rank("data")
    lanes = list(range(d * per, (d + 1) * per))
    prompts = _tp_prompts(torch, cfg, case)[d * per:(d + 1) * per]
    m = build_model(cfg, fetch_fn=make_pooled_fetch(mesh), topk_fn=_tp_topk,
                    device=TP_DEV, opts=_tp_opts(cfg))
    L = cfg.n_layers
    with shd.use_rules(shd.SERVE_RULES, mesh):
        for r in range(world):
            if r == rank:
                params = shd.init_shards(
                    m.specs, torch.Generator(device=TP_DEV).manual_seed(0),
                    TP_DEV)
                _tp_sync(torch)
                torch.cuda.empty_cache()
            dist.barrier()
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _tree_tensors(params))
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        gates = [] if cfg.n_experts else None
        with _tp_gates(gates):
            state, lg0 = _tp_state(torch, m, params, prompts, case, mesh)
        prefill_s = time.perf_counter() - t0
        launches_prefill = ops.launch_counts()
        logits, wall = [lg0.cpu()], []
        with _tp_gates(gates):
            for i, tok in enumerate(tokens[:case["steps"]]):
                if i == case["steps"] - 1:
                    before_last = _tp_clone(state)
                _tp_sync(torch)
                t1 = time.perf_counter()
                state, lg = m.decode(params, state,
                                     tok[d * per:(d + 1) * per].to(TP_DEV))
                _tp_sync(torch)
                wall.append(time.perf_counter() - t1)
                logits.append(lg.cpu())
        launches = ops.launch_counts()
        hot = _tp_hot(state)
        last = {"tok": tokens[case["steps"] - 1][d * per:(d + 1) * per]
                .to(TP_DEV)}

        def step():
            last["state"], _ = m.decode(params, last.get("state", state),
                                        last["tok"])
        if rank == 0 and TP_DEV == "cuda":
            prof = profile_steps(
                torch, step, n_steps=2,
                device_kernels=SERVES[case["arch"]]["device_kernels"],
                spans={"pool_layer": L})
        else:
            step()
            step()
            prof = None
        peak = _tp_peak(torch)
        del state, last
        grouped = None
        if grouped_tokens is not None:      # (c) on the same blocks
            grouped = _tp_grouped_serve(
                torch, ops, _tp_grouped_model(cfg, mesh), params, prompts,
                case, mesh, [t[d * per:(d + 1) * per] for t in grouped_tokens])
        # the control: the last step again from its state, with model
        # rank 1's ``wo`` blocks zeroed
        if mesh.get_local_rank("model") == 1:
            for layer in pool_layer_params(cfg, params):
                layer["attn"]["wo"].zero_()
        _, lg = m.decode(params, before_last,
                         tokens[case["steps"] - 1][d * per:(d + 1) * per]
                         .to(TP_DEV))
        control = lg.cpu()
    return dict(lanes=lanes, model_rank=mesh.get_local_rank("model"),
                logits=logits, control=control, gates=gates, hot=hot,
                launches=launches, wall_s=wall, prefill_s=prefill_s,
                weight_bytes=weight_bytes, peak_bytes=peak, profile=prof,
                grouped=grouped, launches_prefill=launches_prefill,
                seconds=time.perf_counter() - t0)


def _tp_clone(state):
    """A copy of a serve state (its pools, hot tier and counters)."""
    from repro_torch.core.hisparse import BufferState
    return {k: (BufferState(*(t.clone() for t in v)) if k == "hot_buf"
                else v.clone()) for k, v in state.items()}


def _tree_tensors(tree) -> list:
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v)]
    return [tree]


def _tp_rank(rank, world, port, out_dir):
    """Phase 19, one of four ranks sharing card 0 over gloo: every case
    of TP_CASES at each of its meshes, in order."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    # segments that grow in place: four processes share the card, and
    # a rank's freed blocks must not stay stranded in its cache
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if TP_DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _wait_file(Path(out_dir) / "inputs.ready")
        inp = torch.load(Path(out_dir) / "inputs.pt", weights_only=False)
        out = {}
        for arch, case in TP_CASES.items():
            for shape in case["meshes"]:
                mesh = make_mesh(shape, ("data", "model"), device=TP_DEV)
                out[arch, shape] = _tp_rank_case(
                    torch, dist, ops, case, mesh, inp[arch], rank, world,
                    inp.get(("grouped", arch)) if shape == (2, 2) else None)
                gc.collect()
                torch.cuda.empty_cache()
                dist.barrier()
            if arch == "deepseek-v32" and rank == 0:
                # its blocks have left the card: the parent makes (c)'s
                # training reference while the other cases run
                (Path(out_dir) / "deepseek.done").touch()
        _wait_file(Path(out_dir) / "grouped.ready")
        mesh = make_mesh((2, 2), ("data", "model"), device=TP_DEV)
        out["grouped_train"] = _tp_rank_grouped_train(
            torch, mesh, Path(out_dir) / "grouped_train.pt")
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tp_near(got, want):
    """(relative L2, logits outside BF16_TOL, the worst ratio to it)."""
    got, want = got.double(), want.double()
    err = ((got - want).norm() / want.norm()).item()
    ratio = (got - want).abs() / (TP_BF16_TOL + TP_BF16_TOL * want.abs())
    return err, int((ratio > 1).sum()), ratio.max().item()


def _tp_flips(ref_gates, gates, lane: int, step: int, layers: int,
              prompt: int):
    """The layers whose experts for the token behind ``lane``'s logits at
    ``step`` differ between the runs (step 0: the prefill's last prompt
    token, the dispatch of the whole [B, prompt] batch; step i: decode
    step i), each with the unsharded run's gap at that token."""
    token = lane * prompt + prompt - 1 if step == 0 else lane
    out = []
    for layer in range(layers):
        a = ref_gates[step * layers + layer]
        b = gates[step * layers + layer]
        if not bool((a[0][token] == b[0][token]).all()):
            out.append(dict(layer=layer, gap=float(a[1][token])))
    return out


def _grouped_flips(ref_gates, gates, lane, step, layers, d, per, prompt,
                   groups):
    """(c)'s ``_tp_flips``: the unsharded prefill dispatches each of its
    ``groups`` groups on its own (a record a group a layer), a rank its
    one group (``d``, its data index); a decode step dispatches the whole
    batch as one group on both."""
    out = []
    for layer in range(layers):
        if step == 0:
            a = ref_gates[layer * groups + d]
            b = gates[layer]
            token = (lane - d * per) * prompt + prompt - 1
        else:
            a = ref_gates[layers * groups + (step - 1) * layers + layer]
            b = gates[layers + (step - 1) * layers + layer]
            token = lane
        if not bool((a[0][token] == b[0][token]).all()):
            out.append(dict(layer=layer, gap=float(a[1][token])))
    return out


def _tp_grouped_check(ref, ranks, smi: str, add, child_s: float) -> list:
    """Phase 19 (c)'s limits over the ranks' results: the serve run's
    logits as (b)'s (but where an expert choice differs at a gate near a
    tie: listed, at most half), the kernels of the decode path launched;
    the training step's loss and ``aux`` and each leaf within
    TP_GROUPED's limits of the unsharded step's, the control outside;
    the records, with each rank's MoE collectives, peak and seconds."""
    case = TP_CASES["deepseek-v32"]
    want = ref["grouped"]
    L, G = _tp_cfg(case).n_layers, TP_GROUPED["groups"]
    per = case["requests"] // 2
    failures, worst, exempt, missing = [], [0.0, 0, 0.0], [], []
    for r, res in enumerate(ranks):
        x = res["deepseek-v32", (2, 2)]["grouped"]
        add(x["launches"])
        d = r // 2
        for step, got in enumerate(x["logits"]):
            for i in range(got.shape[0]):
                lane = d * per + i
                err, n_out, top = _tp_near(got[i], want["logits"][step][lane])
                ok = err <= TP_REL_L2 and n_out <= TP_MISS_FRAC * got.shape[-1]
                flips = [] if ok else _grouped_flips(
                    want["gates"], x["gates"], lane, step, L, d, per,
                    case["context"], G)
                if not ok and flips and all(f["gap"] < TP_GATE_TIE
                                            for f in flips):
                    exempt.append(dict(rank=r, lane=lane, step=step,
                                       rel_l2=err, flips=flips))
                    continue
                worst = [max(worst[0], err), max(worst[1], n_out),
                         max(worst[2], top)]
                if not ok:
                    failures.append(("grouped serve", r, lane, step, err,
                                     n_out, flips))
        path = ("indexer_scores", "gather_kv.shard", "sparse_attn",
                "scatter_kv.rows_at_shard")
        missing += [(r, k) for k in path
                    if TP_DEV == "cuda" and not x["launches"].get(k)]
        # the slots out and back, and the combine's sum reduce-scattered
        # to the rank's block of the sequence (the residual is split)
        moe = x["moe_collectives_prefill"]
        if moe.get("all-to-all") != 2 * L or moe.get(
                "reduce-scatter") != L or any(
                n for k, n in moe.items() if k not in (
                    "all-to-all", "all-gather", "all-reduce",
                    "reduce-scatter")):
            failures.append(("grouped prefill's MoE collectives", r, moe))
    held = case["requests"] * (TP_GROUPED["steps"] + 1)
    if len({(e["lane"], e["step"]) for e in exempt}) > held // 2:
        failures.append(("grouped serve routing flips", exempt))
    if missing:
        failures.append(("grouped serve kernels", missing))
    emit(dict(phase="tensor_parallel", run="gloo_4_ranks_grouped_serve",
              config="deepseek-v32", mesh=[2, 2], card=smi,
              moe_groups=G, requests=case["requests"],
              context=case["context"], decode_steps=TP_GROUPED["steps"],
              limits=dict(rel_l2=TP_REL_L2, bf16_tol=TP_BF16_TOL,
                          miss_frac=TP_MISS_FRAC),
              worst_rel_l2=worst[0], worst_logits_outside=worst[1],
              worst_ratio=worst[2], exempt_routing_flips=exempt,
              kernels_missing=missing,
              unsharded=dict(seconds=want["seconds"],
                             peak_bytes=want["peak_bytes"],
                             moe_collectives=want["moe_collectives"]),
              ranks=[dict(moe_collectives_prefill=x["moe_collectives_prefill"],
                          moe_collectives=x["moe_collectives"],
                          peak_bytes=x["peak_bytes"], seconds=x["seconds"])
                     for x in (res["deepseek-v32", (2, 2)]["grouped"]
                               for res in ranks)],
              peak_bytes_was=PEAK_WAS.get(("grouped_serve",)),
              launches_rank0=ranks[0]["deepseek-v32", (2, 2)]["grouped"][
                  "launches"]))
    tr = [res["grouped_train"] for res in ranks]
    tref = ref["grouped_train"]
    loss_rel = max(abs(x["loss"] - tref["loss"]) / abs(tref["loss"])
                   for x in tr)
    aux_rel = max(abs(x["aux"] - tref["aux"]) / abs(tref["aux"]) for x in tr)
    errs = [max(x["grad_rel_l2"]) for x in tr]
    leaves = tr[0]["leaves"]
    at = max(range(len(leaves)), key=lambda i: max(x["grad_rel_l2"][i]
                                                   for x in tr))
    ctrl = min(max(x["control_grad_rel_l2"]) for x in tr)
    emit(dict(phase="tensor_parallel", run="gloo_4_ranks_grouped_train",
              config=TP_GROUPED["train"]["arch"],
              layers=TP_GROUPED["train"]["n_layers"], mesh=[2, 2], card=smi,
              moe_groups=G, batch=[TP_GROUPED["train"]["batch"],
                                   TP_GROUPED["train"]["seq"]],
              f32=TP_GROUPED["train"]["f32"], limits=TP_GROUPED["limits"],
              loss_rel=loss_rel, aux_rel=aux_rel,
              worst_grad_rel_l2=max(errs), worst_leaf=leaves[at],
              grad_rel_l2_median=sorted(tr[0]["grad_rel_l2"])[
                  len(leaves) // 2],
              control_least_worst=ctrl,
              unsharded=dict(seconds=tref["seconds"],
                             peak_bytes=tref["peak_bytes"]),
              ranks=[dict(weight_bytes=x["weight_bytes"],
                          peak_bytes=x["peak_bytes"],
                          collectives=x["collectives"],
                          moe_collectives=x["moe_collectives"],
                          grads_wall_s=x["grads_wall_s"],
                          seconds=x["seconds"]) for x in tr],
              peak_bytes_was=PEAK_WAS.get(("grouped_train",))))
    lim = TP_GROUPED["limits"]
    if not (loss_rel <= lim["loss_rel"] and aux_rel <= lim["loss_rel"]
            and max(errs) <= lim["grad_rel_l2"]):
        failures.append(("grouped train", loss_rel, aux_rel, max(errs),
                         leaves[at]))
    if not ctrl > lim["grad_rel_l2"]:
        failures.append(("grouped train control within", ctrl))
    if any(x["moe_collectives"].get("all-to-all", 0) < 2 * L for x in tr):
        failures.append(("grouped train: no all-to-all",
                         [x["moe_collectives"] for x in tr]))
    emit(dict(phase="tensor_parallel_grouped", card=smi,
              child_seconds=child_s,
              unsharded_seconds=want["seconds"] + tref["seconds"],
              rank0_seconds=ranks[0]["deepseek-v32", (2, 2)]["grouped"][
                  "seconds"] + tr[0]["seconds"]))
    return failures


def tp_phase(torch, ops, smi: str) -> dict:
    """Phase 19: tensor and expert parallelism of the weights on the card.
    (a) Qwen2-1.5B at full width and depth and (b) DeepSeek-V3.2 at full
    width with 2 layers: the unsharded run (in this process; DeepSeek-V3.2
    in a child) beside the TP path at an NCCL world of one, bit-equal;
    then four gloo ranks sharing the card hold their blocks, are fed the
    unsharded run's tokens, and each rank's logits are held against the
    unsharded run's lanes at the CPU tests' limits, every request and
    step (for DeepSeek-V3.2, but where the runs' experts for that token
    differ: a gate near a tie, listed), with the hot tier's integer state
    exact; the control (model rank 1's ``wo`` zeroed) must fail both
    limits.  (c) The same ranks with MoE dispatch groups over the batch
    axes (TP_GROUPED): DeepSeek-V3.2's prefill and decode on (b)'s
    blocks, and Mixtral-8x22B's training step, each against the
    unsharded run at the same groups (``_tp_grouped_check``).  The four
    ranks start first and wait for the references' tokens.  Returns the
    launches of the path's runs."""
    import tempfile
    t0 = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as child_dir, \
            _started_ranks(_tp_deepseek_child, child_dir, 1) as child, \
            _started_ranks(_tp_rank, tmp_dir.name) as spawned:
        return _tp_phase(torch, ops, smi, t0, tmp_dir, spawned,
                         (child_dir, child))


def _tp_phase(torch, ops, smi, t0, tmp_dir, spawned, child):
    """Phase 19 once its ranks and child are starting (``tp_phase``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    refs, totals = {}, {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
    tmp = tmp_dir.name
    _tp_world_of_one(torch, dist, _free_port())
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=TP_DEV)
        refs["qwen2-1.5b"] = _tp_reference(torch, ops,
                                           TP_CASES["qwen2-1.5b"], mesh)
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    refs["deepseek-v32"] = _go(child)[0]
    child_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    for arch, ref in refs.items():
        one = ref["world_of_one"]
        add(one["launches"])
        emit(dict(phase="tensor_parallel", run="nccl_world_1", config=arch,
                  card=smi, equal_unsharded={k: one[k] for k in (
                      "weights", "logits", "tokens", "hot_tier", "gates")},
                  launches=one["launches"],
                  wall_s_per_decode_step_median=one[
                      "wall_s_per_decode_step_median"],
                  wall_s_per_decode_step_median_unsharded=_median(
                      ref["wall_s"]),
                  peak_bytes_unsharded=ref["peak_bytes"]))
        if not all(one[k] for k in ("weights", "logits", "tokens",
                                    "hot_tier", "gates")):
            raise AssertionError(f"TP at a world of one differs from the "
                                 f"unsharded {arch}: {one}")
    with tmp_dir:
        inputs = {arch: ref["tokens"] for arch, ref in refs.items()}
        inputs.update({("grouped", arch): ref["grouped"]["tokens"]
                       for arch, ref in refs.items() if "grouped" in ref})
        torch.save(inputs, Path(tmp) / "inputs.pt")
        (Path(tmp) / "inputs.ready").touch()
        t1 = time.perf_counter()
        # (c)'s unsharded training step, made once (b)'s DeepSeek-V3.2
        # blocks have left the card, while the ranks run the other cases
        _wait_file(Path(tmp) / "deepseek.done", spawned)
        refs["deepseek-v32"]["grouped_train"] = _tp_grouped_train_reference(
            torch, Path(tmp) / "grouped_train.pt")
        gc.collect()
        torch.cuda.empty_cache()
        (Path(tmp) / "grouped.ready").touch()
        while not spawned.join():
            pass
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(4)]
        ranks_s = time.perf_counter() - t1
    failures = []
    for arch, case in TP_CASES.items():
        ref, L = refs[arch], _tp_cfg(case).n_layers
        steps = case["steps"]
        for shape in case["meshes"]:
            worst = [0.0, 0, 0.0]
            control_least = [math.inf, math.inf]
            exempt = []
            kernels_missing = []
            for r, res in enumerate(ranks):
                x = res[arch, shape]
                lanes = x["lanes"]
                add(x["launches"])
                for step, (got, want) in enumerate(zip(x["logits"],
                                                       ref["logits"])):
                    for i, lane in enumerate(lanes):
                        err, n_out, top = _tp_near(got[i], want[lane])
                        flips = ([] if not ref["gates"] else _tp_flips(
                            ref["gates"], x["gates"], lane, step, L,
                            case["context"]))
                        ok = (err <= TP_REL_L2 and
                              n_out <= TP_MISS_FRAC * want.shape[-1])
                        if not ok and flips and all(
                                f["gap"] < TP_GATE_TIE for f in flips):
                            exempt.append(dict(rank=r, lane=lane, step=step,
                                               rel_l2=err, flips=flips))
                            continue
                        worst = [max(worst[0], err), max(worst[1], n_out),
                                 max(worst[2], top)]
                        if not ok:
                            failures.append((arch, shape, r, lane, step,
                                             err, n_out, top, flips))
                for i, lane in enumerate(lanes):
                    err, n_out, _ = _tp_near(x["control"][i],
                                             ref["logits"][steps][lane])
                    control_least = [min(control_least[0], err),
                                     min(control_least[1], n_out)]
                    if not (err > TP_REL_L2 and
                            n_out > TP_MISS_FRAC * x["control"].shape[-1]):
                        failures.append((arch, shape, r, lane,
                                         "control within the limits"))
                want_hot = [t[:, lanes] for t in ref["hot"]]
                if not _state_equal(torch, x["hot"], want_hot):
                    failures.append((arch, shape, r, "hot tier", [
                        (tuple(a.shape), tuple(b.shape), int((a != b).sum()))
                        for a, b in zip(x["hot"], want_hot)]))
                path = ("indexer_scores", "gather_kv.shard",
                        SERVES[arch]["attn"], "scatter_kv.rows_at_shard")
                kernels_missing += [(r, k) for k in path
                                    if TP_DEV == "cuda"
                                    and not x["launches"].get(k)]
                # the split prefill's warm-up plan: the indexer on the
                # rank's slice of the positions, once a layer
                if TP_DEV == "cuda" and x["launches_prefill"].get(
                        "indexer_scores") != _tp_cfg(case).n_layers:
                    kernels_missing.append((r, "indexer_scores (prefill)"))
            x0 = ranks[0][arch, shape]
            prof = x0["profile"] or dict(
                launches_per_step=None, launches_ex_per_step=None,
                device_busy_s=math.nan, device_busy_share=None, host_ops={},
                port_kernels=None)
            emit(dict(
                phase="tensor_parallel", run="gloo_4_ranks_one_card",
                config=arch, mesh=list(shape), card=smi,
                requests=case["requests"], context=case["context"],
                decode_steps=steps, limits=dict(
                    rel_l2=TP_REL_L2, bf16_tol=TP_BF16_TOL,
                    miss_frac=TP_MISS_FRAC, miss_factor=TP_MISS_FACTOR),
                worst_rel_l2=worst[0], worst_logits_outside=worst[1],
                worst_ratio=worst[2],
                unsharded_f32_products=ref.get("f32_products"),
                control_least_rel_l2=control_least[0],
                control_least_logits_outside=control_least[1],
                exempt_routing_flips=exempt,
                rank0=dict(
                    weight_bytes=x0["weight_bytes"],
                    peak_bytes=x0["peak_bytes"],
                    peak_bytes_was=PEAK_WAS.get(("tp", arch, shape)),
                    prefill_s=x0["prefill_s"],
                    launches_prefill=x0["launches_prefill"],
                    wall_s_per_decode_step_median=_median(x0["wall_s"]),
                    launches=x0["launches"],
                    launches_per_step=prof["launches_per_step"],
                    launches_ex_per_step=prof["launches_ex_per_step"],
                    device_ms_per_step=prof["device_busy_s"] * 1e3 / 2,
                    device_busy_share=prof["device_busy_share"],
                    collectives_per_step={k: v["calls"] / 2 for k, v in
                                          prof["host_ops"].items()},
                    collective_host_ms_per_step=sum(
                        v["host_s"] for v in prof["host_ops"].values())
                    * 1e3 / 2,
                    port_kernels=prof["port_kernels"]),
                kernels_missing=kernels_missing))
            if kernels_missing:
                failures.append((arch, shape, "kernels", kernels_missing))
            held = case["requests"] * (steps + 1)
            if len({(e["lane"], e["step"]) for e in exempt}) > held // 2:
                failures.append((arch, shape, "routing flips", exempt))
    failures += _tp_grouped_check(refs["deepseek-v32"], ranks, smi, add,
                                  child_s)
    emit(dict(phase="tensor_parallel_total", launches=totals,
              ranks_seconds=ranks_s, seconds=time.perf_counter() - t0))
    if failures:
        raise AssertionError(f"tensor parallel: {failures[:12]}")
    return totals


# ---------------------------------------------------------------------------
# phase 20: the d_model rows split across ranks
# ---------------------------------------------------------------------------

# (a) at an NCCL world of one, (b) at FSDP_MESH on four gloo ranks
# sharing the card.  Training: Qwen2-1.5B at full width and depth, the
# train phase's global batch of 8 x 512, FSDP_TRAIN["steps"] steps in
# (a), one step's gradients (and their control) and its AdamW update in
# (b).  Serving (the long_500k cells, B = 1): one request
# over S = 524,288 pool rows, its entries and indexer keys drawn from a
# generator seeded by the layer, ``cache_len`` S - 8, the config's hot
# tier, phase 19's score-independent top-k of 2048, FSDP_SERVE's steps
# (one more on the unsharded run: the control's step)
FSDP_TRAIN = dict(arch="qwen2-1.5b", n_layers=None, batch=8, seq=512,
                  steps=3)
# each serve case's coarse limits on a rank's logits a step: relative L2
# and the share of the logits outside BF16_TOL (see below)
FSDP_SERVE = {"qwen2-1.5b": dict(arch="qwen2-1.5b", n_layers=None,
                                 seq=524288, steps=4, limits=(5.7e-2, 0.55)),
              "deepseek-v32": dict(arch="deepseek-v32", n_layers=2,
                                   seq=524288, steps=4,
                                   limits=(TP_REL_L2, TP_MISS_FRAC))}
FSDP_MESH = (2, 2)
# (b)'s limits, fixed.  Tight, where rounding has not yet been amplified
# by the random layers: the global loss and the gradient norm relative
# (FSDP_LOSS_REL), and the residual stream after each of the first
# FSDP_TIGHT_LAYERS pool layers of the first decode step, relative L2
# (FSDP_HIDDEN_REL_L2).  Coarse, at full depth: each gathered gradient
# leaf, relative L2 (FSDP_GRAD_REL_L2; on an H100 the unsharded bf16
# step's leaves are up to 3.22 % from a float64 run of the same step),
# and each serve case's logits at its ``limits``: Qwen2-1.5B's 28 layers
# carry a change of rounding alone (the unsharded long_500k decode made
# with a rank's f32 products) to 3.78 % relative L2 and 36.5 % of the
# logits outside BF16_TOL, so its limits are 1.5 times those; the
# 2-layer DeepSeek-V3.2 case meets phase 19's
FSDP_LOSS_REL, FSDP_GRAD_REL_L2 = 1e-3, 5e-2
FSDP_TIGHT_LAYERS, FSDP_HIDDEN_REL_L2 = 2, 1e-2
# the reduced configs at small sizes: the CPU rehearsal, and with
# CHIP_SMOKE_FSDP_SMALL=1 the card test (tests/test_torch_fsdp_chip.py)
FSDP_SMALL = TP_DEV == "cpu" or os.environ.get("CHIP_SMOKE_FSDP_SMALL") == "1"
if FSDP_SMALL:
    FSDP_TRAIN = dict(FSDP_TRAIN, batch=4, seq=16, steps=2)
    FSDP_SERVE = {k: dict(v, seq=64, steps=2) for k, v in FSDP_SERVE.items()}


def _fsdp_cfg(case):
    """A case's config (at FSDP_SMALL reduced, its indexer 32 dims wide,
    as the kernel takes it)."""
    from repro_torch.configs import get_config
    if FSDP_SMALL:
        base = get_config(case["arch"]).reduced()
        return dataclasses.replace(base, sac=dataclasses.replace(
            base.sac, d_idx=32))
    return _tp_cfg(case)


def _fsdp_topk(scores, cache_len):
    """Phase 19's injected top-k, 16 lanes at FSDP_SMALL."""
    return _small_topk(scores, cache_len, 16 if FSDP_SMALL else 2048)


def _fsdp_serve_rules():
    from repro_torch.distributed import sharding as shd
    return dict(shd.SERVE_RULES, D=("data",))


def _fsdp_batch(torch, cfg, lanes=None):
    """The training batch (tokens and labels of FSDP_TRAIN's rows, from a
    seeded generator), or its rows ``lanes``."""
    t = torch.randint(0, cfg.vocab, (FSDP_TRAIN["batch"],
                                     FSDP_TRAIN["seq"] + 1),
                      generator=torch.Generator().manual_seed(0),
                      dtype=torch.int32)
    if lanes is not None:
        t = t[lanes]
    return {"tokens": t[:, :-1].to(TP_DEV), "labels": t[:, 1:].to(TP_DEV)}


def _fsdp_tokens(torch, cfg, n: int):
    """The serve runs' fed tokens, one a step (B = 1)."""
    return torch.randint(0, cfg.vocab, (n, 1),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)


def _bit_sums(torch, tree) -> list:
    """Each leaf's bits summed twice in 64-bit integers, once weighted by
    2i + 1 (odd: any one changed element changes it), on the host."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in _tree_tensors(tree):
        v = t.detach().contiguous().view(ints[t.element_size()]) \
            .reshape(-1).long()
        w = torch.arange(v.numel(), device=v.device, dtype=torch.int64)
        out.append((int((v * (2 * w + 1)).sum()), int(v.sum())))
        del v, w
    return out


def _tree_paths(tree, path="") -> list:
    """The leaf paths of a tree of dicts and lists, in ``_tree_tensors``'
    order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _tree_paths(v,
                                                              f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in _tree_paths(v, f"{path}/{i}")]
    return [path]


def _fsdp_train_run(torch, m, params, mesh=None, grads_path=None):
    """FSDP_TRAIN["steps"] steps from ``params`` (the rank's blocks under
    ``use_rules(TRAIN_RULES, mesh)`` with ``mesh``): each step's loss and
    gradient norm and each leaf's ``_bit_sums`` of the parameters and both
    moments, wall seconds a step and the peak, and with ``mesh`` on the
    card a profile of one more step; with ``grads_path`` the first
    step's gradients are saved there first (phase 20 (b)'s reference)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_grad_fn, make_train_step
    batch = _fsdp_batch(torch, m.cfg)
    ctx = (shd.use_rules(shd.TRAIN_RULES, mesh) if mesh is not None
           else contextlib.nullcontext())
    out = dict(loss=[], grad_norm=[], sums=[], wall_s=[])
    with ctx:
        if grads_path is not None:
            metrics, grads = make_grad_fn(m)(params, batch)
            torch.save({"loss": float(metrics["loss"]),
                        "paths": _tree_paths(grads),
                        "grads": [g.cpu() for g in _tree_tensors(grads)]},
                       grads_path)
            del grads
            gc.collect()
            torch.cuda.empty_cache()
        step = make_train_step(m, OptConfig(warmup_steps=1, total_steps=100))
        opt = init_opt_state(params)
        if TP_DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for _ in range(FSDP_TRAIN["steps"]):
            _tp_sync(torch)
            t1 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            _tp_sync(torch)
            out["wall_s"].append(time.perf_counter() - t1)
            out["loss"].append(float(met["loss"]))
            out["grad_norm"].append(float(met["grad_norm"]))
            out["sums"].append(_bit_sums(torch, [params, opt["m"],
                                                  opt["v"]]))
        out["peak_bytes"] = _tp_peak(torch)
        out["profile"] = None
        if mesh is not None and TP_DEV == "cuda":    # one more step
            state = {"p": params, "o": opt}

            def one():
                state["p"], state["o"], _ = step(state["p"], state["o"],
                                                 batch)
            out["profile"] = profile_steps(torch, one, n_steps=1,
                                           device_kernels=(), spans={})
    return out


def _fsdp_state(torch, m, case, mesh=None):
    """A serve state of one request over ``case["seq"]`` pool rows (the
    rank's slice over ``model`` with ``mesh``): each pool layer's entries
    and indexer keys drawn whole from a generator seeded by the layer
    and cut, the config's hot tier over every row, ``cache_len`` S - 8."""
    from repro_torch.core import hisparse
    from repro_torch.core.pool import PoolShard
    S, dev = case["seq"], m.device
    n = PoolShard.of(mesh, "model").size if mesh is not None else 1
    base = PoolShard.of(mesh, "model").base(S // n) if mesh is not None else 0
    shapes = m.serve_state_shapes(1, S)
    state = {}
    for j, key in enumerate(("kv_pool", "idx_pool")):
        L, B, _, d = shapes[key].shape
        pool = torch.empty((L, B, S // n, d), dtype=shapes[key].dtype,
                           device=dev)
        for layer in range(L):
            g = torch.Generator(device=dev).manual_seed(1000 * j + layer)
            whole = torch.randn((B, S, d), generator=g, device=dev)
            pool[layer] = whole[:, base:base + S // n].to(pool.dtype)
            del whole
        state[key] = pool
    i32 = dict(dtype=torch.int32, device=dev)
    buf = m.cfg.sac.device_buffer_size
    state["hot_buf"] = hisparse.init_layered_buffer(
        m.n_kv, 1, buf, S, m.kv_dim, m.kv_dtype, device=dev)
    for k in ("buf_hits", "buf_misses", "pf_inserted", "pf_useful"):
        state[k] = torch.zeros((1,), **i32)
    for k in ("buf_hits_l", "buf_misses_l"):
        state[k] = torch.zeros((m.n_kv, 1), **i32)
    state["cache_len"] = torch.full((1,), S - 8, **i32)
    return state


def _fsdp_serve_model(cfg, mesh=None):
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.models.model import build_model
    if mesh is None:
        return build_model(cfg, topk_fn=_fsdp_topk, device=TP_DEV)
    return build_model(cfg, fetch_fn=make_pooled_fetch(mesh, batch_axes=()),
                       topk_fn=_fsdp_topk, opts=dict(batch_axes=()),
                       device=TP_DEV)


@contextlib.contextmanager
def _layer_outputs(into: list):
    """While open, each pool layer's decode output (the residual stream
    after the layer, ``transformer._layer_decode``'s first result) is
    copied, unchanged, onto ``into`` in layer order."""
    from repro_torch.models import transformer
    plain = transformer._layer_decode

    def recorded(*args):
        out = plain(*args)
        into.append(out[0].detach().clone())
        return out
    transformer._layer_decode = recorded
    try:
        yield into
    finally:
        transformer._layer_decode = plain


def _fsdp_decode(torch, m, params, state, tokens, n: int, gates=None,
                 hidden=None):
    """``n`` decode steps fed ``tokens``: logits on the host, wall s; with
    ``hidden`` (a list) the first step's residual stream after each pool
    layer is put there, on the host."""
    logits, wall = [], []
    with _tp_gates(gates):
        for i in range(n):
            ctx = (_layer_outputs(hidden) if i == 0 and hidden is not None
                   else contextlib.nullcontext())
            _tp_sync(torch)
            t1 = time.perf_counter()
            with ctx:
                state, lg = m.decode(params, state, tokens[i].to(TP_DEV))
            _tp_sync(torch)
            wall.append(time.perf_counter() - t1)
            logits.append(lg.cpu())
    if hidden is not None:
        hidden[:] = [h.cpu() for h in hidden]
    return state, logits, wall


def _fsdp_serve_reference(torch, ops, case, mesh):
    """The unsharded long_500k run of ``case`` (steps + 1 decode steps:
    the last is the control's; the first step's residual stream after
    each pool layer kept), then the path under ``SERVE_RULES`` plus
    ``D=("data",)`` at ``mesh``, a world of one (its blocks are the whole
    weights), which must equal it bit for bit: logits, the hot tier's
    integer state, expert choices."""
    from repro_torch.distributed import sharding as shd
    cfg = _fsdp_cfg(case)
    n = case["steps"]
    tokens = _fsdp_tokens(torch, cfg, n + 1)
    m = _fsdp_serve_model(cfg)
    params = m.init(torch.Generator(device=TP_DEV).manual_seed(0))
    gates = [] if cfg.n_experts else None
    hidden = []
    state = _fsdp_state(torch, m, case)
    state, logits, wall = _fsdp_decode(torch, m, params, state, tokens, n,
                                       gates, hidden)
    hot = _tp_hot(state)
    _, lg, _ = _fsdp_decode(torch, m, params, state, tokens[n:], 1)
    ref = dict(tokens=tokens, logits=logits + lg, hot=hot, gates=gates,
               hidden=hidden, wall_s=wall)
    del state
    gc.collect()
    ref["peak_bytes"] = _tp_peak(torch)
    mt = _fsdp_serve_model(cfg, mesh)
    with shd.use_rules(_fsdp_serve_rules(), mesh):
        ops.reset_launch_counts()
        state = _fsdp_state(torch, mt, case, mesh)
        tgates = [] if cfg.n_experts else None
        state, logits, wall = _fsdp_decode(torch, mt, params, state, tokens,
                                           n, tgates)
        ref["world_of_one"] = dict(
            logits=_state_equal(torch, logits, ref["logits"][:n]),
            hot_tier=_state_equal(torch, _tp_hot(state), ref["hot"]),
            gates=(tgates is None or all(
                torch.equal(a[0], b[0]) for a, b in zip(tgates,
                                                        ref["gates"]))),
            launches=ops.launch_counts(),
            wall_s_per_decode_step_median=_median(wall))
    return ref


def _fsdp_deepseek_child(rank, world, port, out_dir):
    """Phase 20 (a)'s DeepSeek-V3.2 runs in a process of their own (its
    50 GB of weights leave the card before the ranks start)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if TP_DEV == "cuda":
        torch.cuda.set_device(0)
    _wait_file(Path(out_dir) / "go")
    _tp_world_of_one(torch, dist, port)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=TP_DEV)
        ref = _fsdp_serve_reference(torch, ops, FSDP_SERVE["deepseek-v32"],
                                    mesh)
        torch.save(ref, Path(out_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()


class _CollectiveKinds:
    """Collectives by the reference's kind while it is open
    (``distributed/collectives.py::CollectiveCount`` fed by a dispatch
    mode: every ``c10d`` op, the backward's too)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.distributed.collectives import CollectiveCount
        count = CollectiveCount()
        self.counts = count.counts

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                count.observe(func, args)
                return func(*args, **(kwargs or {}))
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _fsdp_rank_train(torch, dist, mesh, rank, grads_path):
    """Phase 20 (b), training, on one rank: its blocks of Qwen2-1.5B's
    weights (``init_shards`` under TRAIN_RULES) and its lanes of the
    batch.  One step: its gradients (``make_step_grads``: timed, its
    collectives counted by kind), gathered,
    each leaf's relative L2 from the unsharded step's; the control, the
    same gradients before the step's batch-axis sum (``reduce_grads``'s
    input); then AdamW on the rank's blocks (timed)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_opt_state)
    cfg = _fsdp_cfg(FSDP_TRAIN)
    m = build_model(cfg, device=TP_DEV)
    nd = mesh.size(0)
    d = mesh.get_local_rank("data")
    rows = FSDP_TRAIN["batch"] // nd
    batch = _fsdp_batch(torch, cfg, slice(d * rows, (d + 1) * rows))
    ref = torch.load(grads_path, mmap=True, weights_only=False)
    out = {}
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with shd.use_rules(shd.TRAIN_RULES, mesh):
        params = shd.init_shards(m.specs, torch.Generator(
            device=TP_DEV).manual_seed(0), TP_DEV)
        out["weight_bytes"] = sum(t.numel() * t.element_size()
                                  for t in _tree_tensors(params))
        step_grads = train_loop.make_step_grads(m)
        kept, reduce = {}, train_loop.reduce_grads

        def keep_local(grads, specs, plan):
            kept["local"] = grads
            return reduce(grads, specs, plan)
        train_loop.reduce_grads = keep_local
        ops.reset_launch_counts()
        try:
            with _CollectiveKinds() as kinds:
                _tp_sync(torch)
                t1 = time.perf_counter()
                kept["out"] = step_grads(params, batch)
                _tp_sync(torch)
                out["grads_wall_s"] = time.perf_counter() - t1
        finally:
            train_loop.reduce_grads = reduce
        out["collectives_per_step_grads"] = kinds.counts
        metrics, grads = kept["out"]

        specs = _tree_tensors(m.specs)

        def errors(tree, leaves):
            got = shd.gather_params([_tree_tensors(tree)[i] for i in leaves],
                                    [specs[i] for i in leaves])
            return {i: _rel_l2(g.float(), ref["grads"][i].to(g.device)
                               .float()) for i, g in zip(leaves, got)}
        out["grad_rel_l2"] = list(errors(grads, range(len(specs))).values())
        # the control differs from the gradients only in the leaves the
        # step's batch-axis sum reaches (the rows' came reduce-scattered)
        out["control_grad_rel_l2"] = errors(kept.pop("local"), [
            i for i, sp in enumerate(specs)
            if train_loop.plan_of(m).grad_sum_axes(sp.dims, sp.shape)])
        opt = init_opt_state(params)
        out["opt_bytes"] = sum(t.numel() * t.element_size()
                               for t in _tree_tensors(opt))
        _tp_sync(torch)
        t1 = time.perf_counter()
        params, opt, stats = adamw_update(
            params, grads, opt, OptConfig(warmup_steps=1, total_steps=100),
            train_loop.whole_norm_of(m))
        _tp_sync(torch)
        out["adamw_wall_s"] = time.perf_counter() - t1
        out["loss"] = float(metrics["loss"])
        out["grad_norm"] = float(stats["grad_norm"])
        out["launches"] = ops.launch_counts()
    out["peak_bytes"] = _tp_peak(torch)
    return out


def _fsdp_rank_serve(torch, dist, ops, mesh, rank, world, case, tokens):
    """Phase 20 (b), serving, on one rank: its blocks under SERVE_RULES
    plus ``D=("data",)`` (drawn one rank at a time), its slice of the
    pool over ``model``, the request's lane replicated over ``data``;
    the unsharded run's tokens for the case's steps (the first one's
    residual stream after each pool layer kept), then the control
    (``data`` rank 1's ``wo`` blocks zeroed) for one more step, its
    collectives counted, then one profiled step (on rank 0; the others
    run it)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import pool_layer_params
    cfg = _fsdp_cfg(case)
    n = case["steps"]
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    m = _fsdp_serve_model(cfg, mesh)
    with shd.use_rules(_fsdp_serve_rules(), mesh):
        for r in range(world):
            if r == rank:
                params = shd.init_shards(
                    m.specs, torch.Generator(device=TP_DEV).manual_seed(0),
                    TP_DEV)
                _tp_sync(torch)
                torch.cuda.empty_cache()
            dist.barrier()
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _tree_tensors(params))
        state = _fsdp_state(torch, m, case, mesh)
        ops.reset_launch_counts()
        gates, hidden = ([] if cfg.n_experts else None), []
        state, logits, wall = _fsdp_decode(torch, m, params, state, tokens,
                                           n, gates, hidden)
        launches = ops.launch_counts()
        hot = _tp_hot(state)
        # the control: data rank 1's wo blocks zeroed for step n + 1
        layers = pool_layer_params(cfg, params)
        kept = [p["attn"]["wo"].clone() for p in layers]
        if mesh.get_local_rank("data") == 1:
            for p in layers:
                p["attn"]["wo"].zero_()
        with _CollectiveKinds() as kinds:        # the step's collectives
            state, control, _ = _fsdp_decode(torch, m, params, state,
                                             tokens[n:], 1)
        for p, w in zip(layers, kept):
            p["attn"]["wo"].copy_(w)
        tok = {"t": tokens[n].to(TP_DEV), "s": state}

        def step():
            tok["s"], _ = m.decode(params, tok["s"], tok["t"])
        if rank == 0 and TP_DEV == "cuda":
            prof = profile_steps(
                torch, step, n_steps=1,
                device_kernels=SERVES[case["arch"]]["device_kernels"],
                spans={"pool_layer": m.n_kv})
        else:
            step()
            prof = None
        peak = _tp_peak(torch)
    return dict(logits=logits, control=control[0], hot=hot, gates=gates,
                hidden=hidden, launches=launches, wall_s=wall, weight_bytes=weight_bytes,
                pool_bytes=sum(state[k].numel() * state[k].element_size()
                               for k in ("kv_pool", "idx_pool")),
                peak_bytes=peak, collectives_per_step=kinds.counts,
                profile=prof)


def _fam_wait(out_dir, families: bool, timeout_s: float = 600.0):
    """Wait until the parent has made phase 21 (b)'s references (and
    released the card's memory they took)."""
    if families:
        _wait_file(out_dir / "families.ready", timeout_s=timeout_s)


def _fsdp_rank(rank, world, port, out_dir):
    """Phase 20 (b), one of four ranks sharing card 0 over gloo at
    FSDP_MESH: the training step, then each serve case; then phase 21
    (b) where the parent asked for it."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if TP_DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _wait_file(Path(out_dir) / "inputs.ready")
        inp = torch.load(Path(out_dir) / "inputs.pt", weights_only=False)
        out = {}
        if inp["fsdp"]:
            mesh = make_mesh(FSDP_MESH, ("data", "model"), device=TP_DEV)
            t0 = time.perf_counter()
            out["train"] = _fsdp_rank_train(torch, dist, mesh, rank,
                                            Path(out_dir) / "grads.pt")
            out["train"]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            _fam_wait(Path(out_dir), inp["families"])
            dist.barrier()
            for arch, case in FSDP_SERVE.items():
                t0 = time.perf_counter()
                out[arch] = _fsdp_rank_serve(torch, dist, ops, mesh, rank,
                                             world, case, inp[arch])
                out[arch]["seconds"] = time.perf_counter() - t0
                gc.collect()
                torch.cuda.empty_cache()
                dist.barrier()
        if inp["families"]:            # phase 21 (b)
            _fam_wait(Path(out_dir), True)
            dist.barrier()
            out["families"] = _fam_rank(torch, dist, ops, rank, world,
                                        Path(out_dir) / "families.pt")
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _prof_summary(prof):
    if prof is None:
        return None
    return dict(launches_per_step=prof["launches_per_step"],
                launches_ex_per_step=prof["launches_ex_per_step"],
                device_ms_per_step=prof["device_busy_s"] * 1e3
                / prof["decode_steps"],
                device_busy_share=prof["device_busy_share"],
                collective_host_ms_per_step=sum(
                    v["host_s"] for v in prof["host_ops"].values()) * 1e3
                / prof["decode_steps"],
                port_kernels=prof["port_kernels"])


def fsdp_phase(torch, ops, smi: str, fsdp: bool = True,
               families: bool = False) -> dict:
    """Phase 20: the d_model rows split across ranks.  (a) At an NCCL
    world of one: Qwen2-1.5B's training steps under TRAIN_RULES equal the
    unsharded steps bit for bit (each step's loss, gradient norm, and the
    bits of every parameter and moment); the long_500k decode of
    Qwen2-1.5B and (in a child) DeepSeek-V3.2 under SERVE_RULES plus
    ``D=("data",)`` equals the unsharded decode bit for bit.  (b) Four
    gloo ranks sharing the card at FSDP_MESH: the training step's loss
    and gradient norm within FSDP_LOSS_REL of the unsharded step's, each
    gathered gradient leaf within FSDP_GRAD_REL_L2, its control (the
    batch-axis sums skipped) outside; each serve case's first step's
    residual stream after each of its first FSDP_TIGHT_LAYERS pool
    layers within FSDP_HIDDEN_REL_L2 of the unsharded run's, its logits a
    step within the case's ``limits`` (but where an expert choice differs
    at a near-tie: listed, at most half), the hot tier's integer state
    exact, the control outside both limits.  With ``families`` the same
    four ranks then run phase 21 (b) (``_fam_rank``, against the parent's
    ``_fam_references``); with ``fsdp`` false, only that.  The four ranks
    start first and wait for (a)'s tokens.  Returns the launches of the
    runs."""
    import tempfile
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        child = None
        if fsdp:
            child_dir = stack.enter_context(tempfile.TemporaryDirectory())
            child = (child_dir, stack.enter_context(_started_ranks(
                _fsdp_deepseek_child, child_dir, 1)))
        spawned = stack.enter_context(_started_ranks(_fsdp_rank, tmp))
        return _fsdp_phase(torch, ops, smi, fsdp, families, t0, tmp,
                           spawned, child)


def _fsdp_phase(torch, ops, smi, fsdp, families, t0, tmp, spawned, child):
    """Phases 20 and 21 (b) once their ranks (and with ``fsdp`` the
    DeepSeek-V3.2 child) are starting (``fsdp_phase``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    totals, failures = {}, []

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    grads_path = Path(tmp) / "grads.pt"
    refs = {}
    if fsdp:
        _tp_world_of_one(torch, dist, _free_port())
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device=TP_DEV)
            cfg = _fsdp_cfg(FSDP_TRAIN)
            runs = {}
            for key, mesh_ in (("unsharded", None), ("world_of_one", mesh)):
                m = build_model(cfg, device=TP_DEV)
                gen = torch.Generator(device=TP_DEV).manual_seed(0)
                if mesh_ is None:
                    params = m.init(gen)
                else:
                    from repro_torch.distributed import sharding as shd
                    with shd.use_rules(shd.TRAIN_RULES, mesh_):
                        params = shd.init_shards(m.specs, gen, TP_DEV)
                runs[key] = _fsdp_train_run(
                    torch, m, params, mesh_,
                    grads_path if mesh_ is None else None)
                del params
                gc.collect()
                torch.cuda.empty_cache()
            u, w = runs["unsharded"], runs["world_of_one"]
            equal = {k: u[k] == w[k] for k in ("loss", "grad_norm")}
            equal["params_m_v_bits"] = u["sums"] == w["sums"]
            emit(dict(phase="fsdp", run="nccl_world_1_train",
                      config=FSDP_TRAIN["arch"], card=smi,
                      batch=[FSDP_TRAIN["batch"], FSDP_TRAIN["seq"]],
                      steps=FSDP_TRAIN["steps"], equal_unsharded=equal,
                      loss=u["loss"], grad_norm=u["grad_norm"],
                      wall_s_per_step=w["wall_s"],
                      wall_s_per_step_unsharded=u["wall_s"],
                      peak_bytes=w["peak_bytes"],
                      peak_bytes_unsharded=u["peak_bytes"],
                      profile=_prof_summary(w["profile"])))
            if not all(equal.values()):
                failures.append(("train world of one", equal))
            refs["qwen2-1.5b"] = _fsdp_serve_reference(
                torch, ops, FSDP_SERVE["qwen2-1.5b"], mesh)
        finally:
            dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
        refs["deepseek-v32"] = _go(child)[0]
        gc.collect()
        torch.cuda.empty_cache()
        for arch, ref in refs.items():
            one = ref["world_of_one"]
            add(one["launches"])
            ok = {k: one[k] for k in ("logits", "hot_tier", "gates")}
            emit(dict(phase="fsdp", run="nccl_world_1_serve", config=arch,
                      card=smi, seq=FSDP_SERVE[arch]["seq"],
                      decode_steps=FSDP_SERVE[arch]["steps"],
                      equal_unsharded=ok, launches=one["launches"],
                      wall_s_per_decode_step_median=one[
                          "wall_s_per_decode_step_median"],
                      wall_s_per_decode_step_median_unsharded=_median(
                          ref["wall_s"]),
                      peak_bytes_unsharded=ref["peak_bytes"]))
            if not all(ok.values()):
                failures.append((arch, "serve world of one", ok))
    inputs = {arch: ref["tokens"] for arch, ref in refs.items()}
    inputs.update(fsdp=fsdp, families=families)
    torch.save(inputs, Path(tmp) / "inputs.pt")
    (Path(tmp) / "inputs.ready").touch()
    t1 = time.perf_counter()
    if families:
        # phase 21 (b)'s references, made while the ranks start; the
        # ranks wait for them before phase 20's serve cases (the card's
        # memory) and phase 21's work
        t2 = time.perf_counter()
        _fam_references(torch, ops, Path(tmp) / "families.pt")
        fam_ref_s = time.perf_counter() - t2
        fam_train_loss = {key[1]: ref["loss"] for key, ref in
                          torch.load(Path(tmp) / "families.pt",
                                     weights_only=False).items()
                          if isinstance(key, tuple)}
        gc.collect()
        if TP_DEV == "cuda":
            torch.cuda.empty_cache()
        (Path(tmp) / "families.ready").touch()
    while not spawned.join():
        pass
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    ranks_s = time.perf_counter() - t1
    if fsdp:
        saved = torch.load(grads_path, mmap=True, weights_only=False)
        ref_loss, paths = saved["loss"], saved["paths"]
        del saved
    if fsdp:
        # (b) training: the loss and the gradient norm within FSDP_LOSS_REL,
        # each gathered leaf within FSDP_GRAD_REL_L2; the control must miss
        tr = [r["train"] for r in ranks]
        errs = [x["grad_rel_l2"] for x in tr]
        over = [(r, paths[i], e[i]) for r, e in enumerate(errs)
                for i in range(len(paths)) if e[i] > FSDP_GRAD_REL_L2]
        control_over = [max(x["control_grad_rel_l2"].values()) / FSDP_GRAD_REL_L2
                        for x in tr]
        worst = max(range(len(paths)), key=lambda i: max(e[i] for e in errs))
        ref_norm = runs["unsharded"]["grad_norm"][0]
        loss_rel = max(abs(x["loss"] - ref_loss) / abs(ref_loss) for x in tr)
        norm_rel = max(abs(x["grad_norm"] - ref_norm) / abs(ref_norm) for x in tr)
        emit(dict(phase="fsdp", run="gloo_4_ranks_train",
                  config=FSDP_TRAIN["arch"], mesh=list(FSDP_MESH), card=smi,
                  batch=[FSDP_TRAIN["batch"], FSDP_TRAIN["seq"]],
                  limits=dict(loss_rel=FSDP_LOSS_REL, grad_norm_rel=FSDP_LOSS_REL,
                              grad_rel_l2=FSDP_GRAD_REL_L2),
                  worst_grad_rel_l2=max(e[worst] for e in errs),
                  worst_leaf=paths[worst],
                  grad_rel_l2_median=sorted(errs[0])[len(paths) // 2],
                  leaves_over=over[:8],
                  control_least_over_limit=min(control_over),
                  loss_rel=loss_rel, loss=tr[0]["loss"],
                  grad_norm_rel=norm_rel, grad_norm=tr[0]["grad_norm"],
                  grad_norm_unsharded=ref_norm,
                  ranks=[dict(weight_bytes=x["weight_bytes"],
                              opt_bytes=x["opt_bytes"],
                              peak_bytes=x["peak_bytes"],
                              collectives_per_step_grads=x[
                                  "collectives_per_step_grads"],
                              grads_wall_s=x["grads_wall_s"],
                              adamw_wall_s=x["adamw_wall_s"],
                              seconds=x["seconds"]) for x in tr],
                  peak_bytes_was=PEAK_WAS.get(("fsdp_train",))))
        if (over or min(control_over) <= 1 or loss_rel > FSDP_LOSS_REL
                or norm_rel > FSDP_LOSS_REL):
            failures.append(("train ranks", over[:8], min(control_over),
                             loss_rel, norm_rel))
        # (b) serving: the first step's residual stream after each of the
        # first FSDP_TIGHT_LAYERS pool layers within FSDP_HIDDEN_REL_L2 of the
        # unsharded run's (the whole depth's reported), each rank's logits a
        # step within the case's coarse limits of the unsharded run's
        for arch, case in FSDP_SERVE.items():
            ref, n = refs[arch], case["steps"]
            rel_lim, frac_lim = case["limits"]
            layers = _fsdp_cfg(case).n_layers
            worst, least, exempt, missing = [0.0, 0, 0.0], [math.inf, math.inf], \
                [], []
            depth = [0.0] * len(ref["hidden"])

            def flips_at(x, step):
                """The layers whose expert choice differs at ``step``."""
                if not ref["gates"]:
                    return []
                return [dict(layer=lyr, gap=float(ref["gates"][
                    step * layers + lyr][1][0]))
                    for lyr in range(layers)
                    if not bool((ref["gates"][step * layers + lyr][0][0]
                                 == x["gates"][step * layers + lyr][0][0]).all())]
            for r, res in enumerate(ranks):
                x = res[arch]
                add(x["launches"])
                hid = [_rel_l2(g.float(), w.float())
                       for g, w in zip(x["hidden"], ref["hidden"])]
                depth = [max(a, b) for a, b in zip(depth, hid)]
                if max(hid[:FSDP_TIGHT_LAYERS]) > FSDP_HIDDEN_REL_L2:
                    flips = [f for f in flips_at(x, 0)
                             if f["layer"] < FSDP_TIGHT_LAYERS]
                    if flips and all(f["gap"] < TP_GATE_TIE for f in flips):
                        exempt.append(dict(rank=r, step=0, hidden=hid[:2],
                                           flips=flips))
                    else:
                        failures.append((arch, r, "hidden",
                                         hid[:FSDP_TIGHT_LAYERS]))
                for step, got in enumerate(x["logits"]):
                    V = got.shape[-1]
                    err, n_out, top = _tp_near(got[0], ref["logits"][step][0])
                    ok = err <= rel_lim and n_out <= frac_lim * V
                    flips = [] if ok else flips_at(x, step)
                    if not ok and flips and all(f["gap"] < TP_GATE_TIE
                                                for f in flips):
                        exempt.append(dict(rank=r, step=step, rel_l2=err,
                                           flips=flips))
                        continue
                    worst = [max(worst[0], err), max(worst[1], n_out),
                             max(worst[2], top)]
                    if not ok:
                        failures.append((arch, r, step, err, n_out, flips))
                c = x["control"][0]
                err, n_out, _ = _tp_near(c, ref["logits"][n][0])
                least = [min(least[0], err), min(least[1], n_out)]
                if not (err > rel_lim and n_out > frac_lim * c.shape[-1]):
                    failures.append((arch, r, "control within the limits"))
                if not _state_equal(torch, x["hot"], ref["hot"]):
                    failures.append((arch, r, "hot tier"))
                path = ("indexer_scores", "gather_kv.shard",
                        SERVES[arch]["attn"], "scatter_kv.rows_at_shard")
                missing += [(r, k) for k in path
                            if TP_DEV == "cuda" and not x["launches"].get(k)]
            x0 = ranks[0][arch]
            emit(dict(phase="fsdp", run="gloo_4_ranks_serve", config=arch,
                      mesh=list(FSDP_MESH), card=smi, seq=case["seq"],
                      decode_steps=n, limits=dict(
                          rel_l2=rel_lim, bf16_tol=TP_BF16_TOL,
                          miss_frac=frac_lim, hidden_rel_l2=FSDP_HIDDEN_REL_L2,
                          hidden_layers=FSDP_TIGHT_LAYERS),
                      hidden_rel_l2_by_layer=depth,
                      worst_rel_l2=worst[0], worst_logits_outside=worst[1],
                      worst_ratio=worst[2],
                      control_least_rel_l2=least[0],
                      control_least_logits_outside=least[1],
                      exempt_routing_flips=exempt, kernels_missing=missing,
                      peak_bytes_was=PEAK_WAS.get(("fsdp_serve", arch)),
                      ranks=[dict(weight_bytes=res[arch]["weight_bytes"],
                                  pool_bytes=res[arch]["pool_bytes"],
                                  peak_bytes=res[arch]["peak_bytes"],
                                  collectives_per_step=res[arch][
                                      "collectives_per_step"],
                                  wall_s_per_step=res[arch]["wall_s"],
                                  seconds=res[arch]["seconds"])
                             for res in ranks],
                      rank0_launches=x0["launches"],
                      rank0_profile=_prof_summary(x0["profile"])))
            if missing:
                failures.append((arch, "kernels", missing))
            if len({(e["step"]) for e in exempt}) > n // 2:
                failures.append((arch, "routing flips", exempt))
    if families:
        failures += _fam_check(ranks, smi) + _fam_check_train(
            ranks, fam_train_loss, smi)
        for r in ranks:
            for key, x in r["families"].items():
                add(x.get("launches", {}))
    emit(dict(phase="fsdp_total", launches=totals, ranks_seconds=ranks_s,
              fsdp=fsdp, families=families,
              families_references_seconds=fam_ref_s if families else None,
              seconds=time.perf_counter() - t0))
    if failures:
        raise AssertionError(f"fsdp: {failures[:12]}")
    return totals


# ---------------------------------------------------------------------------
# phase 21: tensor parallelism of the recurrent and encoder-decoder families
# ---------------------------------------------------------------------------

# (b)'s cases, at full width: Zamba2-7B at 2 super-blocks plus its 3-layer
# tail (15 Mamba2 layers, 2 calls of the shared block), 4 requests of 254
# tokens (one SSD chunk) in a pool of 256 rows; xLSTM-125M whole, 4
# requests of 64 tokens; Whisper-small whole, 4 requests of 4,096 frames.
# Each is prefilled, then decoded ``steps`` steps on the unsharded run's
# greedy tokens, by the parent (unsharded, all lanes) and by each of four
# gloo ranks at every mesh of FAM_MESHES (its lanes).  The training step
# (``FAM_TRAIN``): one step's gradients at (2, 2) against the unsharded
# step's.  (a) rides on phase 16: Zamba2-7B's and Whisper-small's
# unsharded and sharded runs there get a third run, the sharded model
# under SERVE_RULES at its NCCL world of one, and in that world
# xLSTM-125M prefills FAM_XLSTM's requests and decodes, and one
# TRAIN_RULES step of xLSTM-125M and of the 15-layer Zamba2-7B runs,
# each beside the unsharded run
FAM_CASES = {
    "zamba2-7b": dict(arch="zamba2-7b", n_layers=15, requests=4,
                      context=254, steps=2),
    "xlstm-125m": dict(arch="xlstm-125m", n_layers=None, requests=4,
                       context=64, steps=2),
    "whisper-small": dict(arch="whisper-small", n_layers=None, requests=4,
                          context=4096, steps=2),
}
# (b)'s Zamba2-7B step runs in f32 (every weight and activation) and
# without activation checkpointing: 15 random Mamba2 layers carry bf16's
# rounding into every gradient leaf (the bf16 step's median leaf is
# 66 % from the unsharded bf16 step, its control 99 %: PERF.md §6),
# and the recompute's row gathers would double its gloo traffic; (a)
# holds its bf16 step with checkpointing bit for bit at one rank
FAM_TRAIN = {
    "zamba2-7b": dict(arch="zamba2-7b", n_layers=15, batch=4, seq=128,
                      f32=True),
    "xlstm-125m": dict(arch="xlstm-125m", n_layers=None, batch=4, seq=64),
    "whisper-small": dict(arch="whisper-small", n_layers=None, batch=4,
                          seq=64, frames=512),
}
FAM_XLSTM = dict(requests=4, context=2048, steps=4)
FAM_MESHES = ((2, 2), (1, 4))
# (b)'s limits.  Tight, fixed (FAM_HIDDEN_REL_L2, relative L2): the
# residual stream at the input of the first FAM_TIGHT layer norms (the
# embedding's output and the first two layers') of the prefill, and of
# the first decode step up to its first read of the pool, which carries
# the whole prefill's depth (``first``: Whisper-small's decoder layer 0
# reads its cross pool, made by the 12-layer encoder, after its
# self-attention); the training step's loss (``loss``).  Coarse, set
# once from recorded readings (PERF.md §6), each case's logits a
# lane, relative L2: the first logits (the prefill's; Whisper-small's
# first step's) and each later step's (``logits``), and each gradient
# leaf of the training step (``grads``)
FAM_TIGHT, FAM_HIDDEN_REL_L2 = 3, 1e-2
FAM_LIMITS = {"zamba2-7b": dict(first=3, logits=(0.4, 1.2), loss=1e-4,
                                grads=1e-2),
              "xlstm-125m": dict(first=3, logits=(0.06, 0.06), loss=1e-3,
                                 grads=0.25),
              "whisper-small": dict(first=2, logits=(0.07, 0.07), loss=1e-3,
                                    grads=0.25)}
# CHIP_SMOKE_FAM_SPREAD=1: the references also report the unsharded
# runs' own spread under another rounding (the (2, 2) ranks' lane halves
# served alone; the training step in two microbatches), the readings the
# coarse limits are set against
FAM_SPREAD = os.environ.get("CHIP_SMOKE_FAM_SPREAD") == "1"
if FAM_SPREAD:
    # and the ranks also take Zamba2-7B's bf16 step, reported beside its
    # like-for-like control (``_fam_bf16_control``), not held
    FAM_TRAIN["zamba2-7b-bf16"] = dict(FAM_TRAIN["zamba2-7b"], f32=False,
                                       held=False)
# the reduced configs at small sizes: the CPU rehearsal
FAM_SMALL = TP_DEV == "cpu"
if FAM_SMALL:
    FAM_CASES = {k: dict(v, context=30 if k == "zamba2-7b" else 32)
                 for k, v in FAM_CASES.items()}
    FAM_TRAIN = {k: dict(v, seq=16, frames=32) for k, v in FAM_TRAIN.items()}
    FAM_XLSTM = dict(requests=4, context=32, steps=2)


def _fam_cfg(case):
    """A case's config: its depth; at FAM_SMALL reduced, the indexer 32
    dims wide (the kernel's widths)."""
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"])
    if FAM_SMALL:
        cfg = cfg.reduced()
        return dataclasses.replace(cfg, sac=dataclasses.replace(
            cfg.sac, d_idx=32))
    if case["n_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=case["n_layers"])
    return cfg


def _fam_topk(scores, cache_len):
    return _small_topk(scores, cache_len, 16 if FAM_SMALL else 2048)


def _fam_model(cfg, mesh=None):
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.models.model import build_model
    fetch = ({} if mesh is None or not cfg.has_attention
             else dict(fetch_fn=make_pooled_fetch(mesh)))
    return build_model(cfg, topk_fn=_fam_topk, device=TP_DEV, **fetch)


def _fam_inputs(torch, cfg, case):
    """The case's prompts [R, context + steps] (the decode's room; each
    lane's length ``context``) or frames [R, context, D], from a seeded
    generator, on the host."""
    g = torch.Generator().manual_seed(0)
    R, T = case["requests"], case["context"]
    if cfg.enc_dec:
        return torch.randn((R, T, cfg.d_model), generator=g).bfloat16()
    return torch.randint(0, cfg.vocab, (R, T + case["steps"]), generator=g,
                         dtype=torch.int32)


@contextlib.contextmanager
def _fam_residuals(into: list):
    """While open, the input of every residual-stream norm
    (``transformer.rms_norm``, ``encdec.rms_norm``: each layer's input,
    and the final norm's) is copied to the host onto ``into`` (bf16, as
    the stream is: no bit is lost)."""
    from repro_torch.models import encdec, transformer
    plain = transformer.rms_norm

    def recorded(x, gamma, *a):
        into.append(x.detach().cpu())
        return plain(x, gamma, *a)
    transformer.rms_norm = encdec.rms_norm = recorded
    try:
        yield into
    finally:
        transformer.rms_norm = encdec.rms_norm = plain


def _fam_serve(torch, m, params, case, inp, lanes, mesh=None, fed=None,
               steps=None):
    """Prefill ``inp``'s ``lanes`` (the pool cut to the rank's slice
    with ``mesh``), then ``steps`` (by default the case's) decode steps,
    fed ``fed``'s tokens or greedy: the residual records of the prefill
    and of the first decode step, the logits (the prefill's, but for the
    encoder-decoder, whose prefill makes none, then each step's) and
    each step's token on the host, wall s a step."""
    from repro_torch.distributed.sharding import shard_serve_state
    cfg = m.cfg
    x = inp[lanes].to(TP_DEV)
    R, T = x.shape[0], case["context"]
    pre, first, logits, toks, wall = [], [], [], [], []
    with _fam_residuals(pre):
        if cfg.enc_dec:
            st, _ = m.prefill(params, x)
            tok = torch.zeros((R,), dtype=torch.int32, device=TP_DEV)
        else:
            st, lg = m.prefill(params, x, torch.full((R,), T,
                                                     dtype=torch.int32,
                                                     device=TP_DEV))
            tok = lg.argmax(-1).to(torch.int32)
            logits.append(lg.float().cpu())
    if mesh is not None and cfg.has_attention:
        st = shard_serve_state(st, mesh)
    for i in range(case["steps"] if steps is None else steps):
        if fed is not None:
            tok = fed[i][lanes].to(TP_DEV)
        ctx = (_fam_residuals(first) if i == 0
               else contextlib.nullcontext())
        _tp_sync(torch)
        t1 = time.perf_counter()
        with ctx:
            st, lg = m.decode(params, st, tok)
        _tp_sync(torch)
        wall.append(time.perf_counter() - t1)
        toks.append(tok.cpu())
        logits.append(lg.float().cpu())
        tok = lg.argmax(-1).to(torch.int32)
    return dict(prefill=pre, first=first, logits=logits, tokens=toks,
                wall_s=wall, state=st)


def _fam_errors(run, ref, lanes) -> dict:
    """A run's distances from the reference run of its lanes: relative L2
    of each residual record (prefill, first step) and of each lane's
    logits (the first logits, then each later step's)."""
    return dict(
        prefill=[_rel_l2(g.float(), w[lanes].float())
                 for g, w in zip(run["prefill"], ref["prefill"])],
        first=[_rel_l2(g.float(), w[lanes].float())
               for g, w in zip(run["first"], ref["first"])],
        logits=[[_rel_l2(g[b], w[lanes][b]) for b in range(g.shape[0])]
                for g, w in zip(run["logits"], ref["logits"])])


def _fam_batch(torch, cfg, case, lanes=slice(None)):
    g = torch.Generator().manual_seed(1)
    t = torch.randint(0, cfg.vocab, (case["batch"], case["seq"] + 1),
                      generator=g, dtype=torch.int32)[lanes]
    out = {"tokens": t[:, :-1].to(TP_DEV), "labels": t[:, 1:].to(TP_DEV)}
    if cfg.enc_dec:
        out["frames"] = torch.randn(
            (case["batch"], case["frames"], cfg.d_model),
            generator=g)[lanes].bfloat16().to(TP_DEV)
    return out


@contextlib.contextmanager
def _fam_precision(torch, case):
    """A training case's precision: with ``f32`` the models' activations
    in f32 (the embedding's and the frames' cast)."""
    from repro_torch.models import encdec, transformer
    if not case.get("f32"):
        yield
        return
    dtype = transformer.DTYPE
    transformer.DTYPE = encdec.DTYPE = torch.float32
    try:
        yield
    finally:
        transformer.DTYPE = encdec.DTYPE = dtype


def _fam_train_model(torch, case, params):
    """(model, params) of a training case: the bf16 default, or with
    ``f32`` f32 weights and no activation checkpointing."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import tree_map
    f32 = bool(case.get("f32"))
    m = build_model(_fam_cfg(case), remat=not f32, device=TP_DEV)
    if params is None:
        params = m.init(torch.Generator(device=TP_DEV).manual_seed(0))
    return m, (tree_map(lambda t: t.float(), params) if f32 else params)


def _fam_zero_w_out(tree, key: str, restore=None):
    """Zero every ``key`` leaf of ``tree`` in place (the control), keeping
    copies; with ``restore`` (those copies) put them back."""
    kept = []

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == key and not isinstance(v, (dict, list)):
                    if restore is None:
                        kept.append(v.clone())
                        v.zero_()
                    else:
                        v.copy_(restore.pop(0))
                else:
                    walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(tree)
    return kept


def _fam_w_out_key(cfg) -> str:
    return "wo" if cfg.enc_dec else "w_out"


def _fam_references(torch, ops, path):
    """Phase 21 (b)'s references, made by the parent before the ranks
    start: each case's unsharded run of all its lanes and each training
    step's loss and gradients, saved on the host at ``path``; with
    FAM_SPREAD, each one's spread under another rounding, emitted."""
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import make_grad_fn, make_step_grads
    out = {}
    for arch, case in FAM_CASES.items():
        cfg = _fam_cfg(case)
        m = _fam_model(cfg)
        params = m.init(torch.Generator(device=TP_DEV).manual_seed(0))
        inp = _fam_inputs(torch, cfg, case)
        ops.reset_launch_counts()
        run = _fam_serve(torch, m, params, case, inp, slice(None))
        del run["state"]
        run.update(inputs=inp, launches=ops.launch_counts())
        out[arch] = run
        if FAM_SPREAD:
            half = case["requests"] // 2
            for what, ctx in (
                    ("lane halves served alone", contextlib.nullcontext),
                    ("lane halves served alone, rounded as a rank of "
                     "model 2 (_rank_rounding)",
                     lambda: _rank_rounding(torch, 2))):
                with ctx():
                    errs = [_fam_errors(_fam_serve(
                        torch, m, params, case, inp, lanes,
                        fed=run["tokens"]), run, lanes)
                        for lanes in (slice(0, half), slice(half, None))]
                emit(dict(phase="families_tp", run="unsharded_spread",
                          config=arch, what=what, **_fam_summary(errs)))
        del m, params
        gc.collect()
        if TP_DEV == "cuda":
            torch.cuda.empty_cache()
    for arch, case in FAM_TRAIN.items():
        cfg = _fam_cfg(case)
        m, params = _fam_train_model(torch, case, None)
        batch = _fam_batch(torch, cfg, case)
        with _fam_precision(torch, case):
            metrics, grads = make_grad_fn(m)(params, batch)
        ref = dict(loss=float(metrics["loss"]), paths=_tree_paths(grads),
                   grads=[g.cpu() for g in _tree_tensors(grads)])
        out["train", arch] = ref
        if FAM_SPREAD:
            with _fam_precision(torch, case):
                met2, g2 = make_step_grads(m, 2)(params, batch)
            emit(dict(phase="families_tp", run="unsharded_spread",
                      config=arch, what="training step in two microbatches",
                      **_fam_grad_spread(torch, met2, g2, ref)))
            del g2
            if not case.get("f32"):
                emit(dict(phase="families_tp", run="unsharded_spread",
                          config=arch, **_fam_bf16_control(torch, case,
                                                           batch)))
        del m, params, grads
        gc.collect()
        if TP_DEV == "cuda":
            torch.cuda.empty_cache()
    torch.save(out, path)


def _fam_grad_spread(torch, metrics, grads, ref) -> dict:
    """A training step's distance from the reference step: the loss's
    relative error, the worst and the median gradient leaf's relative L2
    (each leaf the reference's is not all zeros), the leaves by name."""
    errs = {p: _rel_l2(a.float(), w.float().to(a.device))
            for p, a, w in zip(ref["paths"], _tree_tensors(grads),
                               ref["grads"]) if bool(w.any())}
    vals = sorted(errs.values())
    return dict(loss_rel=abs(float(metrics["loss"]) - ref["loss"])
                / abs(ref["loss"]), worst_grad_rel_l2=vals[-1],
                worst_leaf=max(errs, key=errs.get),
                grad_rel_l2_median=vals[len(vals) // 2],
                by_kind=_by_kind(errs))


def _by_kind(errs: dict) -> dict:
    """{leaf name: [median, worst]} of per-leaf errors keyed by path,
    over the leaves of each name (``A_log``, ``w_in``, ...)."""
    kinds: dict = {}
    for path, e in errs.items():
        kinds.setdefault(path.split("/")[-1], []).append(e)
    return {k: [sorted(v)[len(v) // 2], max(v)]
            for k, v in sorted(kinds.items())}


def _fam_bf16_control(torch, case, batch) -> dict:
    """The like-for-like control of a training case's bf16 TP gap at
    (2, 2): the unsharded bf16 step (with activation checkpointing, as
    the ranks' bf16 step runs) against itself in two microbatches (the
    data ranks' halves) rounded as a rank of model 2 rounds
    (``_rank_rounding``)."""
    from repro_torch.training.train_loop import make_grad_fn, make_step_grads
    m, params = _fam_train_model(torch, dict(case, f32=False), None)
    metrics, grads = make_grad_fn(m)(params, batch)
    ref = dict(loss=float(metrics["loss"]), paths=_tree_paths(grads),
               grads=_tree_tensors(grads))
    with _rank_rounding(torch, 2):
        met2, g2 = make_step_grads(m, 2)(params, batch)
    return dict(what="bf16 training step against itself in two "
                "microbatches rounded as a rank of model 2 "
                "(_rank_rounding)", **_fam_grad_spread(torch, met2, g2, ref))


def _fam_summary(errs: list) -> dict:
    """The worst of several runs' ``_fam_errors``: each residual record's,
    and the logits' by step."""
    def worst(key):
        return [max(e[key][i] for e in errs)
                for i in range(len(errs[0][key]))]
    return dict(hidden_prefill=worst("prefill"),
                hidden_first_step=worst("first"),
                logits_rel_l2_by_step=[max(max(e["logits"][i]) for e in errs)
                                       for i in range(len(errs[0]["logits"]))])


def _fam_rank_serve(torch, dist, ops, mesh, case, ref):
    """Phase 21 (b), serving, on one rank: its blocks under SERVE_RULES
    (drawn leaf by leaf from the parent's seed), its lanes, the case's
    run fed the unsharded run's tokens, then the control (model rank 1's
    ``w_out`` blocks zeroed; Whisper's attention ``wo``); each against
    the reference's records and logits of its lanes."""
    from repro_torch.distributed import sharding as shd
    cfg = _fam_cfg(case)
    nd, d = mesh.size(0), mesh.get_local_rank("data")
    R = case["requests"]
    lanes = slice(d * R // nd, (d + 1) * R // nd)
    m = _fam_model(cfg, mesh)
    if TP_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with shd.use_rules(shd.SERVE_RULES, mesh):
        params = shd.init_shards(m.specs, torch.Generator(
            device=TP_DEV).manual_seed(0), TP_DEV)
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _tree_tensors(params))
        ops.reset_launch_counts()
        with _CollectiveKinds() as kinds:
            run = _fam_serve(torch, m, params, case, ref["inputs"], lanes,
                             mesh, fed=ref["tokens"])
        launches = ops.launch_counts()
        ctrl = None
        if mesh.size(0) == FAM_MESHES[0][0]:   # the control, at (2, 2)
            key = _fam_w_out_key(cfg)
            kept = (_fam_zero_w_out(params, key)
                    if mesh.get_local_rank("model") == 1 else None)
            ctrl = _fam_errors(_fam_serve(
                torch, m, params, case, ref["inputs"], lanes, mesh,
                fed=ref["tokens"], steps=1 if cfg.enc_dec else 0), ref,
                lanes)
            if kept is not None:
                _fam_zero_w_out(params, key, kept)
    return dict(errors=_fam_errors(run, ref, lanes), control=ctrl,
                launches=launches,
                collectives_per_run=kinds.counts, wall_s=run["wall_s"],
                weight_bytes=weight_bytes, peak_bytes=_tp_peak(torch))


def _fam_rank_train(torch, mesh, case, ref):
    """Phase 21 (b), training, on one rank at (2, 2): one step's gradients
    under TRAIN_RULES, each leaf's relative L2 from the unsharded step's
    (on the ranks' blocks: nothing gathered); the control, before the
    batch-axis sums."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop
    cfg = _fam_cfg(case)
    m = build_model(cfg, device=TP_DEV)
    nd, d = mesh.size(0), mesh.get_local_rank("data")
    rows = case["batch"] // nd
    batch = _fam_batch(torch, cfg, case, slice(d * rows, (d + 1) * rows))
    with shd.use_rules(shd.TRAIN_RULES, mesh), _fam_precision(torch, case):
        m, params = _fam_train_model(torch, case, shd.init_shards(
            m.specs, torch.Generator(device=TP_DEV).manual_seed(0), TP_DEV))
        kept, reduce = {}, train_loop.reduce_grads

        def keep_local(grads, specs, plan):
            kept["local"] = grads
            return reduce(grads, specs, plan)
        train_loop.reduce_grads = keep_local
        try:
            with _CollectiveKinds() as kinds:
                _tp_sync(torch)
                t1 = time.perf_counter()
                metrics, grads = train_loop.make_step_grads(m)(params, batch)
                _tp_sync(torch)
                wall = time.perf_counter() - t1
        finally:
            train_loop.reduce_grads = reduce
        specs = _tree_tensors(m.specs)
        plan = train_loop.plan_of(m)

        def errors(tree, leaves):
            return _block_rel_l2(torch, plan, mesh, specs,
                                 _tree_tensors(tree), ref["grads"], leaves)
        live = [i for i, g in enumerate(ref["grads"]) if bool(g.any())]
        grad_rel = errors(grads, live)
        summed = [i for i in live
                  if plan.grad_sum_axes(specs[i].dims, specs[i].shape)]
        control = errors(kept.pop("local"), summed)
    return dict(loss=float(metrics["loss"]), grad_rel_l2=grad_rel,
                leaves=[ref["paths"][i] for i in live],
                control_grad_rel_l2=control, grads_wall_s=wall,
                collectives=kinds.counts, peak_bytes=_tp_peak(torch))


def _fam_rank(torch, dist, ops, rank, world, path):
    """Phase 21 (b) on one rank of phase 20's spawned world: every case at
    each mesh of FAM_MESHES (two meshes over the same four ranks), then
    each training step at (2, 2)."""
    from repro_torch.launch.mesh import make_mesh
    ref = torch.load(path, mmap=True, weights_only=False)
    out = {}
    meshes = {s: make_mesh(s, ("data", "model"), device=TP_DEV)
              for s in FAM_MESHES}
    for shape, mesh in meshes.items():
        for arch, case in FAM_CASES.items():
            t0 = time.perf_counter()
            out[shape, arch] = _fam_rank_serve(torch, dist, ops, mesh, case,
                                               ref[arch])
            out[shape, arch]["seconds"] = time.perf_counter() - t0
            gc.collect()
            if TP_DEV == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
    for arch, case in FAM_TRAIN.items():
        t0 = time.perf_counter()
        out["train", arch] = _fam_rank_train(torch, meshes[(2, 2)], case,
                                             ref["train", arch])
        out["train", arch]["seconds"] = time.perf_counter() - t0
        gc.collect()
        if TP_DEV == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _fam_check(ranks, smi: str) -> list:
    """Phase 21 (b)'s serving limits over the ranks' results: records,
    and the failures."""
    failures = []
    for shape in FAM_MESHES:
        for arch, case in FAM_CASES.items():
            lim = FAM_LIMITS[arch]
            xs = [r["families"][shape, arch] for r in ranks]
            cfg = _fam_cfg(case)
            if cfg.has_attention and TP_DEV == "cuda":
                # every pool layer of every step through the four kernels
                L, n = _fam_model(cfg).n_kv, case["steps"]
                write = ("scatter_kv.rows_at" if cfg.enc_dec
                         else "scatter_kv.rows_at_shard")
                want = {"indexer_scores": L * n, "gather_kv.shard": L * n,
                        "sparse_attn_gqa": (2 if cfg.enc_dec else 1) * L * n,
                        write: n, "scatter_kv.splice_shard": 1}
                bad = [(r, k, x["launches"][k]) for r, x in enumerate(xs)
                       for k, v in want.items() if x["launches"][k] != v]
                if bad:
                    failures.append((arch, shape, "launches", bad[:4]))
            run = _fam_summary([x["errors"] for x in xs])
            ctrls = [x["control"] for x in xs if x["control"] is not None]
            least = ([min(max(c["prefill"][1:FAM_TIGHT]) for c in ctrls),
                      min(min(c["logits"][0]) for c in ctrls)] if ctrls
                     else [None, None])
            tight = max(run["hidden_prefill"][:FAM_TIGHT]
                        + run["hidden_first_step"][:lim["first"]])
            logit_lims = [lim["logits"][min(i, 1)]
                          for i in range(len(run["logits_rel_l2_by_step"]))]
            emit(dict(phase="families_tp", run="gloo_4_ranks_serve",
                      config=arch, mesh=list(shape), card=smi,
                      requests=case["requests"], context=case["context"],
                      decode_steps=case["steps"],
                      limits=dict(hidden_rel_l2=FAM_HIDDEN_REL_L2,
                                  hidden_prefill_records=FAM_TIGHT,
                                  hidden_first_step_records=lim["first"],
                                  logits_rel_l2=list(lim["logits"])),
                      worst_tight_rel_l2=tight, **run,
                      control_least_tight_rel_l2=least[0],
                      control_least_first_logits_rel_l2=least[1],
                      ranks=[dict(weight_bytes=x["weight_bytes"],
                                  peak_bytes=x["peak_bytes"],
                                  collectives_per_run=x[
                                      "collectives_per_run"],
                                  launches=x["launches"],
                                  wall_s_per_step=x["wall_s"],
                                  seconds=x["seconds"]) for x in xs]))
            if not (tight <= FAM_HIDDEN_REL_L2 and all(
                    e <= w for e, w in zip(run["logits_rel_l2_by_step"],
                                           logit_lims))):
                failures.append((arch, shape, "limits", tight,
                                 run["logits_rel_l2_by_step"]))
            if ctrls and not (least[0] > FAM_HIDDEN_REL_L2
                              and least[1] > lim["logits"][0]):
                failures.append((arch, shape, "control within", least))
    return failures


def _fam_check_train(ranks, refs_train, smi: str) -> list:
    failures = []
    for arch, case in FAM_TRAIN.items():
        limits = FAM_LIMITS[case["arch"]]
        lim, loss_lim = limits["grads"], limits["loss"]
        xs = [r["families"]["train", arch] for r in ranks]
        ref_loss = refs_train[arch]
        loss_rel = max(abs(x["loss"] - ref_loss) / abs(ref_loss) for x in xs)
        errs = [max(x["grad_rel_l2"]) for x in xs]
        worst = max(range(len(xs[0]["leaves"])),
                    key=lambda i: max(x["grad_rel_l2"][i] for x in xs))
        ctrl = min(max(x["control_grad_rel_l2"]) for x in xs)
        emit(dict(phase="families_tp", run="gloo_4_ranks_train",
                  config=arch, mesh=[2, 2], card=smi,
                  batch=[FAM_TRAIN[arch]["batch"], FAM_TRAIN[arch]["seq"]],
                  limits=dict(loss_rel=loss_lim, grad_rel_l2=lim),
                  loss_rel=loss_rel, worst_grad_rel_l2=max(errs),
                  worst_leaf=xs[0]["leaves"][worst],
                  grad_rel_l2_median=sorted(xs[0]["grad_rel_l2"])[
                      len(xs[0]["grad_rel_l2"]) // 2],
                  control_least_worst=ctrl, held=case.get("held", True),
                  by_kind=_by_kind(dict(zip(xs[0]["leaves"],
                                            xs[0]["grad_rel_l2"]))),
                  ranks=[dict(peak_bytes=x["peak_bytes"],
                              collectives=x["collectives"],
                              grads_wall_s=x["grads_wall_s"],
                              seconds=x["seconds"]) for x in xs]))
        if not case.get("held", True):
            continue
        if not (loss_rel <= loss_lim and max(errs) <= lim):
            failures.append((arch, "train", loss_rel, max(errs)))
        if not ctrl > lim:
            failures.append((arch, "train control within", ctrl))
    return failures


def families_world_of_one(torch, ops, mesh) -> dict:
    """Phase 21 (a) beyond phase 16's third runs, at the NCCL world of one
    of ``mesh`` (1, 1): xLSTM-125M at full width and depth, FAM_XLSTM's
    requests prefilled and decoded under SERVE_RULES beside the unsharded
    model (logits and ``rec_*`` bit-equal, no kernel launched); one
    TRAIN_RULES step of xLSTM-125M and of Zamba2-7B (15 layers) beside the
    unsharded step (loss, gradient norm, parameters and AdamW moments
    bit-equal).  Returns the launches."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    t0 = time.perf_counter()
    case = dict(FAM_CASES["xlstm-125m"], **FAM_XLSTM)
    cfg = _fam_cfg(case)
    m = _fam_model(cfg)
    params = m.init(torch.Generator(device=TP_DEV).manual_seed(0))
    inp = _fam_inputs(torch, cfg, case)
    ops.reset_launch_counts()
    runs = {}
    for key, ctx in (("unsharded", contextlib.nullcontext()),
                     ("tp", shd.use_rules(shd.SERVE_RULES, mesh))):
        with ctx:
            runs[key] = _fam_serve(
                torch, m, params, case, inp, slice(None),
                fed=runs["unsharded"]["tokens"] if runs else None)
        st = runs[key].pop("state")
        runs[key]["rec"] = _bit_sums(torch, [st[k] for k in sorted(st)
                                             if k.startswith("rec_")])
        del st
    launches = ops.launch_counts()
    equal = dict(logits=all(torch.equal(a, b) for a, b in zip(
        runs["tp"]["logits"], runs["unsharded"]["logits"])),
        rec=runs["tp"]["rec"] == runs["unsharded"]["rec"])
    emit(dict(phase="families_tp", run="nccl_world_1_xlstm",
              config=f"{cfg.name} (n_layers={cfg.n_layers})",
              requests=case["requests"], context=case["context"],
              decode_steps=case["steps"], equal_unsharded=equal,
              launches=launches,
              wall_s_per_decode_step_median=_median(runs["tp"]["wall_s"]),
              wall_s_per_decode_step_median_unsharded=_median(
                  runs["unsharded"]["wall_s"]),
              seconds=time.perf_counter() - t0))
    failures = [] if all(equal.values()) else [("xlstm serve", equal)]
    if any(launches.values()):
        failures.append(("xlstm launched", launches))
    del m, params
    for arch in ("xlstm-125m", "zamba2-7b"):
        t1 = time.perf_counter()
        tcase = FAM_TRAIN[arch]
        cfg = _fam_cfg(tcase)
        out = {}
        for key in ("unsharded", "tp"):
            m = build_model(cfg, device=TP_DEV)
            gen = torch.Generator(device=TP_DEV).manual_seed(0)
            ctx = (shd.use_rules(shd.TRAIN_RULES, mesh) if key == "tp"
                   else contextlib.nullcontext())
            with ctx:
                params = (shd.init_shards(m.specs, gen, TP_DEV)
                          if key == "tp" else m.init(gen))
                step = make_train_step(m, OptConfig(warmup_steps=1,
                                                    total_steps=100))
                opt = init_opt_state(params)
                _tp_sync(torch)
                t2 = time.perf_counter()
                params, opt, met = step(params, opt,
                                        _fam_batch(torch, cfg, tcase))
                _tp_sync(torch)
                out[key] = dict(loss=float(met["loss"]),
                                grad_norm=float(met["grad_norm"]),
                                wall_s=time.perf_counter() - t2,
                                sums=_bit_sums(torch, [params, opt["m"],
                                                       opt["v"]]))
            del m, params, opt
            gc.collect()
            if TP_DEV == "cuda":
                torch.cuda.empty_cache()
        u, w = out["unsharded"], out["tp"]
        equal = {k: u[k] == w[k] for k in ("loss", "grad_norm", "sums")}
        equal["finite"] = math.isfinite(u["grad_norm"])
        emit(dict(phase="families_tp", run="nccl_world_1_train",
                  config=f"{cfg.name} (n_layers={cfg.n_layers})",
                  batch=[tcase["batch"], tcase["seq"]],
                  equal_unsharded=equal, loss=u["loss"],
                  wall_s=w["wall_s"], wall_s_unsharded=u["wall_s"],
                  seconds=time.perf_counter() - t1))
        if not all(equal.values()):
            failures.append((arch, "train world of one", equal))
    if failures:
        raise AssertionError(f"families (a): {failures}")
    return launches


def families_nccl(torch, ops) -> list:
    """Phase 21 (a) alone (``--families``): phase 16's NCCL world of one
    with only its Zamba2-7B and Whisper-small runs, each with its third
    (tensor-parallel) run, then ``families_world_of_one``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    _tp_world_of_one(torch, dist, _free_port())
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        counts = [sharded_zamba(torch, ops, mesh, tp=True)]
        counts += sharded_whisper(torch, ops, mesh, tp=True)
        counts.append(families_world_of_one(torch, ops, mesh))
        return counts
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc/ptxas resource usage of each kernel")
    ap.add_argument("--sharded", action="store_true",
                    help="phases 1-3, then only the sharded phase (16)")
    ap.add_argument("--twin", action="store_true",
                    help="phases 1-3, then only the simulator twin (17); "
                    "with --sharded, phases 1-3, 16 and 17")
    ap.add_argument("--dryrun", action="store_true",
                    help="phases 1-3, then only the dry-run (18)")
    ap.add_argument("--tp", action="store_true",
                    help="phases 1-3, then only tensor parallelism (19)")
    ap.add_argument("--fsdp", action="store_true",
                    help="phases 1-3, then only the d_model rows split "
                    "across ranks (20)")
    ap.add_argument("--families", action="store_true",
                    help="phases 1-3, then only tensor parallelism of the "
                    "recurrent and encoder-decoder families (21, with "
                    "phase 16 (e)-(f) that it rides on)")
    args = ap.parse_args()
    only = (args.kernels or args.sharded or args.twin or args.dryrun
            or args.tp or args.fsdp or args.families)
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
    parts = {}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t1
        return out
    recs = dict(gather_kv=timed("gathers", check_gathers, torch, ref,
                                gather_kv),
                scatter_kv=timed("pool_writes", check_pool_writes, torch,
                                 ref, scatter_kv))
    recs["indexer_scores"] = timed("indexer", check_indexer, torch, ref,
                                   indexer)
    indexer_edges = timed("indexer_edges", check_indexer_edges, torch, ref,
                          indexer)
    attn, attn_cases = timed("attention", check_attention, torch, ref,
                             sparse_attn)
    recs.update(attn)
    recs["gather_kv_pages"] = timed("gather_pages", check_gather_pages,
                                    torch, ref, gather_kv)
    recs.update(timed("shard_forms", check_shard_forms, torch, ref,
                      gather_kv, scatter_kv))
    edges = timed("attention_edges", check_attention_edges, torch, ops, ref,
                  sparse_attn)
    emit(dict(phase="kernels_vs_plain", tolerance_f32=TOL_F32,
              max_abs_err={k: v["max_abs_err"] for k, v in recs.items()},
              attention_cases=attn_cases, attention_edges=edges,
              indexer_edges=indexer_edges, seconds_by_check=parts,
              seconds=time.perf_counter() - t0))

    launches = shard_launches = dryrun_started = None
    if not only:
        # phase 18's host work, on the host's idle cores meanwhile
        dryrun_started = start_dryrun_cells(DRYRUN_WORKERS_BESIDE)
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
                ("deepseek-v32", "sac", 40, 64, False, True),
                ("zamba2-7b", "sac", 40, 64, False, False),
                ("xlstm-125m", "dense", 40, 64, False, False)):
            t0 = time.perf_counter()
            cfg = small_config(name, fp8)
            ops.reset_launch_counts()
            err, control_err = small_check(torch, cfg, mode=mode,
                                           prompt_len=plen, pool_len=slen,
                                           prefetch=prefetch)
            small_counts = ops.launch_counts()
            emit(dict(phase="small_check", config=name, mode=mode,
                      prefetch=prefetch, kv_quant=cfg.sac.kv_quant,
                      context=plen, window=cfg.sliding_window,
                      local_window=(cfg.local_window
                                    if cfg.local_global_ratio else None),
                      max_rel_l2_err=err, tolerance=SMALL_TOL,
                      control_e4m3_rel_l2_err=control_err,
                      launches=small_counts,
                      seconds=time.perf_counter() - t0))
            if not cfg.has_attention:      # xLSTM: no pool, no kernel
                if any(small_counts.values()):
                    raise AssertionError(f"small check {name} launched "
                                         f"{small_counts}")
                continue
            attn = "sparse_attn" if cfg.mla else "sparse_attn_gqa"
            missing = [k for k in path_kernels[mode] + (attn,)
                       if not small_counts[k]]
            if missing:
                raise AssertionError(f"small check {name} ({mode}) did not "
                                     f"run {missing}")
        # 4 (continued). reduced Whisper, then one training step
        enc_kernels = {"sac": ("indexer_scores", "gather_kv",
                               "sparse_attn_gqa", "scatter_kv.rows_at"),
                       "dense": ("sparse_attn_gqa", "scatter_kv.rows_at")}
        for mode in ("sac", "dense"):
            t0 = time.perf_counter()
            cfg = small_config("whisper-small")
            ops.reset_launch_counts()
            err, control_err = small_check_encdec(torch, cfg, mode=mode)
            small_counts = ops.launch_counts()
            emit(dict(phase="small_check", config="whisper-small", mode=mode,
                      max_rel_l2_err=err, tolerance=SMALL_TOL,
                      control_e4m3_rel_l2_err=control_err,
                      launches=small_counts,
                      seconds=time.perf_counter() - t0))
            missing = [k for k in enc_kernels[mode] if not small_counts[k]]
            if missing or small_counts["sparse_attn"] or (
                    mode == "dense" and small_counts["indexer_scores"]):
                raise AssertionError(f"small check whisper-small ({mode}) "
                                     f"launched {small_counts}")
        for name in ("deepseek-v32", "whisper-small"):
            t0 = time.perf_counter()
            cfg = small_config(name)
            ops.reset_launch_counts()
            err, control_err, loss, leaves = train_small_check(
                torch, cfg, seq=64 if cfg.enc_dec else 32)
            emit(dict(phase="small_check", config=name, mode="train_step",
                      loss=loss, gradient_leaves=leaves,
                      max_rel_l2_err=err, tolerance=SMALL_TOL,
                      control_e4m3_rel_l2_err=control_err,
                      launches=ops.launch_counts(),
                      seconds=time.perf_counter() - t0))
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
        cli_counts = [cli_defaults(torch, ops, "gemma3-12b")]
        # 11-12. Zamba2-7B at full width and depth, then its CLI run;
        # 13. xLSTM-125M, then its CLI run
        runs["zamba2-7b"] = serve_and_profile(torch, ops, "zamba2-7b")
        cli_counts.append(cli_defaults(torch, ops, "zamba2-7b"))
        runs["xlstm-125m"] = serve_and_profile(torch, ops, "xlstm-125m")
        cli_counts.append(cli_defaults(torch, ops, "xlstm-125m"))
        # 14. Whisper-small through the model facade; 15. training
        whisper_counts = serve_whisper(torch, ops)
        train_phase(torch, ops)
        for counts in ([r[0] for r in runs.values()]
                       + [fetch_counts, whisper_counts] + cli_counts):
            for k, n in counts.items():
                launches[k] += n
    if args.sharded or not only:
        # 16. the pool sharded over a torch.distributed mesh
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            started = {}
            _, refs, counts_a = sharded_nccl(
                torch, ops, families=not only,
                then=lambda: started.update(start_sharded_ranks(stack)))
            _, counts_b = sharded_gloo(torch, refs, started["b"])
            sharded_small(torch, started["c"])
            sharded_families_small(torch, started["g"])
        shard_launches = {k: sum(c[k] for c in counts_a + [counts_b])
                          for k in counts_b}
        emit(dict(phase="sharded_total", launches=shard_launches,
                  seconds=time.perf_counter() - t0))
    if args.families and not args.sharded:
        # 21 (a) alone: phase 16 (e)-(f) with their third runs, and the
        # rest of (a), in an NCCL world of one
        t0 = time.perf_counter()
        counts = families_nccl(torch, ops)
        shard_launches = {k: sum(c.get(k, 0) for c in counts)
                          for k in counts[0]}
        emit(dict(phase="families_tp_world_1_total", launches=shard_launches,
                  seconds=time.perf_counter() - t0))
    if args.twin or not only:
        # 17. the simulator twin: the engine's timeline replayed
        t0 = time.perf_counter()
        twin_counts = simulator_twin(torch, ops)
        if launches is not None:
            for k, n in twin_counts.items():
                launches[k] += n
        emit(dict(phase="simulator_twin_total", launches=twin_counts,
                  seconds=time.perf_counter() - t0))

    if args.dryrun or not only:
        # 18. the dry-run: the host's shape rules, the one production
        # cell that fits a card on meta and on the card, the CLI's
        # cells, the examples
        t0 = time.perf_counter()
        dryrun_phase(torch, indexer, sparse_attn, smi[0], dryrun_started)
        emit(dict(phase="dryrun_total", seconds=time.perf_counter() - t0))

    if args.tp or not only:
        # 19. tensor and expert parallelism of the weights
        tp_counts = tp_phase(torch, ops, smi[0])
        if launches is not None:
            for k in launches:
                launches[k] += tp_counts.get(k, 0)
        if shard_launches is not None:
            for k in shard_launches:
                shard_launches[k] += tp_counts.get(k, 0)

    if args.fsdp or args.families or not only:
        # 20. the d_model rows split across ranks: training, long_500k;
        # 21 (b) in the same spawned world
        fsdp_counts = fsdp_phase(torch, ops, smi[0],
                                 fsdp=args.fsdp or not only,
                                 families=args.families or not only)
        if launches is not None:
            for k in launches:
                launches[k] += fsdp_counts.get(k, 0)
        if shard_launches is not None:
            for k in shard_launches:
                shard_launches[k] += fsdp_counts.get(k, 0)

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
        "gather_kv_shard": ("src/repro_torch/csrc/gather_kv.cu",
                            "src/repro/kernels/gather_kv.py:29"),
        "scatter_kv_rows_at_shard": ("src/repro_torch/csrc/scatter_kv.cu",
                                     "src/repro/kernels/scatter_kv.py:25"),
        "scatter_kv_splice_shard": ("src/repro_torch/csrc/scatter_kv.cu",
                                    "src/repro/kernels/scatter_kv.py:25"),
    }
    # the shard forms' launches: phase 16's sharded runs (its main path)
    shard_counter = {"gather_kv_shard": "gather_kv.shard",
                     "scatter_kv_rows_at_shard": "scatter_kv.rows_at_shard",
                     "scatter_kv_splice_shard": "scatter_kv.splice_shard"}
    kernels = []
    for name, (source, replaces) in info.items():
        r = recs[name]
        if name in shard_counter:
            n = (shard_launches[shard_counter[name]]
                 if shard_launches is not None else None)
        elif launches is not None and name != "gather_kv_pages":
            n = launches[name]
        else:
            n = None
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("ms_batched", "library_ms_batched", "l2",
                                 "copies", "ms_was", "ms_batched_was",
                                 "ms_rows", "ms_batched_rows", "shapes",
                                 "e4m3")
               if k in r}))
        if name == "scatter_kv" and launches is not None:
            kernels[-1]["launches_by_form"] = {
                k.split(".")[1]: n for k, n in launches.items()
                if k.startswith("scatter_kv.")}
    emit({"kernels": kernels})
    print(smi[0])
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
