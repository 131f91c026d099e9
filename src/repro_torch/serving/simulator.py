"""Event-driven cluster simulator for disaggregated sparse-attention serving.

Reproduces the paper's evaluation (Figs 9-14) on the calibrated fabric
models of core/transfer.py.  One simulated server = ``n_lanes`` DP-attention
decode lanes (paper: 8xH20, TP8 + DP-attention 8) + a prefill stage +
a disaggregated pool backend.

Backend semantics (the crux of the paper):

  - **cxl** (SAC): no *full* prefetch.  Every decode step, each request
    fetches its per-layer top-k *misses* straight from the pool; per-
    pool-device links serialize their demand (interleaving spreads
    requests).  ``SimConfig.prefetch_width`` adds the fetch pipeline's
    *speculative* per-step prefetch (serving/prefetch.py) and the
    overlap knobs split fabric time into issued vs exposed seconds.
  - **rdma**: full-prefetch.  A request only becomes decodable after its
    ENTIRE prefix KV crosses the NIC (FIFO, shared aggregate bandwidth) —
    the transmission bottleneck (P1); resident KV consumes local DRAM —
    the memory wall (P2).  During decode, swap-in traffic contends with
    ongoing prefetch traffic on the PCIe bus (paper §5.1: 1.8x TBT).
  - **dram**: non-disaggregated upper bound — pool in local DRAM.
  - **hbm**: GPU-only baseline — zero fetch cost but KV capacity caps the
    resident batch (fig 12 plateau).

The decode-step cost model:
  t_step = t_weights + t_batch_compute + max(0, t_fetch - overlap * t_weights)
  t_fetch = max over pool devices of (sum of that device's miss bytes / bw)

The HiSparse hot-buffer hit model: consecutive-step top-k sets overlap
heavily; a buffer of ``buf`` entries (per layer per request) retains
``h = rho(ctx) * buf / (buf + topk)`` of each step's top-k, where rho
decays slowly with context (score drift grows with more candidates).
``hit_rate`` is evaluated per request on its OWN context length, so a
mixed-length trace charges each request its own miss traffic.  The model
is calibrated against the real in-graph HiSparse buffer
(core/hisparse.py) two ways: directly in tests/test_hisparse.py, and
against the serving engine's *measured* hit rate (the engine decodes
with the real buffer wired into its jitted step) in
tests/test_engine_buffer.py.

Shared substrate: placement decisions come from core/placement.py (via
the embedded Scheduler) and per-device fetch demand is accumulated in a
core/traffic.py ``FabricAccountant`` — the same schema the real engine
reports, so simulator and engine traffic numbers are directly
comparable.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fabric import FabricTopology
from repro_torch.core.traffic import FabricAccountant
from repro_torch.core.transfer import PipelineModel, QOS_SPECULATIVE
from repro_torch.serving.arbiter import (ArbiterConfig, BudgetArbiter,
                                   DemandTracker, LayerSizer,
                                   resize_allocation_width)
from repro_torch.serving.policy import (LocalityBonus, PrefillSchedule,
                                  PressureFeed, ReplicationPolicy,
                                  WarmupPressureSeed, make_admission)
from repro_torch.serving.prefetch import analytic_prefetch, analytic_warmup
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

REARRANGE_BW = 10e9       # page-first -> layer-first re-layout engine (P1)


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Decode/prefill cost constants for one served model."""
    name: str
    n_attn_layers: int
    topk: int
    entry_bytes: int
    weights_bytes_per_gpu: float      # resident weights read per step
    hbm_bw_Bps: float = 4.0e12        # H20
    flops_per_gpu: float = 148e12     # H20 bf16 dense
    flops_eff: float = 0.45
    active_params: float = 37e9       # per-token FLOPs = 2 * this
    n_lanes: int = 8                  # DP-attention width

    @property
    def base_step_s(self) -> float:
        return self.weights_bytes_per_gpu / self.hbm_bw_Bps

    def per_token_compute_s(self) -> float:
        """Marginal decode compute per token across the whole server
        (MoE/FFN is TP over all GPUs; attention DP over lanes)."""
        flops = 2 * self.active_params \
            + 2 * self.n_attn_layers * self.topk * self.entry_bytes  # attn
        return flops / (self.n_lanes * self.flops_per_gpu * self.flops_eff)

    def prefill_s(self, ctx: int) -> float:
        """Compute-bound prefill of a ctx-token prompt on one lane group."""
        flops = 2 * self.active_params * ctx \
            + self.n_attn_layers * self.topk * ctx * 600  # indexer+sparse attn
        return flops / (self.n_lanes * self.flops_per_gpu * self.flops_eff)

    def kv_bytes_per_token(self) -> float:
        return self.n_attn_layers * self.entry_bytes


def profile_from_config(cfg: ModelConfig, **kw) -> ModelProfile:
    entry = cfg.kv_bytes_per_token_layer
    quant = 0.5 if cfg.name.startswith("deepseek") else 2.0  # AWQ-4bit paper
    weights = cfg.param_count() * quant / kw.pop("n_gpus", 8)
    return ModelProfile(
        name=cfg.name, n_attn_layers=max(cfg.n_attn_layers, 1),
        topk=cfg.sac.topk, entry_bytes=entry,
        weights_bytes_per_gpu=weights,
        active_params=cfg.active_param_count(), **kw)


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    name: str                          # cxl | rdma | dram | hbm
    fetch_bw_Bps: float                # per pool device (cxl) / bus (dram)
    n_pool_devices: int = 2
    interleave: bool = True
    prefetch: bool = False             # full-prefetch before decode (rdma)
    nic_bw_Bps: float = 100e9          # pool-node egress bandwidth
    pcie_contention: float = 0.45      # swap-bw fraction lost during prefetch
    local_dram_bytes: float = 2e12
    hbm_kv_bytes: float = float("inf")
    fetch_base_s: float = 1e-6         # per-step fabric setup
    layer_latency_s: float = 10e-6     # per-layer swap-in launch + fabric
                                       # round-trip (CXL pays the switch hop)
    admit_overhead_s: float = 0.08     # scheduling + metadata ops per request
                                       # (CXL: load/store metadata §4.3.1;
                                       #  RDMA: RPC metadata service)


def default_backends(**overrides) -> Dict[str, BackendProfile]:
    """Paper §A.2 hardware: 2x CXL Type-3 devices behind an XConn switch
    (PCIe5 x8 links), loopback RNIC pool (100 Gb/s per NIC — the pool
    node's egress is the shared bottleneck), 2 TB local DRAM, 8x H20."""
    b = {
        "cxl": BackendProfile("cxl", fetch_bw_Bps=32e9, n_pool_devices=2,
                              layer_latency_s=25e-6, admit_overhead_s=0.15),
        "rdma": BackendProfile("rdma", fetch_bw_Bps=90e9, n_pool_devices=1,
                               prefetch=True, interleave=False,
                               nic_bw_Bps=14e9, pcie_contention=0.95,
                               layer_latency_s=10e-6, admit_overhead_s=0.25),
        "dram": BackendProfile("dram", fetch_bw_Bps=90e9, n_pool_devices=2,
                               interleave=True, layer_latency_s=12e-6,
                               admit_overhead_s=0.18),
        "hbm": BackendProfile("hbm", fetch_bw_Bps=4e12, n_pool_devices=1,
                              hbm_kv_bytes=45e9 * 8, interleave=False,
                              layer_latency_s=2e-6, admit_overhead_s=0.18),
    }
    for k, v in overrides.items():
        b[k] = v
    return b


# ---------------------------------------------------------------------------
# HiSparse hot-buffer hit model
# ---------------------------------------------------------------------------


def hit_rate(buf: int, topk: int, ctx: int, *, miss_base: float = 0.10,
             ctx_slope: float = 0.35, miss_floor: float = 0.004) -> float:
    """Fraction of a step's top-k served from the device buffer.

    Consecutive decode steps' top-k sets overlap heavily (the salient
    context drifts slowly); a buffer of ``buf`` entries retains roughly
    the last ``buf/topk`` steps' selections, and the recurrence
    probability of an entry last used ``j`` steps ago decays ~1/j — so
    the miss mass beyond the buffer horizon scales ~(topk/buf)^2.
    Longer contexts spread indexer scores over more candidates (more
    churn): misses grow log-linearly in context.  ``miss_floor`` is the
    fresh-context fraction (never-before-selected positions).
    Calibrated against the real HiSparse buffer (core/hisparse.py) in
    tests/test_hisparse.py.
    """
    if buf <= 0:
        return 0.0
    ratio = topk / buf
    miss = (miss_base * ratio * ratio
            * (1.0 + ctx_slope * math.log2(max(ctx, 16384) / 16384))
            + miss_floor)
    return max(0.0, 1.0 - min(miss, 1.0))


def analytic_resize(sizes: List[int], topk: int, ctx_ref: float, *,
                    device_buffer: int) -> List[int]:
    """Analytic twin of the engine's online LayerSizer re-sizing.

    The engine re-apportions the hot tier every ``resize_interval``
    steps from the measured per-layer miss rates of that interval;
    analytically those converge to the miss rates of the *current* sizes
    at the trace's context mix, so the steady state is one LayerSizer
    evaluation at that fixed point.  The hard per-layer cap is the SAME
    ``resize_allocation_width`` formula the engine allocates with.
    """
    total = sum(sizes)
    width = resize_allocation_width(sizes, device_buffer)
    rates = [1.0 - hit_rate(s, topk, int(ctx_ref)) for s in sizes]
    return LayerSizer(len(sizes), total, topk=topk,
                      max_slots=width).sizes(rates)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimConfig:
    concurrency: int = 64
    device_buffer: int = 6144
    overlap_frac: float = 0.0          # fetch/compute overlap (off: swap-in
                                       # is on the per-layer critical path)
    pipeline_depth: int = 2            # double-buffered fetch queues; the
                                       # hide window is overlap_frac *
                                       # t_comp * (depth - 1) (PipelineModel)
    prefetch_width: int = 0            # speculative entries/layer/step; the
                                       # analytic twin of the engine's
                                       # in-graph prefetch (prefetch.py)
    arbiter: bool = False              # cross-request prefetch budget
                                       # arbitration (serving/arbiter.py):
                                       # per-device demand pressure shrinks
                                       # the granted speculative width
    link_budget_frac: float = 1.0      # arbiter link budget vs hide window
    min_prefetch_width: int = 0        # granted-width floor
    warmup_entries: int = 0            # prefill warm-up seeds per layer —
                                       # models the engine's cold-start
                                       # miss reduction (analytic_warmup)
    warm_precision: float = 0.7        # fraction of warm seeds that land
                                       # in the first step's actual top-k
    layer_buffer_sizes: Optional[List[int]] = None
                                       # per-layer hot-tier sizes (the
                                       # LayerSizer apportioning); None =
                                       # uniform device_buffer per layer
    placement: Optional[str] = None    # scheduler placement policy
                                       # override; "pressure_aware" feeds
                                       # the placer the analytic per-step
                                       # demand seconds (the same signal
                                       # the engine measures)
    page_size: int = 16                # pool page tokens (SACConfig.
                                       # page_size twin): radix reuse
                                       # credit is floored to whole pages
                                       # exactly like the engine's
    radix_affinity: bool = False       # analytic radix prefix cache: a
                                       # request whose prefix_group is
                                       # already cached gets that device
                                       # as a placement affinity hint
                                       # (policy "radix_affinity" unless
                                       # `placement` overrides) and, when
                                       # it lands there, skips the matched
                                       # tokens' prefill compute + pool
                                       # write — the twin of the engine's
                                       # RadixIndex loop (capacity/
                                       # eviction effects stay with the
                                       # engine's real allocator)
    replicate_prefixes: bool = False   # PR 6 hot-prefix replication twin:
                                       # when the corrected pressure on a
                                       # cached prefix's cheapest copy-
                                       # holding link covers the one-time
                                       # copy cost within
                                       # `replicate_horizon` steps, the
                                       # group gains a copy on the least-
                                       # pressured other link (copy
                                       # traffic charged, unkeyed)
    replicate_horizon_steps: int = 64  # payback horizon in decode steps
                                       # (SACConfig.replicate_horizon_
                                       # steps twin; named identically so
                                       # sweeps set the same knob on both
                                       # sides — sacheck twin-coverage)
    dedup_pages: bool = False          # PR 6 page-dedup twin: a same-
                                       # device hit returns the matched
                                       # bytes from the request's booking
                                       # (Scheduler.shrink_booking) — the
                                       # pages are refcount-shared with
                                       # the cache, not privately held
    radix_admission: bool = False      # PR 6 radix-aware admission twin:
                                       # the wait queue orders by paged
                                       # match length (FCFS tie-break)
                                       # via Scheduler.set_reuse_fn
    precision_weighted: bool = False   # arbiter grants split per request
                                       # by analytic prefetch precision
    resize_interval: int = 0           # > 0 models online LayerSizer
                                       # re-sizing: layer sizes evaluated
                                       # at the analytic miss-rate fixed
                                       # point instead of the given prior
    round1: bool = False               # cold cache: prefill + write first
    prefill_concurrency: int = 8
    max_sim_s: float = 1e5
    # --- PR 8: continuous batching + disaggregated prefill ---
    colocated_prefill: bool = False    # charge prefill compute + pool
                                       # write INSIDE the decode loop (the
                                       # engine's monolithic/chunked
                                       # colocated path) instead of
                                       # admitting straight to decode;
                                       # round1=True stays the
                                       # disaggregated twin (separate
                                       # prefill lanes + handoff)
    prefill_chunk_tokens: int = 0      # > 0 with colocated_prefill: each
                                       # pending prompt advances one
                                       # bounded chunk per decode step
                                       # (0 = monolithic, the whole
                                       # prompt in one stall)
    slo_ttft_s: float = 0.0            # SLO targets forwarded to
    slo_tbt_s: float = 0.0             # summarize() attainment fractions
    # --- PR 10: shared admission policy (SACConfig twins) ---
    admission: Optional[str] = None    # queue-ordering policy: None keeps
                                       # the legacy mapping (radix when
                                       # radix_admission is on, else
                                       # fcfs); "fcfs" | "radix" | "edf"
                                       # (EDF deadline = arrival_s +
                                       # slo_ttft_s)
    shed_queue_depth: int = 0          # > 0 (EDF only): drop the arrived
                                       # backlog beyond this many
                                       # earliest-deadline waiting
                                       # requests (never dispatched)
    # --- PR 7: CXL fabric topology (core/fabric.py) ---
    topology: Optional[str] = None     # fabric spec ("tree:NxS", "multi_
                                       # switch:NxS", "mesh:NxP", ...);
                                       # None = flat star — one dedicated
                                       # host port per device, bit-
                                       # identical to the pre-PR 7 flat
                                       # per-device accounting.  Timing
                                       # always honors the topology: the
                                       # step's fetch time is the max
                                       # per-SEGMENT drain time (a shared
                                       # trunk serializes the traffic of
                                       # every device behind it)
    segment_aware: bool = True         # control plane (placer pressure,
                                       # DemandTracker, arbiter budgets)
                                       # reads per-SEGMENT bottleneck
                                       # pressure along each path.  False
                                       # = segment-BLIND baseline: timing
                                       # still pays the topology but the
                                       # control loop only sees flat
                                       # per-device endpoint demand — the
                                       # A/B cell of benchmarks/
                                       # fabric_sweep.py
    warmup_pressure_seed: bool = False # PR 7 satellite (engine twin):
                                       # seed the placement pressure feed
                                       # from BOOKED prefill-write demand
                                       # during the window before the
                                       # FIRST decode step only
    replica_reads: bool = False        # PR 7 satellite (engine twin):
                                       # re-pick the least-bottleneck-
                                       # pressured replica of a cached
                                       # prefix every step; the matched
                                       # fraction of the request's misses
                                       # follows the read device
    replicate_horizon: dataclasses.InitVar[Optional[int]] = None
                                       # deprecated pre-PR 9 spelling of
                                       # replicate_horizon_steps, accepted
                                       # at construction only

    def __post_init__(self, replicate_horizon: Optional[int]) -> None:
        if replicate_horizon is not None:
            self.replicate_horizon_steps = int(replicate_horizon)


class _Prefetch:
    """FIFO bulk-transfer queue over a shared link (the RDMA NIC)."""

    def __init__(self, bw_Bps: float):
        self.bw = bw_Bps
        self.queue: deque = deque()    # (request_id, bytes_left)
        self.inflight_bytes = 0.0

    def enqueue(self, rid: int, n_bytes: float):
        self.queue.append([rid, n_bytes])
        self.inflight_bytes += n_bytes

    def advance(self, dt: float) -> List[int]:
        """Progress by dt seconds; return completed request ids."""
        budget = self.bw * dt
        done = []
        while self.queue and budget > 0:
            head = self.queue[0]
            take = min(head[1], budget)
            head[1] -= take
            budget -= take
            self.inflight_bytes -= take
            if head[1] <= 1e-6:
                done.append(head[0])
                self.queue.popleft()
        return done

    def busy(self) -> bool:
        return bool(self.queue)

    def eta_next(self) -> float:
        if not self.queue:
            return float("inf")
        return self.queue[0][1] / self.bw


def simulate(reqs: List[Request], model: ModelProfile,
             backend: BackendProfile, sim: SimConfig) -> Dict[str, float]:
    """Run the trace to completion; returns summarize() metrics."""
    # deep-copy request records so traces can be reused across backends
    reqs = [dataclasses.replace(r) for r in reqs]
    # any PR 6 mechanism implies the radix prefix cache exists
    use_radix = bool(sim.radix_affinity or sim.replicate_prefixes
                     or sim.dedup_pages or sim.radix_admission)
    # PR 7: the switch fabric.  ``topo`` always shapes TIMING (per-segment
    # drain); ``ctl_topo`` additionally shapes the CONTROL PLANE (pressure
    # feed, tracker, arbiter budgets) unless segment_aware is off — the
    # segment-blind A/B baseline of benchmarks/fabric_sweep.py.
    topo = FabricTopology.from_spec(sim.topology, backend.n_pool_devices)
    ctl_topo = topo if sim.segment_aware else None
    n_slots = ctl_topo.n_segments if ctl_topo is not None \
        else backend.n_pool_devices
    sched = Scheduler(SchedulerConfig(
        concurrency=sim.concurrency,
        n_pool_devices=backend.n_pool_devices,
        interleave=backend.interleave,
        placement=sim.placement or ("radix_affinity" if use_radix
                                    else None),
        pool_device_bytes=backend.local_dram_bytes / backend.n_pool_devices
        if backend.name != "hbm" else float("inf"),
        local_dram_bytes=(backend.local_dram_bytes if backend.prefetch
                          else float("inf")),
        hbm_kv_bytes=backend.hbm_kv_bytes,
        bytes_per_token=model.kv_bytes_per_token(),
        topology=ctl_topo,
    ))
    prefetch = _Prefetch(backend.nic_bw_Bps)
    rearrange = _Prefetch(REARRANGE_BW)
    t = 0.0
    arrivals = deque(sorted(reqs, key=lambda r: r.arrival_s))
    waiting_prefetch: Dict[int, Request] = {}
    decoding: Dict[int, Request] = {}
    prefill_q: deque = deque()
    prefill_done: List[Tuple[float, Request]] = []
    prefill_busy_until = [0.0] * max(sim.prefill_concurrency, 1)
    # trunk write serialization (PR 7): concurrent prefill pool-writes
    # whose routes cross the same multi-device segment serialize on it
    # (a switch trunk carries one device-link's worth of upstream
    # bandwidth).  Single-device segments keep the independent-lane
    # model, so the flat star — no shared segments — is bit-identical
    # to the pre-fabric behavior.
    seg_write_busy = [0.0] * topo.n_segments
    n_done = 0
    acct = FabricAccountant(n_devices=backend.n_pool_devices,
                            topology=topo)

    # per-request miss traffic: each request's hot-buffer hit rate depends
    # on its OWN context length (mixed-length traces are the norm).
    # Speculative prefetch (fetch pipeline) lifts the hit rate and issues
    # its own fabric traffic — the analytic twin of the engine's in-graph
    # speculation (serving/prefetch.py).
    pipeline = PipelineModel(depth=sim.pipeline_depth,
                             overlap_frac=sim.overlap_frac)
    step_topk = model.n_attn_layers * model.topk
    if sim.layer_buffer_sizes:
        # per-layer hot-tier sizing (serving/arbiter.py LayerSizer): the
        # request's steady hit rate is the mean of per-layer hit rates at
        # each layer's own capacity
        sizes = list(sim.layer_buffer_sizes)
        if sim.resize_interval:
            sizes = analytic_resize(sizes, model.topk,
                                    sum(r.context_len for r in reqs)
                                    / max(len(reqs), 1),
                                    device_buffer=sim.device_buffer)
        base_hit = {r.request_id:
                    sum(hit_rate(s, model.topk, r.context_len)
                        for s in sizes) / max(len(sizes), 1)
                    for r in reqs}
    else:
        base_hit = {r.request_id: hit_rate(sim.device_buffer, model.topk,
                                           r.context_len) for r in reqs}

    # steady-state prefetch outcome at a granted width w, cached per
    # (request, w) — the arbiter re-grants every step but the analytic
    # model only depends on (base_hit, w)
    _pf_cache: Dict[Tuple[int, int], Tuple[float, float, float]] = {}

    def pf_at(rid: int, w: int) -> Tuple[float, float, float]:
        key = (rid, w)
        if key not in _pf_cache:
            h2, issued = analytic_prefetch(base_hit[rid], w, model.topk)
            _pf_cache[key] = (h2, issued * model.n_attn_layers,
                              (h2 - base_hit[rid]) * step_topk)
        return _pf_cache[key]

    # the budget arbiter, evaluated analytically on the same grant logic
    # the engine runs (serving/arbiter.py): per-device demand seconds
    # observed last step shape this step's speculative widths
    arb = None
    if sim.arbiter and sim.prefetch_width:
        arb = BudgetArbiter(
            ArbiterConfig(max_width=sim.prefetch_width,
                          min_width=sim.min_prefetch_width,
                          link_budget_frac=sim.link_budget_frac,
                          precision_weighted=sim.precision_weighted),
            entry_s=model.entry_bytes / backend.fetch_bw_Bps,
            n_layers=model.n_attn_layers, pipeline=pipeline,
            topology=ctl_topo)
    # per-link AND per-request analytic demand (the engine's
    # DemandTracker twin): a finishing request's own share leaves its
    # link's pressure signal immediately, not via EMA decay.  With a
    # control-plane topology the tracker runs in SEGMENT space.
    tracker = DemandTracker(backend.n_pool_devices, ctl_topo)

    def _ctl_route(dev: int):
        return ctl_topo.route(dev) if ctl_topo is not None else (dev,)

    # PR 7 satellite (engine twin): before the first decode step the
    # demand feed is silent, so wave-1 admissions herd onto the prefix
    # owner — seed the feed with each admission's BOOKED prefill-write
    # demand until the first real measurement lands.  The window and
    # the feed are the SHARED control-plane objects
    # (serving/policy/seeding.py) the engine wires into its own placer.
    warm_seed = WarmupPressureSeed(bool(sim.warmup_pressure_seed),
                                   n_slots)
    _pressure = PressureFeed(tracker, warm_seed)

    # pressure_aware / radix_affinity placement reads the live analytic
    # demand seconds — the same per-link signal the engine feeds its
    # own placer (per-segment when the control plane is topology-aware;
    # the placer projects it to per-device bottleneck pressure)
    sched.set_pressure_fn(_pressure)
    grant_sum = grant_n = 0
    replica_redirects = [0]

    # analytic radix prefix cache (SimConfig.radix_affinity): group id ->
    # [cached prefix tokens, devices holding a copy].  First writer wins,
    # like the engine's RadixIndex.insert; replication (PR 6) appends
    # copy devices.  Reuse is only real when placement lands the request
    # on A device holding a copy — exactly the locality-vs-pressure
    # decision the radix_affinity policy arbitrates.  ``matched`` carries
    # each admitted request's reused tokens into the prefill model
    # (skipped compute + write).
    radix_cache: Dict[int, list] = {}
    matched: Dict[int, int] = {}
    write_bw = backend.fetch_bw_Bps * backend.n_pool_devices
    page = max(int(sim.page_size), 1)
    replicated_b = [0.0]
    dedup_b = [0.0]

    def _paged(tokens: int) -> int:
        """Reuse is page-granular, exactly as the engine credits it —
        a raw prefix_len would diverge for unaligned prefixes."""
        return (tokens // page) * page

    def _group_hit(r: Request):
        """(paged hit tokens, copy-device list) for ``r``'s group, or
        None when nothing usable is cached."""
        if not use_radix or r.prefix_group is None:
            return None
        cached = radix_cache.get(r.prefix_group)
        if cached is None:
            return None
        plen = _paged(min(cached[0], r.prefix_len))
        if plen <= 0:
            return None
        return plen, cached[1]

    # the locality-bonus FORMULA is the shared policy object
    # (serving/policy/locality.py) bound to the simulator's analytic
    # costs — the engine binds the same class to its fabric/profile
    _locality = LocalityBonus(
        prefill_s=model.prefill_s,
        write_s=lambda n: n * model.kv_bytes_per_token() / write_bw)
    # replication trigger twin: pick + fire/hold are the shared
    # ReplicationPolicy (serving/policy/replication.py)
    _repl = ReplicationPolicy(
        horizon_steps=int(sim.replicate_horizon_steps))

    def _bonus_s(r: Request, plen: int) -> float:
        return _locality(r.context_len, plen)

    def _maybe_replicate(plen: int, devices: list) -> None:
        """Hot-prefix replication twin (the engine's _maybe_replicate):
        fire when the reuse benefit covers the one-time copy cost AND
        the CORRECTED pressure on the cheapest copy-holding link (the
        placer's view including in-flight bookings — same-wave bursts
        count before the demand feed catches up) exceeds the copy cost
        amortized over ``replicate_horizon_steps`` steps, copying to the
        least-pressured copy-free link (never a hotter one) — the
        shared :class:`ReplicationPolicy` decides both.  Copy traffic
        is charged unkeyed (cache-owned; no departure subtracts it) on
        both links."""
        pressure = sched.placer.corrected_pressure()
        others = [d for d in range(backend.n_pool_devices)
                  if d not in devices]
        pick = _repl.pick(pressure, devices, others,
                          sched.placer.bytes_used)
        if pick is None:
            return
        src, dst = pick
        copy_b = plen * model.kv_bytes_per_token()
        copy_cost = copy_b / backend.fetch_bw_Bps
        # benefit proxy: the locality bonus of a full-prefix reuse
        bonus = (model.prefill_s(plen) +
                 copy_b / write_bw)
        if not _repl.should_fire(pressure[src], pressure[dst], bonus,
                                 copy_cost):
            return
        devices.append(dst)
        acct.record_copy_bytes(copy_b)
        acct.charge_seconds(copy_cost)
        tracker.note_transfer(src, copy_cost)
        tracker.note_transfer(dst, copy_cost)
        replicated_b[0] += copy_b

    def _affinity(r: Request):
        hit = _group_hit(r)
        if hit is None:
            return None
        plen, devices = hit
        if sim.replicate_prefixes:
            _maybe_replicate(plen, devices)
        return tuple(devices), _bonus_s(r, plen)

    def _note_radix(r: Request) -> None:
        """Post-placement accounting (the Scheduler admit hook — runs
        after EACH placement, so same-wave requests see earlier ones):
        record the reuse (hits on any copy-holding device) and register
        the first cached copy of a new group."""
        if r.prefix_group is None:
            return
        cached = radix_cache.get(r.prefix_group)
        if cached is not None and r.pool_device in cached[1]:
            hit = _paged(min(cached[0], r.prefix_len))
            if hit > 0:
                matched[r.request_id] = hit
                if sim.dedup_pages:
                    # page-dedup twin: the matched bytes are refcount-
                    # shared with the cache, not privately booked
                    dedup_b[0] += sched.shrink_booking(
                        r, hit * model.kv_bytes_per_token())
        elif cached is None:
            radix_cache[r.prefix_group] = [r.prefix_len, [r.pool_device]]

    def _reuse_score(r: Request) -> float:
        hit = _group_hit(r)
        return float(hit[0]) if hit is not None else 0.0

    def _seed_pressure(r: Request) -> None:
        """Warm-up pressure seeding: charge the admitted request's booked
        prefill-write seconds along its device's path (runs AFTER
        ``_note_radix``, so a dedup/radix hit seeds only the unmatched
        residue — the engine reads the same booked write_back traffic
        via ``TrafficStats.segment_demand_s``)."""
        eff = r.context_len - matched.get(r.request_id, 0)
        s = eff * model.kv_bytes_per_token() / write_bw
        warm_seed.note_admission(_ctl_route(r.pool_device), s)

    def _admit_hook(r: Request) -> None:
        if use_radix:
            _note_radix(r)
        _seed_pressure(r)

    # the shared admission policy (serving/policy/admission.py): the
    # SAME factory + classes the engine constructs, with the analytic
    # prefix-cache lookup bound as the radix scorer
    admission = make_admission(
        sim.admission, radix_admission=bool(sim.radix_admission),
        slo_ttft_s=float(sim.slo_ttft_s),
        shed_queue_depth=int(sim.shed_queue_depth),
        score_fn=_reuse_score, has_radix=use_radix)
    sched.set_admission_policy(admission)
    if use_radix:
        sched.set_affinity_fn(_affinity)
    if use_radix or sim.warmup_pressure_seed:
        sched.set_admit_fn(_admit_hook)

    # prefill warm-up's cold-start miss reduction: a request's FIRST
    # decode step runs against a cold hot tier, lifted to the modeled
    # warm-up hit rate when warmup_entries seeds it (analytic_warmup —
    # the simulator twin of the engine's prefill warm_lane path)
    cold = {r.request_id for r in reqs}
    cold_hit = analytic_warmup(sim.warmup_entries, model.topk,
                               sim.device_buffer,
                               precision=sim.warm_precision)
    warm_inserts = (min(sim.warmup_entries, sim.device_buffer)
                    * model.n_attn_layers if sim.warmup_entries else 0)
    cold_hits_seen: List[float] = []

    # colocated chunked prefill (PR 8): rid -> [request, tokens left].
    # Each decode-loop iteration advances every pending prompt by one
    # bounded chunk; the chunk's compute + pool-write tail joins the
    # step's duration — the analytic twin of the engine's
    # _advance_chunk_jobs (monolithic = one whole-prompt chunk).
    pending_chunk: Dict[int, list] = {}
    # the shared prefill schedule (serving/policy/prefill.py): round1
    # is the disaggregated twin (separate lanes + handoff), colocated
    # chunking reads the same chunk_take the engine's
    # _advance_chunk_jobs uses
    prefill_schedule = PrefillSchedule.from_knobs(
        bool(sim.round1), int(sim.prefill_chunk_tokens),
        int(sim.prefill_concurrency))
    n_shed = [0]

    def admit_ready(now: float):
        nonlocal n_done
        shed0 = len(sched.shed_log)
        admitted = sched.try_admit(now)
        # shed requests leave the system without decoding: they count
        # toward completion (the open-loop drain must terminate) but
        # never toward summarize(), which only reads finished requests
        n_shed[0] += len(sched.shed_log) - shed0
        n_done += len(sched.shed_log) - shed0
        for r in admitted:
            if sim.round1:
                prefill_q.append(r)
            elif backend.prefetch:
                prefetch.enqueue(
                    r.request_id, r.context_len * model.kv_bytes_per_token())
                waiting_prefetch[r.request_id] = r
            elif sim.colocated_prefill:
                pending_chunk[r.request_id] = [
                    r, r.context_len - matched.get(r.request_id, 0)]
            else:
                decoding[r.request_id] = r

    while n_done < len(reqs) and t < sim.max_sim_s:
        t_iter0 = t         # a decoding request's token gap spans the
                            # whole iteration (chunk stalls included)
        # arrivals
        while arrivals and arrivals[0].arrival_s <= t:
            sched.submit(arrivals.popleft())
        admit_ready(t)

        # prefill stage (round 1): assign queued requests to free lanes
        if sim.round1:
            for i in range(len(prefill_busy_until)):
                if prefill_busy_until[i] <= t and prefill_q:
                    r = prefill_q.popleft()
                    # a radix hit skips the matched prefix's recompute
                    # AND its pool write (the cached copy is device-
                    # local) — the engine's _fill_slots twin
                    eff_ctx = r.context_len - matched.get(r.request_id, 0)
                    dur = model.prefill_s(eff_ctx)
                    # pool write (layer-wise bulk) on the backend fabric,
                    # serialized on any shared trunk along the owning
                    # device's route (flat star: exactly wb / write_bw)
                    wb = eff_ctx * model.kv_bytes_per_token()
                    acct.record_write_bytes(wb)
                    xfer = topo.transfer_seconds(r.pool_device,
                                                 wb / write_bw)
                    trunks = [sg for sg in topo.route(r.pool_device)
                              if sg in topo.shared_segments]
                    if trunks:
                        # a shared trunk drains at its own scaled LINK
                        # rate, not the pool's striped aggregate — the
                        # shared port is the write's bottleneck
                        xfer = max(xfer, max(
                            wb / (backend.fetch_bw_Bps
                                  * max(topo.segments[sg].bandwidth_scale,
                                        1e-12))
                            for sg in trunks))
                        start = max([t] + [seg_write_busy[sg]
                                           for sg in trunks])
                        for sg in trunks:
                            seg_write_busy[sg] = start + xfer
                        dur += (start - t) + xfer
                    else:
                        dur += xfer
                    prefill_busy_until[i] = t + dur
                    r.first_token_s = t + dur      # TTFT = prefill completion
                    r.generated = 1
                    prefill_done.append((t + dur, r))
            for ready, r in list(prefill_done):
                if ready <= t:
                    decoding[r.request_id] = r
                    prefill_done.remove((ready, r))

        # colocated prefill (PR 8): advance every pending prompt ONE
        # chunk; its compute + pool-write tail advances the wall clock
        # before (and instead of stalling inside) the decode step —
        # completed prompts join the batch this same iteration, exactly
        # like the engine splicing at the top of step()
        if pending_chunk:
            t_chunks = 0.0
            for rid in list(pending_chunk):
                r, left = pending_chunk[rid]
                take = prefill_schedule.chunk_take(left)
                t_chunks += model.prefill_s(take)
                if take > 0:
                    wb = take * model.kv_bytes_per_token()
                    acct.record_write_bytes(wb)
                    xfer = topo.transfer_seconds(r.pool_device,
                                                 wb / write_bw)
                    acct.charge_seconds(xfer)
                    t_chunks += xfer
                pending_chunk[rid][1] = left - take
                if pending_chunk[rid][1] <= 0:
                    del pending_chunk[rid]
                    decoding[rid] = r
            t += t_chunks

        if not decoding:
            if pending_chunk:
                # chunked prefills advanced (time moved) but none
                # finished — loop again rather than event-jumping
                continue
            # jump to the next event
            cands = []
            if arrivals:
                cands.append(arrivals[0].arrival_s)
            if prefetch.busy():
                cands.append(t + prefetch.eta_next())
            if rearrange.busy():
                cands.append(t + rearrange.eta_next())
            if sim.round1 and prefill_done:
                cands.append(min(rd for rd, _ in prefill_done))
            if sim.round1 and prefill_q:
                cands.append(min(prefill_busy_until))
            nxt = min(cands, default=t)
            if nxt <= t or nxt == float("inf"):
                break
            for rid in prefetch.advance(nxt - t):
                rearrange.enqueue(
                    rid, waiting_prefetch[rid].context_len
                    * model.kv_bytes_per_token())
            for rid in rearrange.advance(nxt - t):
                decoding[rid] = waiting_prefetch.pop(rid)
            t = nxt
            continue

        # ---- one decode step over the active batch ----
        batch = len(decoding)
        t_comp = model.base_step_s + batch * model.per_token_compute_s()
        # fetch demand per pool device (shared traffic substrate)
        if backend.name == "hbm":
            t_fetch = t_exposed = 0.0
        else:
            # PR 7 replica-aware reads (engine twin): re-pick the least-
            # bottleneck-pressured copy of each request's cached prefix
            # THIS step; the matched fraction of its misses (and its
            # speculative prefetch) reads from that copy, so grants and
            # demand charges follow the read device
            reads: Dict[int, Tuple[int, int, float]] = {}
            replica_on = sim.replica_reads and use_radix
            pres = (list(sched.placer.device_pressure())
                    if replica_on else None)
            # within-step booking: charge each reader's expected step
            # demand onto its chosen devices as reads are assigned —
            # the pressure feed refreshes only BETWEEN steps, so
            # without it every reader of a hot prefix herds onto the
            # same least-pressured copy each step (the copies flip-flop
            # in lockstep and the per-step bottleneck never improves)
            est_s = step_topk * model.entry_bytes / backend.fetch_bw_Bps
            for r in decoding.values():
                own = r.pool_device
                rd, frac = own, 0.0
                hit = matched.get(r.request_id, 0)
                if replica_on and hit > 0 and r.prefix_group is not None:
                    cached = radix_cache.get(r.prefix_group)
                    if cached is not None:
                        copies = sorted(set(cached[1]) | {own})
                        rd = min(copies, key=lambda d: (pres[d], d))
                        if rd != own:
                            frac = min(hit / max(r.context_len, 1), 1.0)
                            replica_redirects[0] += 1
                if pres is not None:
                    pres[rd] += frac * est_s
                    pres[own] += (1.0 - frac) * est_s
                reads[r.request_id] = (own, rd, frac)
            grants = None
            if arb is not None:
                dev_reqs: Dict[int, List[int]] = {}
                precision = None
                if arb.cfg.precision_weighted:
                    # analytic per-request precision: the cumulative
                    # prefetch attribution the accountant tracked (the
                    # same TrafficStats signal the engine feeds)
                    precision = {}
                for r in decoding.values():
                    dev_reqs.setdefault(reads[r.request_id][1],
                                        []).append(r.request_id)
                    if precision is not None:
                        precision[r.request_id] = \
                            acct.stats.request_precision(r.request_id)
                grants = arb.grant(t_comp, tracker.last_demand_s, dev_reqs,
                                   precision=precision)
            # per-SLOT demand-only backlog (segment space when the
            # control plane is topology-aware, device space otherwise) —
            # next step's pressure signal
            demand_ctl = [0.0] * n_slots
            req_miss_b: Dict[int, float] = {}
            for r in decoding.values():
                rid = r.request_id
                w = (grants[rid] if grants is not None
                     else sim.prefetch_width)
                if grants is not None:
                    grant_sum += w
                    grant_n += 1
                was_cold = rid in cold
                if was_cold:
                    # first decode step: cold tier, warm-up seeds only.
                    # With the arbiter on, the warm burst drew from the
                    # same link budget (grant_warmup) at prefill time
                    cold.discard(rid)
                    w_warm = sim.warmup_entries
                    if arb is not None and w_warm:
                        # hide window = the (radix-shortened) prefill
                        # this warm burst rode behind, as in the engine
                        w_warm = arb.grant_warmup(
                            model.prefill_s(
                                r.context_len
                                - matched.get(r.request_id, 0)),
                            tracker.last_demand_s, r.pool_device,
                            min(w_warm, sim.device_buffer))
                    h = (cold_hit if w_warm == sim.warmup_entries
                         else analytic_warmup(w_warm, model.topk,
                                              sim.device_buffer,
                                              precision=sim.warm_precision))
                    cold_hits_seen.append(h)
                    pf_n = float(min(w_warm, sim.device_buffer)
                                 * model.n_attn_layers
                                 if w_warm else 0.0)
                    pf_u = min(h * step_topk, pf_n)
                else:
                    h, pf_n, pf_u = pf_at(rid, w)
                miss_b = step_topk * (1 - h) * model.entry_bytes
                pf_b = pf_n * model.entry_bytes
                own, rd, frac = reads[rid]
                pfx_b = miss_b * frac         # matched-prefix share ->
                                              # the replica read device
                if pfx_b:
                    acct.add_step_demand(rd, pfx_b)
                    for slot in _ctl_route(rd):
                        demand_ctl[slot] += pfx_b
                acct.add_step_demand(own, miss_b - pfx_b)
                for slot in _ctl_route(own):
                    demand_ctl[slot] += miss_b - pfx_b
                if pf_b:
                    # speculation is QoS-classed: at qos_spec_yield
                    # topologies it can only fill the hide window left
                    # after demand (the drain below), and it follows
                    # the read device like the engine's prefetch lane
                    acct.add_step_demand(rd, pf_b, qos=QOS_SPECULATIVE)
                req_miss_b[rid] = miss_b
                acct.record_hits(h * step_topk, (1 - h) * step_topk)
                if pf_n:
                    # warm-up (cold step) stays UNkeyed like the engine:
                    # keying the burst would tank a fresh request's
                    # precision before its first real speculation
                    acct.record_prefetch(pf_n, pf_u,
                                         key=None if was_cold else rid)
                    acct.record_prefetch_bytes(pf_b)
            step_demand = acct.drain_step()     # per-SEGMENT bytes
            bw = backend.fetch_bw_Bps
            if backend.prefetch and (prefetch.busy() or rearrange.busy()):
                bw *= (1 - backend.pcie_contention)   # PCIe bus contention
            # arbiter feedback: this step's demand-only (non-speculative)
            # seconds per slot are next step's pressure signal, split
            # per request so a departure subtracts its own share
            tracker.set_step([d / bw for d in demand_ctl],
                             {rid: b / bw for rid, b in req_miss_b.items()})
            sched.note_pressure_update()
            # per-SEGMENT drain: a shared trunk serializes everything
            # behind it, so the step's fetch tail is the BOTTLENECK
            # segment's drain time (flat star: exactly the old per-
            # device max)
            seg_s = topo.segment_seconds(step_demand, bw)
            spec_s = topo.segment_seconds(acct.step_spec_bytes, bw)
            t_fetch = (max(seg_s) + backend.fetch_base_s
                       + model.n_attn_layers * backend.layer_latency_s)
            if topo.qos_spec_yield:
                # QoS: speculation yields to demand at congested
                # segments — only DEMAND traffic can stall the step,
                # and spec beyond each segment's leftover hide window
                # arrives too late to help (dropped from exposure,
                # counted in spec_yielded_s; it stays issued)
                dem_s = [a - b for a, b in zip(seg_s, spec_s)]
                t_exposed = pipeline.exposed_time(
                    max(dem_s) + backend.fetch_base_s
                    + model.n_attn_layers * backend.layer_latency_s,
                    t_comp)
                window = pipeline.hide_window_s(t_comp)
                acct.record_spec_yield(sum(
                    max(0.0, sp - max(0.0, window - dm))
                    for sp, dm in zip(spec_s, dem_s)))
            else:
                # issued vs exposed: only the tail of the step's fetch
                # that does not fit the double-buffered hide window
                # stalls decode
                t_exposed = pipeline.exposed_time(t_fetch, t_comp)
            acct.charge_segment_seconds(seg_s, spec_s)
            acct.charge_seconds(t_fetch)
            acct.charge_exposed(t_exposed)
        warm_seed.deactivate()     # first decode step ends warm seeding
        dt = t_comp + t_exposed
        t += dt

        # prefetch progress during the step; completed transfers queue for
        # the page-first -> layer-first rearrangement engine (P1)
        for rid in prefetch.advance(dt):
            rearrange.enqueue(
                rid, waiting_prefetch[rid].context_len
                * model.kv_bytes_per_token())
        for rid in rearrange.advance(dt):
            decoding[rid] = waiting_prefetch.pop(rid)

        # token accounting
        finished = []
        for r in decoding.values():
            r.generated += 1
            if r.first_token_s < 0:
                r.first_token_s = t + backend.admit_overhead_s
            else:
                r.tbt_max_s = max(r.tbt_max_s, t - t_iter0)
            if r.generated >= r.output_len:
                r.finish_s = t
                finished.append(r)
        for r in finished:
            decoding.pop(r.request_id, None)
            sched.finish(r)
            # per-request demand attribution: the departing request's
            # own share leaves its link's pressure signal immediately
            share = tracker.depart(r.request_id, r.pool_device)
            sched.note_departure(r.pool_device, share)
            acct.stats.drop_request(r.request_id)
            n_done += 1

    out = summarize(reqs, slo_ttft_s=sim.slo_ttft_s,
                    slo_tbt_s=sim.slo_tbt_s)
    out.update(fabric_time_s=acct.stats.fabric_time_s,
               issued_fabric_s=acct.stats.issued_fabric_s,
               exposed_fabric_s=acct.stats.exposed_fabric_s,
               bytes_fetched=acct.stats.bytes_fetched,
               bytes_written=acct.stats.bytes_written,
               critical_demand_bytes=acct.stats.critical_demand_bytes,
               critical_issued_s=acct.stats.critical_issued_s,
               spec_yielded_s=acct.stats.spec_yielded_s,
               replica_redirects=float(replica_redirects[0]),
               shed_requests=float(n_shed[0]),
               radix_hit_tokens=float(sum(matched.values())),
               replicated_bytes=replicated_b[0],
               dedup_shared_bytes=dedup_b[0],
               pool_bytes_per_req=(sched.booked_bytes_cum
                                   / max(n_done, 1)),
               prefetch_bytes=acct.stats.prefetch_bytes,
               prefetched_entries=acct.stats.prefetched_entries,
               prefetch_useful=acct.stats.prefetch_useful,
               sim_hit_rate=acct.stats.hit_rate,
               cold_hit_rate=(sum(cold_hits_seen) / len(cold_hits_seen)
                              if cold_hits_seen else cold_hit))
    # per-SEGMENT traffic (lists — benchmarks/fabric_sweep.py computes
    # trunk/leaf hotspot ratios from these against the topology)
    out["segment_demand_bytes"] = list(acct.stats.segment_demand_bytes)
    out["segment_issued_s"] = list(acct.stats.segment_issued_s)
    if arb is not None:
        out["arbiter_width_mean"] = (grant_sum / grant_n if grant_n
                                     else 0.0)
    return out


def run_backend_sweep(reqs: List[Request], model: ModelProfile,
                      backends: Dict[str, BackendProfile], sim: SimConfig
                      ) -> Dict[str, Dict[str, float]]:
    return {name: simulate(reqs, model, b, sim)
            for name, b in backends.items()}


def replay_engine_timeline(eng, reqs: List[Request],
                           *, max_steps: int = 100_000) -> List[Request]:
    """Analytic replay of the engine's continuous-batching loop (PR 8).

    Reproduces :meth:`Engine.step`'s virtual-clock sequencing — arrival-
    gated admission into freed slots, chunked / monolithic / disagg-lane
    prefill, cold-read decode charging, idle jumps to the next event —
    using the engine's OWN cost objects (``eng.profile``,
    ``eng.sac.fabric``, ``eng.sac.entry_bytes``), so per-request
    ``dispatch_s`` / ``first_token_s`` / ``finish_s`` must agree with a
    real engine run to float precision.

    Valid for the parity regime the rolling-admission tests pin down:
    cold reads (``device_buffer == 0``), radix/prefetch/warm-up off,
    overlap off, flat star topology (timing independent of placement).
    Returns fresh request copies carrying the replayed timestamps.

    Admission and prefill-mode dispatch consume the engine's OWN
    shared policy objects (``eng.admission_policy``,
    ``eng.prefill_schedule`` — serving/policy/), so engine/replay
    parity on these decisions is object identity, not reimplementation.
    """
    cfg = eng.cfg
    fabric = eng.sac.fabric
    entry_b = eng.sac.entry_bytes
    policy = eng.admission_policy
    schedule = eng.prefill_schedule
    wb_layers = max(cfg.n_attn_layers, 1)
    n_kv = max(getattr(eng.model, "n_kv", 1), 1)
    k = min(cfg.sac.topk, eng.max_ctx)
    eps = 1e-12

    reqs = sorted((dataclasses.replace(
        r, dispatch_s=-1.0, first_token_s=-1.0, finish_s=-1.0,
        generated=0, tbt_max_s=0.0, out_tokens=None)
        for r in reqs), key=lambda r: r.request_id)
    queue: List[Request] = list(reqs)      # engine submit order (FCFS)
    slots: List[Optional[Request]] = [None] * eng.slots
    # chunked mode: slot -> [request, effective tokens left]
    jobs: List[Optional[list]] = [None] * eng.slots
    # disagg mode: prefill lanes + handoff records [ready_s, request]
    lane_busy = [0.0] * eng.prefill_lanes
    handoffs: List[list] = []
    shed: List[Request] = []
    clock = 0.0

    def write_s(n_tokens: int) -> float:
        return fabric.bulk_transfer_time(n_tokens * entry_b * wb_layers)

    def prefill_one(r: Request) -> float:
        """Prefill compute + exposed pool write for a whole prompt."""
        return (eng.profile.prefill_s(r.context_len)
                + write_s(r.context_len))

    def eligible() -> Optional[Request]:
        """The next request the shared admission policy would admit
        (None when nothing has arrived on the replay clock)."""
        elig = policy.eligible(queue, clock)
        if not elig:
            return None
        return queue[policy.select(queue, elig)]

    def fill() -> bool:
        nonlocal clock
        progressed = False
        drop = policy.shed(queue, clock)     # EDF load shedding, same
        for i in reversed(drop):             # policy object the engine
            shed.append(queue.pop(i))        # sheds through
        if schedule.disagg:
            for s in range(eng.slots):           # adopt ready handoffs
                if slots[s] is not None:
                    continue
                ready = [h for h in handoffs if h[0] <= clock + eps]
                if not ready:
                    break
                h = min(ready, key=lambda h: (h[0], h[1].request_id))
                handoffs.remove(h)
                slots[s] = h[1]                  # no warm-up traffic in
                progressed = True                # the parity regime
            for lane in range(eng.prefill_lanes):
                if lane_busy[lane] > clock + eps:
                    continue
                r = eligible()
                if r is None:
                    break
                queue.remove(r)
                r.dispatch_s = clock
                ready_s = clock + prefill_one(r)
                lane_busy[lane] = ready_s
                handoffs.append([ready_s, r])
                progressed = True
            return progressed
        if schedule.chunked:
            for s in range(eng.slots):           # bind arrivals to jobs
                if slots[s] is not None or jobs[s] is not None:
                    continue
                r = eligible()
                if r is None:
                    break
                queue.remove(r)
                r.dispatch_s = clock
                jobs[s] = [r, r.context_len]
                progressed = True
            for s in range(eng.slots):           # advance one chunk each
                if jobs[s] is None:
                    continue
                r, left = jobs[s]
                take = schedule.chunk_take(left)
                jobs[s][1] = left - take
                if jobs[s][1] <= 0:
                    jobs[s] = None
                    slots[s] = r
                clock += eng.profile.prefill_s(take) + \
                    (write_s(take) if take > 0 else 0.0)
                progressed = True
            return progressed
        for s in range(eng.slots):               # monolithic colocated
            if slots[s] is not None:
                continue
            r = eligible()
            if r is None:
                break
            queue.remove(r)
            r.dispatch_s = clock
            clock += prefill_one(r)
            slots[s] = r
            progressed = True
        return progressed

    def inflight() -> bool:
        return any(j is not None for j in jobs) or bool(handoffs)

    steps = 0
    while queue or any(s is not None for s in slots) or inflight():
        steps += 1
        assert steps < max_steps, "replay failed to drain"
        progressed = fill()
        occupied = [s for s in range(eng.slots) if slots[s] is not None]
        if not occupied:
            if not progressed:
                cands = [r.arrival_s for r in queue] \
                    + [h[0] for h in handoffs]
                future = [c for c in cands if c > clock]
                if not future:
                    break
                clock = min(future)
                fill()
                occupied = [s for s in range(eng.slots)
                            if slots[s] is not None]
            if not occupied:
                continue
        # one decode step: modeled compute + cold-read fetch per slot
        # (overlap off: every issued second is exposed)
        t_comp = eng.step_compute_s(len(occupied))
        fetch = 0.0
        for s in occupied:
            r = slots[s]
            prev_len = r.context_len + r.generated
            n = min(k * n_kv, prev_len * n_kv or 1)
            fetch += fabric.sparse_fetch_time(n, entry_b)
        clock += t_comp + fetch
        for s in occupied:
            r = slots[s]
            r.generated += 1
            if r.first_token_s < 0:
                r.first_token_s = clock
            if r.generated >= r.output_len:
                r.finish_s = clock
                slots[s] = None
    return reqs
