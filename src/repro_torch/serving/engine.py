"""Decode engine (``repro/serving/engine.py``): continuous batching
over the SAC cache on the card -- prefill and decode steps of the port's
model plus the host-side ``SACSystem`` bookkeeping, runnable end to end
on the CPU (``device="cpu"``) with reduced configs.

Every host branch of the reference is kept: radix prefix reuse with its
page lifecycle, replication and dedup, placement and fabric topology,
admission (FCFS / radix / EDF with shedding), monolithic, chunked and
disaggregated prefill, and the HiSparse hot tier, whose measured misses
are the only demand traffic charged to the fabric.  ``now`` is the same
deterministic virtual clock (modeled compute from the simulator's
``ModelProfile`` + exposed fabric), so the timeline and ``TrafficStats``
are comparable with the reference engine's number for number.

The port runs eagerly (nothing is jitted).  The serve state is updated
in place.  The fetch pipeline (``prefetch=True``: speculative prefetch,
prefill warm-up and, with it, the budget arbiter) and online hot-tier
re-sizing (``cfg.sac.resize_interval > 0``) raise NotImplementedError
until their slice lands (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hisparse
from repro_torch.core.sac import SACSystem
from repro_torch.core.traffic import TrafficStats
from repro_torch.core.transfer import PipelineModel
from repro_torch.core.pool import pool_write_prefill
from repro_torch.models.model import build_model
from repro_torch.models.transformer import kv_layer_windows
from repro_torch.serving.arbiter import DemandTracker, LayerSizer
from repro_torch.serving.policy import (LocalityBonus, PrefillSchedule,
                                  PressureFeed, RadixAdmission,
                                  ReplicationPolicy, WarmupPressureSeed,
                                  make_admission)
from repro_torch.serving.radix import RadixIndex
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.simulator import profile_from_config


def _resolve_device(device) -> torch.device:
    """The engine's device; the default ``"cuda"`` is refused on a
    machine without a card (no quiet switch to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass
class EngineStats:
    """Engine counters; fabric traffic lives in the shared TrafficStats
    schema (the same object the engine's SACSystem accountant charges)."""

    steps: int = 0
    tokens: int = 0
    radix_hit_tokens: int = 0       # PAGE-GRANULAR tokens whose prefill
                                    # compute + pool write were skipped
                                    # because the prefix was cached on
                                    # the request's own pool device
    radix_hit_requests: int = 0     # requests with a same-device hit
    radix_evicted_pages: int = 0    # cached-prefix pages returned to the
                                    # pool under page pressure
    resizes: int = 0                # online LayerSizer re-apportionings
                                    # actually applied
    resize_skips: int = 0           # intervals skipped by the hysteresis
                                    # epsilon (rates barely moved)
    replicated_pages: int = 0       # hot-prefix replica pages copied to a
                                    # second pool device
    dedup_shared_pages: int = 0     # request pages refcount-shared with
                                    # the cache instead of held privately
    replica_redirects: int = 0      # slot-steps whose prefix reads went
                                    # to a less-pressured replica device
                                    # instead of the slot's own
                                    # (replica-aware grants)
    shed_requests: int = 0          # requests dropped by EDF load
                                    # shedding before admission (the
                                    # SLO-aware admission policy)
    traffic: TrafficStats = dataclasses.field(default_factory=TrafficStats)
    # measured per-layer hot-tier outcomes ([L] arrays, accumulated per
    # step) — the LayerSizer's miss-rate signal (serving/arbiter.py)
    layer_hits: Optional[np.ndarray] = None
    layer_misses: Optional[np.ndarray] = None

    def layer_miss_rates(self) -> Optional[np.ndarray]:
        """Per-layer miss fraction of the layer's demand top-k reads."""
        if self.layer_hits is None or self.layer_misses is None:
            return None
        tot = self.layer_hits + self.layer_misses
        return self.layer_misses / np.maximum(tot, 1)

    @property
    def pool_entries_fetched(self) -> int:
        """Entries that crossed the fabric (demand misses + prefetch) —
        the shared ``TrafficStats.entries_fetched`` counter, not a
        separately drifting engine tally."""
        return int(self.traffic.entries_fetched)

    @property
    def buffer_hits(self) -> int:
        return int(self.traffic.buffer_hits)

    @property
    def buffer_misses(self) -> int:
        return int(self.traffic.buffer_misses)

    @property
    def fabric_time_s(self) -> float:
        return self.traffic.fabric_time_s

    @property
    def issued_fabric_s(self) -> float:
        return self.traffic.issued_fabric_s

    @property
    def exposed_fabric_s(self) -> float:
        return self.traffic.exposed_fabric_s

    @property
    def hit_rate(self) -> float:
        return self.traffic.hit_rate

    @property
    def prefetched_entries(self) -> int:
        return int(self.traffic.prefetched_entries)

    @property
    def prefetch_useful(self) -> int:
        return int(self.traffic.prefetch_useful)

    @property
    def prefetch_wasted(self) -> int:
        return int(self.traffic.prefetch_wasted)

    @property
    def prefetch_precision(self) -> float:
        return self.traffic.prefetch_precision


@dataclasses.dataclass
class _PrefillJob:
    """A prefill in flight (chunked / disaggregated prefill).

    All host-side admission work is already done when the job exists —
    pool pages booked (``rp``), radix pins held, dedup shared, dispatch
    stamped — but the jitted prefill + state splice are DEFERRED to
    completion (``Engine._complete_prefill``).  A mid-flight slot
    therefore holds no decodable state at all, so the decoded tokens
    cannot depend on the chunk schedule: chunking and disaggregation
    change timing and traffic, never tokens (the repo invariant)."""

    req: Request
    prompt: np.ndarray
    matched: int                 # page-granular radix-hit tokens
    pins: List[list]             # radix paths pinned for the lifetime
    rp: object                   # the SACSystem placement record
    dedup_n: int                 # pages refcount-shared with the cache
    copies: tuple                # replica-read copy devices
    frac: float                  # prefix read fraction for replica reads
    done_tokens: int = 0         # effective tokens already chunked
    ready_s: float = -1.0        # disagg: handoff-ready wall-clock time

    @property
    def effective(self) -> int:
        """Prompt tokens that actually cost compute + pool write (the
        radix-matched prefix is copied device-locally)."""
        return len(self.prompt) - self.matched


class Engine:
    """Fixed-slot continuous batching engine.

    ``slots`` requests decode together in one compiled step; finished
    slots are refilled from the queue (prefill on demand, with radix
    prefix reuse).  The pool state is the serve_state pytree of
    models/transformer.py; per-slot independence is guaranteed by the
    batch dimension.

    ``track_buffer`` wires the HiSparse hot buffer into the decode step
    (``device_buffer`` entries per layer per slot, default
    ``cfg.sac.device_buffer_size``); fabric time is then charged on
    measured misses only.  Off, every step is charged the full cold-read
    top-k transfer.

    ``device`` (default ``"cuda"``) is where the model, its parameters
    and the serve state live; a machine without a card refuses the
    default, and ``device="cpu"`` runs the plain PyTorch versions of the
    kernels.

    NOT YET PORTED (raise NotImplementedError): ``prefetch=True`` and
    with it the arbiter, and ``cfg.sac.resize_interval > 0``.  The
    reference's description of them follows for orientation.

    ``prefetch`` turns on the fetch pipeline (serving/prefetch.py):
    speculative in-graph prefetch of ``cfg.sac.prefetch_width`` entries
    per layer per step, prefill warm-up of the hot tier, and overlap
    queues (issued vs exposed fabric seconds).  ``prefetch_fn`` overrides
    the in-graph speculation ``(scores, cache_len) -> (idx, valid)`` —
    the hook parity tests use to replay controlled drift.  ``overlap``
    forces the overlap queues on/off independently of prefetch (default:
    on when prefetch or ``cfg.sac.overlap_fetch`` is set).

    ``arbiter`` (default ``cfg.sac.arbiter``) turns on cross-request
    prefetch budget arbitration (serving/arbiter.py): each step, last
    step's measured per-device demand seconds shrink or grow every
    request's granted speculative width, passed into the jitted decode
    as a per-slot budget tensor.  ``layer_sizing`` (default
    ``cfg.sac.layer_sizing``) apportions the hot tier's total slot
    budget across layers via the LayerSizer instead of uniformly.
    Neither changes decoded tokens (property-tested in
    tests/test_arbiter.py).

    The closed control loops:

      - ``placement`` (default ``cfg.sac.placement``) overrides the pool
        placement policy; ``"pressure_aware"`` feeds the placer the
        engine's live per-device demand seconds so new requests land on
        the least-pressured fabric link;
      - ``cfg.sac.precision_weighted`` splits each device's grant budget
        across its requests by their measured prefetch precision (the
        per-request ``TrafficStats.request_pf`` attribution) instead of
        uniformly;
      - ``cfg.sac.resize_interval`` re-apportions the hot tier online:
        every that many steps the LayerSizer re-runs on the measured
        per-layer miss rates and the hisparse DISABLED sentinels are
        re-marked in place (``hisparse.resize_layers``);
      - with the arbiter on, prefill warm-up bursts draw from the same
        per-device link budget (``BudgetArbiter.grant_warmup`` caps the
        warm-up plan's width).

    All four change traffic and timing only — decoded tokens are
    bit-identical with every knob on or off.

    The radix prefix cache is request-lifetime-correct and closes the
    prefix-locality loop: the index holds the request's
    ACTUAL pool pages (pinned for the request's lifetime, retained
    under cache ownership at finish, evicted back to the allocator
    under pool page pressure, purged the moment ``sac.release`` frees
    them); ``placement="radix_affinity"`` weighs a matched prefix's
    device against live link pressure; and a same-device hit skips the
    matched pages' pool write and shortens the modeled prefill
    (``radix_hit_tokens`` changes timing and traffic — never tokens:
    prefill always recomputes the full prompt in-graph).  ``radix=False``
    disables the cache entirely (the A/B baseline).

    Three knobs trade pool bytes for link bandwidth on hot prefixes:

      - ``replicate_prefixes`` (default ``cfg.sac.replicate_prefixes``)
        copies a matched prefix's pages to the least-pressured pool
        device when the corrected pressure on the copy-holding link
        covers the one-time copy cost within
        ``cfg.sac.replicate_horizon_steps`` decode steps — placement
        then picks the cheapest COPY (``MatchResult.copies``) instead
        of the single owner, splitting a hot prefix's load across
        links;
      - ``dedup_pages`` (default ``cfg.sac.dedup_pages``) refcount-
        shares a same-device match's cached pages with the new slot
        instead of holding private pool copies (decode never mutates
        prefix pages, so no copy-on-write is needed) — the slot's
        booking shrinks by the shared bytes, multiplying effective pool
        capacity under shared-prefix load;
      - ``radix_admission`` (default ``cfg.sac.radix_admission``)
        admits the waiting request with the longest page-granular match
        against the current tree (FCFS tie-break) so batches sharing a
        prefix land while the copy is hot.

    All three change traffic, timing, and pool bytes — never decoded
    tokens (prefill still recomputes the full prompt in-graph; page ids
    are host-side bookkeeping).
    """

    def __init__(self, cfg: ModelConfig, *, slots: int = 4,
                 max_ctx: int = 256, backend: str = "cxl",
                 mode: str = "sac", track_buffer: bool = True,
                 device_buffer: Optional[int] = None,
                 prefetch: bool = False, prefetch_fn=None,
                 overlap: Optional[bool] = None,
                 arbiter: Optional[bool] = None,
                 layer_sizing: Optional[str] = None,
                 placement: Optional[str] = None,
                 radix: bool = True,
                 replicate_prefixes: Optional[bool] = None,
                 dedup_pages: Optional[bool] = None,
                 radix_admission: Optional[bool] = None,
                 admission: Optional[str] = None,
                 shed_queue_depth: Optional[int] = None,
                 topology=None,
                 warmup_pressure_seed: Optional[bool] = None,
                 replica_reads: Optional[bool] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 disagg: Optional[bool] = None,
                 prefill_lanes: Optional[int] = None,
                 topk_fn=None, seed: int = 0, device="cuda"):
        self.device = _resolve_device(device)
        if prefetch:
            raise NotImplementedError(
                "prefetch=True (and the arbiter) waits for the fetch-"
                "pipeline slice (ROADMAP: serving/prefetch.py)")
        if cfg.sac.resize_interval > 0:
            raise NotImplementedError(
                "online hot-tier re-sizing (resize_interval > 0) waits for "
                "the fetch-pipeline slice (ROADMAP: hisparse.resize_layers)")
        # f32 products (MLA absorption, attention oracles) stay f32
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.slots = slots
        self.max_ctx = max_ctx
        buffered = (track_buffer and cfg.sac.enabled and not cfg.enc_dec
                    and mode == "sac")
        self.device_buffer = 0
        if buffered:
            self.device_buffer = (cfg.sac.device_buffer_size
                                  if device_buffer is None else device_buffer)
        self.prefetch = False
        # topk_fn overrides the indexer's top-k selection inside the
        # decode step (scores, cache_len) -> (idx, valid); used by parity
        # tests to replay controlled top-k traces through the buffer
        self.model = build_model(cfg, mode=mode, topk_fn=topk_fn,
                                 device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.model.init(gen)
        self.placement = placement if placement is not None \
            else cfg.sac.placement
        # fabric topology (core/fabric.py): one object shared by the
        # accountant (per-segment charging), placer (bottleneck-pressure
        # projection), demand tracker, and arbiter.  None -> cfg.sac
        # spec -> flat star (bit-identical to flat per-device accounting)
        self.sac = SACSystem(cfg, backend=backend,
                             placement=self.placement,
                             topology=(topology if topology is not None
                                       else cfg.sac.topology))
        self.topology = self.sac.topology
        # radix prefix cache: the SACSystem owns its page lifecycle
        # (retention at finish, eviction under pressure, purge on free)
        self.radix = (RadixIndex(page_size=cfg.sac.page_size)
                      if radix else None)
        self.sac.attach_radix(self.radix)
        # prefix replication / dedup knobs (gated on the radix cache)
        has_radix = self.radix is not None
        self.replicate_on = bool(
            (cfg.sac.replicate_prefixes if replicate_prefixes is None
             else replicate_prefixes) and has_radix)
        self.dedup_on = bool((cfg.sac.dedup_pages if dedup_pages is None
                              else dedup_pages) and has_radix)
        # admission policy (serving/policy/admission.py): the ONE
        # arrival-gate + queue-ordering + shedding object shared with
        # the simulator twin and the analytic replay.  name=None keeps
        # the legacy mapping (radix when radix_admission is on, else
        # FCFS); "edf" adds SLO-aware ordering + optional load shedding
        self.admission_policy = make_admission(
            cfg.sac.admission if admission is None else admission,
            radix_admission=bool(
                cfg.sac.radix_admission if radix_admission is None
                else radix_admission),
            slo_ttft_s=float(cfg.sac.slo_ttft_s),
            shed_queue_depth=int(
                cfg.sac.shed_queue_depth if shed_queue_depth is None
                else shed_queue_depth),
            score_fn=self._radix_score, has_radix=has_radix)
        self.admission_on = isinstance(self.admission_policy,
                                       RadixAdmission)
        # warm-up-only pressure seeding (the feed is
        # silent before the first decode step — seed it from BOOKED
        # demand so wave-1 admissions stop herding; always-on regresses
        # under dedup, see benchmarks/locality_sweep.py) and replica-
        # aware per-step reads (prefix fetches go to the least-pressured
        # copy each step instead of the copy frozen at placement)
        self.warm_seed_on = bool(
            cfg.sac.warmup_pressure_seed if warmup_pressure_seed is None
            else warmup_pressure_seed)
        self.replica_reads_on = bool(
            (cfg.sac.replica_reads if replica_reads is None
             else replica_reads) and has_radix)
        # continuous batching + disaggregated prefill.  Admission
        # is ALWAYS gated on the virtual clock vs arrival_s (the open-
        # loop bugfix); chunk_tokens > 0 splices a prompt in over
        # bounded chunks interleaved with decode steps; disagg runs
        # prefill on separate lanes (their own busy-until times on the
        # shared wall clock) and hands completed prefills to the decode
        # loop through _PrefillJob handoff records.  Chunking is a
        # colocated-engine concern: disagg lanes never block decode, so
        # chunk_tokens is ignored there.
        self.chunk_tokens = int(cfg.sac.prefill_chunk_tokens
                                if prefill_chunk_tokens is None
                                else prefill_chunk_tokens)
        self.disagg_on = bool(cfg.sac.disagg_prefill if disagg is None
                              else disagg)
        self.prefill_lanes = max(1, int(cfg.sac.prefill_lanes
                                        if prefill_lanes is None
                                        else prefill_lanes))
        self._jobs: List[Optional[_PrefillJob]] = [None] * slots
        self._lane_busy: List[float] = [0.0] * self.prefill_lanes
        self._handoffs: List[_PrefillJob] = []
        # per-slot (replica copy devices, prefix read fraction) of the
        # matched cached prefix — the backing pin held for the slot's
        # lifetime keeps the copy set valid
        self._slot_prefix: List[tuple] = [((), 0.0) for _ in range(slots)]
        # per-slot radix bookkeeping: (pinned token paths — the matched
        # BACKING prefix and the request's own aligned path — and the
        # pages the index registered from this request's allocation)
        self._slot_radix: List[tuple] = [([], 0) for _ in range(slots)]
        # the engine's stats share the SACSystem accountant's TrafficStats:
        # every charged fetch/write and recorded hit/miss lands here
        self.stats = EngineStats(traffic=self.sac.traffic.stats)
        self.pipeline = PipelineModel(depth=cfg.sac.pipeline_depth,
                                      overlap_frac=cfg.sac.overlap_frac)
        self.overlap_on = (bool(self.prefetch or cfg.sac.overlap_fetch)
                           if overlap is None else bool(overlap))
        if self.overlap_on:
            self.sac.traffic.enable_overlap(self.pipeline)
        # virtual clock: per-step compute from the simulator's profile
        # constants, so engine latency numbers are deterministic and
        # engine/simulator timing is built from the same model
        self.profile = profile_from_config(cfg)
        self.clock_s = 0.0
        # per-link AND per-request demand-step deltas (serving/arbiter.py
        # DemandTracker): the pressure feed subtracts a finishing
        # request's own share from its link immediately at departure
        self._demand = DemandTracker(self.sac.n_devices, self.topology)
        # shared control-plane objects (serving/policy/): the SAME
        # classes the simulator twin and the analytic replay construct,
        # so parity tests assert object identity instead of float
        # agreement.  The pressure feed is wired here (not earlier)
        # because it closes over the demand tracker; no placement can
        # have happened yet, so the placer never saw the gap.
        self.warm_seed = WarmupPressureSeed(
            self.warm_seed_on, len(self._demand.last_demand_s))
        self.pressure_feed = PressureFeed(
            self._demand, self.warm_seed,
            booked_fn=lambda: self.stats.traffic.segment_demand_s())
        self.sac.set_pressure_fn(self.pressure_feed)
        self.replication = ReplicationPolicy(
            horizon_steps=int(cfg.sac.replicate_horizon_steps))
        self.locality_bonus = LocalityBonus(
            prefill_s=self.profile.prefill_s,
            write_s=self._prefix_write_s)
        self.prefill_schedule = PrefillSchedule.from_knobs(
            self.disagg_on, self.chunk_tokens, self.prefill_lanes)
        self.shed: List[Request] = []
        # per-layer hot-tier sizing: apportion the uniform total
        # (device_buffer * n_layers) by the LayerSizer's windowed prior
        # (static sizes; the online re-sizing of the reference raises)
        self.layer_sizing = (cfg.sac.layer_sizing if layer_sizing is None
                             else layer_sizing)
        self.buffer_sizes: Optional[List[int]] = None
        self.buffer_width: Optional[int] = None
        if self.device_buffer and self.layer_sizing != "uniform":
            n_kv = max(self.model.n_kv, 1)
            self.buffer_sizes = LayerSizer(
                n_kv, self.device_buffer * n_kv,
                layer_windows=kv_layer_windows(cfg),
                topk=cfg.sac.topk).sizes()

        # eager steps: the port runs its model without tracing
        self._decode = self.model.decode
        self._prefill_one = self.model.prefill
        self.state = self.model.init_serve_state(
            slots, max_ctx,
            device_buffer=self.buffer_sizes or self.device_buffer,
            buffer_width=self.buffer_width)
        if self.device_buffer:
            n_kv = max(self.model.n_kv, 1)
            self.stats.layer_hits = np.zeros(n_kv)
            self.stats.layer_misses = np.zeros(n_kv)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_tokens: List[List[int]] = [[] for _ in range(slots)]
        self.queue: List[Request] = []

    @property
    def _last_demand_s(self) -> List[float]:
        """Last step's per-SEGMENT demand seconds (departures already
        subtracted) — the arbiter's and the placer's pressure signal
        (the placer projects each device's path bottleneck from it).
        Delegates to the shared :class:`PressureFeed` (the same object
        wired into ``set_pressure_fn``): the warm-up-only seeding
        window — booked prefill-write demand overlaid before the first
        decode step only — lives once, in serving/policy/seeding.py."""
        return self.pressure_feed()

    def _radix_score(self, req: Request) -> int:
        """Radix-admission score: this request's page-granular match
        length against the CURRENT tree (the admission policy's
        ``score_fn``)."""
        return self.radix.match(
            req.prompt_tokens[: req.context_len].tolist()).paged_tokens

    def _prefix_write_s(self, matched: int) -> float:
        """Pool-write seconds the matched prefix tokens skip — the
        engine-native cost the shared :class:`LocalityBonus` formula
        is bound to (the simulator binds its analytic striped-pool
        write bandwidth instead)."""
        return self.sac.fabric.bulk_transfer_time(
            matched * self.sac.entry_bytes
            * max(self.cfg.n_attn_layers, 1))

    # -- submission --------------------------------------------------------------
    def submit(self, req: Request):
        assert req.prompt_tokens is not None, "engine needs real tokens"
        assert req.context_len + req.output_len <= self.max_ctx, \
            "request exceeds engine max_ctx"
        self.queue.append(req)

    # -- modeled step time --------------------------------------------------------
    def step_compute_s(self, batch: int) -> float:
        """Modeled decode-step compute for ``batch`` occupied slots."""
        return (self.profile.base_step_s
                + batch * self.profile.per_token_compute_s())

    # -- slot refill -------------------------------------------------------------
    def _locality_bonus_s(self, prompt_len: int, matched: int) -> float:
        """Seconds a same-device radix hit saves: the matched tokens'
        modeled prefill compute plus their skipped pool write — the
        ``affinity_s`` weight the radix_affinity placement policy holds
        against live link pressure.  The FORMULA is the shared
        :class:`LocalityBonus` (serving/policy/locality.py) — the
        simulator's ``_bonus_s`` binds the same object to its analytic
        costs."""
        return self.locality_bonus(prompt_len, matched)

    def _eligible_indices(self) -> List[int]:
        """Queue indices whose requests have ARRIVED on the virtual
        clock — the open-loop admission gate.  Without it an open-loop
        trace would be served as if all requests arrived at t=0 and
        arrival-anchored TTFT would be meaningless.  Delegates to the shared admission policy's arrival gate."""
        return self.admission_policy.eligible(self.queue, self.clock_s)

    def _pick_queue_index(self, eligible: List[int]) -> int:
        """The next queue index to admit among the ARRIVED requests —
        the shared policy's ``select``: FCFS by default, longest radix
        match first under radix admission, earliest deadline first
        under EDF (ties always break FCFS)."""
        return self.admission_policy.select(self.queue, eligible)

    def _shed_waiting(self):
        """Load shedding (EDF + ``shed_queue_depth``): drop the arrived
        backlog beyond the policy's keep set BEFORE admission.  Shed
        requests leave the queue and never decode — they stay on
        ``self.shed`` (and out of summarize(), which only counts
        finished requests)."""
        drop = self.admission_policy.shed(self.queue, self.clock_s)
        for i in reversed(drop):
            self.shed.append(self.queue.pop(i))
        if drop:
            self.stats.shed_requests = len(self.shed)

    def _prefill_inflight(self) -> bool:
        """Any admitted prefill not yet spliced into a decode slot —
        chunked jobs mid-flight or disagg handoffs awaiting adoption."""
        return (any(j is not None for j in self._jobs)
                or bool(self._handoffs))

    def _next_event_s(self) -> Optional[float]:
        """The earliest future event the idle engine can jump to: the
        next arrival or the next handoff completion."""
        cands = [r.arrival_s for r in self.queue]
        cands += [h.ready_s for h in self._handoffs]
        future = [c for c in cands if c > self.clock_s]
        return min(future) if future else None

    def _maybe_replicate(self, m, toks: List[int], prompt_len: int):
        """Hot-prefix replication trigger.  Fire when (a) the reuse
        benefit itself covers the one-time copy cost and (b) the
        CORRECTED pressure on the prefix's cheapest copy-holding link —
        the raw feed plus the placer's in-flight booking correction, so
        a same-wave admission burst counts before the feed catches up —
        exceeds the one-time copy cost amortized over
        ``cfg.sac.replicate_horizon_steps`` decode steps, with the copy
        going to the least-pressured copy-free link (never a hotter
        one).  Per-step backlog on the owning link must cover the bulk
        copy's per-step share, or a lightly-loaded fabric would
        replicate everything for nothing.  The (src, dst) pick and the
        fire/hold predicate are the shared :class:`ReplicationPolicy`
        (serving/policy/replication.py) — the simulator twin consumes
        the same object.  Returns the re-match (placement must see the
        new copy) or None."""
        pressure = self.sac.placer.corrected_pressure()
        holders = [d for d in m.copies if 0 <= d < self.sac.n_devices]
        others = [d for d in range(self.sac.n_devices)
                  if d not in m.copies]
        pick = self.replication.pick(pressure, holders, others,
                                     self.sac.placer.bytes_used)
        if pick is None:
            return None
        src, dst = pick
        n_pages = len(m.copies[src])
        copy_cost = self.sac.replica_copy_cost_s(n_pages)
        bonus = self._locality_bonus_s(prompt_len, m.paged_tokens)
        if not self.replication.should_fire(pressure[src], pressure[dst],
                                            bonus, copy_cost):
            return None
        if not self.sac.replicate_prefix(list(m.pin_tokens),
                                         m.copies[src], src, dst):
            return None
        self.stats.replicated_pages = self.sac.replicated_pages
        return self.radix.match(toks)

    def _admit_request(self, req: Request) -> Optional[_PrefillJob]:
        """Host-side admission for one popped request: radix match/pin
        (+ replication), pool placement, dedup, dispatch stamp.  No
        compute advances the clock and no fabric write is charged here —
        each mode (monolithic / chunked / disagg lane) pays those on its
        own schedule.  Returns None when the pool is exhausted (pins
        released; the caller requeues at the head)."""
        prompt = req.prompt_tokens[: req.context_len]
        toks = prompt.tolist()
        # radix prefix lookup — PAGE-granular reuse (crediting the
        # raw token walk would count prefix tokens no cached page
        # backs).  The BACKING node's path is pinned immediately so
        # the pool-pressure eviction inside place() cannot free the
        # pages we are about to reuse.
        m = self.radix.match(toks) if self.radix is not None else None
        pins: List[list] = []
        if m is not None and m.hit:
            pins.append(list(m.pin_tokens))
            self.radix.pin(pins[-1])
            if self.replicate_on:
                # the pin above keeps the node alive through the
                # copy; a successful replication re-matches so the
                # placer sees every copy (same node, same pin path)
                m2 = self._maybe_replicate(m, toks, len(prompt))
                if m2 is not None and m2.hit:
                    m = m2
        bonus_s = (self._locality_bonus_s(len(prompt), m.paged_tokens)
                   if pins else 0.0)
        rp = self.sac.place(req.request_id, len(prompt) + req.output_len,
                            affinity=sorted(m.copies) if pins else None,
                            affinity_s=bonus_s)
        if rp is None:
            for p in pins:
                self.radix.release(p)
            return None
        req.dispatch_s = self.clock_s
        req.pool_device = rp.device
        # reuse is only real on a device holding a copy of the
        # cached pages (off-device, the prefix would cross two
        # fabric links — no better than recomputing); radix_affinity
        # placement + replication are what make this coincide
        matched = (m.paged_tokens
                   if pins and rp.device in m.copies else 0)
        if pins and not matched:
            self.radix.release(pins.pop())
        self.stats.radix_hit_tokens += matched
        if matched:
            self.stats.radix_hit_requests += 1
        # page dedup: share the matched copy's pages with this slot
        # instead of holding private duplicates — the slot's own
        # leading pages return to the pool and its booking shrinks.
        # The backing pin (held for the request's lifetime) is what
        # keeps the shared pages resident.
        dedup_n = 0
        if self.dedup_on and matched:
            shared = m.copies[rp.device][: matched
                                         // self.cfg.sac.page_size]
            dedup_n = self.sac.dedup_match(req.request_id, shared)
            if dedup_n:
                self.stats.dedup_shared_pages = \
                    self.sac.dedup_shared_pages
        # replica-aware reads: the devices holding a copy of the
        # matched prefix and the fraction of this slot's reads in the
        # prefix region — step() re-picks the least-pressured copy
        # every step (the backing pin keeps every copy resident)
        copies, frac = (), 0.0
        if self.replica_reads_on and matched:
            copies = tuple(sorted(m.copies))
            frac = matched / max(len(prompt), 1)
        return _PrefillJob(req=req, prompt=prompt, matched=matched,
                           pins=pins, rp=rp, dedup_n=dedup_n,
                           copies=copies, frac=frac)

    def _complete_prefill(self, s: int, job: _PrefillJob):
        """Splice a finished prefill into slot ``s`` — the
        prefill ALWAYS recomputes the full prompt in-graph, so the
        radix hit, the chunk schedule, and the handoff route change
        modeled timing and fabric traffic, never decoded tokens."""
        req, prompt, rp = job.req, job.prompt, job.rp
        matched = job.matched
        toks = torch.as_tensor(np.asarray(prompt)[None, :],
                               dtype=torch.int32, device=self.device)
        st, _ = self._prefill_one(self.params, toks)
        self._splice_state(s, st, len(prompt))
        page_tokens = (len(prompt) // self.cfg.sac.page_size) \
            * self.cfg.sac.page_size
        keep = 0
        if self.radix is not None and page_tokens and not job.dedup_n:
            # (with dedup, the slot's leading pages ARE the cached
            # node's pages — inserting its own path would register a
            # second owner for them; the backing pin + existing node
            # already serve future matches)
            own = prompt[:page_tokens].tolist()
            # register the request's ACTUAL pool pages (not
            # fabricated range(n) ids) — an identical cached prefix
            # keeps the first copy
            keep = self.radix.insert(
                own, rp.device,
                rp.pages[:page_tokens // self.cfg.sac.page_size])
            # pin the request's own aligned path for its lifetime;
            # the matched BACKING path stays pinned too (the reused
            # pages must survive while the request decodes)
            self.radix.pin(own)
            job.pins.append(own)
        self._slot_radix[s] = (job.pins, keep)
        self._slot_prefix[s] = (job.copies, job.frac)
        self.slot_req[s] = req
        self.slot_tokens[s] = [int(prompt[-1])]

    def _requeue_unplaceable(self, req: Request):
        """Pool exhausted even after radix eviction.  Charging device 0
        for a booking that never happened would leave a phantom request
        on its link; instead requeue at the head (FCFS) and retry once a finishing request frees pages
        — unless nothing is in flight anywhere (no decoding slot, no
        chunked job, no handoff), in which case capacity will never
        appear."""
        self.queue.insert(0, req)
        if (not any(r is not None for r in self.slot_req)
                and not self._prefill_inflight()):
            raise RuntimeError(
                f"request {req.request_id} "
                f"({req.context_len + req.output_len} tokens) can "
                "never be placed: every pool device lacks "
                "capacity even with the radix cache evicted")

    def _fill_slots(self) -> bool:
        """Admission + prefill scheduling for this step, gated on the
        virtual clock vs ``arrival_s`` in every mode.  Returns True
        when any prefill work progressed (slot filled, chunk advanced,
        lane started, or handoff adopted) — step() uses that to decide
        whether an empty batch may jump the clock to the next event.
        Mode dispatch goes through the shared :class:`PrefillSchedule`
        (serving/policy/prefill.py), the same object the replay's
        ``fill()`` reads."""
        self._shed_waiting()
        if self.prefill_schedule.disagg:
            adopted = self._adopt_handoffs()
            started = self._start_prefill_lanes()
            return adopted or started
        if self.prefill_schedule.chunked:
            created = self._create_chunk_jobs()
            advanced = self._advance_chunk_jobs()
            return created or advanced
        # monolithic colocated: the seed path + the arrival gate
        progressed = False
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            eligible = self._eligible_indices()
            if not eligible:
                break
            req = self.queue.pop(self._pick_queue_index(eligible))
            job = self._admit_request(req)
            if job is None:
                self._requeue_unplaceable(req)
                break
            issued0 = self.stats.traffic.fabric_time_s
            # charge the pool write for the NON-matched tokens only (the
            # matched pages' KV is copied device-locally from the cached
            # prefix, never crossing the fabric), against the request's
            # own pool link — the arbiter's demand signal must see
            # prefill pressure on the device it actually loads
            self.sac.write_back_time(job.effective,
                                     device=req.pool_device,
                                     key=req.request_id)
            self._complete_prefill(s, job)
            # virtual clock: prefill compute — a genuine radix hit skips
            # the matched prefix's recompute, so the modeled prefill (and
            # with it TTFT) shortens; fill-time fabric traffic (pool
            # write + warm-up) hides behind it when overlap is on
            t_prefill = self.profile.prefill_s(job.effective)
            if self.overlap_on:
                exposed = self.sac.traffic.drain_overlap(t_prefill)
            else:
                exposed = self.stats.traffic.fabric_time_s - issued0
            self.clock_s += t_prefill + exposed
            progressed = True
        return progressed

    def _create_chunk_jobs(self) -> bool:
        """Chunked colocated admission: bind an arrived request to each
        free slot as an in-flight job — no compute, no fabric charge
        yet (the chunks pay as they run in _advance_chunk_jobs)."""
        progressed = False
        for s in range(self.slots):
            if self.slot_req[s] is not None or self._jobs[s] is not None:
                continue
            eligible = self._eligible_indices()
            if not eligible:
                break
            req = self.queue.pop(self._pick_queue_index(eligible))
            job = self._admit_request(req)
            if job is None:
                self._requeue_unplaceable(req)
                break
            self._jobs[s] = job
            progressed = True
        return progressed

    def _advance_chunk_jobs(self) -> bool:
        """Advance every in-flight chunked prefill by ONE bounded chunk:
        the chunk's compute plus its pool-write tail advance the clock,
        so a decode step is delayed by one chunk, never a whole prompt.
        A job whose last chunk lands splices and decodes this same step
        — with chunk >= prompt this reduces exactly to the monolithic
        path (same charges, same clock advances, same order), and the
        deferred splice keeps decoded tokens independent of the chunk
        schedule."""
        progressed = False
        for s in range(self.slots):
            job = self._jobs[s]
            if job is None:
                continue
            take = self.prefill_schedule.chunk_take(
                job.effective - job.done_tokens)
            issued0 = self.stats.traffic.fabric_time_s
            if take > 0:
                self.sac.write_back_time(take, device=job.req.pool_device,
                                         key=job.req.request_id)
                job.done_tokens += take
            if job.done_tokens >= job.effective:
                self._jobs[s] = None
                self._complete_prefill(s, job)
            t_chunk = self.profile.prefill_s(take)
            if self.overlap_on:
                exposed = self.sac.traffic.drain_overlap(t_chunk)
            else:
                exposed = self.stats.traffic.fabric_time_s - issued0
            self.clock_s += t_chunk + exposed
            progressed = True
        return progressed

    def _start_prefill_lanes(self) -> bool:
        """The disaggregated prefill engine's loop: assign arrived
        requests to free lanes on the shared wall clock.  The lane pays
        the (radix-shortened) prefill compute and the full pool write
        on the fabric route NOW — prefill writes KV to the pool device
        exactly as the colocated path charges it — and the handoff
        record becomes adoptable by the decode loop at ``ready_s``."""
        progressed = False
        for lane in range(self.prefill_lanes):
            if self._lane_busy[lane] > self.clock_s + 1e-12:
                continue
            eligible = self._eligible_indices()
            if not eligible:
                break
            req = self.queue.pop(self._pick_queue_index(eligible))
            job = self._admit_request(req)
            if job is None:
                self._requeue_unplaceable(req)
                break
            issued0 = self.stats.traffic.fabric_time_s
            self.sac.write_back_time(job.effective,
                                     device=req.pool_device,
                                     key=req.request_id)
            t_prefill = self.profile.prefill_s(job.effective)
            if self.overlap_on:
                exposed = self.sac.traffic.drain_overlap(t_prefill)
            else:
                exposed = self.stats.traffic.fabric_time_s - issued0
            job.ready_s = self.clock_s + t_prefill + exposed
            self._lane_busy[lane] = job.ready_s
            self._handoffs.append(job)
            progressed = True
        return progressed

    def _adopt_handoffs(self) -> bool:
        """Decode-side adoption (disagg): splice the earliest-ready
        handoff into each free slot.  The prefill compute was already
        paid on its lane (``ready_s``); adoption pays only the warm-up
        burst's fabric tail (hidden behind the next decode step when
        overlap is on), so decode TBT never stalls on a prompt."""
        progressed = False
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            ready = [h for h in self._handoffs
                     if h.ready_s <= self.clock_s + 1e-12]
            if not ready:
                break
            job = min(ready, key=lambda h: (h.ready_s, h.req.request_id))
            self._handoffs.remove(job)
            issued0 = self.stats.traffic.fabric_time_s
            self._complete_prefill(s, job)
            if not self.overlap_on:
                self.clock_s += (self.stats.traffic.fabric_time_s
                                 - issued0)
            progressed = True
        return progressed

    def _splice_state(self, slot: int, st_one: Dict, length: int):
        """Copy a 1-batch prefill state into slot ``slot`` of the engine
        state, IN PLACE.  The prompt's pool rows are written by one
        scatter per pool (``pool_write_prefill``), and the rows past the
        prompt are zeroed, as the reference's zero padding does.  The
        hot buffer has no prefill counterpart: the slot's lane is reset
        (a fresh request starts cold)."""
        for key, dst in self.state.items():
            if key == "hot_buf":
                hisparse.reset_lane(dst, slot)
            elif key in ("buf_hits", "buf_misses", "pf_inserted",
                         "pf_useful"):
                dst[slot] = 0
            elif key in ("buf_hits_l", "buf_misses_l"):   # [L, B] layouts
                dst[:, slot] = 0
            elif key in ("kv_pool", "idx_pool"):
                src = st_one[key]
                pad = dst.shape[2] - src.shape[2]
                if pad:
                    src = torch.cat([src, src.new_zeros(
                        src.shape[0], src.shape[1], pad, src.shape[3])],
                        dim=2)
                pool_write_prefill(dst, src, lane=slot)
            elif key == "cache_len":
                dst[slot] = st_one[key][0]
            else:
                raise KeyError(f"serve-state key {key!r} has no splice rule")

    # -- stepping -----------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> List[Request]:
        """One decode step for all occupied slots; returns finished reqs.

        ``now`` defaults to the engine's virtual clock (advanced by the
        modeled compute + exposed fabric of this step); passing an
        explicit value only overrides the request timestamps."""
        clock0 = self.clock_s       # a slot decoding through this step
                                    # sees the WHOLE step() wall time —
                                    # chunk stalls included — as its gap
        progressed = self._fill_slots()
        if not any(r is not None for r in self.slot_req):
            # no decodable slot.  If admission made no progress either,
            # the engine is idle before the next event (a future arrival
            # or a disagg handoff completing) — jump the virtual clock
            # to it and retry admission, so open-loop gaps cost wall
            # time but never spin the step counter.
            if not progressed:
                nxt = self._next_event_s()
                if nxt is not None and nxt > self.clock_s:
                    self.clock_s = nxt
                    self._fill_slots()
            if not any(r is not None for r in self.slot_req):
                return []
        tokens = torch.tensor(
            [(toks[-1] if toks else 0) for toks in self.slot_tokens],
            dtype=torch.int32, device=self.device)
        prev_len = self.state["cache_len"].cpu().numpy()
        occupied = [s for s in range(self.slots) if self.slot_req[s]]
        t_comp = self.step_compute_s(len(occupied))
        # replica-aware read choice: slot -> (read device, prefix
        # read fraction).  Re-evaluated every step from the bottleneck-
        # projected pressure feed — the copy choice is NOT frozen at
        # placement.  With replica_reads off this is (own device, 0.0)
        # and everything below is bit-identical to the flat path.
        reads: Dict[int, tuple] = {}
        pres = (list(self.sac.placer.device_pressure())
                if self.replica_reads_on else None)
        # within-step booking: charge each slot's expected step demand
        # onto its chosen devices as reads are assigned — the pressure
        # feed refreshes only between steps, so without it every reader
        # of a hot prefix herds onto the same least-pressured copy each
        # step (the simulator twin books the same way)
        est_s = (self.cfg.sac.topk * self.sac.entry_bytes
                 / self.sac.fabric.bandwidth_Bps)
        for s in occupied:
            own = self.sac.device_of(self.slot_req[s].request_id)
            copies, frac = self._slot_prefix[s]
            rd = own
            if pres is not None and copies and frac > 0.0:
                cands = sorted(set(copies) | {own})
                rd = min(cands,
                         key=lambda d: (pres[d] if d < len(pres) else 0.0,
                                        d))
            if rd == own:
                frac = 0.0
            else:
                self.stats.replica_redirects += 1
            if pres is not None:
                if rd < len(pres):
                    pres[rd] += frac * est_s
                if own < len(pres):
                    pres[own] += (1.0 - frac) * est_s
            reads[s] = (own, rd, frac)
        self.state, logits = self._decode(self.params, self.state, tokens)
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        self.stats.steps += 1
        # the first decode step closes the warm-up seeding window:
        # the tracker's first observe() below includes the warm-up
        # traffic, so leaving the seed on would double-count it
        self.warm_seed.deactivate()

        # fabric accounting per occupied slot
        issued0 = self.stats.traffic.fabric_time_s
        if self.cfg.sac.enabled and self.model.mode == "sac":
            if self.device_buffer:
                # miss-only charging: the decode step measured per-slot
                # hot-tier residency; only misses cross the fabric
                hits = self.state["buf_hits"].cpu().numpy()
                misses = self.state["buf_misses"].cpu().numpy()
                # per-layer split (LayerSizer miss-rate signal)
                self.stats.layer_hits += \
                    self.state["buf_hits_l"].cpu().numpy()[:, occupied] \
                    .sum(1)
                self.stats.layer_misses += \
                    self.state["buf_misses_l"].cpu().numpy()[:, occupied] \
                    .sum(1)
                for s in occupied:
                    req = self.slot_req[s]
                    dev, read_dev, frac = reads[s]
                    self.sac.traffic.record_hits(int(hits[s]),
                                                 int(misses[s]))
                    n_miss = int(misses[s])
                    if n_miss:
                        # keyed: the request's own demand share, so the
                        # pressure feed can subtract it at departure.
                        # The prefix-region share of the misses reads
                        # the step's chosen replica copy; the rest stays
                        # on the slot's own device (frac == 0 charges
                        # everything there — the flat path, unchanged).
                        n_pfx = min(int(round(n_miss * frac)), n_miss)
                        if n_pfx:
                            self.sac.sparse_fetch_time(
                                n_pfx, device=read_dev,
                                key=req.request_id)
                        if n_miss - n_pfx:
                            self.sac.sparse_fetch_time(
                                n_miss - n_pfx, device=dev,
                                key=req.request_id)
            else:
                # cold-read convention: every step is charged the full
                # top-k transfer per layer
                k = min(self.cfg.sac.topk, self.max_ctx)
                n_layers = max(getattr(self.model, "n_kv", 1), 1)
                for s in occupied:
                    req = self.slot_req[s]
                    n = min(k * n_layers, int(prev_len[s]) * n_layers or 1)
                    self.sac.sparse_fetch_time(
                        n, device=self.sac.device_of(req.request_id),
                        key=req.request_id)
        # issued vs exposed: drain the per-device queues against this
        # step's compute window (exposed == issued when overlap is off)
        if self.overlap_on:
            exposed = self.sac.traffic.drain_overlap(t_comp)
        else:
            exposed = self.stats.traffic.fabric_time_s - issued0
        # arbiter feedback: snapshot this step's per-device demand-only
        # issued seconds (total minus prefetch) as next step's pressure
        # (also the pressure_aware placer's live feed) — tracked per
        # REQUEST too, so a departure below subtracts its own share
        self._demand.observe(
            self.stats.traffic,
            [self.slot_req[s].request_id for s in occupied])
        self.sac.note_pressure_update()
        self.clock_s += t_comp + exposed
        if now is None:
            now = self.clock_s

        finished = []
        for s in occupied:
            req = self.slot_req[s]
            self.slot_tokens[s].append(int(next_tokens[s]))
            req.generated += 1
            if req.first_token_s < 0:
                req.first_token_s = now
            else:
                req.tbt_max_s = max(req.tbt_max_s,
                                    self.clock_s - clock0)
            self.stats.tokens += 1
            if req.generated >= req.output_len:
                req.finish_s = now
                # decoded stream only — slot_tokens[0] is the seeded
                # last prompt token, not a generated one
                req.out_tokens = self.slot_tokens[s][1:]
                finished.append(req)
                dev = self.sac.device_of(req.request_id)
                # radix lifecycle at departure: unpin the request's
                # prefix path, retain the pages the index registered
                # (ownership moves request -> cache), free the rest —
                # sac.release purges anything it frees from the index,
                # so a stale (device, pages) can never be matched
                pins, keep = self._slot_radix[s]
                if self.radix is not None:
                    for p in pins:
                        self.radix.release(p)
                self._slot_radix[s] = ([], 0)
                self._slot_prefix[s] = ((), 0.0)
                kept = self.sac.release(req.request_id, keep_pages=keep)
                if kept and self.cfg.sac.radix_headroom_frac > 0:
                    # pool page pressure: push the LRU tail of the cache
                    # back to the allocator before admissions need it
                    self.sac.evict_to_headroom(
                        self.cfg.sac.radix_headroom_frac)
                # pressure feedback: subtract the departing request's
                # own measured demand share from its link immediately
                # (per-request attribution) instead of letting the
                # placement EMA decay it over the next snapshots
                share = self._demand.depart(req.request_id, dev)
                self.sac.note_departure(dev, share)
                # the per-request prefetch attribution is an arbitration
                # signal, not a report — drop it with the request
                self.stats.traffic.drop_request(req.request_id)
                self.slot_req[s] = None
                self.slot_tokens[s] = []
                # reset this slot's cache length so the next request starts
                # fresh (pool pages are overwritten by the next prefill)
                self.state["cache_len"][s] = 0
        # cumulative, from the SACSystem: includes the evictions place()
        # performed under admission pressure, which a finish-time-only
        # tally would miss
        self.stats.radix_evicted_pages = self.sac.radix_evicted_pages
        return finished

    def run(self, requests: List[Request], *, max_steps: int = 10_000,
            slo_ttft_s: float = 0.0, slo_tbt_s: float = 0.0
            ) -> Dict[str, float]:
        for r in requests:
            self.submit(r)
        done = 0
        while done < len(requests) and self.stats.steps < max_steps:
            finished = self.step()
            done += len(finished)
            if (not finished and not any(self.slot_req)
                    and not self.queue and not self._prefill_inflight()):
                break
        out = summarize(requests, slo_ttft_s=slo_ttft_s,
                        slo_tbt_s=slo_tbt_s)
        out.update(engine_steps=self.stats.steps,
                   engine_tokens=self.stats.tokens,
                   radix_hit_tokens=self.stats.radix_hit_tokens,
                   radix_hit_requests=self.stats.radix_hit_requests,
                   bytes_written=self.stats.traffic.bytes_written,
                   fabric_time_s=self.stats.fabric_time_s,
                   issued_fabric_s=self.stats.issued_fabric_s,
                   exposed_fabric_s=self.stats.exposed_fabric_s,
                   buffer_hits=self.stats.buffer_hits,
                   buffer_misses=self.stats.buffer_misses,
                   buffer_hit_rate=self.stats.hit_rate,
                   prefetched_entries=self.stats.prefetched_entries,
                   prefetch_useful=self.stats.prefetch_useful,
                   prefetch_wasted=self.stats.prefetch_wasted,
                   prefetch_precision=self.stats.prefetch_precision,
                   replicated_pages=self.sac.replicated_pages,
                   dedup_shared_pages=self.sac.dedup_shared_pages,
                   replica_redirects=self.stats.replica_redirects,
                   shed_requests=self.stats.shed_requests,
                   spec_yielded_s=self.stats.traffic.spec_yielded_s,
                   critical_demand_bytes=(
                       self.sac.traffic.stats.critical_demand_bytes),
                   critical_issued_s=(
                       self.sac.traffic.stats.critical_issued_s),
                   pool_bytes_per_req=(self.sac.booked_pages_cum
                                       * self.sac.page_bytes
                                       / max(len(requests), 1)))
        return out
