"""Shared fabric-traffic accounting substrate.

One stats schema — :class:`TrafficStats` — for every serving layer:

  - ``SACSystem`` (core/sac.py) charges real engine fetches/writes here;
  - ``Engine`` (serving/engine.py) exposes the same object as
    ``EngineStats.traffic`` (buffer hits/misses are *measured* from the
    in-graph HiSparse buffer, core/hisparse.py);
  - ``simulate()`` (serving/simulator.py) accumulates its analytic
    per-device step demand through the same accountant.

The point of sharing the schema is paper §5.5: SAC's wins hinge on
*miss-only* fabric traffic, so the engine's measured hits/misses and the
simulator's analytic hit model must be comparable numbers — the parity
test (tests/test_engine_buffer.py) grounds one against the other.

Since PR 7 the charging unit is the **link segment** of a
:class:`~repro_torch.core.fabric.FabricTopology`: every transfer is routed
host->device and books occupancy (``seconds / bandwidth_scale +
latency_s``) on EACH segment of its path, with the end-to-end time being
the bottleneck segment's occupancy.  Per-device counters are kept as
views (demand bytes / issued seconds of that device's transfers), and
under the default flat-star topology — one dedicated segment per device,
``sid == device`` — every per-segment number degenerates exactly to the
historical flat per-device accounting (tests/test_fabric.py pins this
bit-for-bit).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Union

from repro_torch.core.fabric import FabricTopology
from repro_torch.core.transfer import (FABRICS, QOS_DEMAND, QOS_SPECULATIVE,
                                 FabricModel, PipelineModel)


@dataclasses.dataclass
class TrafficStats:
    """Cumulative fabric-traffic counters (one schema for all layers).

    ``fabric_time_s`` is the *issued* total: every second the fabric
    links were busy.  ``exposed_fabric_s`` is the part that was NOT
    hidden behind compute by the fetch pipeline and therefore landed on
    the step critical path (serving/prefetch.py; without an overlap model
    the two are equal).  Invariant: ``issued >= exposed >= 0``.
    """

    n_devices: int = 1
    n_segments: int = 0              # fabric link segments (== n_devices
                                     # under the default flat star)
    bytes_fetched: float = 0.0       # entries/pages pulled over the fabric
    bytes_written: float = 0.0       # prefill / decode write-back traffic
    entries_fetched: float = 0.0     # discrete entries pulled over the fabric
    buffer_hits: float = 0.0         # HiSparse hot-tier hits (no fabric)
    buffer_misses: float = 0.0       # hot-tier misses (crossed the fabric)
    fabric_time_s: float = 0.0       # seconds issued on the fabric
    exposed_fabric_s: float = 0.0    # issued seconds not hidden by compute
    prefetched_entries: float = 0.0  # speculative/warm-up entries inserted
    prefetch_useful: float = 0.0     # prefetched entries later demand-hit
    prefetch_bytes: float = 0.0      # fabric bytes spent on prefetch
    spec_yielded_s: float = 0.0      # speculative segment-seconds dropped
                                    # at congested segments by the QoS
                                    # yield rule (topologies built with
                                    # qos_spec_yield; core/fabric.py)
    critical_demand_bytes: float = 0.0   # sum over steps of the MAX per-
                                    # SEGMENT demand bytes — the step
                                    # fetch critical path.  Unlike end-to-
                                    # end exposed seconds this is
                                    # independent of the hide-window
                                    # volume (how many steps the run
                                    # took), so it is the fair link-
                                    # hotspot envelope metric
                                    # (benchmarks/locality_gate.py).
                                    # Flat star: segments == devices, so
                                    # this is the pre-PR 7 per-device max
    critical_issued_s: float = 0.0  # engine twin: sum over steps of the
                                    # max per-SEGMENT issued seconds (the
                                    # overlap queues' critical link)
    device_demand_bytes: List[float] = dataclasses.field(
        default_factory=list)       # cumulative fetch demand per device
    device_issued_s: List[float] = dataclasses.field(
        default_factory=list)       # cumulative issued transfer seconds
                                    # per device (end-to-end bottleneck
                                    # time of that device's transfers)
    device_prefetch_s: List[float] = dataclasses.field(
        default_factory=list)       # issued seconds spent on prefetch, per
                                    # device (subset of device_issued_s) —
                                    # the arbiter's per-link pressure split
    segment_demand_bytes: List[float] = dataclasses.field(
        default_factory=list)       # cumulative fetch bytes crossing each
                                    # fabric segment (a byte is counted on
                                    # EVERY segment of its path)
    segment_issued_s: List[float] = dataclasses.field(
        default_factory=list)       # cumulative occupancy seconds per
                                    # segment (seconds/bandwidth_scale +
                                    # latency per transfer)
    segment_exposed_s: List[float] = dataclasses.field(
        default_factory=list)       # per-segment unhidden tails (subset
                                    # of segment_issued_s)
    segment_prefetch_s: List[float] = dataclasses.field(
        default_factory=list)       # speculative share of segment_issued_s
    device_anomalies: int = 0       # out-of-range device ids seen at the
                                    # accounting boundary (clamped once and
                                    # counted instead of silently aliased)
    request_pf: Dict[Hashable, List[float]] = dataclasses.field(
        default_factory=dict)       # per-request [inserted, useful]
                                    # prefetch attribution — the arbiter's
                                    # precision-weighting signal
    request_demand_s: Dict[Hashable, float] = dataclasses.field(
        default_factory=dict)       # per-request issued DEMAND seconds
                                    # (misses + writes, never prefetch) —
                                    # lets the pressure feed subtract a
                                    # finishing request's own share from
                                    # its link immediately instead of
                                    # waiting for the EMA to decay it

    def __post_init__(self):
        if self.n_segments <= 0:
            self.n_segments = self.n_devices
        if not self.device_demand_bytes:
            self.device_demand_bytes = [0.0] * self.n_devices
        if not self.device_issued_s:
            self.device_issued_s = [0.0] * self.n_devices
        if not self.device_prefetch_s:
            self.device_prefetch_s = [0.0] * self.n_devices
        if not self.segment_demand_bytes:
            self.segment_demand_bytes = [0.0] * self.n_segments
        if not self.segment_issued_s:
            self.segment_issued_s = [0.0] * self.n_segments
        if not self.segment_exposed_s:
            self.segment_exposed_s = [0.0] * self.n_segments
        if not self.segment_prefetch_s:
            self.segment_prefetch_s = [0.0] * self.n_segments

    def device_demand_s(self) -> List[float]:
        """Per-device issued seconds attributable to *demand* traffic
        (total issued minus the speculative share) — the link-pressure
        signal flat-topology consumers read."""
        return [t - p for t, p in zip(self.device_issued_s,
                                      self.device_prefetch_s)]

    def segment_demand_s(self) -> List[float]:
        """Per-SEGMENT issued seconds attributable to demand traffic —
        the pressure signal topology-aware consumers (DemandTracker,
        Placer) read; under the flat star it equals
        :meth:`device_demand_s` element-for-element."""
        return [t - p for t, p in zip(self.segment_issued_s,
                                      self.segment_prefetch_s)]

    @property
    def hit_rate(self) -> float:
        tot = self.buffer_hits + self.buffer_misses
        return self.buffer_hits / tot if tot else 0.0

    @property
    def total_bytes(self) -> float:
        return self.bytes_fetched + self.bytes_written

    @property
    def issued_fabric_s(self) -> float:
        return self.fabric_time_s

    @property
    def prefetch_wasted(self) -> float:
        """Prefetched entries never demand-hit (evicted unused, or still
        resident unused).  ``prefetched == useful + wasted`` always."""
        return self.prefetched_entries - self.prefetch_useful

    @property
    def prefetch_precision(self) -> float:
        return (self.prefetch_useful / self.prefetched_entries
                if self.prefetched_entries else 0.0)

    def request_precision(self, key: Hashable, prior: float = 1.0,
                          pseudo: float = 8.0) -> float:
        """One request's measured prefetch precision (useful / inserted),
        Laplace-smoothed toward an optimistic ``prior`` with ``pseudo``
        virtual entries.  The smoothing matters: a fresh request's first
        inserts have not had a chance to be demand-hit yet, and a raw
        0/N estimate would starve it before the signal exists (a
        feedback loop — starved requests never accumulate the inserts
        that would redeem them).  Heavily-wasteful speculators still
        converge to ~0."""
        ins, use = self.request_pf.get(key, (0.0, 0.0))
        return (use + pseudo * prior) / (ins + pseudo)

    def drop_request(self, key: Hashable) -> None:
        """Forget a finished request's prefetch and demand attribution
        (the key — an engine slot or a request id — is about to be
        reused)."""
        self.request_pf.pop(key, None)
        self.request_demand_s.pop(key, None)


class OverlapQueue:
    """Per-segment double-buffered fetch queues (issued vs exposed split).

    Fetch seconds are *issued* along a device's fabric path as the step
    discovers its misses (and prefetch candidates); at step end ``drain``
    hides as much as the :class:`~repro_torch.core.transfer.PipelineModel`
    window allows and returns the step's *exposed* stall — the slowest
    segment's unhidden tail, since the step cannot advance past its
    critical-path link.

    QoS: each segment keeps separate demand and speculative backlogs.
    On a topology with ``qos_spec_yield``, demand drains first; the
    speculative backlog is serviced only from the segment's leftover hide
    window, and the remainder is *yielded* (dropped from this step's
    exposure — speculated entries are stale by the next step — and
    accumulated in ``spec_yielded_s``).  Without the yield flag (and
    under the default flat star) both classes share the window exactly as
    one queue did pre-PR 7.
    """

    def __init__(self, topology: Union[int, FabricTopology],
                 pipeline: PipelineModel):
        if not isinstance(topology, FabricTopology):
            topology = FabricTopology.flat_star(max(int(topology), 1))
        self.topology = topology
        self.pipeline = pipeline
        n = topology.n_segments
        self._pending_dem = [0.0] * n
        self._pending_spec = [0.0] * n
        self.spec_yielded_s = 0.0            # cumulative yielded seconds
        self.last_yielded_s = 0.0            # yielded by the last drain
        self.last_exposed = [0.0] * n        # per-segment exposed tails
                                             # of the last drain

    def issue(self, device: int, seconds: float,
              qos: int = QOS_DEMAND) -> None:
        # an aliased id would charge the WRONG link's hide window;
        # callers (FabricAccountant) validate at the accounting boundary,
        # so an IndexError from route() here is a programming error
        charges = self.topology.segment_charge(device, seconds)
        if seconds <= 0:
            return
        pend = (self._pending_spec if qos == QOS_SPECULATIVE
                else self._pending_dem)
        for sid, c in charges:
            pend[sid] += c

    @property
    def pending_s(self) -> float:
        return sum(self._pending_dem) + sum(self._pending_spec)

    @property
    def peak_pending_s(self) -> float:
        """This step's critical-path segment: the max per-segment queue."""
        return max((d + s for d, s in zip(self._pending_dem,
                                          self._pending_spec)),
                   default=0.0)

    def drain(self, compute_s: float) -> float:
        """End-of-step: return exposed seconds, clear the queues."""
        window = self.pipeline.hide_window_s(compute_s)
        yielded = 0.0
        exposed = [0.0] * len(self._pending_dem)
        for sid, (dem, spec) in enumerate(zip(self._pending_dem,
                                              self._pending_spec)):
            if self.topology.qos_spec_yield:
                # demand owns the segment; speculation gets the leftover
                # window or is dropped (never exposed, never deferred)
                exposed[sid] = self.pipeline.exposed_time(dem, compute_s)
                leftover = max(0.0, window - dem)
                yielded += max(0.0, spec - min(spec, leftover))
            else:
                exposed[sid] = self.pipeline.exposed_time(dem + spec,
                                                          compute_s)
        self.last_exposed = exposed
        self.last_yielded_s = yielded
        self.spec_yielded_s += yielded
        self._pending_dem = [0.0] * len(self._pending_dem)
        self._pending_spec = [0.0] * len(self._pending_spec)
        return max(exposed, default=0.0)


class FabricAccountant:
    """Charges fabric operations against a :class:`FabricModel` and keeps
    one :class:`TrafficStats` for every consumer.

    Two usage styles:

      - **timed ops** (real engine): ``sparse_fetch`` / ``bulk_fetch`` /
        ``write_back`` return seconds from the calibrated fabric model and
        accumulate bytes + time;
      - **per-step demand** (simulator): ``add_step_demand`` accumulates a
        decode step's per-device byte demand; ``drain_step`` returns the
        per-SEGMENT backlog (the slowest segment is the step's fetch
        critical path) and folds it into the cumulative stats;
        ``charge_seconds`` books the time the caller computed from that
        demand.

    Routing: every op names its endpoint ``device``; the accountant routes
    it through ``self.topology`` and books per-segment occupancy
    (``Segment.charge``) on each path segment.  The *returned* transfer
    time is the path bottleneck's occupancy — identical to the raw model
    time under the default flat star.

    Overlap: without ``enable_overlap``, every charged second is also
    exposed (``charge_exposed`` is called by the timed ops).  With an
    :class:`OverlapQueue` enabled, timed ops *issue* into the per-segment
    queues instead and the caller drains once per step with its compute
    window (``drain_overlap``) — only the unhidden tail lands in
    ``exposed_fabric_s``.
    """

    def __init__(self, fabric: Optional[FabricModel] = None, *,
                 backend: Optional[str] = None, n_devices: int = 1,
                 topology: Union[str, FabricTopology, None] = None):
        if fabric is None and backend is not None:
            fabric = FABRICS[backend]
        self.fabric = fabric
        if isinstance(topology, FabricTopology):
            n_devices = topology.n_devices
        else:
            topology = FabricTopology.from_spec(topology, n_devices)
        self.topology: FabricTopology = topology
        self.stats = TrafficStats(n_devices=n_devices,
                                  n_segments=topology.n_segments)
        self._seg_step_dem = [0.0] * topology.n_segments
        self._seg_step_spec = [0.0] * topology.n_segments
        self._dev_step = [0.0] * n_devices
        self.step_spec_bytes: List[float] = [0.0] * topology.n_segments
        self.overlap: Optional[OverlapQueue] = None

    # -- overlap (fetch pipeline) ------------------------------------------
    def enable_overlap(self, pipeline: PipelineModel) -> OverlapQueue:
        self.overlap = OverlapQueue(self.topology, pipeline)
        return self.overlap

    def charge_exposed(self, seconds: float) -> None:
        self.stats.exposed_fabric_s += max(seconds, 0.0)  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def drain_overlap(self, compute_s: float) -> float:
        """Drain the per-segment queues against this step's compute window
        and book the exposed tail.  No-op (0.0) when overlap is off —
        timed ops then charge exposed at issue time."""
        if self.overlap is None:
            return 0.0
        self.stats.critical_issued_s += self.overlap.peak_pending_s  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        exposed = self.overlap.drain(compute_s)
        for sid, e in enumerate(self.overlap.last_exposed):
            self.stats.segment_exposed_s[sid] += e  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.spec_yielded_s += self.overlap.last_yielded_s  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.charge_exposed(exposed)
        return exposed

    def _book_time(self, seconds: float, device: int,
                   qos: int = QOS_DEMAND) -> None:
        """Issued seconds (raw device-link time — the queue re-routes):
        queue behind compute if overlap is on, else expose immediately
        (the serial seed semantics)."""
        if self.overlap is not None:
            self.overlap.issue(device, seconds, qos)
        else:
            self.charge_exposed(self.topology.transfer_seconds(device,
                                                               seconds))
            for sid, c in self.topology.segment_charge(device, seconds):
                self.stats.segment_exposed_s[sid] += c  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def _charge_path(self, device: int, seconds: float,
                     qos: int = QOS_DEMAND) -> float:
        """Book per-segment issued occupancy for one transfer and return
        the end-to-end (bottleneck-segment) transfer time."""
        if seconds <= 0:
            return 0.0
        worst = 0.0
        for sid, c in self.topology.segment_charge(device, seconds):
            self.stats.segment_issued_s[sid] += c  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
            if qos == QOS_SPECULATIVE:
                self.stats.segment_prefetch_s[sid] += c  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
            worst = max(worst, c)
        return worst

    @property
    def n_devices(self) -> int:
        return self.stats.n_devices

    @property
    def n_segments(self) -> int:
        return self.stats.n_segments

    def _resolve_device(self, device: int) -> int:
        """Validate a device id at the accounting boundary.

        A silently aliased id (the pre-PR 4 ``dev % n`` convention) would
        charge the WRONG link's budget and feed the arbiter/placer a
        corrupted pressure signal.  Out-of-range ids are clamped ONCE
        here — every downstream counter then indexes directly — and the
        anomaly is counted in ``TrafficStats.device_anomalies`` so tests
        and dashboards can see it happened.
        """
        if 0 <= device < self.n_devices:
            return device
        self.stats.device_anomalies += 1  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        return min(max(device, 0), self.n_devices - 1)

    def _attribute_demand(self, key: Optional[Hashable], t: float) -> None:
        """Book issued DEMAND seconds against one request (never called
        on the prefetch path — speculation is not the request's demand
        share and must not be subtracted from its link at departure)."""
        if key is not None and t > 0:
            # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
            self.stats.request_demand_s[key] = \
                self.stats.request_demand_s.get(key, 0.0) + t

    # -- timed ops (engine / SACSystem) ------------------------------------
    def sparse_fetch(self, n_entries: int, entry_bytes: int, *,
                     device: int = 0, contention: float = 1.0,
                     key: Optional[Hashable] = None,
                     qos: int = QOS_DEMAND) -> float:
        """Fine-grained fetch of ``n_entries`` discrete entries.

        ``key`` attributes the issued seconds to one request
        (``TrafficStats.request_demand_s``) — the per-request demand
        share the pressure feed subtracts when that request departs.
        """
        if n_entries <= 0:
            return 0.0
        assert self.fabric is not None, "timed ops need a fabric model"
        device = self._resolve_device(device)
        t = self.fabric.sparse_fetch_time(n_entries, entry_bytes,
                                          contention=contention)
        n_bytes = n_entries * entry_bytes
        self.stats.bytes_fetched += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.entries_fetched += n_entries  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.device_demand_bytes[device] += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        for sid in self.topology.route(device):
            self.stats.segment_demand_bytes[sid] += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        tt = self._charge_path(device, t, qos)
        self.stats.fabric_time_s += tt  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.device_issued_s[device] += tt  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        if qos != QOS_SPECULATIVE:
            self._attribute_demand(key, tt)
        self._book_time(t, device, qos)
        return tt

    def prefetch_fetch(self, n_entries: int, entry_bytes: int, *,
                       device: int = 0, contention: float = 1.0) -> float:
        """Speculative/warm-up fetch of ``n_entries`` entries: same fabric
        cost and accounting as a demand fetch, additionally attributed to
        prefetch traffic (and issued as ``QOS_SPECULATIVE``, so it yields
        at congested segments on QoS topologies)."""
        device = self._resolve_device(device)
        t = self.sparse_fetch(n_entries, entry_bytes, device=device,
                              contention=contention, qos=QOS_SPECULATIVE)
        if n_entries > 0:
            self.stats.prefetch_bytes += n_entries * entry_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
            self.stats.device_prefetch_s[device] += t  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        return t

    def bulk_fetch(self, n_bytes: float, *, device: int = 0,
                   contention: float = 1.0,
                   key: Optional[Hashable] = None) -> float:
        """Streaming fetch of a contiguous region (full-prefetch path)."""
        if n_bytes <= 0:
            return 0.0
        assert self.fabric is not None, "timed ops need a fabric model"
        device = self._resolve_device(device)
        t = self.fabric.bulk_transfer_time(n_bytes, contention=contention)
        self.stats.bytes_fetched += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.device_demand_bytes[device] += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        for sid in self.topology.route(device):
            self.stats.segment_demand_bytes[sid] += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        tt = self._charge_path(device, t)
        self.stats.fabric_time_s += tt  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.device_issued_s[device] += tt  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self._attribute_demand(key, tt)
        self._book_time(t, device)
        return tt

    def write_back(self, n_bytes: float, *, device: int = 0,
                   contention: float = 1.0,
                   key: Optional[Hashable] = None) -> float:
        """Pool write (prefill bulk write / decode write-back).

        ``device`` matters for the arbiter's per-link demand signal: a
        prefill write lands on the request's pool device, not device 0.
        """
        if n_bytes <= 0:
            return 0.0
        assert self.fabric is not None, "timed ops need a fabric model"
        device = self._resolve_device(device)
        t = self.fabric.bulk_transfer_time(n_bytes, contention=contention)
        self.stats.bytes_written += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        tt = self._charge_path(device, t)
        self.stats.fabric_time_s += tt  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.device_issued_s[device] += tt  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self._attribute_demand(key, tt)
        self._book_time(t, device)
        return tt

    # -- hot-buffer accounting --------------------------------------------
    def record_hits(self, hits: float, misses: float) -> None:
        """Record HiSparse hot-tier outcomes (measured or analytic)."""
        self.stats.buffer_hits += hits  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.buffer_misses += misses  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def record_prefetch(self, inserted: float, useful: float, *,
                        key: Optional[Hashable] = None) -> None:
        """Record prefetch outcomes (measured in-graph by the HiSparse
        ``pf_*`` counters, or analytic in the simulator).  ``key``
        additionally attributes the outcome to one request (engine slot
        or request id) — the per-request precision the arbiter's
        precision-weighted grants consume."""
        self.stats.prefetched_entries += inserted  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.prefetch_useful += useful  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        if key is not None:
            pf = self.stats.request_pf.setdefault(key, [0.0, 0.0])
            pf[0] += inserted
            pf[1] += useful

    def record_prefetch_bytes(self, n_bytes: float) -> None:
        """Attribute already-issued fabric bytes to prefetch traffic.

        The simulator's analytic speculation issues its demand through
        ``add_step_demand(..., qos=QOS_SPECULATIVE)`` (bytes + timing are
        booked there); this records the prefetch-bytes attribution the
        precision metrics read.  The engine path gets the same
        attribution inside :meth:`prefetch_fetch`."""
        self.stats.prefetch_bytes += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def record_spec_yield(self, seconds: float) -> None:
        """Book speculative seconds dropped by the QoS yield rule.

        The engine's :class:`OverlapQueue` drains book this through
        :meth:`drain_overlap`; the simulator's analytic drain computes
        the yielded share itself and records it here."""
        self.stats.spec_yielded_s += seconds  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def record_write_bytes(self, n_bytes: float) -> None:
        """Book pool-write bytes whose TIMING the caller models itself
        (the simulator's trunk-serialized prefill writes and chunked
        prefill tails charge seconds via :meth:`charge_seconds` after
        computing the drain analytically).  The engine's timed path is
        :meth:`write_back`, which books bytes AND time."""
        self.stats.bytes_written += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def record_copy_bytes(self, n_bytes: float) -> None:
        """Book a replica copy: ``n_bytes`` read from the owning device
        and written to the target (hot-prefix replication, PR 6).  The
        caller charges the transfer seconds on both links."""
        self.stats.bytes_fetched += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.bytes_written += n_bytes  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    # -- per-step demand (simulator) ---------------------------------------
    def add_step_demand(self, device: int, n_bytes: float,
                        qos: int = QOS_DEMAND) -> None:
        """Accumulate one request's step byte demand on every segment of
        its device's path (plus the per-device view)."""
        device = self._resolve_device(device)
        self._dev_step[device] += n_bytes
        seg = (self._seg_step_spec if qos == QOS_SPECULATIVE
               else self._seg_step_dem)
        for sid in self.topology.route(device):
            seg[sid] += n_bytes

    def drain_step(self) -> List[float]:
        """Fold the current step's demand into the stats and return the
        per-SEGMENT byte backlog (demand + speculative; the speculative
        split is left in ``step_spec_bytes`` for QoS-aware timing)."""
        total = [d + s for d, s in zip(self._seg_step_dem,
                                       self._seg_step_spec)]
        self.step_spec_bytes = list(self._seg_step_spec)
        for d, n in enumerate(self._dev_step):
            self.stats.device_demand_bytes[d] += n  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self.stats.bytes_fetched += sum(self._dev_step)  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        for sid, n in enumerate(total):
            self.stats.segment_demand_bytes[sid] += n  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        if total:
            self.stats.critical_demand_bytes += max(total)  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        self._seg_step_dem = [0.0] * self.n_segments
        self._seg_step_spec = [0.0] * self.n_segments
        self._dev_step = [0.0] * self.n_devices
        return total

    def charge_seconds(self, seconds: float) -> None:
        self.stats.fabric_time_s += seconds  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py

    def charge_segment_seconds(self, seg_seconds: List[float],
                               spec_seconds: Optional[List[float]] = None
                               ) -> None:
        """Simulator twin of the per-segment issued booking: fold one
        step's analytic per-segment drain times (and optionally the
        speculative share) into the cumulative per-segment stats."""
        for sid, t in enumerate(seg_seconds):
            self.stats.segment_issued_s[sid] += t  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        if spec_seconds is not None:
            for sid, t in enumerate(spec_seconds):
                self.stats.segment_prefetch_s[sid] += t  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
        if seg_seconds:
            self.stats.critical_issued_s += max(seg_seconds)  # sacheck: disable=accounting-boundary -- port copy of the accounting home, repro/core/traffic.py
