"""Fabric budget arbiter: the control loop between the fetch pipeline's
mechanisms (serving/prefetch.py) and a multi-tenant serving story.

PR 2 let every request speculate at the full ``prefetch_width`` no matter
how loaded its pool link was — exactly the regime where speculative
fetching degrades: once a device's issued seconds outgrow the pipeline's
hide window, every extra prefetched entry lands on the step critical
path.  Two host-side policies close that loop:

  - :class:`BudgetArbiter` — each step, read per-device link pressure
    (the per-step deltas of ``TrafficStats.device_demand_s()``: issued
    seconds minus the speculative share) and grant every request a
    speculative entry budget: requests on saturated links shrink toward
    ``min_width``, requests on idle links keep full ``max_width``.
    Grants obey, per device: ``sum(width * n_layers) * per_entry_s <=
    link_budget_frac * hide_window - demand_s`` (when that headroom is
    positive; property-tested in tests/test_arbiter.py).
  - :class:`LayerSizer` — apportion the hot tier's total slot budget
    (``device_buffer_size * n_layers``) across layers by miss pressure
    instead of uniformly: windowed layers can never select more than
    ``window`` distinct positions, so their slots are capped and the
    surplus goes to the full-attention layers that actually churn.

Both consume the engine and the simulator identically — the simulator
evaluates ``grant`` analytically on its modeled per-device demand, so
engine↔simulator stay comparable (tests/test_parity_suite.py).  Neither
ever changes decoded tokens: arbitration caps *speculation* (warm
inserts) and *buffer slots* (residency), never demand reads — the pool
stays authoritative.

PR 4 closes the remaining loops: grants split a device's budget by
per-request measured prefetch precision (``precision_weighted``,
``TrafficStats.request_pf``) with the floor-division remainder
distributed largest-share-first instead of discarded; prefill warm-up
bursts draw from the same link budget (``grant_warmup``); and the
LayerSizer re-apportions ONLINE from measured miss rates
(``max_slots`` hard-caps at the static allocation width,
``hisparse.resize_layers`` realizes the new layout in place).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List, Mapping, Optional, \
    Sequence

from repro_torch.core.fabric import FabricTopology
from repro_torch.core.traffic import TrafficStats
from repro_torch.core.transfer import FabricModel, PipelineModel


class DemandTracker:
    """Per-step demand deltas, per LINK and per REQUEST, with departure
    subtraction — the conditioning stage of the arbiter's (and the
    pressure-aware placer's) feedback signal.

    The raw counters (``TrafficStats.device_demand_s`` and the PR 5
    ``request_demand_s``) are cumulative; the control loops want *this
    step's* demand.  Before PR 5 the engine kept only the per-device
    deltas, so when a request finished, its share lingered in the link's
    signal until the policy EMA decayed it — several steps of placement
    and grants against load that had already left.  The tracker keeps
    the per-request split too, so ``depart`` can subtract a finishing
    request's own last-step share from its link immediately.

    Two feeding modes, one ``depart``:

      - :meth:`observe` (engine): snapshot cumulative stats each step;
      - :meth:`set_step` (simulator): the analytic per-step seconds are
        computed directly, no cumulative counters needed.

    Downstream, ``last_demand_s`` is not read raw by the placers: both
    layers wrap the tracker in the shared
    :class:`repro_torch.serving.policy.PressureFeed` (PR 10), which overlays
    the warm-up pressure seed while its window is open and hands the
    result to ``Placer.set_pressure_fn`` and the arbiter alike.

    With a :class:`~repro_torch.core.fabric.FabricTopology` attached (PR 7) the
    tracked slot space is the fabric's SEGMENTS, not devices: ``observe``
    reads ``TrafficStats.segment_demand_s()``, ``note_transfer`` books a
    device's transfer on every segment of its path, and ``depart``
    subtracts the request's share along its device's route (clamped at
    zero — exact under the flat star, a safe under-estimate when shared
    trunk segments carry other requests' traffic too).  The flat-star
    topology degenerates to the per-device behavior bit-for-bit.
    """

    def __init__(self, n_devices: int,
                 topology: Optional[FabricTopology] = None):
        self.n_devices = max(int(n_devices), 1)
        self.topology = topology
        self.n_slots = (topology.n_segments if topology is not None
                        else self.n_devices)
        self.last_demand_s: List[float] = [0.0] * self.n_slots
        self._dev_mark: List[float] = [0.0] * self.n_slots
        self._req_mark: Dict[Hashable, float] = {}
        self._req_last: Dict[Hashable, float] = {}
        self._pending: List[float] = [0.0] * self.n_slots

    def _route(self, device: int) -> Sequence[int]:
        """Slots a device's traffic lands on: its fabric path, or just
        its own slot when no topology is attached."""
        if self.topology is None:
            return (device,) if 0 <= device < self.n_slots else ()
        if not 0 <= device < self.topology.n_devices:
            return ()
        return self.topology.route(device)

    def note_transfer(self, device: int, seconds: float) -> None:
        """Attribute UNkeyed cache-owned traffic (a hot-prefix replica
        copy, PR 6) to a link's next step signal.  SIMULATOR-ONLY
        companion to ``set_step``: the engine's ``observe`` path reads
        cumulative counters that already include replica copies, so
        calling this there would double-count.  The seconds fold into
        the next ``set_step`` and, being unkeyed, no departure ever
        subtracts them."""
        if seconds <= 0:
            return
        if self.topology is not None:
            for sid, c in self.topology.segment_charge(device,
                                                       float(seconds)):
                self._pending[sid] += c
        elif 0 <= device < self.n_slots:
            self._pending[device] += float(seconds)

    def observe(self, stats: TrafficStats, keys: Iterable[Hashable]
                ) -> List[float]:
        """Engine mode: fold this step's cumulative counters into fresh
        per-link and per-request deltas.  ``keys`` are the requests
        live this step (their attribution is snapshotted; others keep
        their last known share for a late ``depart``)."""
        cur = (stats.segment_demand_s() if self.topology is not None
               else stats.device_demand_s())
        cur = (list(cur) + [0.0] * self.n_slots)[:self.n_slots]
        self.last_demand_s = [c - m for c, m in zip(cur, self._dev_mark)]
        self._dev_mark = cur
        for k in keys:
            cum = stats.request_demand_s.get(k, 0.0)
            self._req_last[k] = cum - self._req_mark.get(k, 0.0)
            self._req_mark[k] = cum
        return list(self.last_demand_s)

    def set_step(self, demand_s: Sequence[float],
                 request_shares: Optional[Mapping[Hashable, float]] = None
                 ) -> List[float]:
        """Simulator mode: this step's per-link demand seconds (per
        SEGMENT when a topology is attached, per device otherwise; and
        optionally each request's own share of them) were computed
        analytically — install them directly."""
        d = [max(float(x), 0.0) for x in demand_s]
        d = (d + [0.0] * self.n_slots)[:self.n_slots]
        if any(self._pending):
            d = [x + p for x, p in zip(d, self._pending)]
            self._pending = [0.0] * self.n_slots
        self.last_demand_s = d
        if request_shares is not None:
            for k, s in request_shares.items():
                self._req_last[k] = float(s)
        return list(self.last_demand_s)

    def depart(self, key: Hashable, device: int) -> float:
        """A request finished: drop its attribution and subtract its own
        last-step demand share from its link's (every segment on its
        route's) live signal.  Returns the share subtracted (0 for
        unknown keys/devices)."""
        share = self._req_last.pop(key, 0.0)
        self._req_mark.pop(key, None)
        if share <= 0:
            return 0.0
        slots = self._route(device)
        if not slots:
            return 0.0
        for s in slots:
            self.last_demand_s[s] = max(0.0, self.last_demand_s[s] - share)
        return share


@dataclasses.dataclass(frozen=True)
class ArbiterConfig:
    """Budget-arbitration knobs (mirrored by ``SACConfig``)."""

    max_width: int                   # = cfg.sac.prefetch_width
    min_width: int = 0               # floor granted even when saturated
    link_budget_frac: float = 1.0    # fraction of the pipeline hide window
                                     # speculation may fill per device
    precision_weighted: bool = False  # split each device's entry budget
                                      # across requests in proportion to
                                      # their measured prefetch precision
                                      # instead of uniformly


def _hand_out_units(budget: int, order: Sequence[int], out: List[int],
                    cap: Sequence[int]) -> int:
    """Hand out integer units one at a time in fixed ``order``, cycling,
    until the budget or every per-index ``cap`` is exhausted.  Mutates
    ``out``; returns the undistributable remainder.  Shared by the grant
    remainder distribution (:func:`_apportion`) and the LayerSizer's
    past-caps surplus spread — one algorithm, one set of edge cases."""
    while budget > 0:
        progressed = False
        for i in order:
            if budget <= 0:
                break
            if out[i] < cap[i]:
                out[i] += 1
                budget -= 1
                progressed = True
        if not progressed:
            break
    return budget


def _apportion(total_w: int, cap: int, weights: Sequence[float]
               ) -> List[int]:
    """Split ``total_w`` integer width units across requests.

    Each request's ideal share is proportional to its weight; shares are
    floored, then the remainder is handed out one unit at a time —
    largest fractional share first (ties to the larger weight, then the
    lower index), cycling until the budget or the per-request ``cap`` is
    exhausted.  Guarantees ``sum(out) <= total_w`` and every entry
    ``<= cap`` — the floor-division remainder the PR 3 grant silently
    discarded is spent instead of dropped.
    """
    n = len(weights)
    tw = sum(weights)
    if tw <= 0:
        weights = [1.0] * n
        tw = float(n)
    ideal = [total_w * w / tw for w in weights]
    out = [min(int(s), cap) for s in ideal]
    left = min(total_w, n * cap) - sum(out)
    order = sorted(range(n),
                   key=lambda i: (-(ideal[i] - int(ideal[i])),
                                  -weights[i], i))
    _hand_out_units(left, order, out, [cap] * n)
    return out


class BudgetArbiter:
    """Cross-request speculative-prefetch budget arbitration.

    One instance per serving engine (or simulated cluster).  ``grant``
    is a pure function of the step's compute window and the previous
    step's measured per-device demand seconds — a feedback control loop:
    pressure observed at step t shapes speculation issued at step t+1.
    """

    def __init__(self, cfg: ArbiterConfig, *, entry_s: float,
                 n_layers: int, pipeline: PipelineModel,
                 topology: Optional[FabricTopology] = None):
        assert entry_s > 0, "per-entry fabric seconds must be positive"
        self.cfg = cfg
        self.entry_s = float(entry_s)
        self.n_layers = max(int(n_layers), 1)
        self.pipeline = pipeline
        # with a fabric topology, grants are per-PATH: a device's budget
        # is the headroom of the most-loaded segment on its route, and
        # spec seconds granted at one device are charged against every
        # segment of its path before the next device is considered — two
        # devices behind one saturated trunk can no longer each claim the
        # trunk's full residue (None = flat per-device budgets, the
        # pre-PR 7 behavior, which the flat star matches exactly)
        self.topology = topology

    @classmethod
    def from_fabric(cls, cfg: ArbiterConfig, fabric: FabricModel,
                    entry_bytes: int, *, n_layers: int,
                    pipeline: PipelineModel,
                    topology: Optional[FabricTopology] = None
                    ) -> "BudgetArbiter":
        """Engine-side constructor: amortized per-entry cost from the
        calibrated fabric model, over a nominal full-width burst."""
        nominal = max(cfg.max_width * max(n_layers, 1), 1)
        entry_s = fabric.per_entry_seconds(entry_bytes,
                                           nominal_batch=nominal)
        return cls(cfg, entry_s=entry_s, n_layers=n_layers,
                   pipeline=pipeline, topology=topology)

    # -- budget arithmetic -------------------------------------------------
    def link_budget_s(self, compute_s: float) -> float:
        """Per-device link seconds speculation may fill this step."""
        return (max(self.cfg.link_budget_frac, 0.0)
                * self.pipeline.hide_window_s(compute_s))

    def device_entry_budget(self, compute_s: float, demand_s: float
                            ) -> float:
        """Speculative entries that fit a device's remaining headroom
        after the measured demand backlog is accounted for."""
        headroom = self.link_budget_s(compute_s) - max(demand_s, 0.0)
        return max(headroom, 0.0) / self.entry_s

    def _device_demand(self, demand_s: Sequence[float], dev: int,
                       extra: Optional[Mapping[int, float]] = None
                       ) -> float:
        """Validated per-device demand lookup.  The pre-PR 4 ``dev %
        len(demand_s)`` convention silently aliased an out-of-range id
        onto the WRONG link's budget; the arbiter is control logic, so a
        bad id is a programming error and raises.

        With a topology attached, ``demand_s`` is per-SEGMENT and the
        returned figure is the BOTTLENECK on the device's path — the
        most-loaded segment between host and device (plus any
        ``extra`` spec seconds already granted there this step).
        Occupancy seconds are directly comparable across segments
        (``Segment.charge`` already folds in bandwidth_scale), so path
        headroom = window - max-over-path.
        """
        if not len(demand_s):
            return 0.0
        if self.topology is not None:
            if not 0 <= dev < self.topology.n_devices:
                raise ValueError(
                    f"device {dev} out of range "
                    f"[0, {self.topology.n_devices}) — placement and "
                    "the fabric topology disagree on the device space")
            vals = (list(demand_s)
                    + [0.0] * self.topology.n_segments)
            return max(vals[s] + (extra.get(s, 0.0) if extra else 0.0)
                       for s in self.topology.route(dev))
        if not 0 <= dev < len(demand_s):
            raise ValueError(
                f"device {dev} out of range [0, {len(demand_s)}) — "
                "placement and traffic accounting disagree on the "
                "device space")
        return demand_s[dev] + (extra.get(dev, 0.0) if extra else 0.0)

    def grant(self, compute_s: float, demand_s: Sequence[float],
              device_requests: Mapping[int, Sequence[Hashable]],
              precision: Optional[Mapping[Hashable, float]] = None
              ) -> Dict[Hashable, int]:
        """Allocate per-request speculative widths for one step.

        compute_s: the step's modeled compute window; demand_s: per-device
        demand seconds observed last step (``TrafficStats.device_demand_s``
        deltas, or the simulator's analytic miss seconds);
        device_requests: device -> request keys decoding on that device;
        precision: request -> measured prefetch precision (the
        ``TrafficStats.request_precision`` attribution) — consumed only
        when ``cfg.precision_weighted`` is on, in which case a device's
        entry budget is split in proportion to each request's precision
        (precise speculators keep width, imprecise ones shrink) instead
        of uniformly.

        Returns request -> granted width (entries per layer per step),
        clamped to ``[min(min_width, max_width), max_width]``; with
        ``min_width == 0`` the per-device sum respects the link budget:
        ``sum(w_r) * n_layers * entry_s <= max(headroom, 0)``.  The
        device's whole width budget is spent (largest-share-first
        remainder distribution) rather than floor-divided away.
        """
        grants: Dict[Hashable, int] = {}
        floor = max(min(self.cfg.min_width, self.cfg.max_width), 0)
        weighted = self.cfg.precision_weighted and precision is not None
        # spec seconds already granted per segment this step (per-path
        # budgets only; empty interaction under flat star — each device
        # owns its single segment and appears once)
        granted_seg: Dict[int, float] = {}
        for dev, rids in device_requests.items():
            if not rids:
                continue
            d = self._device_demand(demand_s, dev, granted_seg)
            entries = self.device_entry_budget(compute_s, d)
            total_w = int(entries // self.n_layers)
            if weighted:
                # epsilon keeps a zero-precision request eligible for
                # remainder units instead of degenerate 0-weight shares
                weights = [max(float(precision.get(r, 1.0)), 0.0) + 1e-3
                           for r in rids]
            else:
                weights = [1.0] * len(rids)
            widths = _apportion(total_w, self.cfg.max_width, weights)
            spec_s = 0.0
            for rid, w in zip(rids, widths):
                grants[rid] = max(w, floor)
                spec_s += grants[rid] * self.n_layers * self.entry_s
            if self.topology is not None and spec_s > 0:
                for sid in self.topology.route(dev):
                    granted_seg[sid] = granted_seg.get(sid, 0.0) + spec_s
        return grants

    def grant_warmup(self, compute_s: float, demand_s: Sequence[float],
                     device: int, width: int) -> int:
        """Cap one request's prefill warm-up burst by its link headroom.

        Warm bursts ride behind the prefill compute window exactly like
        speculation rides behind decode, so they draw from the same
        per-device budget: ``width`` (the planned warm entries per layer)
        shrinks to what fits ``device_entry_budget`` over ``n_layers``
        layers, never below ``min(min_width, width)`` — a saturated link
        still seeds a floor-sized warm set (pure traffic shaping: the
        first decode step just misses more, it never decodes differently).
        """
        if width <= 0:
            return 0
        d = self._device_demand(demand_s, device)
        cap = int(self.device_entry_budget(compute_s, d)
                  // self.n_layers)
        floor = min(max(self.cfg.min_width, 0), width)
        return min(width, max(cap, floor))


# ---------------------------------------------------------------------------
# per-layer hot-tier sizing
# ---------------------------------------------------------------------------


def resize_allocation_width(sizes: Sequence[int],
                            device_buffer: int) -> int:
    """Static allocation width for an online-resizable layered buffer:
    2x headroom over the widest initial layer (and over the uniform
    per-layer share) so re-sizing can grow layers, capped at the total.
    ONE formula shared by the engine's allocation and the simulator's
    analytic twin — their LayerSizer ``max_slots`` hard caps must agree
    or the analytic re-sized hit rates drift from the engine's."""
    total = sum(sizes)
    return min(total, 2 * max(max(sizes), device_buffer))


class LayerSizer:
    """Apportion ``total_slots`` hot-tier entries across pool layers.

    Weights come from measured per-layer miss rates when available (the
    engine's ``buf_misses_l`` counters), else from a structural prior:
    a windowed layer's decode mask only ever selects from its trailing
    ``window`` positions, so it is weighted (and hard-capped) by
    ``min(window, topk)`` while full-attention layers carry weight
    ``topk``.  Sizes always sum exactly to ``total_slots`` and every
    layer keeps at least ``min_slots`` (capacity permitting) so the
    layered buffer layout stays valid.
    """

    def __init__(self, n_layers: int, total_slots: int, *,
                 layer_windows: Optional[Sequence[int]] = None,
                 topk: int = 0, min_slots: int = 1,
                 max_slots: Optional[int] = None):
        self.n_layers = max(int(n_layers), 1)
        self.total_slots = max(int(total_slots), self.n_layers)
        wins = list(layer_windows or [])
        self.layer_windows = (wins + [0] * self.n_layers)[:self.n_layers]
        self.topk = max(int(topk), 1)
        self.min_slots = max(int(min_slots), 1)
        # hard per-layer ceiling: the static allocation width of an
        # already-built layered buffer (online re-sizing can never grow a
        # layer past it).  Feasibility: the initial layout satisfies
        # n * max(sizes) >= sum(sizes) == total, so a ceiling taken from
        # that layout always fits the whole budget.
        self.max_slots = None if max_slots is None else max(int(max_slots), 1)
        if self.max_slots is not None:
            assert self.total_slots <= self.n_layers * self.max_slots, \
                (self.total_slots, self.n_layers, self.max_slots)

    def _hard_cap(self) -> int:
        return (self.max_slots if self.max_slots is not None
                else self.total_slots)

    def caps(self) -> List[int]:
        """Per-layer ceilings: a windowed layer never benefits from more
        resident slots than distinct selectable positions.  The caps are
        honored while the budget fits under them; when ``total_slots``
        exceeds their sum (every layer windowed and over-provisioned),
        ``sizes`` spreads the surplus past the window caps — the total is
        the engine↔simulator comparability contract and always wins —
        though never past ``max_slots`` (an allocation width is physical,
        not advisory)."""
        hard = self._hard_cap()
        return [min(w, hard) if w > 0 else hard
                for w in self.layer_windows]

    def weights(self, miss_rates: Optional[Sequence[float]] = None
                ) -> List[float]:
        if miss_rates is not None:
            rates = (list(miss_rates) + [0.0] * self.n_layers)
            return [max(float(r), 0.0) + 1e-9
                    for r in rates[:self.n_layers]]
        return [float(min(w, self.topk)) if w > 0 else float(self.topk)
                for w in self.layer_windows]

    def sizes(self, miss_rates: Optional[Sequence[float]] = None
              ) -> List[int]:
        n, total = self.n_layers, self.total_slots
        caps = self.caps()
        w = self.weights(miss_rates)
        base = min(self.min_slots, total // n)
        sizes = [min(max(base, 1), caps[l]) for l in range(n)]
        remaining = total - sum(sizes)
        # proportional fill under caps; iterate because capped layers
        # return their unused share to the pool
        while remaining > 0:
            active = [l for l in range(n) if sizes[l] < caps[l]]
            if not active:
                break
            tw = sum(w[l] for l in active)
            if tw <= 0:
                w = [1.0] * n
                continue
            shares = [(l, remaining * w[l] / tw) for l in active]
            progressed = 0
            for l, s in shares:
                add = min(int(s), caps[l] - sizes[l])
                sizes[l] += add
                progressed += add
            remaining -= progressed
            if progressed == 0:
                # fractional shares all rounded to zero: hand out single
                # slots by descending weight until the budget is spent
                for l, _ in sorted(shares, key=lambda t: -w[t[0]]):
                    if remaining <= 0:
                        break
                    if sizes[l] < caps[l]:
                        sizes[l] += 1
                        remaining -= 1
        if remaining > 0:
            # every layer at its window cap but budget left: keep the sum
            # invariant (the total is the comparability contract) by
            # spreading the surplus past the window caps — rotating in
            # DESCENDING weight order (a fixed layer-0 start would hand
            # the heaviest-missing layers nothing extra and bias early
            # layers every call), and never past the hard allocation cap
            hard = self._hard_cap()
            order = sorted(range(n), key=lambda l: (-w[l], l))
            remaining = _hand_out_units(remaining, order, sizes,
                                        [hard] * n)
            assert remaining == 0, \
                "total_slots exceeds n_layers * max_slots"
        return sizes
