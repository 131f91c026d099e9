"""Shared request->pool-device placement substrate (paper §4.3.3).

This is the ONE implementation of placement used by every serving layer:

  - ``SACSystem.place`` (core/sac.py) — page-granular pool bookkeeping for
    the real engine;
  - ``Scheduler`` (serving/scheduler.py) — byte-granular admission control;
  - ``simulate()`` (serving/simulator.py) — consumes placement through the
    Scheduler it embeds.

A :class:`Placer` tracks per-device occupancy in BOTH bytes and pages and
answers "which device should this request's KV live on" under a pluggable
:class:`PlacementPolicy`:

  - ``round_robin`` — the paper's CXL-device interleaving: consecutive
    requests land on different devices so concurrent fetches spread over
    fabric links (skipping full devices), bounding per-device imbalance;
  - ``first_fit``  — lowest-index device with room (interleaving OFF — the
    ablation baseline of paper Fig 13);
  - ``least_loaded`` — smallest booked-bytes device first (beyond-paper:
    balances *capacity* rather than request count, useful under highly
    skewed context lengths);
  - ``pressure_aware`` — least *link-pressured* device first (the PR 4
    closed loop): the placer consumes a live per-device pressure feed
    (``TrafficStats.device_demand_s()`` step deltas, supplied by the
    engine or simulator through ``set_pressure_fn``) and lands new
    requests on the device whose fabric link has the most headroom,
    breaking pressure ties by booked bytes (the least-loaded key).
    Without a feed it degrades exactly to ``least_loaded``.
  - ``radix_affinity`` — pressure-aware *plus* prefix locality (the
    PR 5 closed loop): a request whose prompt prefix is cached on some
    device (serving/radix.py) passes that device as an ``affinity``
    hint together with the fabric/compute seconds reuse would save
    (skipped re-prefill + skipped pool write of the matched pages).
    The hint device wins whenever its corrected pressure is within the
    saved seconds of the best link — locality-first tiering, but a
    slammed link still repels the request.  Capacity ALWAYS wins: the
    hint only reorders candidates, never overrides the byte/page fit.

The paper stores one request's KV entirely within a single device; the
placer decides *which* device, the caller owns the page/byte payloads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


class PlacementPolicy:
    """Candidate-device ordering strategy.  Stateless except for what the
    subclass declares (round-robin keeps a pointer)."""

    name = "base"

    def order(self, placer: "Placer") -> List[int]:
        raise NotImplementedError

    def on_commit(self, placer: "Placer", device: int) -> None:
        """Called after a successful placement on ``device``."""

    def on_departure(self, placer: "Placer", device: int,
                     seconds: float) -> None:
        """Called when a request finishes: its own measured demand share
        (``seconds``) just left ``device``'s link.  Pressure-keyed
        policies subtract it immediately instead of waiting for the EMA
        to decay (no-op for pressure-blind policies)."""


class RoundRobinPolicy(PlacementPolicy):
    """Interleave requests across devices (paper §4.3.3)."""

    name = "round_robin"

    def __init__(self):
        self._rr = 0

    def order(self, placer: "Placer") -> List[int]:
        n = placer.n_devices
        return [(self._rr + i) % n for i in range(n)]

    def on_commit(self, placer: "Placer", device: int) -> None:
        self._rr = (device + 1) % placer.n_devices


class FirstFitPolicy(PlacementPolicy):
    """Lowest index with room (interleaving disabled, Fig 13 baseline)."""

    name = "first_fit"

    def order(self, placer: "Placer") -> List[int]:
        return list(range(placer.n_devices))


class LeastLoadedPolicy(PlacementPolicy):
    """Smallest booked-bytes device first (ties break toward pages, then
    index, so the ordering is deterministic)."""

    name = "least_loaded"

    def order(self, placer: "Placer") -> List[int]:
        return sorted(range(placer.n_devices),
                      key=lambda d: (placer.bytes_used[d],
                                     placer.pages_used[d], d))


class PressureAwarePolicy(PlacementPolicy):
    """Least link-pressured device first (serving/arbiter.py feedback
    loop): the primary key is the placer's live per-device pressure feed
    (demand fabric seconds observed last step), so a new request lands on
    the link with the most headroom even when byte loads are balanced.
    Ties fall back to the least-loaded ordering (bytes, pages, index) —
    with no feed attached every pressure is 0.0 and the policy IS
    least_loaded.

    The feed is a per-STEP measurement, so several requests admitted in
    one scheduling gap would all see the same stale snapshot and herd
    onto the same device.  The policy therefore keeps an in-flight
    correction: each booking committed since the snapshot last changed
    adds one average request's worth of pressure to its device, exactly
    like the least-loaded key updates bytes per booking."""

    name = "pressure_aware"
    ema_beta = 0.7      # snapshot smoothing: one step's demand delta is
                        # noisy (cold bursts, warm-up); the decision key
                        # is an EMA over successive snapshots

    def __init__(self):
        self._snapshot = None          # (epoch, values) of the last reset
        self._ema: List[float] = []
        self._placed_since: List[int] = []
        # EMA of departed requests' measured per-step shares: the
        # in-flight correction's per-request estimate when the live
        # signal cannot provide one (right after a synchronized finish
        # wave the feed is near zero and sum(ema)/active collapses —
        # without this floor an admission burst would herd)
        self._dep_share = 0.0

    def _corrected(self, placer: "Placer") -> List[float]:
        pressure = placer.device_pressure()
        # a snapshot is stale until the feed is re-measured — tracked by
        # the placer's pressure epoch (bumped by the serving layer each
        # step) so a fresh reading that happens to EQUAL the previous
        # one still resets the correction (steady-state traces repeat
        # values exactly; accumulating would double-count load the new
        # measurement already includes)
        snapshot = (placer.pressure_epoch, pressure)
        if snapshot != self._snapshot:
            self._snapshot = snapshot
            if len(self._ema) != placer.n_devices:
                self._ema = list(pressure)
            else:
                b = self.ema_beta
                self._ema = [b * e + (1 - b) * p
                             for e, p in zip(self._ema, pressure)]
            self._placed_since = [0] * placer.n_devices
        active = sum(placer.counts)
        per_req = sum(self._ema) / active if active else 0.0
        per_req = max(per_req, self._dep_share)
        return [p + per_req * n
                for p, n in zip(self._ema, self._placed_since)]

    def order(self, placer: "Placer") -> List[int]:
        pressure = self._corrected(placer)
        return sorted(range(placer.n_devices),
                      key=lambda d: (pressure[d], placer.bytes_used[d],
                                     placer.pages_used[d], d))

    def on_commit(self, placer: "Placer", device: int) -> None:
        if device < len(self._placed_since):
            self._placed_since[device] += 1

    def on_departure(self, placer: "Placer", device: int,
                     seconds: float) -> None:
        """A finishing request's own demand share leaves its link NOW:
        subtract it from the smoothed pressure instead of letting the
        EMA decay it over the next several snapshots (during which new
        requests would still see the departed load and avoid a link
        that is actually free).  The share also updates the per-request
        estimate the in-flight correction falls back on."""
        if seconds <= 0:
            return
        b = self.ema_beta
        self._dep_share = (b * self._dep_share + (1 - b) * seconds
                           if self._dep_share else seconds)
        if 0 <= device < len(self._ema):
            self._ema[device] = max(0.0, self._ema[device] - seconds)


class RadixAffinityPolicy(PressureAwarePolicy):
    """Prefix locality weighed against live link pressure (paper §A.3 +
    the "Unifying Sparse Attention with Hierarchical Memory"
    locality-first resolution): order devices by corrected pressure as
    ``pressure_aware`` does, but when the caller supplied an affinity
    hint — the device holding the request's radix-cached prefix, plus
    the seconds reuse there would save — promote that device to the
    front IF its pressure is within the saved seconds of the best
    candidate.  Reuse off-device is worthless (the pages cannot be read
    without crossing two links), so the comparison is exactly
    "locality benefit vs extra link exposure".  Capacity still always
    wins: ``Placer.place`` books the first *fitting* device in order.
    Without a hint (or without a pressure feed) the policy degrades to
    its parent."""

    name = "radix_affinity"

    def order(self, placer: "Placer") -> List[int]:
        pressure = self._corrected(placer)
        ordered = sorted(range(placer.n_devices),
                         key=lambda d: (pressure[d], placer.bytes_used[d],
                                        placer.pages_used[d], d))
        hint = placer.affinity_hint
        if hint is None:
            return ordered
        devs, bonus_s = hint
        devs = [d for d in devs if 0 <= d < placer.n_devices]
        if not devs:
            return ordered
        # PR 6: the hint may name SEVERAL devices (a replicated prefix —
        # every copy is equally reusable), so promote the cheapest copy,
        # not the single owner: the least-corrected-pressure replica
        # competes against the globally best link
        dev = min(devs, key=lambda d: (pressure[d], placer.bytes_used[d],
                                       placer.pages_used[d], d))
        if pressure[dev] <= pressure[ordered[0]] + max(bonus_s, 0.0):
            ordered.remove(dev)
            ordered.insert(0, dev)
        return ordered


POLICIES = {
    "round_robin": RoundRobinPolicy,
    "first_fit": FirstFitPolicy,
    "least_loaded": LeastLoadedPolicy,
    "pressure_aware": PressureAwarePolicy,
    "radix_affinity": RadixAffinityPolicy,
}


def make_policy(policy: str) -> PlacementPolicy:
    if policy not in POLICIES:
        raise ValueError(f"unknown placement policy {policy!r} "
                         f"(have {sorted(POLICIES)})")
    return POLICIES[policy]()


def policy_for_interleave(interleave: bool) -> str:
    """Map the paper's interleave on/off knob to a policy name."""
    return "round_robin" if interleave else "first_fit"


# ---------------------------------------------------------------------------
# the placer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Booking:
    device: int
    n_bytes: float
    n_pages: int


class Placer:
    """Capacity-aware request->device placement with byte AND page budgets.

    ``place`` walks devices in policy order and books the first that fits
    both budgets; ``release`` undoes a booking.  All serving layers share
    this class so their placement decisions agree by construction.
    """

    def __init__(self, n_devices: int, *, policy: str = "round_robin",
                 capacity_bytes: float = float("inf"),
                 capacity_pages: Optional[int] = None,
                 pressure_fn: Optional[Callable[[], Sequence[float]]] = None,
                 topology=None):
        assert n_devices >= 1
        self.n_devices = n_devices
        # optional FabricTopology (core/fabric.py): when attached, the
        # pressure feed is per-SEGMENT and device_pressure() projects
        # each device's BOTTLENECK-segment pressure (a device behind a
        # saturated trunk reads the trunk, not its idle leaf).  The
        # policies stay per-device — only the signal changes.
        self.topology = topology
        self.policy = make_policy(policy)
        self.capacity_bytes = capacity_bytes
        self.capacity_pages = (capacity_pages if capacity_pages is not None
                               else (1 << 62))
        self.bytes_used: List[float] = [0.0] * n_devices
        self.pages_used: List[int] = [0] * n_devices
        self.counts: List[int] = [0] * n_devices      # active requests
        self._bookings: Dict[int, _Booking] = {}
        self._pressure_fn = pressure_fn
        self.pressure_epoch = 0
        # transient per-placement hint (radix_affinity): set by place()
        # for the duration of the policy's order() call only
        self.affinity_hint: Optional[tuple] = None

    # -- live link-pressure feed (pressure_aware policy) -------------------
    def set_pressure_fn(self,
                        fn: Optional[Callable[[], Sequence[float]]]) -> None:
        """Attach the live per-device pressure source (demand fabric
        seconds per link, e.g. ``TrafficStats.device_demand_s()`` step
        deltas).  The feed is read at ``place`` time, so placement always
        sees the freshest pressure the serving layer measured.  In both
        serving layers the attached callable is the shared
        :class:`repro_torch.serving.policy.PressureFeed` over a
        ``DemandTracker`` (serving/arbiter.py)."""
        self._pressure_fn = fn

    def note_pressure_update(self) -> None:
        """Mark the feed as re-measured (the serving layer calls this
        once per step).  The pressure_aware policy keys its in-flight
        booking correction on this epoch, NOT on value equality — a
        steady-state trace repeats pressure values exactly, and treating
        a fresh-but-equal reading as stale would keep accumulating
        synthetic load the new measurement already includes."""
        self.pressure_epoch += 1

    def device_pressure(self) -> List[float]:
        """Per-device link pressure from the attached feed (0.0 per
        device without one — pressure_aware then degrades to
        least_loaded).  Shorter feeds are zero-padded; longer ones
        truncated (the placer's device space is authoritative).

        With a topology attached the feed is per-SEGMENT and each
        device's reading is the max over the segments on its route —
        the bottleneck on the path a placement would load.  The flat
        star's identity routing makes this the plain per-device feed."""
        if self._pressure_fn is None:
            return [0.0] * self.n_devices
        raw = [max(float(p), 0.0) for p in self._pressure_fn()]
        if self.topology is not None:
            return self.topology.device_view(raw)
        return (raw + [0.0] * self.n_devices)[:self.n_devices]

    def corrected_pressure(self) -> List[float]:
        """Pressure as the active policy will see it at the NEXT
        placement: the raw feed plus pressure-keyed policies' in-flight
        booking correction.  The PR 6 replication trigger reads this —
        during a same-wave admission burst the raw feed is a stale
        snapshot, but every booking already committed raises its
        device's corrected pressure, so the burst itself can push the
        copy-holding link over the replication threshold before the
        feed catches up.  Pressure-blind policies fall back to the raw
        feed."""
        corr = getattr(self.policy, "_corrected", None)
        if corr is not None:
            return corr(self)
        return self.device_pressure()

    # -- placement ---------------------------------------------------------
    def fits(self, device: int, n_bytes: float = 0.0, n_pages: int = 0
             ) -> bool:
        return (self.bytes_used[device] + n_bytes <= self.capacity_bytes
                and self.pages_used[device] + n_pages <= self.capacity_pages)

    def place(self, request_id: int, *, n_bytes: float = 0.0,
              n_pages: int = 0, affinity=None,
              affinity_s: float = 0.0) -> Optional[int]:
        """Book ``request_id`` on the first policy-ordered device with
        room; returns the device or None if every device is full.

        ``affinity``/``affinity_s`` (radix_affinity policy): the
        device(s) holding the request's cached prefix — an int, or a
        sequence of ints when the prefix is replicated (PR 6) — and the
        seconds reuse there would save.  Pressure-blind policies ignore
        the hint; no policy may use it to override capacity — it only
        reorders candidates.
        """
        assert request_id not in self._bookings, \
            f"request {request_id} already placed"
        if affinity is None:
            self.affinity_hint = None
        else:
            devs = ((affinity,) if isinstance(affinity, int)
                    else tuple(affinity))
            self.affinity_hint = (devs, affinity_s) if devs else None
        try:
            order = self.policy.order(self)
        finally:
            self.affinity_hint = None
        for dev in order:
            if self.fits(dev, n_bytes, n_pages):
                self.bytes_used[dev] += n_bytes
                self.pages_used[dev] += n_pages
                self.counts[dev] += 1
                self._bookings[request_id] = _Booking(dev, n_bytes, n_pages)
                self.policy.on_commit(self, dev)
                return dev
        return None

    def adjust(self, device: int, *, n_bytes: float = 0.0,
               n_pages: int = 0) -> None:
        """Raw occupancy adjustment for non-request residents — the
        radix cache's retained prefix pages (core/sac.py) keep charging
        the device's byte/page budgets after their request's booking is
        gone, and are credited back when the index evicts them."""
        assert 0 <= device < self.n_devices, device
        self.bytes_used[device] = max(0.0, self.bytes_used[device] + n_bytes)
        self.pages_used[device] = max(0, self.pages_used[device] + n_pages)

    def note_departure(self, device: int, seconds: float) -> None:
        """Report a finished request's own measured demand share so
        pressure-keyed policies can subtract it from their smoothed
        per-link signal immediately (serving layers call this alongside
        their own pressure-feed correction at finish time)."""
        self.policy.on_departure(self, device, seconds)

    def shrink(self, request_id: int, *, n_bytes: float = 0.0,
               n_pages: int = 0) -> Tuple[float, int]:
        """Shrink a live booking in place (page dedup, PR 6): a request
        whose leading pages are refcount-shared with the radix cache
        returns its private copies to the pool, so its booking — and the
        device occupancy it charges — must drop by exactly that much NOW,
        not at release.  Release then subtracts only the shrunk booking,
        which is what keeps a departing sharer from subtracting bytes
        the cache (or another sharer) still holds.  Clamped to the
        booking; returns (bytes, pages) actually shrunk."""
        bk = self._bookings.get(request_id)
        if bk is None:
            return 0.0, 0
        n_bytes = min(max(n_bytes, 0.0), bk.n_bytes)
        n_pages = min(max(n_pages, 0), bk.n_pages)
        bk.n_bytes -= n_bytes
        bk.n_pages -= n_pages
        self.bytes_used[bk.device] = max(
            0.0, self.bytes_used[bk.device] - n_bytes)
        self.pages_used[bk.device] = max(
            0, self.pages_used[bk.device] - n_pages)
        return n_bytes, n_pages

    def release(self, request_id: int) -> Optional[int]:
        """Undo a booking; returns the device it lived on (None if
        unknown).  Subtracts the booking's CURRENT size — a booking
        shrunk by page dedup (``shrink``) releases only what it still
        holds, never bytes shared pages' other owners keep charging."""
        bk = self._bookings.pop(request_id, None)
        if bk is None:
            return None
        self.bytes_used[bk.device] = max(
            0.0, self.bytes_used[bk.device] - bk.n_bytes)
        self.pages_used[bk.device] = max(
            0, self.pages_used[bk.device] - bk.n_pages)
        self.counts[bk.device] -= 1
        return bk.device

    def device_of(self, request_id: int) -> Optional[int]:
        bk = self._bookings.get(request_id)
        return bk.device if bk else None

    # -- introspection -----------------------------------------------------
    def device_loads(self) -> List[int]:
        """Active request count per device."""
        return list(self.counts)

    def max_imbalance(self) -> int:
        loads = self.device_loads()
        return max(loads) - min(loads) if loads else 0


# ---------------------------------------------------------------------------
# convenience (paper Fig 13 ablation helper)
# ---------------------------------------------------------------------------


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(max(n_tokens, 0) / max(page_size, 1)))


def interleaved_assignment(request_ids: Sequence[int], n_devices: int,
                           enabled: bool = True) -> List[int]:
    """Round-robin request -> pool-device assignment (capacity-free).

    With interleaving on, consecutive requests land on different pool
    devices so concurrent fetches spread across fabric links; off, all
    requests hit device 0 (the ablation baseline of paper Fig 13).

    Assignment is by ARRIVAL ORDER (the shared round-robin policy), not
    keyed on the ids — a pre-substrate version used ``rid % n_devices``,
    which coincides for sequential ids but not for arbitrary ones.
    """
    placer = Placer(n_devices, policy=policy_for_interleave(enabled))
    return [placer.place(i) for i, _ in enumerate(request_ids)]
