"""CXL switch-fabric topology: routing, per-segment capacity, QoS.

The paper's pool is not a bundle of independent point-to-point links —
it is a *switch fabric* (§A.2: CXL Type-3 devices behind an XConn
switch) where congestion lives at shared switch ports.  Two devices
behind one saturated upstream port are not independent, and placement /
arbitration decisions made on per-endpoint numbers are blind to that.

:class:`FabricTopology` models the fabric as a graph of directed **link
segments** between the host, switches, and memory devices:

  - ``route(device)`` returns the deterministic host->device path as a
    tuple of segment ids (the LAST segment is always the device's leaf
    link, so per-device stats project out of per-segment stats);
  - every :class:`Segment` carries a ``bandwidth_scale`` (capacity as a
    multiple of one device link) and an additive ``latency_s``;
  - a transfer that takes ``t`` seconds at the device-link rate occupies
    each segment on its path for ``t / bandwidth_scale + latency_s``
    seconds (``segment_charge``) — the *link-segment seconds* the shared
    accountant (core/traffic.py) books, and the unit every control loop
    (arbiter grants, pressure-aware placement) reasons in.

Two QoS classes split that traffic (``QOS_DEMAND`` / ``QOS_SPECULATIVE``,
core/transfer.py): demand fetches (top-k misses, prefill writes) own the
segment; speculative prefetch *yields* at congested segments — on a
topology built with ``qos_spec_yield=True``, a segment's speculative
backlog is only serviced from the hide window left over after its demand
backlog, and the remainder is dropped from the step's exposure and
counted in ``TrafficStats.spec_yielded_s`` (the speculated entries go
stale by the next step, so deferring them has no value).  Demand is
never delayed by speculation at a shared port.

Presets (all deterministic, no external graph library):

  - ``flat_star(n)``      — one dedicated host port per device; paths are
    single leaf segments with ``sid == device``, so every per-segment
    number degenerates EXACTLY to the flat per-device accounting the
    repo used before PR 7.  This is the default everywhere
    (``SACConfig.topology is None``) and is bit-identical by
    construction (tests/test_fabric.py).
  - ``tree(n, s)``        — ``s`` switches, devices grouped contiguously;
    each path crosses a shared host->switch trunk then the leaf.
  - ``multi_switch(n, s)``— cascaded: one shared host uplink feeding
    ``s`` switch trunks (two shared levels).
  - ``mesh(n, p)``        — ``p`` host ports with devices striped across
    them (``device % p``) — the interleaved dual-homing layout.

``from_spec`` parses the string forms used by configs and the CLI:
``"flat:4"``, ``"tree:4x2"``, ``"multi_switch:8x2"``, ``"mesh:4x2"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core.transfer import QOS_DEMAND, QOS_SPECULATIVE  # noqa: F401
                                    # (re-exported: fabric is the natural
                                    # import site for QoS-aware consumers)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One directed link segment of the fabric graph."""

    sid: int
    name: str
    bandwidth_scale: float = 1.0   # capacity as a multiple of one device
                                   # link (trunks shared by many leaves
                                   # with scale 1.0 are the congestion)
    latency_s: float = 0.0         # additive per-transfer propagation

    def charge(self, seconds: float) -> float:
        """Segment occupancy for a transfer of ``seconds`` at the
        device-link rate."""
        if seconds <= 0.0:
            return 0.0
        return seconds / max(self.bandwidth_scale, 1e-12) + self.latency_s


class FabricTopology:
    """Deterministic switch-fabric graph with host->device routing.

    ``device_paths[d]`` is the host->device segment-id path; its last
    element is the device's *leaf* segment.  By convention every preset
    numbers leaves first (``sid == device id``) so the leaf projection of
    per-segment arrays lines up index-for-index with the historical
    per-device arrays.
    """

    def __init__(self, n_devices: int, segments: Sequence[Segment],
                 device_paths: Sequence[Sequence[int]], *,
                 name: str = "custom", qos_spec_yield: bool = False):
        assert n_devices >= 1 and len(device_paths) == n_devices
        self.name = name
        self.n_devices = int(n_devices)
        self.segments: Tuple[Segment, ...] = tuple(segments)
        assert all(s.sid == i for i, s in enumerate(self.segments)), \
            "segment ids must be dense and ordered"
        self.qos_spec_yield = bool(qos_spec_yield)
        paths = []
        for d, p in enumerate(device_paths):
            p = tuple(int(s) for s in p)
            assert p, f"device {d} has an empty path"
            assert all(0 <= s < len(self.segments) for s in p), (d, p)
            paths.append(p)
        self._paths: Tuple[Tuple[int, ...], ...] = tuple(paths)
        counts: dict = {}
        for p in self._paths:
            for s in p:
                counts[s] = counts.get(s, 0) + 1
        # trunks: segments on >= 2 device paths — where concurrent
        # transfers to DIFFERENT devices contend.  Flat star: empty by
        # construction, so trunk-only serialization degenerates to the
        # independent-lane model the repo used before PR 7.
        self.shared_segments: frozenset = frozenset(
            s for s, c in counts.items() if c >= 2)

    # -- structure ---------------------------------------------------------
    @property
    def n_segments(self) -> int:
        return len(self.segments)

    def route(self, device: int) -> Tuple[int, ...]:
        """Deterministic host->device path (segment ids; last = leaf)."""
        if not 0 <= device < self.n_devices:
            raise IndexError(
                f"device {device} out of range [0, {self.n_devices})")
        return self._paths[device]

    def route_between(self, src: int, dst: int) -> Tuple[int, ...]:
        """Device->device path (replica copies): up from ``src`` to the
        lowest common ancestor, down to ``dst`` — the shared upper
        segments (common path prefix) are never crossed."""
        a, b = self.route(src), self.route(dst)
        common = 0
        for x, y in zip(a, b):
            if x != y:
                break
            common += 1
        return tuple(reversed(a[common:])) + b[common:]

    def leaf(self, device: int) -> int:
        """The device's last-hop segment id (== ``device`` in presets)."""
        return self.route(device)[-1]

    # -- per-segment <-> per-device views ----------------------------------
    def device_view(self, seg_values: Sequence[float]) -> List[float]:
        """Project per-segment values to per-device BOTTLENECK values:
        ``out[d] = max over segments on route(d)``.  This is the pressure
        the placement policies and replica selection consume — a device
        behind a saturated trunk reads the trunk's pressure, not its idle
        leaf's."""
        vals = list(seg_values) + [0.0] * self.n_segments
        return [max(vals[s] for s in self._paths[d])
                for d in range(self.n_devices)]

    def leaf_view(self, seg_values: Sequence[float]) -> List[float]:
        """Project per-segment values to per-device LEAF values — the
        endpoint-only view (exactly the pre-fabric flat accounting; the
        segment-blind baseline of benchmarks/fabric_sweep.py)."""
        vals = list(seg_values) + [0.0] * self.n_segments
        return [vals[p[-1]] for p in self._paths]

    def segment_charge(self, device: int, seconds: float
                       ) -> List[Tuple[int, float]]:
        """Per-segment occupancy of a host<->device transfer that takes
        ``seconds`` at the device-link rate: ``(sid, charge)`` per
        segment on the path."""
        return [(s, self.segments[s].charge(seconds))
                for s in self.route(device)]

    def transfer_seconds(self, device: int, seconds: float) -> float:
        """End-to-end transfer time along the path: the bottleneck
        segment's occupancy (cut-through switching — the transfer moves
        at the slowest segment's rate, latencies additive through
        ``Segment.charge``).  Flat star: exactly ``seconds``."""
        if seconds <= 0.0:
            return 0.0
        return max(c for _, c in self.segment_charge(device, seconds))

    def segment_seconds(self, seg_bytes: Sequence[float], bw_Bps: float
                        ) -> List[float]:
        """Per-segment drain time of a step's byte backlog at a base
        device-link bandwidth (the simulator's analytic fetch model)."""
        return [b / (max(bw_Bps, 1e-9) * max(s.bandwidth_scale, 1e-12))
                for b, s in zip(seg_bytes, self.segments)]

    def describe(self) -> str:
        lanes = ", ".join(
            f"dev{d}<-[{':'.join(str(s) for s in p)}]"
            for d, p in enumerate(self._paths))
        return (f"{self.name}(n={self.n_devices}, "
                f"segments={self.n_segments}, qos_yield="
                f"{self.qos_spec_yield}) {lanes}")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FabricTopology<{self.describe()}>"

    # -- presets -----------------------------------------------------------
    @classmethod
    def flat_star(cls, n_devices: int, *,
                  qos_spec_yield: bool = False) -> "FabricTopology":
        """The degenerate topology: every device on its own host port.
        One leaf segment per device, ``sid == device`` — per-segment
        accounting IS the historical per-device accounting."""
        segs = [Segment(d, f"host->dev{d}") for d in range(n_devices)]
        return cls(n_devices, segs, [(d,) for d in range(n_devices)],
                   name="flat", qos_spec_yield=qos_spec_yield)

    @classmethod
    def tree(cls, n_devices: int, n_switches: int = 2, *,
             trunk_scale: float = 1.0,
             qos_spec_yield: bool = True) -> "FabricTopology":
        """``n_switches`` switches on dedicated host ports; devices
        grouped contiguously (device d behind switch d // ceil(n/s)).
        Each trunk has ``trunk_scale`` device-links of capacity — at the
        default 1.0 a switch's devices genuinely share one link's worth
        of upstream bandwidth (PCIe x8 uplink, paper §A.2)."""
        s = max(min(int(n_switches), n_devices), 1)
        per = -(-n_devices // s)                       # ceil division
        segs = [Segment(d, f"sw{d // per}->dev{d}")
                for d in range(n_devices)]
        segs += [Segment(n_devices + i, f"host->sw{i}",
                         bandwidth_scale=trunk_scale) for i in range(s)]
        paths = [(n_devices + d // per, d) for d in range(n_devices)]
        return cls(n_devices, segs, paths, name="tree",
                   qos_spec_yield=qos_spec_yield)

    @classmethod
    def multi_switch(cls, n_devices: int, n_switches: int = 2, *,
                     trunk_scale: float = 1.0, uplink_scale: float = 2.0,
                     qos_spec_yield: bool = True) -> "FabricTopology":
        """Cascaded fabric: one shared host uplink feeds ``n_switches``
        switch trunks which feed contiguous device groups.  The uplink
        (default 2x one device link) is the pod-level shared port every
        transfer crosses."""
        s = max(min(int(n_switches), n_devices), 1)
        per = -(-n_devices // s)
        segs = [Segment(d, f"sw{d // per}->dev{d}")
                for d in range(n_devices)]
        segs += [Segment(n_devices + i, f"up->sw{i}",
                         bandwidth_scale=trunk_scale) for i in range(s)]
        root = n_devices + s
        segs.append(Segment(root, "host->up", bandwidth_scale=uplink_scale))
        paths = [(root, n_devices + d // per, d) for d in range(n_devices)]
        return cls(n_devices, segs, paths, name="multi_switch",
                   qos_spec_yield=qos_spec_yield)

    @classmethod
    def mesh(cls, n_devices: int, n_ports: int = 2, *,
             port_scale: float = 1.0,
             qos_spec_yield: bool = True) -> "FabricTopology":
        """Striped dual-homing: ``n_ports`` host ports with device d
        hanging off port ``d % n_ports`` — the interleaved counterpart
        of ``tree``'s contiguous grouping (adjacent devices never share
        an upstream port)."""
        p = max(min(int(n_ports), n_devices), 1)
        segs = [Segment(d, f"port{d % p}->dev{d}")
                for d in range(n_devices)]
        segs += [Segment(n_devices + i, f"host->port{i}",
                         bandwidth_scale=port_scale) for i in range(p)]
        paths = [(n_devices + d % p, d) for d in range(n_devices)]
        return cls(n_devices, segs, paths, name="mesh",
                   qos_spec_yield=qos_spec_yield)

    # -- spec parsing ------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: Union[str, "FabricTopology", None],
                  n_devices: Optional[int] = None) -> "FabricTopology":
        """Resolve a topology spec:

          - ``None``            -> flat star over ``n_devices``;
          - a FabricTopology    -> passed through (``n_devices`` must
            agree when given);
          - ``"flat[:N]"``, ``"tree[:NxS]"``, ``"multi_switch[:NxS]"``,
            ``"mesh[:NxP]"`` -> the preset (``N`` defaults to
            ``n_devices``; ``S``/``P`` defaults to 2).
        """
        if isinstance(spec, FabricTopology):
            assert n_devices is None or spec.n_devices == n_devices, \
                (spec.n_devices, n_devices)
            return spec
        if spec is None:
            assert n_devices is not None, \
                "a None topology spec needs n_devices"
            return cls.flat_star(n_devices)
        parts = str(spec).strip().split(":")
        kind = parts[0]
        n, arg = n_devices, 2
        if len(parts) > 1 and parts[1]:
            dims = parts[1].lower().split("x")
            n = int(dims[0])
            if len(dims) > 1:
                arg = int(dims[1])
        if n is None:
            raise ValueError(
                f"topology spec {spec!r} names no device count and none "
                "was supplied")
        if n_devices is not None and n != n_devices:
            raise ValueError(
                f"topology spec {spec!r} names {n} devices but the "
                f"serving layer has {n_devices}")
        makers = {"flat": lambda: cls.flat_star(n),
                  "star": lambda: cls.flat_star(n),
                  "tree": lambda: cls.tree(n, arg),
                  "multi_switch": lambda: cls.multi_switch(n, arg),
                  "mesh": lambda: cls.mesh(n, arg)}
        if kind not in makers:
            raise ValueError(f"unknown topology kind {kind!r} "
                             f"(have {sorted(makers)})")
        return makers[kind]()
