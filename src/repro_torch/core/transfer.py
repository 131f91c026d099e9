"""Fabric cost models: CXL / RDMA / local DRAM / TPU ICI.

These drive the event-driven serving simulator that reproduces the paper's
Figures 5 and 9-14.  Constants are calibrated against the paper's own
measurements (§3.2, Fig 5):

  - sparse fetch of 64-4096 MLA entries (1152 B each):
      CXL   = 1.04-1.64x local-DRAM latency,
      RDMA  = 4-19.7x local-DRAM, reaching ms-level at high entry counts;
  - "local DRAM" means *GPU-initiated* reads of host DRAM over PCIe
    (the paper's upper-bound backend), not CPU-local loads.

The RDMA model charges the full message-protocol stack the paper blames:
per-transfer setup (QP sync, doorbell, completion polling), per-segment
software overhead for scatter/gather lists, and message-size-limited
bandwidth.  The CXL model has near-zero protocol overhead but a lower
per-link bandwidth (PCIe5 x8 per device), which is why device interleaving
(paper §4.3.3) matters — the simulator models per-device link contention.

The ICI model is used for the TPU `pooled_hbm` backend mapping (DESIGN §2).

Consumers do not call these models directly for accounting: the shared
``FabricAccountant`` (core/traffic.py) wraps them so every serving layer
(engine, SACSystem, simulator) charges traffic into one ``TrafficStats``
schema.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

# ---------------------------------------------------------------------------
# QoS classes (fabric topology, core/fabric.py)
# ---------------------------------------------------------------------------
# Every transfer the accountant books carries one of two service classes.
# DEMAND traffic (decode-step top-k misses, prefill write-back) is on the
# token-latency critical path and owns the link.  SPECULATIVE traffic
# (arbiter-granted prefetch, warm-up) yields at congested fabric segments:
# on a topology with ``qos_spec_yield`` set, a segment services its
# speculative backlog only from the hide window left over after its demand
# backlog, and the un-serviced remainder is dropped from the step's
# exposure (speculated entries go stale by the next step, so deferring
# them has no value) and counted in ``TrafficStats.spec_yielded_s``.
QOS_DEMAND = 0
QOS_SPECULATIVE = 1


@dataclasses.dataclass(frozen=True)
class FabricModel:
    name: str
    base_latency_s: float        # one-time setup per fetch operation
    per_message_s: float         # per message / doorbell on the fabric
    per_entry_s: float           # per-segment software overhead (SGE build etc.)
    bandwidth_Bps: float         # per-initiator link bandwidth
    max_sge: int                 # segments coalesced per message
    granularity: int             # minimum transfer unit (bytes)
    congestion_n: float = 0.0    # per-entry overhead grows ~(1 + n/congestion_n)
                                 # (completion-queue pressure; 0 = none)

    def sparse_fetch_time(self, n_entries: int, entry_bytes: int,
                          contention: float = 1.0) -> float:
        """Time to fetch ``n_entries`` discrete entries (seconds).

        ``contention`` >= 1 scales the bandwidth term (link sharing).
        """
        if n_entries <= 0:
            return 0.0
        n_msgs = math.ceil(n_entries / self.max_sge)
        wire = math.ceil(entry_bytes / self.granularity) * self.granularity
        bw_t = n_entries * wire / self.bandwidth_Bps * contention
        cong = 1.0 + (n_entries / self.congestion_n if self.congestion_n else 0.0)
        return (self.base_latency_s + n_msgs * self.per_message_s
                + n_entries * self.per_entry_s * cong + bw_t)

    def per_entry_seconds(self, entry_bytes: int, *,
                          nominal_batch: int = 256) -> float:
        """Amortized seconds per entry for a sparse fetch of
        ``nominal_batch`` entries — the marginal cost the budget arbiter
        (serving/arbiter.py) uses to convert a link-seconds budget into a
        per-request speculative entry budget.  Amortizing over a batch
        spreads the one-time ``base_latency_s`` the way a real per-step
        miss burst does."""
        n = max(int(nominal_batch), 1)
        return self.sparse_fetch_time(n, entry_bytes) / n

    def bulk_transfer_time(self, n_bytes: int, contention: float = 1.0
                           ) -> float:
        """Streaming transfer of a contiguous region (full-prefetch path)."""
        if n_bytes <= 0:
            return 0.0
        n_msgs = max(1, math.ceil(n_bytes / (1 << 20)))  # 1 MiB messages
        return (self.base_latency_s + n_msgs * self.per_message_s
                + n_bytes / self.bandwidth_Bps * contention)


# ---------------------------------------------------------------------------
# fetch/compute overlap (fetch pipeline, serving/prefetch.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    """Issued-vs-exposed split for pipelined fabric traffic.

    CXL's load/store semantics let a decode step's miss fetches (and all
    speculative prefetch) be *issued* into per-device double-buffered
    queues and drained while the step computes; only the tail that does
    not fit in the hide window stalls the step — the *exposed* time.

    ``depth`` is the number of in-flight step buffers (2 = classic double
    buffering: the fetch for step t+1 drains behind step t's compute);
    ``overlap_frac`` is the fraction of a step's compute the link can
    actually hide behind (dependency chains — the layer's own indexer and
    top-k must run before its miss set is known — keep it < 1).

    Invariant (tested): ``0 <= exposed_time(...) <= issued``.
    """

    depth: int = 2
    overlap_frac: float = 0.85

    def hide_window_s(self, compute_s: float) -> float:
        return max(self.overlap_frac, 0.0) * max(compute_s, 0.0) \
            * max(self.depth - 1, 0)

    def exposed_time(self, issued_s: float, compute_s: float) -> float:
        """Seconds of ``issued_s`` fabric time NOT hidden behind compute."""
        if issued_s <= 0.0:
            return 0.0
        return max(0.0, issued_s - self.hide_window_s(compute_s))


# serial reference: nothing hides, exposed == issued (the seed's model)
NO_OVERLAP = PipelineModel(depth=1, overlap_frac=0.0)


# ---------------------------------------------------------------------------
# calibrated fabrics (paper Fig 5 / §A.2)
# ---------------------------------------------------------------------------

# GPU reading host DRAM through PCIe5 x16: ~1.5 us base, ~60 GB/s effective.
DRAM = FabricModel("dram", base_latency_s=1.5e-6, per_message_s=0.0,
                   per_entry_s=0.0, bandwidth_Bps=60e9, max_sge=1 << 30,
                   granularity=64)

# CXL Type-3 pool behind an XConn switch: load/store semantics, no message
# protocol; 36 GB/s effective per x8 device link.
CXL = FabricModel("cxl", base_latency_s=0.8e-6, per_message_s=0.0,
                  per_entry_s=0.0, bandwidth_Bps=36e9, max_sge=1 << 30,
                  granularity=64)

# 100 Gb/s RNIC: QP sync / doorbell / completion-poll setup, 30-entry
# scatter/gather lists, per-segment software overhead that degrades under
# completion-queue pressure (the paper's "dozens of independent requests").
RDMA = FabricModel("rdma", base_latency_s=1e-6, per_message_s=0.3e-6,
                   per_entry_s=0.07e-6, bandwidth_Bps=12.5e9, max_sge=30,
                   granularity=256, congestion_n=1400)

# TPU ICI link (the pooled_hbm fabric on the TPU mapping): remote-DMA
# semantics, ~1 us software-visible latency, ~45 GB/s effective per link.
ICI = FabricModel("ici", base_latency_s=1.0e-6, per_message_s=0.0,
                  per_entry_s=0.0, bandwidth_Bps=45e9, max_sge=1 << 30,
                  granularity=32)

# local HBM (GPU-only baseline of Fig 12)
HBM = FabricModel("hbm", base_latency_s=0.1e-6, per_message_s=0.0,
                  per_entry_s=0.0, bandwidth_Bps=819e9, max_sge=1 << 30,
                  granularity=32)

FABRICS: Dict[str, FabricModel] = {f.name: f for f in
                                   (DRAM, CXL, RDMA, ICI, HBM)}


def fig5_ratios(n_entries: int, entry_bytes: int = 1152) -> Dict[str, float]:
    """Fetch-latency ratio vs the DRAM baseline (reproduces paper Fig 5)."""
    base = DRAM.sparse_fetch_time(n_entries, entry_bytes)
    return {name: f.sparse_fetch_time(n_entries, entry_bytes) / base
            for name, f in FABRICS.items() if name in ("cxl", "rdma", "dram")}
