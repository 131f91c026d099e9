"""Request scheduler: admission control + pool-device interleaving.

Implements the paper's §4.3.3 dispatch policy through the shared
placement substrate (core/placement.py): a request's KV lives on ONE
pool device; the placer's round-robin policy spreads requests across
devices so concurrent GPU fetches spread over fabric links.  Admission
respects (a) the concurrency cap, (b) pool capacity (byte-granular,
enforced by the placer), (c) local-memory capacity (the RDMA baseline's
resident-KV constraint), and (d) HBM KV capacity (GPU-only baseline).
The max per-device queue imbalance is bounded by construction
(property-tested in tests/test_placement.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.core.placement import Placer, policy_for_interleave
from repro_torch.serving.policy import (AdmissionPolicy, FCFSAdmission,
                                  RadixAdmission)
from repro_torch.serving.request import Request


@dataclasses.dataclass
class SchedulerConfig:
    concurrency: int = 64
    n_pool_devices: int = 2
    interleave: bool = True
    placement: Optional[str] = None            # override policy by name
    pool_device_bytes: float = 256e9
    local_dram_bytes: float = float("inf")     # RDMA baseline constraint
    hbm_kv_bytes: float = float("inf")         # GPU-only baseline constraint
    bytes_per_token: float = 0.0               # KV bytes/token (all layers)
    topology: Optional[object] = None          # FabricTopology (PR 7): when
                                               # set, the pressure feed is
                                               # per-SEGMENT and the placer
                                               # projects it to per-device
                                               # bottleneck pressure


class Scheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.placer = Placer(
            cfg.n_pool_devices,
            policy=cfg.placement or policy_for_interleave(cfg.interleave),
            capacity_bytes=cfg.pool_device_bytes,
            topology=cfg.topology)
        self.local_bytes = 0.0
        self.hbm_bytes = 0.0
        self._affinity_fn = None
        self._admit_fn = None
        # admission policy (serving/policy/admission.py): the shared
        # arrival gate + queue ordering + shedding object — the same
        # classes the engine and the analytic replay construct
        self.admission: AdmissionPolicy = FCFSAdmission()
        # requests dropped by load shedding (EDF): removed from the
        # queue before admission, never dispatched
        self.shed_log: List[Request] = []
        # PR 6 dedup accounting: per-request booked bytes returned early
        # (refcount-shared with the cache) and the cumulative bytes ever
        # booked net of those shrinks — the simulator's pool-bytes-per-
        # request numerator, mirroring SACSystem.booked_pages_cum
        self._shrunk: Dict[int, float] = {}
        self.booked_bytes_cum = 0.0

    def set_pressure_fn(self, fn) -> None:
        """Attach the live per-device link-pressure feed consumed by the
        ``pressure_aware`` placement policy (core/placement.py) — the
        simulator wires its per-step analytic demand seconds in here, the
        same signal the engine feeds its own placer."""
        self.placer.set_pressure_fn(fn)

    def note_pressure_update(self) -> None:
        """Mark the pressure feed re-measured (once per simulated step)."""
        self.placer.note_pressure_update()

    def set_affinity_fn(self, fn) -> None:
        """Attach the radix-affinity resolver consumed at admission:
        ``fn(req) -> Optional[(device, saved_seconds)]`` — the device
        holding the request's cached prefix and the prefill/write
        seconds reuse there would save (the ``radix_affinity`` placement
        input, core/placement.py).  The simulator wires its analytic
        prefix cache in here; the engine threads its real RadixIndex
        match through ``SACSystem.place`` directly."""
        self._affinity_fn = fn

    def set_admit_fn(self, fn) -> None:
        """Callback invoked right after EACH successful placement inside
        ``try_admit`` (before the next request is placed).  The
        simulator's analytic radix twin registers a new prefix group
        here, so requests later in the same admission wave can already
        hit it — matching the engine, whose slot fills interleave
        insert with placement."""
        self._admit_fn = fn

    def set_admission_policy(self, policy: AdmissionPolicy) -> None:
        """Install the shared admission policy consumed by
        ``try_admit`` (arrival gate, queue ordering, load shedding) —
        the identical object family the engine wires into its
        ``_fill_slots``, so parity holds at the class level."""
        self.admission = policy

    def set_reuse_fn(self, fn) -> None:
        """Attach the radix-admission scorer ``fn(req) -> float`` (the
        request's expected prefix reuse, e.g. its page-granular match
        length against the current tree).  When set, ``try_admit``
        stable-sorts the wait queue by descending score each wave —
        requests sharing a hot prefix land together; ties keep FCFS
        order.  None restores pure FCFS.  Back-compat wrapper over
        :meth:`set_admission_policy`."""
        self.admission = (FCFSAdmission() if fn is None
                          else RadixAdmission(fn))

    def shrink_booking(self, req: Request, n_bytes: float) -> float:
        """Return part of an ACTIVE request's booking early (PR 6 page
        dedup twin: the matched prefix's bytes are refcount-shared with
        the cache, not privately held).  Shrinks the placer booking and
        the local/HBM tallies now, and remembers the amount so
        ``finish`` doesn't subtract it a second time.  Returns the
        bytes actually shrunk."""
        if req.request_id not in self.active or n_bytes <= 0:
            return 0.0
        got, _ = self.placer.shrink(req.request_id, n_bytes=n_bytes)
        if got:
            self._shrunk[req.request_id] = \
                self._shrunk.get(req.request_id, 0.0) + got
            self.local_bytes = max(0.0, self.local_bytes - got)
            self.hbm_bytes = max(0.0, self.hbm_bytes - got)
            self.booked_bytes_cum -= got
        return got

    def note_departure(self, device: int, seconds: float) -> None:
        """Forward a finished request's measured demand share to the
        placer's pressure-keyed policies (core/placement.py)."""
        if 0 <= device < self.cfg.n_pool_devices:
            self.placer.note_departure(device, seconds)

    # -- queueing --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _kv_bytes(self, req: Request) -> float:
        return (req.context_len + req.output_len) * self.cfg.bytes_per_token

    def try_admit(self, now_s: float) -> List[Request]:
        """Admit queued requests while resources allow, in the order the
        shared admission policy dictates (FCFS by default, descending
        expected reuse under radix admission, earliest deadline under
        EDF — the stable sort means the policy can only ever PROMOTE,
        never starve FCFS ties).  EDF load shedding drops the arrived
        backlog beyond ``shed_queue_depth`` onto ``shed_log`` first."""
        admitted = []
        drop = self.admission.shed(list(self.queue), now_s)
        if drop:
            q = list(self.queue)
            for i in reversed(drop):
                self.shed_log.append(q.pop(i))
            self.queue = deque(q)
        if len(self.queue) > 1:
            self.queue = deque(self.admission.order(list(self.queue)))
        while self.queue and len(self.active) < self.cfg.concurrency:
            req = self.queue[0]
            if not self.admission.arrived(req, now_s):
                # the arrival gate (PR 8) now lives ONCE in the shared
                # policy: simulate() only submits arrived requests, but
                # a caller driving try_admit directly must never see a
                # dispatch before arrival — the open-loop bug the
                # engine's _fill_slots had
                break
            need = self._kv_bytes(req)
            if self.local_bytes + need > self.cfg.local_dram_bytes:
                break                      # RDMA local-memory wall (P2)
            if self.hbm_bytes + need > self.cfg.hbm_kv_bytes:
                break                      # HBM capacity wall (fig 12)
            hint = (self._affinity_fn(req) if self._affinity_fn is not None
                    else None)
            aff_dev, aff_s = hint if hint is not None else (None, 0.0)
            dev = self.placer.place(req.request_id, n_bytes=need,
                                    affinity=aff_dev, affinity_s=aff_s)
            if dev is None:
                break                      # pool exhausted
            self.queue.popleft()
            req.pool_device = dev
            req.dispatch_s = now_s
            self.local_bytes += need
            self.hbm_bytes += need
            self.booked_bytes_cum += need
            self.active[req.request_id] = req
            admitted.append(req)
            if self._admit_fn is not None:
                self._admit_fn(req)
        return admitted

    def finish(self, req: Request) -> None:
        """Idempotent: a double finish (or a finish of a never-admitted
        request) must not decrement the byte accounting below truth or
        double-release the placer — guard on the active-table pop (the
        pre-PR 5 version unconditionally subtracted, so one duplicate
        finish corrupted ``local_bytes``/``hbm_bytes`` forever)."""
        if self.active.pop(req.request_id, None) is None:
            return
        # a dedup-shrunk booking already returned part of its bytes
        # (shrink_booking); subtracting the full need again would drive
        # the tallies below truth — the PR 6 half of the idempotence fix
        need = self._kv_bytes(req) - self._shrunk.pop(req.request_id, 0.0)
        self.placer.release(req.request_id)
        self.local_bytes = max(0.0, self.local_bytes - need)
        self.hbm_bytes = max(0.0, self.hbm_bytes - need)

    # -- introspection ----------------------------------------------------------
    @property
    def device_bytes(self) -> List[float]:
        return list(self.placer.bytes_used)

    def device_loads(self) -> List[int]:
        return self.placer.device_loads()

    def max_imbalance(self) -> int:
        return self.placer.max_imbalance()
