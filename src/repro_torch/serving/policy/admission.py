"""Admission control: the arrival gate, queue ordering, and load
shedding — ONE implementation for the engine, the simulator's
``Scheduler``, and the analytic replay.

Before this package the decision lived three times: the engine's
``_eligible_indices``/``_pick_queue_index`` pair, the scheduler's
defensive arrival gate + ``set_reuse_fn`` wave sort, and the replay's
``eligible()``.  Each policy object below is pure — it reads a queue
and a clock and returns indices; popping, placement, and accounting
stay with the caller — so all three layers consume the identical code
and parity tests can assert object identity instead of float
agreement.

Policies:

  - :class:`FCFSAdmission` — submission order (the default);
  - :class:`RadixAdmission` — longest page-granular prefix match
    first, FCFS tie-break (PR 6 radix-aware admission);
  - :class:`EDFAdmission` — earliest deadline (``arrival_s +
    slo_ttft_s``) first, with optional load shedding when the arrived
    backlog exceeds ``shed_queue_depth`` (the PR 8 residue item:
    SLO-aware admission, landed once here for all three consumers).

Admission choice changes timing and traffic only — never decoded
tokens (property-tested in tests/test_policy.py): prefill always
recomputes the full prompt in-graph, so the order requests enter
slots cannot alter any request's own stream.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

# the ONE arrival-gate epsilon (engine clock, scheduler gate, replay):
# a request is eligible when arrival_s <= clock_s + ARRIVAL_EPS
ARRIVAL_EPS = 1e-12

# SACConfig knobs routed exclusively through this module (read by
# sacheck's twin-coverage pass: a knob consumed here needs no
# same-named SimConfig twin — this IS the shared implementation)
CONSUMED_KNOBS = ("admission", "shed_queue_depth", "slo_ttft_s",
                  "radix_admission")


def arrived(req, clock_s: float) -> bool:
    """The single source of truth for the arrival gate (PR 8): no
    request may be dispatched before its ``arrival_s`` on the caller's
    clock, open-loop traces included."""
    return req.arrival_s <= clock_s + ARRIVAL_EPS


class AdmissionPolicy:
    """Base policy: FCFS semantics, no shedding.  Subclasses override
    ``sort_key`` (and optionally ``shed``); ``eligible``/``select``/
    ``order`` are shared plumbing.

    ``select`` picks ONE index among the arrived requests (the
    engine's per-slot pop); ``order`` re-orders a whole wait queue
    (the scheduler's admission wave).  Both derive from the same
    ``sort_key``, so a policy cannot drift between its two call
    sites."""

    name = "fcfs"

    def sort_key(self, req, pos: int, score: float) -> Tuple:
        return (pos,)

    # -- scoring (radix reuse); the base policy ignores scores --------
    def score(self, req) -> float:
        return 0.0

    def needs_scores(self) -> bool:
        return False

    # -- the three verbs ----------------------------------------------
    def eligible(self, queue: Sequence, clock_s: float) -> List[int]:
        """Indices of ARRIVED requests, in queue order."""
        return [i for i, r in enumerate(queue) if arrived(r, clock_s)]

    def arrived(self, req, clock_s: float) -> bool:
        return arrived(req, clock_s)

    def select(self, queue: Sequence, eligible: List[int]) -> int:
        """The queue index to admit next among ``eligible``.  Ties
        break FCFS (lowest queue position) by construction of every
        ``sort_key``; a trivial choice short-circuits so no scorer
        runs when the answer cannot depend on it."""
        if len(eligible) <= 1 or not self.needs_scores():
            return eligible[0]
        return min(eligible,
                   key=lambda i: self.sort_key(queue[i], i,
                                               self.score(queue[i])))

    def order(self, queue: Sequence) -> List:
        """The whole wait queue re-ordered for an admission wave
        (stable: equal keys keep submission order)."""
        if len(queue) <= 1:
            return list(queue)
        ordered = sorted(enumerate(queue),
                         key=lambda p: self.sort_key(p[1], p[0],
                                                     self.score(p[1])))
        return [r for _, r in ordered]

    def shed(self, queue: Sequence, clock_s: float) -> List[int]:
        """Queue indices to drop before admission (load shedding).
        The base policies never shed."""
        return []


class FCFSAdmission(AdmissionPolicy):
    """Strict submission order — the pre-PR 6 default."""

    name = "fcfs"

    def order(self, queue: Sequence) -> List:
        return list(queue)


class RadixAdmission(AdmissionPolicy):
    """Longest page-granular prefix match against the current radix
    tree goes first; FCFS breaks ties (PR 6).  ``score_fn`` is bound
    by the consumer — the engine wires its real ``RadixIndex.match``,
    the simulator its analytic prefix-cache lookup — so the ORDERING
    decision is shared while the score source stays layer-native."""

    name = "radix"

    def __init__(self, score_fn: Optional[Callable] = None):
        self.score_fn = score_fn

    def sort_key(self, req, pos: int, score: float) -> Tuple:
        return (-score, pos)

    def score(self, req) -> float:
        return float(self.score_fn(req)) if self.score_fn is not None \
            else 0.0

    def needs_scores(self) -> bool:
        return self.score_fn is not None


class EDFAdmission(AdmissionPolicy):
    """Earliest-deadline-first against the TTFT SLO (the PR 8 residue
    item).  A request's deadline is ``arrival_s + slo_ttft_s``; with a
    uniform SLO this re-orders by arrival time (which differs from
    FCFS whenever requeues or out-of-order submission perturb queue
    positions) and, more importantly, gives shedding a principled
    victim order.

    ``shed_queue_depth > 0`` turns on load shedding: whenever more
    than that many ARRIVED requests are waiting, the arrived backlog
    beyond the ``shed_queue_depth`` earliest-deadline requests is
    dropped (deterministically — latest deadlines first).  Shed
    requests never decode; they simply leave the queue, so a saturated
    system keeps its admitted requests' deadlines reachable instead of
    missing everyone's."""

    name = "edf"

    def __init__(self, slo_ttft_s: float = 0.0,
                 shed_queue_depth: int = 0):
        self.slo_ttft_s = float(slo_ttft_s)
        self.shed_queue_depth = int(shed_queue_depth)

    def deadline(self, req) -> float:
        return req.arrival_s + self.slo_ttft_s

    def sort_key(self, req, pos: int, score: float) -> Tuple:
        return (self.deadline(req), pos)

    def needs_scores(self) -> bool:
        # deadlines come from the request itself, but select() must
        # still rank (not just take eligible[0])
        return True

    def score(self, req) -> float:
        return 0.0

    def shed(self, queue: Sequence, clock_s: float) -> List[int]:
        if self.shed_queue_depth <= 0:
            return []
        waiting = [i for i, r in enumerate(queue)
                   if arrived(r, clock_s)]
        if len(waiting) <= self.shed_queue_depth:
            return []
        keep = sorted(waiting,
                      key=lambda i: (self.deadline(queue[i]), i))
        return sorted(keep[self.shed_queue_depth:])


def make_admission(name: Optional[str], *, radix_admission: bool = False,
                   slo_ttft_s: float = 0.0, shed_queue_depth: int = 0,
                   score_fn: Optional[Callable] = None,
                   has_radix: bool = True) -> AdmissionPolicy:
    """The one factory all three consumers construct through.

    ``name=None`` keeps the legacy mapping: ``radix`` when the PR 6
    ``radix_admission`` knob is on (and a radix cache exists to score
    against), else ``fcfs``.  ``radix`` without a cache degrades to
    FCFS — the same gating the engine's ``admission_on`` always had.
    """
    if name is None:
        name = "radix" if radix_admission else "fcfs"
    if name == "radix" and (not has_radix or score_fn is None):
        name = "fcfs"
    if name == "fcfs":
        return FCFSAdmission()
    if name == "radix":
        return RadixAdmission(score_fn)
    if name == "edf":
        return EDFAdmission(slo_ttft_s=slo_ttft_s,
                            shed_queue_depth=shed_queue_depth)
    raise ValueError(f"unknown admission policy {name!r} "
                     "(expected fcfs | radix | edf)")
