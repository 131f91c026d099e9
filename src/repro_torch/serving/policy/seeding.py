"""Warm-up pressure seeding (PR 7) and the placement pressure feed.

The problem both layers solve identically: before the FIRST decode
step the demand tracker has never observed, so the pressure feed is
silent exactly while wave-1 admissions are herding onto a hot prefix's
owner.  The fix — add the BOOKED prefill-write demand to the feed
during that window only — used to live twice: the engine's
``_last_demand_s`` property and the simulator's ``_pressure()``
closure over a ``warm_seed`` list and a ``_seed_on`` cell.

:class:`WarmupPressureSeed` is the shared window + accumulator;
:class:`PressureFeed` is the shared callable handed to
``set_pressure_fn`` on both sides (``Placer`` and ``BudgetArbiter``
read it), so the parity suite can assert the engine's and the
simulator's placers consume the same feed CLASS rather than re-deriving
float agreement.  The engine deactivates the seed right after its
first decode step's counter increment; the simulator right after its
first decode-step block — the same instant on each layer's own clock.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

# SACConfig knobs routed exclusively through this policy object
CONSUMED_KNOBS = ("warmup_pressure_seed",)


class WarmupPressureSeed:
    """The warm-up-only seeding window.

    ``note_admission`` accumulates booked seconds per control-plane
    slot (the simulator's analytic path); ``apply`` overlays either
    that accumulator or a caller-supplied booked snapshot (the
    engine's measured ``TrafficStats.segment_demand_s``) onto the base
    feed.  Inactive, ``apply`` returns the base list UNCHANGED (same
    object — consumers rely on the zero-copy fast path)."""

    def __init__(self, enabled: bool, n_slots: int):
        self.enabled = bool(enabled)
        self.active = self.enabled
        self.extra: List[float] = [0.0] * n_slots

    def note_admission(self, slots: Sequence[int], seconds: float) -> None:
        """Book one admission's prefill-write seconds along its route
        (no-op outside the seeding window)."""
        if not self.active:
            return
        for s in slots:
            self.extra[s] += seconds

    def deactivate(self) -> None:
        """The first decode step ends warm seeding (idempotent)."""
        self.active = False

    def apply(self, base: List[float],
              booked: Optional[Sequence[float]] = None) -> List[float]:
        if not self.active:
            return base
        overlay = self.extra if booked is None else booked
        return [b + x for b, x in zip(base, overlay)]


class PressureFeed:
    """The live per-segment pressure signal: last step's tracked demand
    seconds plus the warm-up seed while its window is open.  This is
    the ONE object wired into ``set_pressure_fn`` by the engine's
    ``SACSystem`` and the simulator's ``Scheduler`` alike."""

    def __init__(self, tracker, seed: WarmupPressureSeed,
                 booked_fn: Optional[Callable[[], Sequence[float]]] = None):
        self.tracker = tracker
        self.seed = seed
        self.booked_fn = booked_fn

    def __call__(self) -> List[float]:
        base = self.tracker.last_demand_s
        if not self.seed.active:
            return base
        booked = self.booked_fn() if self.booked_fn is not None else None
        return self.seed.apply(base, booked)
