"""Hot-prefix replication trigger (PR 6) — the shared decision behind
``Engine._maybe_replicate`` and the simulator's twin of the same name.

The policy answers two questions and nothing else: WHICH links a copy
should flow between (:meth:`ReplicationPolicy.pick`) and WHETHER the
copy pays for itself (:meth:`ReplicationPolicy.should_fire`).  Both
layers keep their own side effects — the engine moves real pool pages
through ``SACSystem.replicate_prefix``, the simulator charges analytic
copy traffic — but the trigger arithmetic lives once, here:

  - source = the least-pressured copy-holding link (the cheapest link
    the prefix can already be read from);
  - destination = the least-pressured copy-free link, ties broken on
    booked bytes then device id (a bare min() would funnel every
    group's first copy onto device 0 at cold start);
  - fire only when the reuse benefit itself covers the one-time copy
    cost, the source link is at least as pressured as the destination
    (never copy toward a hotter link), and the source's per-step
    backlog amortizes the copy within ``horizon_steps`` decode steps
    (a lightly-loaded fabric must not replicate for nothing).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

# SACConfig knobs routed exclusively through this policy object
# (sacheck twin-coverage: no same-named SimConfig twin required)
CONSUMED_KNOBS = ("replicate_horizon_steps",)


@dataclasses.dataclass(frozen=True)
class ReplicationPolicy:
    """Pure trigger: consumers pass pressure/booking views in, get the
    (src, dst) pair and the fire/hold verdict out."""

    horizon_steps: int = 64

    def pick(self, pressure: Sequence[float], holders: List[int],
             others: List[int], bytes_used: Sequence[float]
             ) -> Optional[Tuple[int, int]]:
        """(source, destination) devices for a prospective copy, or
        None when no copy is possible (every link already holds one,
        or none does)."""
        if not holders or not others:
            return None
        src = min(holders, key=lambda d: pressure[d])
        dst = min(others, key=lambda d: (pressure[d], bytes_used[d], d))
        return src, dst

    def should_fire(self, p_src: float, p_dst: float, bonus_s: float,
                    copy_cost_s: float) -> bool:
        """True when the copy pays for itself within the horizon."""
        horizon = max(int(self.horizon_steps), 1)
        return not (bonus_s < copy_cost_s or p_src < p_dst
                    or p_src * horizon <= copy_cost_s)
