"""The radix locality bonus — seconds a same-device prefix hit saves —
shared by ``Engine._locality_bonus_s`` and the simulator's ``_bonus_s``.

The FORMULA is the policy: matched tokens save their marginal prefill
compute (``prefill_s(n) - prefill_s(n - matched)``) plus their skipped
pool write.  Each layer binds its own cost callables — the engine's
write cost is the fabric's bulk-transfer time over its real entry
bytes, the simulator's is the analytic striped-pool write bandwidth —
so the two sides keep their native units while the decision (what
counts as the bonus, and that ``matched <= 0`` is worth exactly 0)
cannot drift apart again.  The bonus is the ``affinity_s`` weight the
``radix_affinity`` placement policy (core/placement.py) holds against
live link pressure, and the benefit side of the replication trigger.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# no SACConfig knob is routed through this module; the tuple exists so
# the sacheck twin-coverage pass can treat every policy module uniformly
CONSUMED_KNOBS = ()


@dataclasses.dataclass(frozen=True)
class LocalityBonus:
    """``prefill_s(tokens) -> seconds`` and ``write_s(tokens) ->
    seconds`` are bound by the consumer; the call is the shared
    formula."""

    prefill_s: Callable[[int], float]
    write_s: Callable[[int], float]

    def __call__(self, prompt_len: int, matched: int) -> float:
        if matched <= 0:
            return 0.0
        return (self.prefill_s(prompt_len)
                - self.prefill_s(prompt_len - matched)
                + self.write_s(matched))
