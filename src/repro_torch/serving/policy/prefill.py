"""Prefill schedule selection (PR 8): monolithic vs chunked vs
disaggregated — the shared decision behind the engine's
``_fill_slots`` dispatch, the simulator's ``colocated_prefill`` /
``round1`` branches, and the replay's ``fill()``.

The knob precedence and the chunk arithmetic are the policy; the job
state machines (splice timing, lane clocks, handoff adoption) stay
with each consumer, because they ARE the execution substrate being
timed.  Disaggregation wins over chunking — disagg lanes never block
decode, so a chunk size is meaningless there (the engine has always
ignored it) — and ``chunk_take`` floors nothing: a non-positive chunk
size means "the whole remainder in one piece", which is exactly the
monolithic schedule, so the chunked path with a huge chunk reduces
bit-identically to the monolithic one.
"""
from __future__ import annotations

import dataclasses

# SACConfig knobs routed exclusively through this policy object
# (sacheck twin-coverage: the simulator consumes the SAME schedule
# object, so no same-named SimConfig twin is required)
CONSUMED_KNOBS = ("prefill_chunk_tokens", "disagg_prefill",
                  "prefill_lanes")

MONOLITHIC = "monolithic"
CHUNKED = "chunked"
DISAGG = "disagg"


@dataclasses.dataclass(frozen=True)
class PrefillSchedule:
    """One prefill schedule: ``mode`` plus the knobs that mode reads."""

    mode: str = MONOLITHIC
    chunk_tokens: int = 0
    lanes: int = 1

    @staticmethod
    def from_knobs(disagg: bool, chunk_tokens: int,
                   lanes: int) -> "PrefillSchedule":
        """Knob precedence shared by every consumer: disaggregation
        wins, then chunking, else monolithic."""
        if disagg:
            return PrefillSchedule(DISAGG, 0, max(1, int(lanes)))
        if int(chunk_tokens) > 0:
            return PrefillSchedule(CHUNKED, int(chunk_tokens), 1)
        return PrefillSchedule(MONOLITHIC, 0, 1)

    @property
    def disagg(self) -> bool:
        return self.mode == DISAGG

    @property
    def chunked(self) -> bool:
        return self.mode == CHUNKED

    def chunk_take(self, left: int) -> int:
        """Tokens the next chunk advances given ``left`` remaining —
        the whole remainder when chunking is off."""
        return left if self.chunk_tokens <= 0 else min(self.chunk_tokens,
                                                       left)
