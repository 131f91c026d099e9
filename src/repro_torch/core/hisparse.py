"""HiSparse hierarchical device buffer (``repro/core/hisparse.py``).

The decode instance keeps a small hot tier of KV entries per (layer,
request).  Each decode step's swap-in does, per request, the three
operations of the HiSparse kernel: miss identification (page-table
lookup), LRU eviction (empty slots first, never a current hit while an
unprotected slot is left, DISABLED slots never), and the page-table
update with the fetched data written in.  The batch is a written-out
dimension of every op (the reference vmaps one request).

Every integer field follows the reference exactly: scatters use a sink
row (index ``buf``/``S``) for inactive lanes, the LRU order is a stable
argsort, and the ``.at[].min/.max`` reductions are ``scatter_reduce``
with ``include_self``.  ``hits``/``misses`` drive the miss-only fabric
charging of the engine.

The fetch-pipeline parts (``warm_insert``, ``warm_lane``) and online
re-sizing (``resize_layers``) wait for the fetch-pipeline slice
(ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

EMPTY = -1
# a DISABLED slot belongs to no layer budget: never empty, never a
# victim, never assigned (per-layer sizes inside one static layout)
DISABLED = -2
_BIG = 1 << 30


class BufferState(NamedTuple):
    """Per-request hot-tier state (leading dims [B, ...], or [L, B, ...]
    for the layered buffer)."""
    entries: torch.Tensor      # [B, buf, d]   cached KV entries
    slot_pos: torch.Tensor     # [B, buf]      position held by slot (-1 empty)
    page_table: torch.Tensor   # [B, S]        position -> slot (-1 not resident)
    last_use: torch.Tensor     # [B, buf]      LRU clocks
    clock: torch.Tensor        # [B]           step counter
    pf_flag: torch.Tensor      # [B, buf]      slot prefetched, not yet used
    pf_inserted: torch.Tensor  # [B]           cumulative warm-inserted entries
    pf_used: torch.Tensor      # [B]           cumulative prefetched-then-hit


def init_buffer(batch: int, buf_size: int, seq_len: int, entry_dim: int,
                dtype=torch.bfloat16, device="cuda") -> BufferState:
    i32 = dict(dtype=torch.int32, device=device)
    return BufferState(
        entries=torch.zeros((batch, buf_size, entry_dim), dtype=dtype,
                            device=device),
        slot_pos=torch.full((batch, buf_size), EMPTY, **i32),
        page_table=torch.full((batch, seq_len), EMPTY, **i32),
        last_use=torch.zeros((batch, buf_size), **i32),
        clock=torch.zeros((batch,), **i32),
        pf_flag=torch.zeros((batch, buf_size), dtype=torch.bool,
                            device=device),
        pf_inserted=torch.zeros((batch,), **i32),
        pf_used=torch.zeros((batch,), **i32),
    )


def lookup(state: BufferState, idx: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which of idx [B, k] are resident?  -> (slots [B,k], hit [B,k])."""
    slots = state.page_table.gather(1, idx.long())
    return slots, slots >= 0


def _pad(t: torch.Tensor, value) -> torch.Tensor:
    """Append one sink column (row, for 3-d tensors) along axis 1."""
    shape = list(t.shape)
    shape[1] = 1
    return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                    device=t.device)], dim=1)


def _swap_in(entries, slot_pos, page_table, last_use, clock, pf_flag,
             idx, fetched, valid):
    """Batched swap-in: the reference's ``_swap_in_one`` with the batch
    written out.

    idx: [B, k] positions requested this step (always in [0, S));
    fetched: [B, k, d] pool values for all of them; valid: [B, k].
    If k > buf the overflow misses stay unbuffered; hit accounting is
    exact because reads happen before the swap-in.
    """
    B, buf = slot_pos.shape
    k = idx.shape[1]
    S = page_table.shape[1]
    dev = idx.device
    idx = idx.long()
    order = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k)

    slots = page_table.gather(1, idx)                          # [B, k]
    hit = (slots >= 0) & valid
    miss = (~hit) & valid
    # dedupe repeated positions: only the first VALID occurrence fills
    idx_dedup = torch.where(valid, idx, S)
    first_occ = torch.full((B, S + 1), k, dtype=torch.int32, device=dev) \
        .scatter_reduce(1, idx_dedup, order, "amin", include_self=True)
    miss = miss & (first_occ.gather(1, idx_dedup) == order)

    # eviction order: empty slots first, then LRU, protected (current
    # hits) second-to-last, DISABLED strictly last and never assigned
    prot = torch.zeros((B, buf), dtype=torch.int32, device=dev) \
        .scatter_reduce(1, torch.where(hit, slots, buf - 1).long(),
                        hit.to(torch.int32), "amax", include_self=True) \
        .bool()
    empty = slot_pos == EMPTY
    disabled = slot_pos == DISABLED
    ar = torch.arange(buf, dtype=torch.int32, device=dev).expand(B, buf)
    key = torch.where(empty, ar - _BIG,
                      torch.where(disabled, _BIG,
                                  torch.where(prot, _BIG - 1, last_use)))
    victim_order = torch.argsort(key, dim=1, stable=True)      # [B, buf]
    n_slots = buf - disabled.sum(1, dtype=torch.int32)         # [B]

    miss_rank = torch.cumsum(miss.to(torch.int32), dim=1) - 1  # [B, k]
    fillable = miss & (miss_rank < n_slots[:, None])
    assign = torch.where(
        fillable,
        victim_order.gather(1, torch.clamp(miss_rank, 0, buf - 1).long()),
        buf)                                                   # buf = sink

    # --- padded updates: column S / column buf are write sinks ---
    pt = _pad(page_table, EMPTY)
    sp = _pad(slot_pos, EMPTY)
    old_pos = sp.gather(1, assign)                             # evicted pos
    pt.scatter_(1, torch.where(old_pos >= 0, old_pos, S).long(), EMPTY)
    pt.scatter_(1, torch.where(fillable, idx, S),
                assign.to(torch.int32))
    page_table = pt[:, :S]

    sp.scatter_(1, assign,
                torch.where(fillable, idx, EMPTY).to(torch.int32))
    slot_pos = sp[:, :buf]

    ent = _pad(entries, 0)
    d = entries.shape[-1]
    ent.scatter_(1, assign[..., None].expand(B, k, d),
                 fetched.to(entries.dtype))
    entries = ent[:, :buf]

    touched = torch.where(hit, slots.long(), assign)           # in [0, buf]
    lu = _pad(last_use, 0)
    lu.scatter_(1, touched, clock[:, None].expand(B, k).contiguous())
    last_use = lu[:, :buf]

    # prefetch accounting: a demand hit on a prefetched slot consumes its
    # flag (once per slot); demand fills clear any stale flag
    hit_mask = torch.zeros((B, buf + 1), dtype=torch.int32, device=dev) \
        .scatter_reduce(1, torch.where(hit, slots.long(), buf),
                        hit.to(torch.int32), "amax",
                        include_self=True)[:, :buf].bool()
    pf_used = (pf_flag & hit_mask).sum(1, dtype=torch.int32)
    pf = _pad(pf_flag & ~hit_mask, False)
    pf.scatter_(1, assign, False)
    pf_flag = pf[:, :buf]

    return (entries, slot_pos, page_table, last_use, pf_flag, pf_used,
            hit.sum(1, dtype=torch.int32), miss.sum(1, dtype=torch.int32))


def swap_in(state: BufferState, idx: torch.Tensor, fetched: torch.Tensor,
            valid: torch.Tensor
            ) -> Tuple[BufferState, torch.Tensor, torch.Tensor]:
    """Batched swap-in.  idx: [B,k]; fetched: [B,k,d]; valid: [B,k].

    Returns (state', hits [B], misses [B]); ``state`` is not modified.
    """
    clock = state.clock + 1
    (entries, slot_pos, page_table, last_use, pf_flag, pf_used, hits,
     misses) = _swap_in(state.entries, state.slot_pos, state.page_table,
                        state.last_use, clock, state.pf_flag, idx, fetched,
                        valid)
    return (BufferState(entries, slot_pos, page_table, last_use, clock,
                        pf_flag, state.pf_inserted,
                        state.pf_used + pf_used),
            hits, misses)


def read_through(state: BufferState, idx: torch.Tensor,
                 fetched: torch.Tensor, valid: torch.Tensor):
    """Serve idx from the buffer where resident, else from ``fetched``
    (pool values), updating the buffer.  Returns (values [B,k,d], state',
    hits [B], misses [B]).  Values are bit-identical with or without the
    buffer: the hot tier changes traffic, never results."""
    slots, hit = lookup(state, idx)
    buf, d = state.entries.shape[1], state.entries.shape[2]
    buffered = state.entries.gather(
        1, torch.clamp(slots, 0, buf - 1).long()[..., None].expand(
            -1, -1, d))
    vals = torch.where((hit & valid)[..., None],
                       buffered.to(fetched.dtype), fetched)
    new_state, hits, misses = swap_in(state, idx, fetched, valid)
    return vals, new_state, hits, misses


# ---------------------------------------------------------------------------
# layered layout (serving engine: one buffer per pool layer)
# ---------------------------------------------------------------------------


def init_layered_buffer(n_layers: int, batch: int,
                        buf_size: Union[int, Sequence[int]],
                        seq_len: int, entry_dim: int,
                        dtype=torch.bfloat16,
                        buf_max: Union[int, None] = None,
                        device="cuda") -> BufferState:
    """Per-(layer, request) buffer stack: every field gains a leading
    [L] axis.  ``buf_size`` may be one size or a per-layer sequence: the
    allocation is ``max(sizes)`` wide (or ``buf_max``) and layer ``l``'s
    slots beyond ``sizes[l]`` are marked :data:`DISABLED`."""
    if isinstance(buf_size, (int, np.integer)):
        sizes = [int(buf_size)] * n_layers
    else:
        sizes = [int(s) for s in buf_size]
        assert len(sizes) == n_layers, (len(sizes), n_layers)
    if buf_max is None:
        buf_max = max(max(sizes), 1)
    else:
        buf_max = int(buf_max)
        assert buf_max >= max(max(sizes), 1), (buf_max, sizes)
    slot = np.arange(buf_max)[None, None, :]
    sz = np.asarray(sizes, np.int32)[:, None, None]
    slot_pos = torch.from_numpy(np.ascontiguousarray(
        np.where(np.broadcast_to(slot < sz, (n_layers, batch, buf_max)),
                 EMPTY, DISABLED).astype(np.int32))).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    return BufferState(
        entries=torch.zeros((n_layers, batch, buf_max, entry_dim),
                            dtype=dtype, device=device),
        slot_pos=slot_pos,
        page_table=torch.full((n_layers, batch, seq_len), EMPTY, **i32),
        last_use=torch.zeros((n_layers, batch, buf_max), **i32),
        clock=torch.zeros((n_layers, batch), **i32),
        pf_flag=torch.zeros((n_layers, batch, buf_max), dtype=torch.bool,
                            device=device),
        pf_inserted=torch.zeros((n_layers, batch), **i32),
        pf_used=torch.zeros((n_layers, batch), **i32),
    )


def reset_lane(state: BufferState, lane: int) -> BufferState:
    """Clear one request lane of a layered buffer ([L, B, ...]) IN PLACE
    and return it.  Entries need no clearing (unmapped slots are
    unreachable); DISABLED slots keep their marker."""
    lane_slots = state.slot_pos[:, lane]
    state.slot_pos[:, lane] = torch.where(lane_slots == DISABLED, DISABLED,
                                          EMPTY).to(torch.int32)
    state.page_table[:, lane] = EMPTY
    state.last_use[:, lane] = 0
    state.clock[:, lane] = 0
    state.pf_flag[:, lane] = False
    state.pf_inserted[:, lane] = 0
    state.pf_used[:, lane] = 0
    return state
