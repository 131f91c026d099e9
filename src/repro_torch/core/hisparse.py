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

The fetch pipeline inserts without reading (``warm_insert``, and
``warm_lane`` for one request lane of the layered buffer), and the
engine re-apportions the layers' capacities online (``resize_layers``),
with the same integer semantics.

Entries of the fp8 pool (``float8_e4m3fn``) move through the row
gathers, scatters and copies as raw integers (``_raw``): pairs of bytes
as ``int16`` where a row has an even width (every served one), so that
PyTorch's kernels move them at the 2-byte rate of bf16 rows; bit for
bit the same, and PyTorch on the CPU has no gather or scatter for
float8.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pool import to_kv_dtype

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


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte float tensor (the fp8 hot tier) as raw integers: int16
    pairs of bytes when its rows have an even width (the last dim
    halves), else uint8; any other tensor as it is."""
    if t.is_floating_point() and t.element_size() == 1:
        return t.view(torch.int16 if t.shape[-1] % 2 == 0 else torch.uint8)
    return t


def store(dst: BufferState, src: BufferState) -> None:
    """Copy ``src`` into ``dst`` (a layer's or a lane's views of a
    layered buffer) IN PLACE, fp8 entries through their raw view."""
    for full, part in zip(dst, src):
        _raw(full).copy_(_raw(part))


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


def _first_wanted(idx, want, S):
    """Keep only the first wanted occurrence of each position in idx
    [B, k]: a first-occurrence scatter-min over ``S + 1`` columns, with
    column ``S`` the sink of the unwanted lanes."""
    B, k = idx.shape
    order = torch.arange(k, dtype=torch.int32, device=idx.device).expand(B, k)
    idx_dedup = torch.where(want, idx, S)
    first_occ = torch.full((B, S + 1), k, dtype=torch.int32,
                           device=idx.device) \
        .scatter_reduce(1, idx_dedup, order, "amin", include_self=True)
    return want & (first_occ.gather(1, idx_dedup) == order)


def _assign_slots(last_use, empty, disabled, prot, want, n_free):
    """Victim slot for each wanted lane; ``buf`` (the sink) for the rest.

    Eviction order: empty slots first, then LRU, ``prot`` second-to-last,
    DISABLED strictly last.  The r-th wanted lane takes the r-th victim
    while ``r < n_free`` [B].  Returns (fill [B, k], assign [B, k]).
    """
    B, buf = last_use.shape
    ar = torch.arange(buf, dtype=torch.int32, device=last_use.device) \
        .expand(B, buf)
    key = torch.where(empty, ar - _BIG,
                      torch.where(disabled, _BIG,
                                  torch.where(prot, _BIG - 1, last_use)))
    victim_order = torch.argsort(key, dim=1, stable=True)      # [B, buf]
    rank = torch.cumsum(want.to(torch.int32), dim=1) - 1       # [B, k]
    fill = want & (rank < n_free[:, None])
    assign = torch.where(
        fill, victim_order.gather(1, torch.clamp(rank, 0, buf - 1).long()),
        buf)
    return fill, assign


def _write_slots(entries, slot_pos, page_table, last_use, clock, idx, vals,
                 fill, assign, touched):
    """Write the filled lanes into their slots: unmap the evicted
    positions, map the new ones, store ``vals`` and stamp ``clock`` on
    the ``touched`` slots.  Column ``S`` / column ``buf`` of the padded
    copies are the write sinks of the other lanes."""
    B, buf = slot_pos.shape
    k = idx.shape[1]
    S = page_table.shape[1]
    pt = _pad(page_table, EMPTY)
    sp = _pad(slot_pos, EMPTY)
    old_pos = sp.gather(1, assign)                             # evicted pos
    pt.scatter_(1, torch.where(old_pos >= 0, old_pos, S).long(), EMPTY)
    pt.scatter_(1, torch.where(fill, idx, S), assign.to(torch.int32))
    sp.scatter_(1, assign, torch.where(fill, idx, EMPTY).to(torch.int32))

    ent = _pad(_raw(entries), 0)
    ent.scatter_(1, assign[..., None].expand(B, k, ent.shape[-1]),
                 _raw(to_kv_dtype(vals, entries.dtype)))

    lu = _pad(last_use, 0)
    lu.scatter_(1, touched, clock[:, None].expand(B, k).contiguous())
    return (ent[:, :buf].view(entries.dtype), sp[:, :buf], pt[:, :S],
            lu[:, :buf])


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
    S = page_table.shape[1]
    idx = idx.long()

    slots = page_table.gather(1, idx)                          # [B, k]
    hit = (slots >= 0) & valid
    miss = _first_wanted(idx, (~hit) & valid, S)

    # the current hits are protected; DISABLED slots are never assigned
    prot = torch.zeros_like(slot_pos) \
        .scatter_reduce(1, torch.where(hit, slots, buf - 1).long(),
                        hit.to(torch.int32), "amax", include_self=True) \
        .bool()
    empty = slot_pos == EMPTY
    disabled = slot_pos == DISABLED
    n_slots = buf - disabled.sum(1, dtype=torch.int32)         # [B]
    fillable, assign = _assign_slots(last_use, empty, disabled, prot, miss,
                                     n_slots)

    touched = torch.where(hit, slots.long(), assign)           # in [0, buf]
    entries, slot_pos, page_table, last_use = _write_slots(
        entries, slot_pos, page_table, last_use, clock, idx, fetched,
        fillable, assign, touched)

    # prefetch accounting: a demand hit on a prefetched slot consumes its
    # flag (once per slot); demand fills clear any stale flag
    hit_mask = torch.zeros((B, buf + 1), dtype=torch.int32,
                           device=idx.device) \
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
    ent = _raw(state.entries)
    buffered = ent.gather(
        1, torch.clamp(slots, 0, ent.shape[1] - 1).long()[..., None].expand(
            -1, -1, ent.shape[2])).view(state.entries.dtype).to(fetched.dtype)
    vals = torch.where((hit & valid)[..., None], _raw(buffered),
                       _raw(fetched)).view(fetched.dtype)
    new_state, hits, misses = swap_in(state, idx, fetched, valid)
    return vals, new_state, hits, misses


# ---------------------------------------------------------------------------
# warm inserts (fetch pipeline: speculative prefetch + prefill warm-up)
# ---------------------------------------------------------------------------


def _warm_insert(entries, slot_pos, page_table, last_use, clock, pf_flag,
                 idx, vals, valid):
    """Batched warm insert: the reference's ``_warm_insert_one`` with
    the batch written out.

    Insert-without-read: resident positions are skipped (no hit, no
    recency bump), and the step's working set (slots with ``last_use >=
    clock``: this step's hits, demand fills and earlier warm inserts) is
    never evicted.  Inserted slots get the current clock.  Returns the
    new fields and the inserted count per request.
    """
    buf = slot_pos.shape[1]
    S = page_table.shape[1]
    idx = idx.long()

    resident = page_table.gather(1, idx) >= 0
    want = _first_wanted(idx, valid & ~resident, S)

    empty = slot_pos == EMPTY
    disabled = slot_pos == DISABLED
    prot = (last_use >= clock[:, None]) & ~empty & ~disabled
    avail = (buf - prot.sum(1, dtype=torch.int32)              # evictable
             - disabled.sum(1, dtype=torch.int32))
    fill, assign = _assign_slots(last_use, empty, disabled, prot, want,
                                 avail)

    entries, slot_pos, page_table, last_use = _write_slots(
        entries, slot_pos, page_table, last_use, clock, idx, vals, fill,
        assign, assign)

    pf = _pad(pf_flag, False)
    pf.scatter_(1, assign, fill)
    pf_flag = pf[:, :buf]

    return (entries, slot_pos, page_table, last_use, pf_flag,
            fill.sum(1, dtype=torch.int32))


def warm_insert(state: BufferState, idx: torch.Tensor, vals: torch.Tensor,
                valid: torch.Tensor) -> Tuple[BufferState, torch.Tensor]:
    """Batched warm insert.  idx: [B, w]; vals: [B, w, d]; valid: [B, w].

    Inserts pool values into the hot tier WITHOUT serving a read: no
    hit/miss is counted, the step's hits are never evicted, resident
    positions are skipped.  Returns (state', inserted [B]); ``state`` is
    not modified, and ``pf_inserted`` advances by ``inserted``.
    """
    (entries, slot_pos, page_table, last_use, pf_flag, ins) = _warm_insert(
        state.entries, state.slot_pos, state.page_table, state.last_use,
        state.clock, state.pf_flag, idx, vals, valid)
    return (BufferState(entries, slot_pos, page_table, last_use,
                        state.clock, pf_flag, state.pf_inserted + ins,
                        state.pf_used),
            ins)


def warm_lane(state: BufferState, lane: int, idx: torch.Tensor,
              vals: torch.Tensor, valid: torch.Tensor
              ) -> Tuple[BufferState, torch.Tensor]:
    """Warm-insert into one request lane of a layered buffer, IN PLACE.

    state: layered ([L, B, ...]); idx: [L, w]; vals: [L, w, d]; valid:
    [L, w].  The lane's per-layer slices form the batched layout (L
    plays the batch axis), so this is ``warm_insert`` over layers.
    Returns (state, total entries inserted): the prefill warm-up path.
    """
    view = BufferState(*(t[:, lane] for t in state))
    sub, ins = warm_insert(view, idx, vals, valid)
    store(view, sub)
    return state, ins.sum()


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


def resize_layers(state: BufferState, sizes: Sequence[int]) -> BufferState:
    """Re-apportion a layered buffer's per-layer capacities IN PLACE and
    return it.

    state: layered ([L, B, buf_max, ...]); sizes: [L] new per-layer slot
    budgets (each <= buf_max, the allocation width).  Layer ``l`` keeps
    its first ``sizes[l]`` slots enabled and the rest DISABLED: entries
    displaced by a shrink are evicted (their positions unmapped, so the
    next demand read is an honest miss); slots enabled in both layouts
    keep their entries, clocks and prefetch flags; the cumulative
    ``pf_inserted`` / ``pf_used`` counters are kept.
    """
    L, B, buf_max = state.slot_pos.shape
    S = state.page_table.shape[2]
    sz = np.asarray([int(s) for s in sizes], np.int32)
    if sz.shape != (L,) or sz.max(initial=0) > buf_max \
            or sz.min(initial=1) < 0:
        raise ValueError(f"resize_layers: {L} sizes in [0, {buf_max}] "
                         f"wanted, got {list(sizes)}")
    dev = state.slot_pos.device
    enabled = (torch.arange(buf_max, device=dev)[None, :]
               < torch.from_numpy(sz).to(dev)[:, None])       # [L, buf]
    enabled = enabled[:, None, :].expand(L, B, buf_max)
    slot_pos = state.slot_pos
    displaced = ~enabled & (slot_pos >= 0)
    pt = _pad(state.page_table.view(L * B, S), EMPTY)
    pt.scatter_(1, torch.where(displaced, slot_pos, S).view(L * B, buf_max)
                .long(), EMPTY)
    state.page_table.copy_(pt[:, :S].view(L, B, S))
    slot_pos.copy_(torch.where(~enabled, DISABLED,
                               torch.where(slot_pos == DISABLED, EMPTY,
                                           slot_pos)).to(torch.int32))
    state.last_use.masked_fill_(~enabled, 0)
    state.pf_flag.logical_and_(enabled)
    return state


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
