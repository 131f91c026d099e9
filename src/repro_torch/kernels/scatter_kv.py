"""In-place KV row writes on the card (``repro/kernels/scatter_kv.py``).

Three forms of ``csrc/scatter_kv.cu``, each with its plain version in
``kernels/ref.py``:

- ``scatter_kv``: rows at given indices (``ref.scatter_kv_ref``), the
  TPU kernel's own form, which no path of the port calls (the two forms
  below took its place); kept as the TPU kernel's tested counterpart;
- ``write_rows_at``: the decode write, one entry per (layer, request) at
  the request's position, the rows computed in the kernel, several pools
  in one launch (``ref.write_rows_at_ref``);
- ``splice``: a prompt's contiguous rows of every layer into one lane
  (or every lane), optionally zeroing the rest of the lane, several pools
  in one launch (``ref.splice_ref``).

The last two have shard forms, for a pool whose sequence axis is split
over ranks (each rank holds the slice [base, base + S_local)):
``write_rows_at_shard`` clamps the position into the whole pool and
writes the row only on the rank that owns it (``ref.write_rows_at_ref``
with ``base``); ``splice_shard`` copies a rank's slice of the prompt's
rows into its pool (``ref.splice_ref`` with ``src_row0``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gather_kv import MAX_SEGMENTS

#: kernel launches since the last reset, one counter per form (read by
#: chip_smoke.py)
launches = 0
launches_rows_at = 0
launches_rows_at_shard = 0
launches_splice = 0
launches_splice_shard = 0


def _check_pools(name: str, pools: Sequence[torch.Tensor],
                 srcs: Sequence[torch.Tensor], src_dim: int) -> None:
    if not 1 <= len(pools) <= MAX_SEGMENTS or len(srcs) != len(pools):
        raise ValueError(f"{name}: 1 to {MAX_SEGMENTS} pools, each with its "
                         f"source; got {len(pools)} and {len(srcs)}")
    for pool, src in zip(pools, srcs):
        _lib.require_dtype(name, src, pool.dtype, "the source")
        if pool.dim() != 4 or src.dim() != src_dim \
                or src.shape[-1] != pool.shape[-1]:
            raise ValueError(f"{name}: pool [L,B,S,d], got "
                             f"{tuple(pool.shape)} and source "
                             f"{tuple(src.shape)}")


def scatter_kv(pool: torch.Tensor, entries: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """pool: [B, S, d]; entries: [B, k, d] (pool dtype); idx: [B, k]
    int32, distinct rows per request.  Writes the rows IN PLACE and
    returns ``pool``; an index outside [0, S) is skipped."""
    global launches
    name = "scatter_kv"
    dev = _lib.require_cuda(name, pool, entries, idx)
    _lib.require_dtype(name, idx, torch.int32, "idx")
    _lib.require_dtype(name, entries, pool.dtype, "entries")
    if (pool.dim() != 3 or entries.dim() != 3 or idx.dim() != 2
            or entries.shape[0] != pool.shape[0]
            or entries.shape[2] != pool.shape[2]
            or tuple(idx.shape) != tuple(entries.shape[:2])):
        raise ValueError(f"{name}: pool [B,S,d], entries [B,k,d], idx "
                         f"[B,k]; got {tuple(pool.shape)}, "
                         f"{tuple(entries.shape)}, {tuple(idx.shape)}")
    B, S, d = pool.shape
    k = idx.shape[1]
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_scatter_kv(pool.data_ptr(), entries.data_ptr(),
                                       idx.data_ptr(), B, S, k,
                                       d * pool.element_size(),
                                       _lib.stream())
    _lib.check(rc, name)
    launches += 1
    return pool


def write_rows_at(pools: Sequence[torch.Tensor],
                  entries: Sequence[torch.Tensor], pos: torch.Tensor
                  ) -> None:
    """The decode write, IN PLACE, in one launch: for each pool [L, B, S,
    d] and its entries [L, B, d] (the pool's dtype), row (l, b) at
    position clamp(pos[b], 0, S-1) takes entries[l, b].  pos: [B]
    int32, shared by the pools."""
    global launches_rows_at
    _write("write_rows_at", pools, entries, pos, 0, None)
    launches_rows_at += 1


def write_rows_at_shard(pools: Sequence[torch.Tensor],
                        entries: Sequence[torch.Tensor], pos: torch.Tensor,
                        base: int, seq_len: int) -> None:
    """The shard form of ``write_rows_at``: each pool [L, B, S_local, d]
    is the slice [base, base + S_local) of a pool of ``seq_len``
    positions; row (l, b) goes to c - base, c = clamp(pos[b], 0,
    seq_len-1), when c lies in the slice, and nowhere otherwise."""
    global launches_rows_at_shard
    _write("write_rows_at_shard", pools, entries, pos, base, seq_len)
    launches_rows_at_shard += 1


def _write(name: str, pools, entries, pos, base: int,
           seq_len: Optional[int]) -> None:
    _check_pools(name, pools, entries, src_dim=3)
    dev = _lib.require_cuda(name, pos, *pools, *entries)
    _lib.require_dtype(name, pos, torch.int32, "pos")
    segs = (_lib.WriteSeg * len(pools))()
    for seg, pool, src in zip(segs, pools, entries):
        L, B, S, d = pool.shape
        if tuple(src.shape[:2]) != (L, B) or tuple(pos.shape) != (B,):
            raise ValueError(f"{name}: entries [L,B,d] and pos [B] for a "
                             f"pool {tuple(pool.shape)}; got "
                             f"{tuple(src.shape)} and {tuple(pos.shape)}")
        if seq_len is not None and not (0 <= base and base + S <= seq_len):
            raise ValueError(f"{name}: the slice [{base}, {base + S}) lies "
                             f"outside a pool of {seq_len} positions")
        seg.pool, seg.src = pool.data_ptr(), src.data_ptr()
        seg.L, seg.B, seg.S, seg.row_bytes = L, B, S, d * pool.element_size()
        seg.base, seg.S_glob = base, S if seq_len is None else seq_len
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_write_rows_at(segs, len(pools), pos.data_ptr(),
                                          _lib.stream())
    _lib.check(rc, name)


def splice(pools: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor], *,
           offset: int = 0, lane: Optional[int] = None,
           zero_tail: bool = False) -> None:
    """The prefill splice, IN PLACE, in one launch: for each pool [L, B,
    S, d] and its source [L, b, T, d] (the pool's dtype; b = B, or 1 with
    ``lane``), rows [offset, offset+T) of every layer of the lanes (all,
    or ``lane``) take the source's rows; with ``zero_tail`` rows
    [offset+T, S) of those lanes become zeros."""
    global launches_splice
    _splice("splice", pools, srcs, offset, lane, zero_tail, None)
    launches_splice += 1


def splice_shard(pools: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                 base: int) -> None:
    """The shard form of ``splice``: each pool [L, B, S_local, d] is the
    slice [base, base + S_local) of a pool, and each source [L, B, T, d]
    the prompts' whole rows (the pool's dtype).  Rows [0, n) of every
    (layer, lane) take the source's rows [base, base + n), n =
    clamp(T - base, 0, S_local), and rows [n, S_local) become zeros: the
    rank's slice of the prompts' rows padded with zeros.  One launch."""
    global launches_splice_shard
    if base < 0:
        raise ValueError(f"splice_shard: base {base} < 0")
    _splice("splice_shard", pools, srcs, 0, None, True, base)
    launches_splice_shard += 1


def _splice(name: str, pools, srcs, offset: int, lane: Optional[int],
            zero_tail: bool, src_row0: Optional[int]) -> None:
    """The splice of each source's rows [src_row0, src_row0 + T) (T the
    rows that are left, cut to the pool; None: all the source's rows)."""
    _check_pools(name, pools, srcs, src_dim=4)
    dev = _lib.require_cuda(name, *pools, *srcs)
    segs = (_lib.SpliceSeg * len(pools))()
    for seg, pool, src in zip(segs, pools, srcs):
        L, B, S, d = pool.shape
        src_rows = src.shape[2]
        T = (src_rows if src_row0 is None
             else min(max(src_rows - src_row0, 0), S - offset))
        n_lanes = B if lane is None else 1
        if (tuple(src.shape[:2]) != (L, n_lanes) or offset < 0
                or offset + T > S or not 0 <= (lane or 0) < B):
            raise ValueError(f"{name}: source {tuple(src.shape)} at rows "
                             f"[{offset}, {offset + T}) of lane {lane} does "
                             f"not fit a pool {tuple(pool.shape)}")
        seg.pool, seg.src = pool.data_ptr(), src.data_ptr()
        seg.L, seg.B, seg.S = L, B, S
        seg.lane0, seg.n_lanes = lane or 0, n_lanes
        seg.T, seg.offset, seg.zero_tail = T, offset, int(zero_tail)
        seg.row_bytes = d * pool.element_size()
        seg.src_rows, seg.src_row0 = src_rows, src_row0 or 0
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_splice_kv(segs, len(pools), _lib.stream())
    _lib.check(rc, name)
