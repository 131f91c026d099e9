"""Sparse KV row gather on the card (``repro/kernels/gather_kv.py``).

``gather_kv`` launches ``csrc/gather_kv.cu`` with the batch in the grid;
``gather_kv_many`` moves up to ``MAX_SEGMENTS`` (kv, idx) segments in one
launch (the decode step's demand set and speculation tail).  Plain
versions: ``kernels/ref.py::gather_kv_ref`` and ``gather_kv_many_ref``.
``gather_kv_shard`` is the shard form, for a pool whose sequence axis is
split over ranks: each kv is one rank's slice [base, base + S_local),
and a row outside it comes out as zeros (plain version
``ref.gather_kv_shard_ref``).
``gather_kv_pages`` is the page-granular form (whole pages of ``page``
consecutive rows, one block per page id), plain version
``ref.gather_kv_pages_ref``; no path of either package calls it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _lib, cost

#: kernel launches since the last reset, one counter per form (read by
#: chip_smoke.py); a launch of several segments counts once
launches = 0
launches_shard = 0
launches_pages = 0

#: segments one launch takes (csrc/rowmove.cuh kMaxSegs)
MAX_SEGMENTS = 4


def gather_kv(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv: [B, S, d] (any dtype); idx: [B, k] int32 -> [B, k, d].

    Indices are clamped into [0, S).  Bit-exact: rows are copied."""
    return gather_kv_many([(kv, idx)])[0]


def gather_kv_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> List[torch.Tensor]:
    """Each (kv [B, S, d], idx [B, k] int32) pair -> out [B, k, d], all in
    one launch (1 to ``MAX_SEGMENTS`` pairs; dtypes and shapes may
    differ)."""
    global launches
    outs, launched = _launch("gather_kv", pairs, None)
    launches += launched
    if cost.RECORDERS:
        cost.record("gather_kv.rows", cost.gather(pairs))
    return outs


def gather_kv_shard(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    base: int) -> List[torch.Tensor]:
    """The shard form of ``gather_kv_many``: each kv [B, S_local, d] is the
    slice [base, base + S_local) of a pool; idx [B, k] int32 holds global
    rows, and out[b, i] is kv[b, idx[b, i] - base] when that row lies in
    the slice, else zeros.  One launch for all the pairs."""
    global launches_shard
    if base < 0:
        raise ValueError(f"gather_kv_shard: base {base} < 0")
    outs, launched = _launch("gather_kv_shard", pairs, base)
    launches_shard += launched
    if cost.RECORDERS:
        cost.record("gather_kv.shard", cost.gather(pairs))
    return outs


def _launch(name: str, pairs, base: Optional[int]
            ) -> Tuple[List[torch.Tensor], bool]:
    """The gather's checks and outputs, and its launch unless the tensors
    lie on ``meta``; (outs, whether it launched)."""
    if not 1 <= len(pairs) <= MAX_SEGMENTS:
        raise ValueError(f"{name}: 1 to {MAX_SEGMENTS} segments, got "
                         f"{len(pairs)}")
    dev = _lib.require_cuda(name, *(t for pair in pairs for t in pair))
    outs, segs = [], (_lib.GatherSeg * len(pairs))()
    for seg, (kv, idx) in zip(segs, pairs):
        _lib.require_dtype(name, idx, torch.int32, "idx")
        if kv.dim() != 3 or idx.dim() != 2 or idx.shape[0] != kv.shape[0]:
            raise ValueError(f"{name}: kv [B,S,d] and idx [B,k], got "
                             f"{tuple(kv.shape)} and {tuple(idx.shape)}")
        B, S, d = kv.shape
        k = idx.shape[1]
        out = torch.empty((B, k, d), dtype=kv.dtype, device=dev)
        seg.kv, seg.idx, seg.out = kv.data_ptr(), idx.data_ptr(), \
            out.data_ptr()
        seg.B, seg.S, seg.k, seg.row_bytes = B, S, k, d * kv.element_size()
        seg.base, seg.shard = base or 0, int(base is not None)
        outs.append(out)
    if dev.type == "meta":
        return outs, False
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_gather_kv(segs, len(pairs), _lib.stream())
    _lib.check(rc, name)
    return outs, True


def gather_kv_pages(kv: torch.Tensor, page_idx: torch.Tensor, *,
                    page: int) -> torch.Tensor:
    """kv: [S, d] (any dtype), S % page == 0; page_idx: [n] int32
    -> [n * page, d].  Page ids are clamped into [0, S / page).
    Bit-exact: pages are copied."""
    global launches_pages
    name = "gather_kv_pages"
    dev = _lib.require_cuda(name, kv, page_idx)
    _lib.require_dtype(name, page_idx, torch.int32, "page_idx")
    if (kv.dim() != 2 or page_idx.dim() != 1 or page < 1
            or kv.shape[0] % page):
        raise ValueError(f"{name}: kv [S,d] with S % page == 0 and "
                         f"page_idx [n], got {tuple(kv.shape)}, page={page} "
                         f"and {tuple(page_idx.shape)}")
    S, d = kv.shape
    n = page_idx.shape[0]
    out = torch.empty((n * page, d), dtype=kv.dtype, device=dev)
    if dev.type != "meta":
        with torch.cuda.device(dev):
            rc = _lib.lib().sac_gather_kv_pages(
                kv.data_ptr(), page_idx.data_ptr(), out.data_ptr(),
                S // page, n, page * d * kv.element_size(), _lib.stream())
        _lib.check(rc, name)
        launches_pages += 1
    if cost.RECORDERS:
        cost.record("gather_kv_pages",
                    cost.gather_pages(n, page, d * kv.element_size()))
    return out
