"""Sparse KV row gather on the card (``repro/kernels/gather_kv.py``).

``gather_kv`` launches ``csrc/gather_kv.cu`` with the batch in the grid;
its plain version is ``kernels/ref.py::gather_kv_ref``.  ``gather_kv_pages``
is the page-granular form (whole pages of ``page`` consecutive rows, one
block per page id), plain version ``ref.gather_kv_pages_ref``; no path of
either package calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0
launches_pages = 0


def gather_kv(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv: [B, S, d] (any dtype); idx: [B, k] int32 -> [B, k, d].

    Indices are clamped into [0, S).  Bit-exact: rows are copied."""
    global launches
    name = "gather_kv"
    dev = _lib.require_cuda(name, kv, idx)
    _lib.require_dtype(name, idx, torch.int32, "idx")
    if kv.dim() != 3 or idx.dim() != 2 or idx.shape[0] != kv.shape[0]:
        raise ValueError(f"{name}: kv [B,S,d] and idx [B,k], got "
                         f"{tuple(kv.shape)} and {tuple(idx.shape)}")
    B, S, d = kv.shape
    k = idx.shape[1]
    out = torch.empty((B, k, d), dtype=kv.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_gather_kv(kv.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), B, S, k,
                                      d * kv.element_size(), _lib.stream())
    _lib.check(rc, name)
    launches += 1
    return out


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
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_gather_kv_pages(
            kv.data_ptr(), page_idx.data_ptr(), out.data_ptr(), S // page,
            n, page * d * kv.element_size(), _lib.stream())
    _lib.check(rc, name)
    launches_pages += 1
    return out
