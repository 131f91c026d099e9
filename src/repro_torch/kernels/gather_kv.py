"""Sparse KV row gather on the card (``repro/kernels/gather_kv.py``).

``gather_kv`` launches ``csrc/gather_kv.cu`` with the batch in the grid;
its plain version is ``kernels/ref.py::gather_kv_ref``.  The page-granular
``gather_kv_pages`` of the reference is still to port (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


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
