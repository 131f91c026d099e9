"""In-place KV row scatter on the card (``repro/kernels/scatter_kv.py``).

``scatter_kv`` launches ``csrc/scatter_kv.cu`` with the batch in the
grid; its plain version is ``kernels/ref.py::scatter_kv_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


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
