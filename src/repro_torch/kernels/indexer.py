"""Lightning-indexer scoring on the card (``repro/kernels/indexer.py``).

``indexer_scores`` launches ``csrc/indexer.cu`` with the batch in the
grid; its plain version is ``kernels/ref.py::indexer_scores_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def indexer_scores(q: torch.Tensor, w: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """q: [B, H, di] f32; w: [B, H] f32; keys: [B, S, di] bf16
    -> scores [B, S] f32.  Any S; di a multiple of 32."""
    global launches
    name = "indexer_scores"
    dev = _lib.require_cuda(name, q, w, keys)
    _lib.require_dtype(name, q, torch.float32, "q")
    _lib.require_dtype(name, w, torch.float32, "w")
    _lib.require_dtype(name, keys, torch.bfloat16, "keys")
    B, H, di = q.shape
    if (keys.dim() != 3 or keys.shape[0] != B or keys.shape[2] != di
            or tuple(w.shape) != (B, H)):
        raise ValueError(f"{name}: q [B,H,di], w [B,H], keys [B,S,di]; got "
                         f"{tuple(q.shape)}, {tuple(w.shape)}, "
                         f"{tuple(keys.shape)}")
    if di % 32 or keys.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes di % 32 == 0 and "
                         f"16-byte aligned keys (di={di})")
    S = keys.shape[1]
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_indexer_scores(
            q.data_ptr(), w.data_ptr(), keys.data_ptr(), out.data_ptr(),
            B, S, H, di, 1.0 / math.sqrt(di), _lib.stream())
    _lib.check(rc, name)
    launches += 1
    return out
