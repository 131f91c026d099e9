"""Lightning-indexer scoring on the card (``repro/kernels/indexer.py``).

``indexer_scores`` launches ``csrc/indexer.cu``: a block per (chunk of
key tiles, request), on the bf16 tensor cores.  ``indexer_plan`` picks
the chunk on the host with the attention's wave model, from the shape
and from the blocks the card holds at once, which the CUDA occupancy
calculator gives (``indexer_slots``).
Its plain version is ``kernels/ref.py::indexer_scores_ref``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib, sparse_attn

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def indexer_plan(B: int, S: int, tile_rows: int,
                 slots: int) -> Tuple[int, int]:
    """(chunks, chunk_tiles) for B requests of S positions in tiles of
    ``tile_rows`` when the card holds ``slots`` blocks at once: block
    (c, b) scores positions [c*chunk_tiles*tile_rows, ...) of request b,
    at most chunk_tiles tiles, and no chunk is empty.  The attention's
    wave model (``sparse_attn.split_plan``) over the positions, with q
    staged once per block as the start-up and no scratch."""
    chunks, chunk = sparse_attn.split_plan(S, B, 0, slots, tile_rows)
    return chunks, chunk // tile_rows


def indexer_slots(H: int, di: int,
                  index: Optional[int] = None) -> Tuple[int, int]:
    """(blocks of the kernel card ``index`` holds at once, rows of its key
    tile) for H heads of di dims, from the CUDA occupancy calculator at
    the kernel's registers and shared memory; (0, 0) for a shape the
    kernel does not take."""
    index = torch.cuda.current_device() if index is None else index
    return _lib.card_slots(index, "sac_indexer_blocks_per_sm", H, di,
                           outs=2)


def indexer_scores(q: torch.Tensor, w: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """q: [B, H, di] f32; w: [B, H] f32; keys: [B, S, di] bf16
    -> scores [B, S] f32.  Any S; di a multiple of 16 in [16, 256] and
    H in [1, 128]."""
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
    slots, rows = indexer_slots(H, di, dev.index)
    if not slots or keys.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes di a multiple of 16 in "
                         f"[16, 256], H in [1, 128] and 16-byte aligned q "
                         f"and keys (H={H}, di={di})")
    S = keys.shape[1]
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return out
    chunk = indexer_plan(B, S, rows, slots)[1]
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_indexer_scores(
            q.data_ptr(), w.data_ptr(), keys.data_ptr(), out.data_ptr(),
            B, S, H, di, chunk, 1.0 / math.sqrt(di), _lib.stream())
    _lib.check(rc, name)
    launches += 1
    return out
