"""KV-cache pool, single-device path (``repro/core/pool.py``).

The pool is one tensor ``[L, B, S, d]`` per kind (latent entries,
indexer keys).  The read path is a row gather of each request's top-k
positions (``local_fetch`` -> the gather kernel on the card); the write
path scatters rows into the pool IN PLACE (``pool_write`` and
``pool_write_prefill`` -> the scatter kernel on the card), so a decode
step writes L*B rows and never copies the pool.

``make_pooled_fetch`` (the pool sharded over devices, gathered with a
collective) waits for the distributed slice (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import ops

FetchFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# read path
# ---------------------------------------------------------------------------


def local_fetch(pool_layer: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Single-device gather. pool_layer: [B, S, d]; idx: [B, k] -> [B, k, d]."""
    return ops.batched_gather(pool_layer, idx)


# ---------------------------------------------------------------------------
# write path
# ---------------------------------------------------------------------------


def _flat_rows(pool: torch.Tensor) -> torch.Tensor:
    L, B, S, d = pool.shape
    if not pool.is_contiguous():
        raise ValueError("the pool must be contiguous: it is written in place")
    return pool.view(1, L * B * S, d)


def pool_write(pool: torch.Tensor, new_entries: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Write one new entry per (layer, request) at per-request positions.

    pool: [L, B, S, d]; new_entries: [L, B, d]; pos: [B] -> ``pool``,
    updated IN PLACE by one scatter of L*B distinct rows.  Positions are
    clamped to S-1, as in the reference.
    """
    L, B, S, d = pool.shape
    pos_c = torch.clamp(pos.long(), 0, S - 1)                    # [B]
    lanes = torch.arange(L * B, device=pool.device).reshape(L, B)
    rows = (lanes * S + pos_c[None, :]).reshape(1, L * B)
    ops.batched_scatter(_flat_rows(pool), new_entries.reshape(1, L * B, d),
                        rows.to(torch.int32))
    return pool


def pool_write_prefill(pool: torch.Tensor, entries: torch.Tensor,
                       offset: int = 0, lane: Optional[int] = None
                       ) -> torch.Tensor:
    """Bulk layer-wise write of prefill entries, IN PLACE.

    pool: [L, B, S, d]; entries: [L, B, T, d] -> ``pool`` with rows
    [offset, offset+T) of every (layer, request) written.  With ``lane``
    the entries are [L, 1, T, d] and go to that request lane only (the
    engine's slot splice).  One scatter of L*B*T (or L*T) rows.
    """
    L, B, S, d = pool.shape
    T = entries.shape[2]
    if offset < 0 or offset + T > S:
        raise ValueError(f"prefill rows [{offset}, {offset + T}) do not fit "
                         f"a pool of {S} positions")
    lanes = (torch.arange(B, device=pool.device) if lane is None
             else torch.tensor([lane], device=pool.device))
    layer_lane = (torch.arange(L, device=pool.device)[:, None] * B
                  + lanes[None, :])                              # [L, b]
    rows = (layer_lane[..., None] * S + offset
            + torch.arange(T, device=pool.device))               # [L, b, T]
    ops.batched_scatter(_flat_rows(pool), entries.reshape(1, -1, d),
                        rows.reshape(1, -1).to(torch.int32))
    return pool
