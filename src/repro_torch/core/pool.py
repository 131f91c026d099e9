"""KV-cache pool, single-device path (``repro/core/pool.py``).

The pool is one tensor ``[L, B, S, d]`` per kind (latent entries,
indexer keys).  The read path is a row gather of each request's top-k
positions (``local_fetch`` -> the gather kernel on the card); the write
path writes rows into the pool IN PLACE (``pool_write`` /
``pool_write_step``, ``pool_write_prefill`` / ``pool_splice_lane`` ->
the scatter kernel's decode and splice forms on the card), so a decode
step writes L*B rows of every pool in one launch and never copies a
pool, and a splice copies the prompt's rows once.

With ``kv_quant="fp8"`` the pool holds ``float8_e4m3fn`` entries:
``to_kv_dtype`` is the one cast into the pool's dtype that the port
uses (prefill pool, write-back, the own entry appended at decode), and
it rounds as the reference's ``astype`` does.

``make_pooled_fetch`` (the pool sharded over devices, gathered with a
collective) waits for the distributed slice (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import ops

FetchFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

E4M3 = torch.float8_e4m3fn
# the largest magnitude that rounds into e4m3's range (448 and the
# midpoint to the next step, 480, which rounds to even: 448)
_E4M3_LIMIT = 464.0


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the pool dtype ``dtype``, as the reference's
    ``astype`` casts it.

    For ``float8_e4m3fn`` PyTorch's cast saturates values past the range
    to +-448, where the reference (ml_dtypes) gives NaN with the sign
    kept (bits ``0x7f`` / ``0xff``); every other value rounds to nearest
    even in both.  So the saturated lanes become NaN here, compared in
    ``x``'s own dtype (no f32 copy of a prefill pool)."""
    if dtype != E4M3 or x.dtype == E4M3:
        return x.to(dtype)
    bits = x.to(E4M3).view(torch.uint8)
    nan = (torch.signbit(x).to(torch.uint8) << 7) | 0x7F
    return torch.where(x.abs() > _E4M3_LIMIT, nan, bits).view(E4M3)


# ---------------------------------------------------------------------------
# read path
# ---------------------------------------------------------------------------


def local_fetch(pool_layer: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Single-device gather. pool_layer: [B, S, d]; idx: [B, k] -> [B, k, d]."""
    return ops.batched_gather(pool_layer, idx)


# ---------------------------------------------------------------------------
# write path
# ---------------------------------------------------------------------------


def pool_write(pool: torch.Tensor, new_entries: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Write one new entry per (layer, request) at per-request positions.

    pool: [L, B, S, d]; new_entries: [L, B, d]; pos: [B] -> ``pool``,
    updated IN PLACE (the entries cast to the pool's dtype).  Positions
    are clamped to S-1, as in the reference.  One launch on the card,
    which computes the rows itself.
    """
    return pool_write_step([pool], [new_entries], pos)[0]


def pool_write_step(pools: Sequence[torch.Tensor],
                    new_entries: Sequence[torch.Tensor], pos: torch.Tensor
                    ) -> Sequence[torch.Tensor]:
    """``pool_write`` of several pools (a decode step's latent or (k, v)
    entries and its indexer keys) at the same positions, IN PLACE, in one
    launch on the card; returns ``pools``."""
    for pool in pools:
        _check_contiguous(pool)
    ops.pool_rows_at(pools, [to_kv_dtype(e, p.dtype)
                             for e, p in zip(new_entries, pools)], pos)
    return pools


def _check_contiguous(pool: torch.Tensor) -> None:
    if not pool.is_contiguous():
        raise ValueError("the pool must be contiguous: it is written in place")


def _check_fits(S: int, offset: int, T: int) -> None:
    if offset < 0 or offset + T > S:
        raise ValueError(f"prefill rows [{offset}, {offset + T}) do not fit "
                         f"a pool of {S} positions")


def pool_write_prefill(pool: torch.Tensor, entries: torch.Tensor,
                       offset: int = 0, lane: Optional[int] = None
                       ) -> torch.Tensor:
    """Bulk layer-wise write of prefill entries, IN PLACE.

    pool: [L, B, S, d]; entries: [L, B, T, d] -> ``pool`` with rows
    [offset, offset+T) of every (layer, request) written.  With ``lane``
    the entries are [L, 1, T, d] and go to that request lane only.  One
    launch on the card: each (layer, lane)'s T rows are one contiguous
    run in both the entries and the pool.
    """
    _check_contiguous(pool)
    _check_fits(pool.shape[2], offset, entries.shape[2])
    ops.pool_splice([pool], [to_kv_dtype(entries, pool.dtype)],
                    offset=offset, lane=lane)
    return pool


def pool_splice_lane(pools: Sequence[torch.Tensor],
                     prompts: Sequence[torch.Tensor], lane: int) -> None:
    """The engine's slot splice, IN PLACE, in one launch on the card: each
    prompt's pool [L, 1, T, d] into rows [0, T) of lane ``lane`` of its
    pool [L, B, S, d], and zeros into rows [T, S), as the reference's
    copy of the prompt's pool padded with zeros to S gives."""
    for pool, src in zip(pools, prompts):
        _check_contiguous(pool)
        _check_fits(pool.shape[2], 0, src.shape[2])
    ops.pool_splice(pools, [to_kv_dtype(s, p.dtype)
                            for s, p in zip(prompts, pools)],
                    lane=lane, zero_tail=True)
