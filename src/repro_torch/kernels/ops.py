"""Batched dispatch over the Hopper kernels (``repro/kernels/ops.py``).

A call whose tensors lie on the CPU runs the plain versions of
``ref.py`` (one request at a time, as the reference vmaps them).  A call
whose tensors lie on a CUDA device launches the kernel once for the
whole batch (the batch is part of the kernel's grid), or raises: there
is no fallback from a CUDA tensor to the plain version.  A call on
``meta`` tensors (the dry-run, ``launch/dryrun.py``) goes through the
same wrapper as a CUDA one, which checks its shapes, reports the call
to an active counter and makes its outputs, but launches nothing (and
so moves no ``launch_counts()`` counter).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import gather_kv as _gather
from repro_torch.kernels import indexer as _indexer
from repro_torch.kernels import ref
from repro_torch.kernels import scatter_kv as _scatter
from repro_torch.kernels import sparse_attn as _attn

# kernel name -> (wrapper module, its counter attribute)
_COUNTERS = {"gather_kv.rows": (_gather, "launches"),
             "gather_kv.shard": (_gather, "launches_shard"),
             "gather_kv_pages": (_gather, "launches_pages"),
             "indexer_scores": (_indexer, "launches"),
             "sparse_attn": (_attn, "launches"),
             "sparse_attn_gqa": (_attn, "launches_gqa"),
             "scatter_kv.scatter": (_scatter, "launches"),
             "scatter_kv.rows_at": (_scatter, "launches_rows_at"),
             "scatter_kv.rows_at_shard": (_scatter, "launches_rows_at_shard"),
             "scatter_kv.splice": (_scatter, "launches_splice"),
             "scatter_kv.splice_shard": (_scatter, "launches_splice_shard")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset; ``gather_kv`` is
    the sum over its two forms (``gather_kv.rows``, ``gather_kv.shard``)
    and ``scatter_kv`` over its five, each also given as
    ``scatter_kv.<form>`` (``scatter``, ``rows_at``: the decode write,
    ``splice``, and the shard forms ``rows_at_shard``,
    ``splice_shard``)."""
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in _COUNTERS.items()}
    for kernel in ("gather_kv", "scatter_kv"):
        counts[kernel] = sum(n for name, n in counts.items()
                             if name.startswith(kernel + "."))
    return counts


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def _to_kernel(*tensors: torch.Tensor) -> bool:
    """True when the call goes to the kernel wrapper: a CUDA tensor (the
    kernel launches) or a ``meta`` one (the dry-run: the wrapper applies
    its own shape checks, reports the call under its ``launch_counts()``
    name with its cost to an active counter (``kernels/cost.py``) and
    returns empty ``meta`` outputs of the kernel's shapes and dtypes,
    launching nothing and counting no launch).  CPU tensors take
    the plain version; a mix of devices is refused by the wrapper."""
    return any(t.is_cuda or t.is_meta for t in tensors)


def batched_gather(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv: [B, S, d]; idx: [B, k] -> [B, k, d]."""
    if _to_kernel(kv, idx):
        return _gather.gather_kv(kv, idx.to(torch.int32).contiguous())
    return torch.stack([ref.gather_kv_ref(kv[b], idx[b])
                        for b in range(kv.shape[0])])


def batched_gather_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                        ) -> List[torch.Tensor]:
    """Each (kv [B, S, d], idx [B, k]) -> [B, k, d]; on the card one
    launch for all the pairs."""
    if _to_kernel(*(t for pair in pairs for t in pair)):
        return _gather.gather_kv_many([(kv, idx.to(torch.int32).contiguous())
                                       for kv, idx in pairs])
    return ref.gather_kv_many_ref(pairs)


def batched_gather_shard(kv: torch.Tensor, idx: torch.Tensor,
                         base: int) -> torch.Tensor:
    """The shard form: kv [B, S_local, d] is the slice [base, base +
    S_local) of a pool; idx [B, k] global rows -> [B, k, d], zeros where
    a row lies outside the slice."""
    if _to_kernel(kv, idx):
        return _gather.gather_kv_shard(
            [(kv, idx.to(torch.int32).contiguous())], base)[0]
    return torch.stack([ref.gather_kv_shard_ref(kv[b], idx[b], base)
                        for b in range(kv.shape[0])])


def batched_indexer_scores(q: torch.Tensor, w: torch.Tensor,
                           keys: torch.Tensor) -> torch.Tensor:
    """q: [B, H, di]; w: [B, H]; keys: [B, S, di] -> [B, S] f32."""
    if _to_kernel(q, w, keys):
        return _indexer.indexer_scores(q.float().contiguous(),
                                       w.float().contiguous(), keys)
    return torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                        for b in range(q.shape[0])])


def batched_sparse_mla(q_lat: torch.Tensor, q_pe: torch.Tensor,
                       entries: torch.Tensor, valid: torch.Tensor, *,
                       dc: int, scale: float) -> torch.Tensor:
    """q_lat: [B,H,dc]; q_pe: [B,H,dr]; entries: [B,k,dc+dr]; valid: [B,k]
    -> out_lat [B,H,dc] f32."""
    if _to_kernel(q_lat, q_pe, entries, valid):
        q = torch.cat([q_lat.float(), q_pe.float()], dim=-1).contiguous()
        return _attn.sparse_attn(q, entries.contiguous(), valid.contiguous(),
                                 scale=scale, dv=dc)
    return torch.stack([ref.sparse_mla_attn_ref(q_lat[b], q_pe[b],
                                                entries[b], valid[b], dc,
                                                scale)
                        for b in range(q_lat.shape[0])])


def batched_sparse_gqa(q: torch.Tensor, entries: torch.Tensor,
                       valid: torch.Tensor, *, n_kv: int) -> torch.Tensor:
    """q: [B,H,hd]; entries: [B,k,2*n_kv*hd]; valid: [B,k] -> [B,H,hd] f32.

    Scale 1/sqrt(hd), as the reference divides q before the dot."""
    if _to_kernel(q, entries, valid):
        return _attn.sparse_attn_gqa(q.float().contiguous(),
                                     entries.contiguous(), valid.contiguous(),
                                     n_kv=n_kv,
                                     scale=1.0 / math.sqrt(q.shape[-1]))
    return torch.stack([ref.sparse_gqa_attn_ref(q[b], entries[b], valid[b],
                                                n_kv)
                        for b in range(q.shape[0])])


def batched_scatter(pool: torch.Tensor, entries: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """pool: [B, S, d]; entries: [B, k, d] in the pool's dtype (callers
    cast with ``core/pool.py::to_kv_dtype``, which rounds e4m3 as the
    reference does); idx: [B, k] -> ``pool``, updated IN PLACE (the
    reference's aliased output)."""
    if entries.dtype != pool.dtype:
        raise TypeError(f"batched_scatter: entries are {entries.dtype}, the "
                        f"pool {pool.dtype}: cast with to_kv_dtype first")
    if _to_kernel(pool, entries, idx):
        return _scatter.scatter_kv(pool, entries.contiguous(),
                                   idx.to(torch.int32).contiguous())
    for b in range(pool.shape[0]):
        ref.scatter_kv_ref(pool[b], entries[b], idx[b])
    return pool


def _same_dtype(name: str, pools, srcs) -> None:
    for pool, src in zip(pools, srcs):
        if src.dtype != pool.dtype:
            raise TypeError(f"{name}: a source is {src.dtype}, its pool "
                            f"{pool.dtype}: cast with to_kv_dtype first")


def pool_rows_at(pools: Sequence[torch.Tensor],
                 entries: Sequence[torch.Tensor], pos: torch.Tensor,
                 base: int = 0, seq_len: Optional[int] = None) -> None:
    """The decode write into each pool [L, B, S, d] of its entries [L, B,
    d] (the pool's dtype) at the positions pos [B] (clamped into [0, S)),
    IN PLACE; on the card one launch for all the pools.  With
    ``seq_len`` (the shard form) each pool is the slice [base, base + S)
    of ``seq_len`` positions and takes only the rows that fall in it."""
    _same_dtype("pool_rows_at", pools, entries)
    if _to_kernel(pos, *pools, *entries):
        args = (pools, [e.contiguous() for e in entries],
                pos.to(torch.int32).contiguous())
        if seq_len is None:
            _scatter.write_rows_at(*args)
        else:
            _scatter.write_rows_at_shard(*args, base, seq_len)
        return
    for pool, e in zip(pools, entries):
        ref.write_rows_at_ref(pool, e, pos, base, seq_len)


def pool_splice(pools: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                *, offset: int = 0, lane: Optional[int] = None,
                zero_tail: bool = False) -> None:
    """Each source [L, b, T, d] (the pool's dtype; b = B, or 1 with
    ``lane``) into rows [offset, offset+T) of its pool [L, B, S, d], and
    with ``zero_tail`` zeros into rows [offset+T, S) of those lanes, IN
    PLACE; on the card one launch for all the pools."""
    _same_dtype("pool_splice", pools, srcs)
    if _to_kernel(*pools, *srcs):
        _scatter.splice(pools, [s.contiguous() for s in srcs], offset=offset,
                        lane=lane, zero_tail=zero_tail)
        return
    for pool, src in zip(pools, srcs):
        ref.splice_ref(pool, src, offset, lane, zero_tail)


def pool_splice_shard(pools: Sequence[torch.Tensor],
                      srcs: Sequence[torch.Tensor], base: int) -> None:
    """The splice's shard form: each pool [L, B, S_local, d] (the slice
    [base, base + S_local) of a pool) takes its source's [L, B, T, d] rows
    [base, base + S_local), zeros past T, IN PLACE; on the card one launch
    for all the pools."""
    _same_dtype("pool_splice_shard", pools, srcs)
    if _to_kernel(*pools, *srcs):
        _scatter.splice_shard(pools, [s.contiguous() for s in srcs], base)
        return
    for pool, src in zip(pools, srcs):
        ref.splice_ref(pool, src, zero_tail=True, src_row0=base)
