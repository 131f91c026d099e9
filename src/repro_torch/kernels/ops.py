"""Batched dispatch over the Hopper kernels (``repro/kernels/ops.py``).

A call whose tensors lie on the CPU runs the plain versions of
``ref.py`` (one request at a time, as the reference vmaps them).  A call
whose tensors lie on a CUDA device launches the kernel once for the
whole batch (the batch is part of the kernel's grid), or raises: there
is no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import gather_kv as _gather
from repro_torch.kernels import indexer as _indexer
from repro_torch.kernels import ref
from repro_torch.kernels import scatter_kv as _scatter
from repro_torch.kernels import sparse_attn as _attn

NEG_INF = ref.NEG_INF
_KERNELS = {"gather_kv": _gather, "indexer_scores": _indexer,
            "sparse_attn": _attn, "scatter_kv": _scatter}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the call goes to the kernel.  CPU tensors take the
    plain version; a mix of devices is refused by the kernel wrapper."""
    return any(t.is_cuda for t in tensors)


def batched_gather(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv: [B, S, d]; idx: [B, k] -> [B, k, d]."""
    if _on_cuda(kv, idx):
        return _gather.gather_kv(kv, idx.to(torch.int32).contiguous())
    return torch.stack([ref.gather_kv_ref(kv[b], idx[b])
                        for b in range(kv.shape[0])])


def batched_indexer_scores(q: torch.Tensor, w: torch.Tensor,
                           keys: torch.Tensor) -> torch.Tensor:
    """q: [B, H, di]; w: [B, H]; keys: [B, S, di] -> [B, S] f32."""
    if _on_cuda(q, w, keys):
        return _indexer.indexer_scores(q.float().contiguous(),
                                       w.float().contiguous(), keys)
    return torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                        for b in range(q.shape[0])])


def batched_sparse_mla(q_lat: torch.Tensor, q_pe: torch.Tensor,
                       entries: torch.Tensor, valid: torch.Tensor, *,
                       dc: int, scale: float) -> torch.Tensor:
    """q_lat: [B,H,dc]; q_pe: [B,H,dr]; entries: [B,k,dc+dr]; valid: [B,k]
    -> out_lat [B,H,dc] f32."""
    if _on_cuda(q_lat, q_pe, entries, valid):
        q = torch.cat([q_lat.float(), q_pe.float()], dim=-1).contiguous()
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
        return _attn.sparse_attn(q, entries.contiguous(), bias.contiguous(),
                                 scale=scale, dv=dc)
    return torch.stack([ref.sparse_mla_attn_ref(q_lat[b], q_pe[b],
                                                entries[b], valid[b], dc,
                                                scale)
                        for b in range(q_lat.shape[0])])


def batched_scatter(pool: torch.Tensor, entries: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """pool: [B, S, d]; entries: [B, k, d]; idx: [B, k] -> ``pool``,
    updated IN PLACE (the reference's aliased output)."""
    if _on_cuda(pool, entries, idx):
        return _scatter.scatter_kv(pool, entries.to(pool.dtype).contiguous(),
                                   idx.to(torch.int32).contiguous())
    for b in range(pool.shape[0]):
        ref.scatter_kv_ref(pool[b], entries[b], idx[b])
    return pool
