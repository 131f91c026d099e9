"""Plain PyTorch versions of every kernel (``repro/kernels/ref.py``).

They are the oracles: the CPU path of ``kernels/ops.py`` runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
Layouts and dtypes follow the reference: one request per call, f32 out.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_kv_ref(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv: [S, d]; idx: [k] int -> [k, d].  Indices are clamped into
    [0, S), as the CUDA kernel clamps them."""
    return kv[idx.long().clamp(0, kv.shape[0] - 1)]


def indexer_scores_ref(q: torch.Tensor, w: torch.Tensor,
                       keys: torch.Tensor) -> torch.Tensor:
    """Lightning indexer: q [H, di], w [H], keys [S, di] -> scores [S].

    I[s] = sum_h w[h] * ReLU(q[h] . k[s]) / sqrt(di)
    """
    di = q.shape[-1]
    logits = torch.relu(keys.float() @ q.float().T) / math.sqrt(di)  # [S, H]
    return logits @ w.float()


def sparse_mla_attn_ref(q_lat: torch.Tensor, q_pe: torch.Tensor,
                        entries: torch.Tensor, valid: torch.Tensor,
                        dc: int, scale: float) -> torch.Tensor:
    """Absorbed-MLA attention over fetched latent entries.

    q_lat: [H, dc]; q_pe: [H, dr]; entries: [k, dc+dr]; valid: [k]
    -> out_lat [H, dc] f32.
    """
    c = entries[:, :dc].float()
    k_pe = entries[:, dc:].float()
    s = (q_lat.float() @ c.T + q_pe.float() @ k_pe.T) * scale   # [H, k]
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1) @ c                        # [H, dc]


def sparse_gqa_attn_ref(q: torch.Tensor, entries: torch.Tensor,
                        valid: torch.Tensor, n_kv: int) -> torch.Tensor:
    """GQA attention over fetched entries.

    q: [H, hd]; entries: [k, 2*n_kv*hd] (stacked k,v); valid: [k]
    -> out [H, hd] f32.
    """
    H, hd = q.shape
    kv = entries.reshape(entries.shape[0], 2, n_kv, hd).float()
    qf = q.float().reshape(n_kv, H // n_kv, hd) / math.sqrt(hd)
    s = torch.einsum("grd,kgd->grk", qf, kv[:, 0])
    s = torch.where(valid[None, None, :], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("grk,kgd->grd", torch.softmax(s, dim=-1), kv[:, 1])
    return out.reshape(H, hd)


def scatter_kv_ref(pool: torch.Tensor, entries: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """pool: [S, d]; entries: [k, d]; idx: [k] distinct rows.

    Writes the rows IN PLACE and returns ``pool``.  Rows outside [0, S)
    are skipped, as the CUDA kernel skips them.
    """
    idx = idx.long()
    keep = (idx >= 0) & (idx < pool.shape[0])
    pool[idx[keep]] = entries[keep].to(pool.dtype)
    return pool
