"""Plain PyTorch versions of every kernel (``repro/kernels/ref.py``).

They are the oracles: the CPU path of ``kernels/ops.py`` runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
Layouts and dtypes follow the reference: one request per call, f32 out.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def gather_kv_ref(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv: [S, d]; idx: [k] int -> [k, d].  Indices are clamped into
    [0, S), as the CUDA kernel clamps them."""
    return kv[idx.long().clamp(0, kv.shape[0] - 1)]


def gather_kv_many_ref(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> List[torch.Tensor]:
    """The multi-segment gather: each (kv [B, S, d], idx [B, k]) pair ->
    [B, k, d], request by request through ``gather_kv_ref``."""
    return [torch.stack([gather_kv_ref(kv[b], idx[b])
                         for b in range(kv.shape[0])])
            for kv, idx in pairs]


def gather_kv_shard_ref(kv: torch.Tensor, idx: torch.Tensor,
                        base: int) -> torch.Tensor:
    """The shard form: kv [S_local, d] is the slice [base, base + S_local)
    of a pool; idx [k] global rows -> [k, d], kv[idx - base] where that
    row lies in the slice, zeros elsewhere (``torch.where`` over the
    clamped gather, on the raw bytes of a 1-byte float)."""
    S = kv.shape[0]
    local = idx.long() - base
    keep = (local >= 0) & (local < S)
    rows = kv[local.clamp(0, S - 1)]
    raw = rows.view(torch.uint8) if rows.element_size() == 1 else rows
    return torch.where(keep[:, None], raw,
                       torch.zeros_like(raw)).view(rows.dtype)


def gather_kv_pages_ref(kv: torch.Tensor, page_idx: torch.Tensor,
                        page: int) -> torch.Tensor:
    """Page-granular gather: kv [S, d] with S % page == 0; page_idx [n]
    page numbers -> [n * page, d], page p being rows [p*page, (p+1)*page).
    Page numbers are clamped into [0, S / page), as the CUDA kernel
    clamps them."""
    S, d = kv.shape
    pages = kv.reshape(S // page, page, d)
    return pages[page_idx.long().clamp(0, S // page - 1)].reshape(-1, d)


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


def split_softmax_combine_ref(q: torch.Tensor, keys: torch.Tensor,
                              values: torch.Tensor, valid: torch.Tensor,
                              scale: float, chunk: int) -> torch.Tensor:
    """The two passes of the split-k attention kernels, in plain PyTorch
    (for the tests: the kernels' own plain versions are the one-pass
    functions above).

    q: [H, dq]; keys: [k, dq]; values: [k, dv]; valid: [k] -> [H, dv] f32.
    Pass 1 gives each chunk of ``chunk`` lanes its running max m, sum l
    and unnormalised accumulator acc; pass 2 takes m* = max m and returns
    sum e^(m - m*) acc / max(sum e^(m - m*) l, 1e-30).
    """
    s = (q.float() @ keys.float().T) * scale                   # [H, k]
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    ms, ls, accs = [], [], []
    for c0 in range(0, s.shape[1], chunk):
        sc = s[:, c0:c0 + chunk]
        m = sc.max(dim=-1).values
        p = torch.exp(sc - m[:, None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(p @ values[c0:c0 + chunk].float())
    m = torch.stack(ms, dim=-1)                                # [H, splits]
    w = torch.exp(m - m.max(dim=-1, keepdim=True).values)
    acc = (w[..., None] * torch.stack(accs, dim=1)).sum(dim=1)
    return acc / (w * torch.stack(ls, dim=-1)).sum(dim=-1,
                                                   keepdim=True).clamp_min(
        1e-30)


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


def write_rows_at_ref(pool: torch.Tensor, entries: torch.Tensor,
                      pos: torch.Tensor, base: int = 0,
                      seq_len: Optional[int] = None) -> torch.Tensor:
    """The decode write: pool [L, B, S, d]; entries [L, B, d]; pos [B].
    Row (l, b) at clamp(pos[b], 0, S-1) takes entries[l, b], IN PLACE,
    through ``scatter_kv_ref`` on the [L*B*S, d] rows; returns ``pool``.
    The shard form (``seq_len``): the pool is the slice [base, base + S)
    of ``seq_len`` positions, c = clamp(pos[b], 0, seq_len-1), and the
    row goes to c - base when c lies in the slice, else nowhere."""
    L, B, S, d = pool.shape
    lanes = torch.arange(L * B, device=pool.device).reshape(L, B)
    local = pos.long().clamp(0, (seq_len or S) - 1) - base
    # a position outside the slice: a row before the first, skipped
    local = torch.where((local >= 0) & (local < S), local, -L * B * S)
    rows = lanes * S + local[None, :]
    scatter_kv_ref(pool.view(L * B * S, d), entries.reshape(L * B, d),
                   rows.reshape(-1))
    return pool


def splice_ref(pool: torch.Tensor, src: torch.Tensor, offset: int = 0,
               lane: Optional[int] = None, zero_tail: bool = False,
               src_row0: Optional[int] = None) -> torch.Tensor:
    """The prefill splice: pool [L, B, S, d]; src [L, b, T, d] (b = B, or
    1 with ``lane``).  Rows [offset, offset+T) of every layer of the lanes
    take src's rows and, with ``zero_tail``, rows [offset+T, S) become
    zeros, IN PLACE, through ``scatter_kv_ref`` on the [L*B*S, d] rows;
    returns ``pool``.  With ``src_row0`` (the shard form) src's rows
    [src_row0, src_row0 + n) are taken, n = clamp(T - src_row0, 0, S -
    offset)."""
    L, B, S, d = pool.shape
    if src_row0 is not None:
        n = min(max(src.shape[2] - src_row0, 0), S - offset)
        src = src[:, :, src_row0:src_row0 + n]
    T = src.shape[2]
    lanes = (torch.arange(B, device=pool.device) if lane is None
             else torch.tensor([lane], device=pool.device))
    first = (torch.arange(L, device=pool.device)[:, None] * B
             + lanes[None, :])[..., None] * S                   # [L, b, 1]
    rows = pool.view(L * B * S, d)
    scatter_kv_ref(rows, src.reshape(-1, d),
                   (first + offset + torch.arange(T, device=pool.device)
                    ).reshape(-1))
    if zero_tail and offset + T < S:
        tail = (first + torch.arange(offset + T, S, device=pool.device)
                ).reshape(-1)
        scatter_kv_ref(rows, pool.new_zeros(tail.shape[0], d), tail)
    return pool
