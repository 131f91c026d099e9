"""Top-k sparse attention on the card (``repro/kernels/sparse_attn.py``).

``sparse_attn`` launches ``sparse_attn_kernel`` of ``csrc/sparse_attn.cu``:
softmax attention of q against key and value columns of one entry
tensor, the batch in the grid.  ``ops.batched_sparse_mla`` is its MLA
form (keys = entries, values = their first dc columns); plain version
``kernels/ref.py::sparse_mla_attn_ref``.

``sparse_attn_gqa`` launches ``sparse_gqa_kernel`` of the same file: the
GQA/MQA form over entries laid out ``[2, n_kv, hd]``, one launch per
layer, one block per (request, KV group) owning all the group's query
heads.  ``ops.batched_sparse_gqa`` calls it; plain version
``kernels/ref.py::sparse_gqa_attn_ref``.  Each form has its own launch
counter.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

#: kernel launches since the last reset (read by chip_smoke.py), MLA
#: form and GQA form
launches = 0
launches_gqa = 0

_TILE_K, _THREADS, _MAX_HEADS_PER_THREAD = 64, 256, 12


def sparse_attn(q: torch.Tensor, entries: torch.Tensor, bias: torch.Tensor,
                *, scale: float, dv: int, k_col: int = 0,
                v_col: int = 0) -> torch.Tensor:
    """q: [B, H, dq] f32; entries: [B, k, de] bf16; bias: [B, k] f32
    (0 / -1e30) -> out [B, H, dv] f32.

    keys = entries[..., k_col:k_col+dq], values =
    entries[..., v_col:v_col+dv].  Any k (the ragged end is masked)."""
    global launches
    name = "sparse_attn"
    dev = _lib.require_cuda(name, q, entries, bias)
    _lib.require_dtype(name, q, torch.float32, "q")
    _lib.require_dtype(name, entries, torch.bfloat16, "entries")
    _lib.require_dtype(name, bias, torch.float32, "bias")
    B, H, dq = q.shape
    if (entries.dim() != 3 or entries.shape[0] != B
            or tuple(bias.shape) != tuple(entries.shape[:2])):
        raise ValueError(f"{name}: q [B,H,dq], entries [B,k,de], bias "
                         f"[B,k]; got {tuple(q.shape)}, "
                         f"{tuple(entries.shape)}, {tuple(bias.shape)}")
    k, de = entries.shape[1], entries.shape[2]
    st_col = min(k_col, v_col)
    st_w = max(k_col + dq, v_col + dv) - st_col
    st_w += -st_w % 8
    if (st_col % 8 or k_col % 8 or v_col % 8 or dq % 8 or de % 8
            or dv % 2 or dv > 1024 or st_col + st_w > de
            or entries.data_ptr() % 16):
        raise ValueError(f"{name}: the kernel takes 8-aligned columns and "
                         f"dq, dv even <= 1024, inside de={de} "
                         f"(dq={dq}, dv={dv}, k_col={k_col}, v_col={v_col})")
    out = torch.empty((B, H, dv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_sparse_attn(
            q.data_ptr(), entries.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, k, dq, dv, k_col, v_col, st_col, st_w,
            k * de, de, float(scale), _lib.stream())
    _lib.check(rc, name)
    launches += 1
    return out


def sparse_attn_gqa(q: torch.Tensor, entries: torch.Tensor,
                    bias: torch.Tensor, *, n_kv: int,
                    scale: float) -> torch.Tensor:
    """q: [B, H, hd] f32; entries: [B, k, 2*n_kv*hd] bf16 (rows laid out
    [2, n_kv, hd]); bias: [B, k] f32 (0 / -1e30) -> out [B, H, hd] f32.

    Head h attends with the keys and values of group h // (H / n_kv).
    Any k (the ragged end is masked); hd a multiple of 8 up to 512."""
    global launches_gqa
    name = "sparse_attn_gqa"
    dev = _lib.require_cuda(name, q, entries, bias)
    _lib.require_dtype(name, q, torch.float32, "q")
    _lib.require_dtype(name, entries, torch.bfloat16, "entries")
    _lib.require_dtype(name, bias, torch.float32, "bias")
    if q.dim() != 3 or entries.dim() != 3:
        raise ValueError(f"{name}: q [B,H,hd] and entries [B,k,de], got "
                         f"{tuple(q.shape)} and {tuple(entries.shape)}")
    B, H, hd = q.shape
    k = entries.shape[1]
    if (entries.shape[0] != B or entries.shape[2] != 2 * n_kv * hd
            or tuple(bias.shape) != (B, k) or n_kv < 1 or H % n_kv):
        raise ValueError(f"{name}: entries [B,k,2*n_kv*hd], bias [B,k] and "
                         f"H % n_kv == 0; got q {tuple(q.shape)}, entries "
                         f"{tuple(entries.shape)}, bias {tuple(bias.shape)}, "
                         f"n_kv={n_kv}")
    n_rep = H // n_kv
    head_slots = min(_THREADS // _TILE_K,
                     max(1, _THREADS // max(hd // 2, 1)))
    if (hd % 8 or hd > 512 or n_rep > _MAX_HEADS_PER_THREAD * head_slots
            or entries.data_ptr() % 16):
        raise ValueError(f"{name}: the kernel takes hd % 8 == 0, hd <= 512 "
                         f"and n_rep <= {_MAX_HEADS_PER_THREAD * head_slots} "
                         f"at hd={hd} (got n_rep={n_rep}), 16-byte aligned "
                         f"entries")
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_sparse_attn_gqa(
            q.data_ptr(), entries.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, n_kv, k, hd, k * entries.shape[2],
            entries.shape[2], float(scale), _lib.stream())
    _lib.check(rc, name)
    launches_gqa += 1
    return out
