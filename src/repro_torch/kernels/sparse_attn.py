"""Top-k sparse attention on the card (``repro/kernels/sparse_attn.py``).

``sparse_attn`` launches ``csrc/sparse_attn.cu``: softmax attention of
q against key and value columns of one entry tensor, the batch in the
grid.  ``ops.batched_sparse_mla`` is its MLA form (keys = entries,
values = their first dc columns); the GQA form is still to port
(ROADMAP) and will be another wrapper over the same kernel.  The plain
version of the MLA form is ``kernels/ref.py::sparse_mla_attn_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


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
