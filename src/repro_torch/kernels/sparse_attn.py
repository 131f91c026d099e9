"""Top-k sparse attention on the card (``repro/kernels/sparse_attn.py``).

Both forms run the split-k design of ``csrc/sparse_attn.cu``: pass 1
(``sparse_mla_partial_kernel`` / ``sparse_gqa_partial_kernel``) computes
the unnormalised softmax partials of each chunk of the k lanes into f32
scratch that the wrapper allocates, pass 2
(``sparse_attn_combine_kernel``) merges them; one C call launches both.
``split_plan`` picks the chunk on the host from the shape and from the
blocks of pass 1 the card holds at once, which the CUDA occupancy
calculator gives (``gqa_slots`` / ``mla_slots``).

``sparse_attn`` is the MLA form (``ops.batched_sparse_mla``: keys =
entries, values = their first dc columns); plain version
``kernels/ref.py::sparse_mla_attn_ref``.  ``sparse_attn_gqa`` is the
GQA/MQA form over entries laid out ``[2, n_kv, hd]``
(``ops.batched_sparse_gqa``); plain version
``kernels/ref.py::sparse_gqa_attn_ref``.  Each form has its own launch
counter, one count per wrapper call.

Both forms take bf16 entries or the fp8 pool's ``float8_e4m3fn`` ones
(read as e4m3 and converted to bf16 in shared memory as each tile lands,
never by a copy before the launch).  Their column rules are in bytes:
every staged range starts and ends on 16 bytes, so 8-element multiples
in bf16 and 16-element multiples in e4m3.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib, cost

#: kernel launches since the last reset (read by chip_smoke.py), MLA
#: form and GQA form
launches = 0
launches_gqa = 0

TILE = 64                       # entry rows per tile of pass 1
MAX_SCRATCH_BYTES = 16 << 20    # partials stay well inside the 50 MB L2
MLA_HEADS = 16                  # heads per block of the MLA form
ENTRY_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


@functools.lru_cache(maxsize=4096)
def split_plan(k: int, blocks: int, row_bytes: int, slots: int,
               tile: int = TILE) -> Tuple[int, int]:
    """(splits, chunk) for k lanes when the grid without splits has
    ``blocks`` blocks, the card holds ``slots`` blocks at once and one
    split costs ``row_bytes`` of scratch (0: none, as in the indexer,
    whose chunks are independent rows).

    Chunks are multiples of ``tile`` and split s takes lanes
    [s*chunk, min(k, (s+1)*chunk)), none empty.  A block's time is
    modelled as its tiles plus one tile of start-up and write-out, so the
    plan takes the chunk that minimises waves x (tiles per chunk + 1),
    the fewer splits on a tie, with the scratch under
    ``MAX_SCRATCH_BYTES``."""
    n_tiles = -(-k // tile)
    best = None
    for chunk_tiles in range(1, n_tiles + 1):
        splits = -(-n_tiles // chunk_tiles)
        if splits > 1 and splits * row_bytes > MAX_SCRATCH_BYTES:
            continue
        waves = -(-blocks * splits // max(slots, 1))
        key = (waves * (chunk_tiles + 1), splits)
        if best is None or key < best[0]:
            best = (key, splits, chunk_tiles * tile)
    return best[1], best[2]


def gqa_slots(n_rep: int, hd: int, index: Optional[int] = None,
              fp8: bool = False) -> int:
    """Blocks of GQA pass 1 (``fp8``: its e4m3 form) the card holds at
    once (0: shape refused)."""
    index = torch.cuda.current_device() if index is None else index
    return _lib.card_slots(index, "sac_sparse_attn_gqa_blocks_per_sm", n_rep,
                           hd, int(fp8))[0]


def mla_slots(dq: int, st_w: int, index: Optional[int] = None,
              fp8: bool = False) -> int:
    """Blocks of MLA pass 1 (``fp8``: its e4m3 form) the card holds at
    once (0: shape refused)."""
    index = torch.cuda.current_device() if index is None else index
    return _lib.card_slots(index, "sac_sparse_attn_blocks_per_sm", dq,
                           st_w, int(fp8))[0]


def mla_plan(B: int, H: int, dv: int, k: int,
             slots: Optional[int] = None,
             fp8: bool = False) -> Tuple[int, int]:
    """(splits, chunk) of the MLA form when the card holds ``slots``
    blocks (None: ask the current card, at DeepSeek-V3.2's 576 staged
    columns, in bf16 or with ``fp8`` in e4m3)."""
    slots = mla_slots(576, 576, fp8=fp8) if slots is None else slots
    return split_plan(k, B * -(-H // MLA_HEADS), B * H * (dv + 2) * 4, slots)


def gqa_plan(B: int, H: int, n_kv: int, hd: int, k: int,
             slots: Optional[int] = None,
             fp8: bool = False) -> Tuple[int, int]:
    """(splits, chunk) of the GQA form when the card holds ``slots``
    blocks (None: ask the current card, for bf16 or with ``fp8`` e4m3
    entries)."""
    slots = gqa_slots(H // n_kv, hd, fp8=fp8) if slots is None else slots
    return split_plan(k, B * n_kv, B * H * (hd + 2) * 4, slots)


# csrc/sparse_attn.cu's pass-1 constants, for the host's mirror of the
# shapes it takes (``gqa_accepts``, ``mla_accepts``)
_WARPS, _MAX_ITEMS, _P_STRIDE, _MAX_SMEM = 8, 5, TILE + 8, 232448


def _partial_smem(ranges: int, stages: int, stride: int, rows: int,
                  qs: int, rstride: int) -> int:
    """``csrc/sparse_attn.cu::partial_smem``: pass 1's shared memory."""
    tile = 2 * TILE * stride
    ring = (ranges * (stages * TILE * rstride + tile) if rstride
            else stages * ranges * tile)
    return (ring + 2 * (2 * rows * qs + 2 * rows * _P_STRIDE)
            + 4 * (2 * rows * _P_STRIDE + 3 * rows))


def gqa_accepts(n_rep: int, hd: int, fp8: bool = False) -> bool:
    """Whether GQA pass 1 takes n_rep heads of head dim hd
    (``csrc/sparse_attn.cu::gqa_pass1``): the host's rule, for ``meta``
    calls, where no card answers ``gqa_slots``."""
    epc = 16 if fp8 else 8
    if n_rep < 1 or hd < epc or hd % epc or hd > 512:
        return False
    dp, ht = -(-hd // 16) * 16, -(-n_rep // 16)
    if (-(-ht * (dp // 16) // _WARPS) > _MAX_ITEMS
            or n_rep * hd * 4 > 2 * 2 * TILE * (dp + 8)):
        return False
    return any(_partial_smem(2, st, dp + 8, 16 * ht, dp + 8,
                             hd if fp8 else 0) <= _MAX_SMEM for st in (2, 1))


def mla_accepts(dq: int, st_w: int, fp8: bool = False) -> bool:
    """Whether MLA pass 1 takes q of dq columns over a staged range of
    st_w (``csrc/sparse_attn.cu::mla_pass1``), for ``meta`` calls."""
    return dq <= st_w and _partial_smem(1, 2, st_w + 8, 16, dq + 8,
                                        st_w if fp8 else 0) <= _MAX_SMEM


def _entry_values(name: str, entries: torch.Tensor) -> int:
    """Entry values a 16-byte copy moves (8 bf16, 16 e4m3); raises for
    any other dtype."""
    if entries.dtype not in ENTRY_DTYPES:
        raise TypeError(f"{name}: entries must be bf16 or float8_e4m3fn, "
                        f"got {entries.dtype}")
    return 16 // entries.element_size()


def _valid_bytes(name: str, valid: torch.Tensor, B: int, k: int):
    """valid [B, k] bool, as the bytes the kernels read."""
    _lib.require_dtype(name, valid, torch.bool, "valid")
    if tuple(valid.shape) != (B, k):
        raise ValueError(f"{name}: valid must be [B, k] = {(B, k)}, got "
                         f"{tuple(valid.shape)}")
    return valid.view(torch.uint8)


def sparse_attn(q: torch.Tensor, entries: torch.Tensor, valid: torch.Tensor,
                *, scale: float, dv: int, k_col: int = 0,
                v_col: int = 0) -> torch.Tensor:
    """q: [B, H, dq] f32; entries: [B, k, de] bf16 or e4m3; valid: [B, k]
    bool -> out [B, H, dv] f32.

    keys = entries[..., k_col:k_col+dq], values =
    entries[..., v_col:v_col+dv]; invalid lanes score -1e30.  Any k (the
    ragged end is masked)."""
    global launches
    name = "sparse_attn"
    dev = _lib.require_cuda(name, q, entries, valid)
    _lib.require_dtype(name, q, torch.float32, "q")
    epc = _entry_values(name, entries)
    if q.dim() != 3 or entries.dim() != 3 or entries.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: q [B,H,dq] and entries [B,k,de], got "
                         f"{tuple(q.shape)} and {tuple(entries.shape)}")
    B, H, dq = q.shape
    k, de = entries.shape[1], entries.shape[2]
    vbytes = _valid_bytes(name, valid, B, k)
    st_col = min(k_col, v_col)
    st_w = max(k_col + dq, v_col + dv) - st_col
    st_w += -st_w % epc
    fp8 = entries.dtype == torch.float8_e4m3fn
    if (st_col % epc or k_col % epc or v_col % epc or dq % 16 or dv % 16
            or dv > 512 or st_col + st_w > de or de % epc
            or entries.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError(f"{name}: the kernel takes columns on 16 bytes "
                         f"({epc}-element multiples in {entries.dtype}), dq "
                         f"and dv multiples of 16, dv <= 512, inside de={de} "
                         f"(dq={dq}, dv={dv}, k_col={k_col}, v_col={v_col})")
    slots = (_lib.META_SLOTS * mla_accepts(dq, st_w, fp8)
             if dev.type == "meta" else mla_slots(dq, st_w, dev.index, fp8))
    if not slots:
        raise ValueError(f"{name}: pass 1 does not fit shared memory at "
                         f"dq={dq}, staged width {st_w}")
    splits, chunk = mla_plan(B, H, dv, k, slots)
    part = torch.empty(B * H * splits * (dv + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, H, dv), dtype=torch.float32, device=dev)
    if cost.RECORDERS:
        cost.record(name, cost.mla(B, H, k, dq, dv, de,
                                   entries.element_size()))
    if dev.type == "meta":
        return out
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_sparse_attn(
            q.data_ptr(), entries.data_ptr(), vbytes.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, H, k, dq, dv, k_col, v_col,
            st_col, st_w, splits, chunk, k * de, de, float(scale), int(fp8),
            _lib.stream())
    _lib.check(rc, name)
    launches += 1
    return out


def sparse_attn_gqa(q: torch.Tensor, entries: torch.Tensor,
                    valid: torch.Tensor, *, n_kv: int,
                    scale: float) -> torch.Tensor:
    """q: [B, H, hd] f32; entries: [B, k, 2*n_kv*hd] bf16 or e4m3 (rows
    laid out [2, n_kv, hd]); valid: [B, k] bool -> out [B, H, hd] f32.

    Head h attends with the keys and values of group h // (H / n_kv);
    invalid lanes score -1e30.  Any k (the ragged end is masked); hd up
    to 512 with a head's row on 16 bytes (a multiple of 8 in bf16, of 16
    in e4m3)."""
    global launches_gqa
    name = "sparse_attn_gqa"
    dev = _lib.require_cuda(name, q, entries, valid)
    _lib.require_dtype(name, q, torch.float32, "q")
    epc = _entry_values(name, entries)
    if q.dim() != 3 or entries.dim() != 3:
        raise ValueError(f"{name}: q [B,H,hd] and entries [B,k,de], got "
                         f"{tuple(q.shape)} and {tuple(entries.shape)}")
    B, H, hd = q.shape
    k = entries.shape[1]
    if (entries.shape[0] != B or n_kv < 1 or H % n_kv
            or entries.shape[2] != 2 * n_kv * hd):
        raise ValueError(f"{name}: entries [B,k,2*n_kv*hd] and H % n_kv == "
                         f"0; got q {tuple(q.shape)}, entries "
                         f"{tuple(entries.shape)}, n_kv={n_kv}")
    vbytes = _valid_bytes(name, valid, B, k)
    n_rep = H // n_kv
    fp8 = entries.dtype == torch.float8_e4m3fn
    slots = (_lib.META_SLOTS * gqa_accepts(n_rep, hd, fp8)
             if dev.type == "meta" else gqa_slots(n_rep, hd, dev.index, fp8))
    if not slots or entries.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(
            f"{name}: the kernel takes hd % {epc} == 0 ({entries.dtype} "
            f"entries), hd <= 512, at most 5 "
            f"P V items (16 heads x 16 columns) a warp, "
            f"ceil(ceil(n_rep/16) * ceil(hd/16) / 8) <= 5, a group's f32 q "
            f"rows within one tile stage, n_rep * hd * 4 <= "
            f"256 * (ceil(hd/16)*16 + 8) bytes, and 16-byte aligned q and "
            f"entries (got n_rep={n_rep}, hd={hd})")
    splits, chunk = gqa_plan(B, H, n_kv, hd, k, slots)
    part = torch.empty(B * H * splits * (hd + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    if cost.RECORDERS:
        cost.record("sparse_attn_gqa", cost.gqa(B, H, n_kv, hd, k,
                                                entries.element_size()))
    if dev.type == "meta":
        return out
    with torch.cuda.device(dev):
        rc = _lib.lib().sac_sparse_attn_gqa(
            q.data_ptr(), entries.data_ptr(), vbytes.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, H, n_kv, k, hd, splits, chunk,
            k * entries.shape[2], entries.shape[2], float(scale), int(fp8),
            _lib.stream())
    _lib.check(rc, name)
    launches_gqa += 1
    return out

