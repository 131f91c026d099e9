"""The analytic cost of each hand-written kernel: FLOPs and bytes as
functions of a call's shapes and dtypes.

One place for the count that two readers need: ``chip_smoke.py``'s
bound of each kernel (``bound_ms``, the ``PERF.md`` bound column) and the
dry-run's whole-step count (``distributed/cost_analysis.py``), to which
every kernel wrapper reports its call while a counter is active
(``record``: on the card the launch, on ``meta`` the launch the card
would make; the wrappers' own ``launches`` counters move only on the
card).  The convention is the roofline's: each input byte is read
once and each output byte written once; FLOPs are the multiply-adds of
the function (two each), none for the row movers.

A count that depends on the data (the valid lanes of an attention call,
the rows of a shard gather that lie in the rank's slice, the lanes whose
decode write a rank owns) is an argument: ``chip_smoke.py`` passes what
its inputs give, and a wrapper, which reads no device data, leaves the
default, the whole call (every lane, every row).
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

# the peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, the
# bf16 tensor cores' dense rate, and one direction of NVLink 4
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
NVLINK_BYTES_PER_S = 450e9

INDEX_BYTES = 4                          # int32 row index or position
F32 = 4


class Cost(NamedTuple):
    flops: float
    bytes: int

    def __add__(self, other):             # tuples would concatenate
        return Cost(self.flops + other.flops, self.bytes + other.bytes)


def bound_ms(cost: Cost) -> Tuple[float, str]:
    """The least time one H100 could take for ``cost``: the larger of its
    bytes over the HBM rate and its FLOPs over the bf16 peak, in ms, and
    which of the two it is ("bytes" or "operations")."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S
    t_ops = cost.flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# the row movers
# ---------------------------------------------------------------------------


def rows(n: int, row_bytes: int, n_read: Optional[int] = None) -> Cost:
    """A row mover over ``n`` int32 indices (the gather, the scatter's
    index form, the page gather with a page as its row): each index
    read, ``n_read`` rows read (default ``n``; the shard gather reads
    only the rows in its slice) and ``n`` rows written."""
    n_read = n if n_read is None else n_read
    return Cost(0.0, n * INDEX_BYTES + (n_read + n) * row_bytes)


def gather(pairs: Sequence) -> Cost:
    """``gather_kv_many`` / ``gather_kv_shard`` over (kv [B, S, d], idx
    [B, k]) pairs, one launch, every row read (the shard form's rows in
    the slice: ``rows`` with ``n_read``)."""
    total = Cost(0.0, 0)
    for kv, idx in pairs:
        total = total + rows(idx.shape[0] * idx.shape[1],
                             kv.shape[-1] * kv.element_size())
    return total


def gather_pages(n_pages: int, page: int, row_bytes: int) -> Cost:
    """``gather_kv_pages``: ``n_pages`` page ids, pages of ``page``
    rows."""
    return rows(n_pages, page * row_bytes)


def write_rows_at(B: int, pools: Iterable[Tuple[int, int]],
                  lanes: Optional[int] = None) -> Cost:
    """The decode write: B positions read once, then for each pool (L,
    row bytes) L rows of each written lane read from the entries and
    written into the pool; ``lanes`` (default B) the lanes written (the
    shard form writes only those whose position it owns)."""
    lanes = B if lanes is None else lanes
    return Cost(0.0, B * INDEX_BYTES
                + sum(2 * L * lanes * w for L, w in pools))


def splice(segments: Iterable[Tuple[int, int, int, int, int]]) -> Cost:
    """A splice over (L, lanes, rows read, rows written, row bytes)
    segments, one a pool: the rows read from each lane's source and the
    rows written into its pool (with the tail zeroed, every row from the
    offset to the pool's end)."""
    return Cost(0.0, sum(L * n * (r + w) * rb for L, n, r, w, rb in segments))


def splice_pools(pools: Sequence, srcs: Sequence, *, offset: int = 0,
                 lane: Optional[int] = None, zero_tail: bool = False,
                 src_row0: Optional[int] = None) -> Cost:
    """``scatter_kv.splice`` / ``splice_shard`` on its tensors (pool [L,
    B, S, d], source [L, b, T, d])."""
    segs: List[Tuple[int, int, int, int, int]] = []
    for pool, src in zip(pools, srcs):
        L, B, S, d = pool.shape
        T = (src.shape[2] if src_row0 is None
             else min(max(src.shape[2] - src_row0, 0), S - offset))
        segs.append((L, B if lane is None else 1, T,
                     S - offset if zero_tail else T,
                     d * pool.element_size()))
    return splice(segs)


# ---------------------------------------------------------------------------
# the indexer and the attention
# ---------------------------------------------------------------------------


def indexer(B: int, S: int, H: int, di: int, key_bytes: int = 2) -> Cost:
    """Σ_h w·ReLU(q·k) over B requests of S keys: the keys read, q and w
    in f32, the scores written in f32; 2·B·S·H·di FLOPs."""
    return Cost(2.0 * B * S * H * di,
                B * S * di * key_bytes + B * H * (di + 1) * F32 + B * S * F32)


def mla(B: int, H: int, k: int, dq: int, dv: int, row: int,
        entry_bytes: int, n_valid: Optional[int] = None) -> Cost:
    """The MLA form over k lanes of entries of ``row`` values: the valid
    lanes' entries read (``n_valid``, all B requests together; default
    every lane), q and out in f32, the mask a byte a lane; QK and PV
    multiply-adds of every valid lane."""
    n_valid = B * k if n_valid is None else n_valid
    return Cost(2.0 * n_valid * H * (dq + dv),
                n_valid * row * entry_bytes + B * H * (dq + dv) * F32 + B * k)


def gqa(B: int, H: int, n_kv: int, hd: int, k: int, entry_bytes: int,
        n_valid: Optional[int] = None) -> Cost:
    """The GQA form: entries of 2·n_kv·hd values (keys and values of
    every KV head), otherwise as ``mla`` with dq = dv = hd."""
    n_valid = B * k if n_valid is None else n_valid
    return Cost(4.0 * n_valid * H * hd,
                n_valid * 2 * n_kv * hd * entry_bytes
                + B * H * 2 * hd * F32 + B * k)


# ---------------------------------------------------------------------------
# the counters that read the wrappers' reports
# ---------------------------------------------------------------------------

#: the active counters (``distributed/cost_analysis.py``); empty unless a
#: dry-run count is under way, so a wrapper's report is one list test
RECORDERS: List = []


def record(name: str, cost: Cost) -> None:
    """A kernel wrapper's call of ``name`` (its ``ops.launch_counts``
    name) at ``cost``, handed to every active counter."""
    for r in RECORDERS:
        r.kernel(name, cost)
