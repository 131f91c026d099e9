"""KV-cache pool (``repro/core/pool.py``): the single-device path and the
pool sharded over a ``torch.distributed`` device mesh.

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

**The sharded pool** (``make_pooled_fetch``, the paper's CXL pool as
the aggregate memory of the ``model`` mesh axis): each rank holds the
slice ``[base, base + S_local)`` of every pool's sequence axis
(``base = model rank * S_local``) for its own request lanes.  A fetch
gathers the top-k rows with the gather kernel's shard form (rows of
other ranks come out as zeros), then ONE all-reduce over the ``model``
group assembles ``[B, k, d]`` on every rank.  The all-reduce takes the
MAX of the rows' bytes (a ``uint8`` view): exactly one rank holds
non-zero bytes for any row, so every row arrives bit for bit, in bf16
and in e4m3 (NaN and -0 included); a bf16 sum would turn -0 into +0,
and gloo sums no float8.  The returned callable carries
its shard (``.shard``), which the decode reads to score, select and
write shard-aware (``core/sac.py``, ``models/transformer.py``,
``models/encdec.py``).  ``dense`` mode reads each layer whole: one
all-gather of the slices' bytes (``PoolShard.gather_pool``), then the
unsharded dense attention, so its bits do not depend on the world.
Each rank decodes the lanes it is handed: split over the non-pool
axes, or the same lanes on each of their ranks (a batch of one
replicated over ``data``); ``batch_axes`` changes neither.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

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


class PoolShard:
    """One rank's place on the pool axis of a mesh: its ``rank`` of
    ``size`` in the axis's process ``group``.  A pool slice of
    ``S_local`` rows starts at ``base(S_local)`` of ``seq_len(S_local)``
    positions.  Both collectives take CUDA tensors in NCCL and in gloo
    (gloo stages them through the host itself)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def of(cls, mesh, pool_axis: str = "model",
           batch_axes=("pod", "data")) -> "PoolShard":
        """``mesh``'s pool axis.  ``batch_axes`` is kept for the
        reference's signature and changes no collective and no result:
        the collectives run over the pool axis's group alone, and each
        rank decodes the lanes its caller hands in.  Whether those lanes
        are split over the other axes (``("data",)``) or the same on
        each of their ranks (``()``, a batch of one replicated over
        ``data``) is the caller's choice of lanes, not this value's.  It
        is checked only for the pool axis, which cannot split the lanes:
        naming it raises."""
        names = tuple(mesh.mesh_dim_names or ())
        if pool_axis not in names:
            raise ValueError(f"the mesh {names} has no pool axis "
                             f"{pool_axis!r}")
        if pool_axis in batch_axes:
            raise ValueError(
                f"batch_axes {tuple(batch_axes)} name the pool axis "
                f"{pool_axis!r}: it splits the pool, not the lanes")
        return cls(mesh.get_group(pool_axis), mesh.get_local_rank(pool_axis),
                   mesh.size(names.index(pool_axis)))

    def base(self, S_local: int) -> int:
        return self.rank * S_local

    def seq_len(self, S_local: int) -> int:
        return self.size * S_local

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n] on each rank -> [B, size * n], the ranks' blocks in rank
        order (so positions stay in order along the pool axis)."""
        B, n = x.shape
        out = x.new_empty((self.size * B, n))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out.view(self.size, B, n).permute(1, 0, 2).reshape(
            B, self.size * n)

    def gather_pool(self, x: torch.Tensor, bufs: Optional[dict] = None
                    ) -> torch.Tensor:
        """A pool layer's slices [B, S_local, d] on each rank -> the whole
        layer [B, S, d] on every rank, bit for bit: ONE all-gather of the
        bytes (gloo takes no float8 and loses a bf16 -0 in a sum; a
        gather of bytes moves every bit) into a buffer [size, B, S_local,
        d], the slices in rank order, then (over more than one rank) one
        copy into [B, S, d] order.  ``bufs`` (a dict the caller keeps
        across layers) holds both buffers, so a decode step allocates
        them once."""
        B, S_local, d = x.shape

        def buf(name, shape):
            t = None if bufs is None else bufs.get(name)
            if t is None or t.shape != shape or t.dtype != x.dtype:
                t = x.new_empty(shape)
                if bufs is not None:
                    bufs[name] = t
            return t
        ranks = buf("ranks", (self.size, B, S_local, d))
        dist.all_gather_into_tensor(
            ranks.view(torch.uint8).view(-1),
            x.contiguous().view(torch.uint8).view(-1), group=self.group)
        if self.size == 1:
            return ranks[0]
        out = buf("pool", (B, self.size * S_local, d))
        out.view(B, self.size, S_local, d).copy_(ranks.permute(1, 0, 2, 3))
        return out

    def combine_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The ranks' masked gathers (zeros where a rank does not hold the
        row) -> the whole gather on every rank, bit for bit: an all-reduce
        of the bytes with MAX, IN PLACE; returns ``rows``."""
        dist.all_reduce(rows.view(torch.uint8), op=dist.ReduceOp.MAX,
                        group=self.group)
        return rows


class PooledFetch:
    """``fetch(pool_layer, idx)`` over a sharded pool: pool_layer [B,
    S_local, d] is this rank's slice, idx [B, k] global rows -> [B, k, d]
    on every rank of the pool axis (the gather's shard form, then one
    byte all-reduce)."""

    def __init__(self, shard: PoolShard):
        self.shard = shard

    def __call__(self, pool_layer: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
        rows = ops.batched_gather_shard(
            pool_layer, idx, self.shard.base(pool_layer.shape[1]))
        return self.shard.combine_rows(rows)


def make_pooled_fetch(mesh, *, batch_axes=("pod", "data"),
                      pool_axis: str = "model") -> PooledFetch:
    """The pooled-HBM fetch over ``mesh`` (a ``DeviceMesh``): each rank
    calls it with its own lanes (split over the non-pool axes or
    replicated over them: ``batch_axes`` does not decide it,
    ``PoolShard.of``) and its slice of the pool axis; the result
    is replicated over ``pool_axis`` (ready for the attention), as the
    reference's ``shard_map`` gives it.
    ``build_model(cfg, fetch_fn=make_pooled_fetch(mesh))`` serves from
    the sharded pool."""
    return PooledFetch(PoolShard.of(mesh, pool_axis, batch_axes))


def make_fetch_fn(mesh, backend: str = "local", **kw) -> FetchFn:
    """Resolve the fetch callback for a backend name.

    ``local``      -- single-device gather (tests, host_dram engine).
    ``pooled_hbm`` -- the pool sharded over ``mesh``'s pool axis.
    """
    if backend == "pooled_hbm":
        if mesh is None:
            raise ValueError("pooled_hbm backend requires a mesh")
        return make_pooled_fetch(mesh, **kw)
    if backend in ("local", "host_dram"):
        return local_fetch
    raise ValueError(f"unknown pool backend {backend!r}")


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
                    new_entries: Sequence[torch.Tensor], pos: torch.Tensor,
                    shard: Optional[PoolShard] = None
                    ) -> Sequence[torch.Tensor]:
    """``pool_write`` of several pools (a decode step's latent or (k, v)
    entries and its indexer keys) at the same positions, IN PLACE, in one
    launch on the card; returns ``pools``.  With ``shard`` the pools are
    this rank's slices, and a row is written only where its position
    (clamped into the whole pool) falls in the slice."""
    for pool in pools:
        _check_contiguous(pool)
    entries = [to_kv_dtype(e, p.dtype) for e, p in zip(new_entries, pools)]
    if shard is None:
        ops.pool_rows_at(pools, entries, pos)
    else:
        S_local = pools[0].shape[2]
        ops.pool_rows_at(pools, entries, pos, shard.base(S_local),
                         shard.seq_len(S_local))
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
