"""Tensor and expert parallelism of the weights, with the d_model rows
split too: what the reference gets from ``params_shardings`` and the
collectives GSPMD inserts (``repro/launch/dryrun.py:147-199``, the
``constrain`` calls of ``repro/models/{transformer,moe}.py``), written
out for one rank.

Under ``sharding.use_rules(rules, mesh)`` the decoder-only models'
``forward``, ``prefill`` and ``decode`` (``models/transformer.py``) run
on this rank's block of every weight (``sharding.shard_params`` /
``init_shards``, the blocks ``spec_for`` names) and read the config
through ``RankView``: the config's fields plus ``tp``, this object.  The
model functions ask it how a weight is split (``split``) and run its
collectives:

- vocab-parallel embedding (an all-reduce of the looked-up rows) and
  column-parallel ``lm_head`` (an all-gather of the logits' blocks);
- column-parallel q / k / v / indexer-q / ``w_uq`` / ``w_gate`` /
  ``w_up`` (all-gathers of the small k / v / q blocks where the whole
  is needed), row-parallel ``wo`` / ``w_down`` (one all-reduce each);
- the experts: the tokens all-gathered over the batch axes, one
  dispatch of the whole token set with the reference's groups and
  capacity on every rank, the rank's experts on their slots, one
  all-reduce of the partial outputs over the axes that split the
  experts' work, then the rank's own lanes; or, with dispatch groups
  over the batch axes, each rank's own groups dispatched and their
  slots traded with the experts' owners by ``all_to_all``.

The d_model rows (``D``, and the experts' ``DE``) split over the
``data`` axis under ``TRAIN_RULES`` and under the serve rules of a batch
that does not split (``SERVE_RULES`` plus ``D=("data",)``).  ``matmul``
runs a product with such a weight in one of two forms, by whether its
input is the same on every rank of the rows' axes:

- the same (a batch of one replicated over ``data``; the MoE block's
  gathered tokens): the rank's columns of the input against its rows,
  the partial products summed over the rows' axes; a product whose
  output dim is ``D`` (``wo``, ``w_down``, the embedding) all-gathers
  its output's blocks.  No weight moves;
- different (the training batch split over ``data``): the weight's
  rows all-gathered over those axes just before the product (``rows``:
  ZeRO-3's gather, bit-exact with the whole block), whose backward
  reduce-scatters the gradient.  Inside the per-layer activation
  checkpoint the gathered block is not kept between layers.

A partial sum is made and crosses in f32 and is rounded once, as the
unsharded product rounds its f32 accumulation once.  Every collective
is an autograd function whose backward gives each rank its gradient of
the global loss (each rank's loss is the mean over its lanes scaled by
its share of the global lanes; the global loss is the sum over the
batch ranks).  The gradient of a tensor that is the same on the ranks of
an axis is held whole on each of them (DTensor's ``Replicate``; a
``Partial`` gradient made by rank-specific work is summed into it by
``enter``, Megatron's f, at the point where the rank-specific use
starts): so an all-reduce's backward is the identity, an all-gather's
the rank's block, and the rows' gather's a reduce-scatter (its whole
weight is used on the rank's own lanes).  A collective over axes whose
sizes multiply to 1 is the identity both ways, so a world of one runs
the unsharded path's arithmetic bit for bit.  ``WHOLE`` is the plan
without a mesh: every weight whole, every collective the identity.

The recurrent and encoder-decoder families run on their blocks too
(``models/ssm.py``, ``models/encdec.py``): a block of a fused or a head
dim need not be whole heads.  ``rms_norm`` normalises a vector whose
blocks lie on several ranks (one all-reduce of the squared sums);
``all_gather(..., reduce=True)`` joins blocks that each rank then uses
on its own part (its backward reduce-scatters the partial gradients);
``rec_block`` is a rank's block of a recurrent-state leaf, placed as the
reference's ``_rec_pspec`` places it (``sharding.rec_spec``).

The sequence-parallel residual (Megatron's sequence parallelism, the
reference's ``constrain(x, ("B", "S", "D"))`` with ``"S": ("model",)``):
a plan made with ``seq`` (the attention families' training forward and
prefill, ``rank_view``) keeps the residual between layers as the rank's
contiguous block of each lane's sequence (``seq``, the ``S`` rule's
axes off the batch's, in ``block_of`` order).  Norms run on the block.
``gather_seq`` joins the blocks in front of the column-parallel
products (its backward reduce-scatters the rank-specific uses'
gradients), and the row-parallel products' sum is a reduce-scatter over
the sequence (``matmul(..., scatter=True)``, ``all_reduce(...,
scatter=True)``: the f32 sum rounded once, its backward an all-gather)
in place of the all-reduce.  A weight the same on every rank of the
sequence's axes that a rank uses on its own block (a norm's gamma,
MLA's down-projections) has its gradient summed over them
(``on_slice``).  Without ``seq`` (decode; Zamba2, xLSTM and Whisper) the
residual is whole on every ``model`` rank and each of these is the
plain path's.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _shd():
    # imported at first use: sharding imports models.layers, which
    # imports this module
    from repro_torch.distributed import sharding
    return sharding


@dataclasses.dataclass(frozen=True)
class Split:
    """A tensor dim over ``axes``: ``n`` blocks, this rank's ``index``."""
    axes: Tuple[str, ...]
    n: int
    index: int

    def bounds(self, size: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's block of a dim of ``size``."""
        b = size // self.n
        return self.index * b, (self.index + 1) * b


WHOLE_SPLIT = Split((), 1, 0)
#: the sequence dim of a ``[B, S, ...]`` activation
SEQ_DIM = 1
#: the logical dims of the d_model rows (a dense weight's, an expert's)
ROW_DIMS = ("D", "DE")


def _minus(axes, drop) -> Tuple[str, ...]:
    return tuple(a for a in axes if a not in drop)


class Whole:
    """One rank holds every weight whole (the unsharded path)."""
    batch_axes: Tuple[str, ...] = ()
    seq: Split = WHOLE_SPLIT

    def split(self, dims: Sequence[str], shape: Sequence[int],
              i: int) -> Split:
        return WHOLE_SPLIT

    def size(self, axes) -> int:
        return 1

    def all_reduce(self, x: torch.Tensor, axes, scatter: bool = False
                   ) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int = -1
                   ) -> torch.Tensor:
        return x

    def matmul(self, x: torch.Tensor, w: torch.Tensor, dims, shape,
               axes=(), scatter: bool = False) -> torch.Tensor:
        return x @ w

    def gather_seq(self, x: torch.Tensor, axes=()) -> torch.Tensor:
        return self.enter(x, axes)

    def own_seq(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def seq_rows(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return x[torch.arange(x.shape[0], device=x.device), pos.long()]

    def on_slice(self, w: torch.Tensor) -> torch.Tensor:
        return w

    def check_seq(self, S: int) -> None:
        pass

    def rows(self, w: torch.Tensor, dims, shape) -> torch.Tensor:
        return w

    def product(self, w: torch.Tensor, dims, shape):
        return lambda x: x @ w

    def enter(self, x: torch.Tensor, axes) -> torch.Tensor:
        return x

    def all_to_all(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        return x

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def own_lanes(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def rms_norm(self, x, gamma, axes, width: int, eps: float = 1e-6):
        from repro_torch.models.layers import rms_norm
        return rms_norm(x, gamma, eps)

    def rec_block(self, shape, lane: int):
        return None


WHOLE = Whole()


def tp_of(cfg):
    """The plan a config view carries (``WHOLE`` for a plain config)."""
    return getattr(cfg, "tp", WHOLE)


# ---------------------------------------------------------------------------
# the collectives, under autograd
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    """The sum over ``axes`` in f32 (a partial sum made whole on every
    rank); backward: the identity (the whole sum's gradient is each
    partial's)."""

    @staticmethod
    def forward(ctx, x, tp, axes):
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=tp._group(axes)[0])
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Megatron's f: the identity, whose backward sums the gradient over
    ``axes`` in f32 (the ranks' rank-specific uses of a tensor that is
    the same on all of them each make a part of its gradient)."""

    @staticmethod
    def forward(ctx, x, tp, axes):
        ctx.tp, ctx.axes = tp, axes
        return x

    @staticmethod
    def backward(ctx, g):
        y = g.to(torch.float32, copy=True)
        dist.all_reduce(y, group=ctx.tp._group(ctx.axes)[0])
        return y.to(g.dtype), None, None


class _SumOver(torch.autograd.Function):
    """The sum over ``axes`` in f32 of a partial sum that each rank then
    uses on its own block: forward and backward are both all-reduces
    (the whole sum's gradient is the sum of the ranks' uses')."""

    @staticmethod
    def forward(ctx, x, tp, axes):
        ctx.tp, ctx.axes = tp, axes
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=tp._group(axes)[0])
        return y

    @staticmethod
    def backward(ctx, g):
        y = g.to(torch.float32, copy=True)
        dist.all_reduce(y, group=ctx.tp._group(ctx.axes)[0])
        return y, None, None


class _AllGather(torch.autograd.Function):
    """The blocks over ``axes`` joined along ``dim``; backward: the
    rank's block of the gradient, summed over ``axes`` first (a
    reduce-scatter in f32) with ``reduce``."""

    @staticmethod
    def forward(ctx, x, tp, axes, dim, reduce):
        ctx.tp, ctx.axes, ctx.dim, ctx.reduce = tp, axes, dim, reduce
        return tp._gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        tp, axes, dim = ctx.tp, ctx.axes, ctx.dim
        if ctx.reduce:
            return tp._reduce_scatter(g, axes, dim), None, None, None, None
        n, i = _shd().block_of(axes, tp.mesh, tp.coord)
        b = g.shape[dim] // n
        return g.narrow(dim, i * b, b), None, None, None, None


class _ScatterSeq(torch.autograd.Function):
    """The sum over ``axes`` of every rank's ``x`` in f32, cut to this
    rank's block of the sequence (dim ``SEQ_DIM``): a reduce-scatter over
    the sequence's axes where they are among ``axes``, else the rank's
    block, then the block's all-reduce over the other axes; backward:
    the gradient's blocks all-gathered over the sequence's axes (each
    rank's use of its block is its own)."""

    @staticmethod
    def forward(ctx, x, tp, axes):
        ctx.tp = tp
        seq = tp.seq.axes
        if set(seq) <= set(axes):
            y = tp._reduce_scatter(x.float(), seq, SEQ_DIM)
        else:
            lo, hi = tp.seq.bounds(x.shape[SEQ_DIM])
            y = x.float().narrow(SEQ_DIM, lo, hi - lo).clone()
        rest = _minus(axes, seq)
        if tp.size(rest) > 1:
            y = y.contiguous()
            dist.all_reduce(y, group=tp._group(rest)[0])
        return y

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._gather(g, ctx.tp.seq.axes, SEQ_DIM), None, None


class _AllToAll(torch.autograd.Function):
    """Block k of ``dim`` sent to the rank that holds block k over
    ``axes``, and every rank's block for this one received in their block
    order; backward: the same exchange of the gradient (the reverse
    all-to-all)."""

    @staticmethod
    def forward(ctx, x, tp, axes, dim):
        ctx.tp, ctx.axes, ctx.dim = tp, axes, dim
        return tp._all_to_all(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_to_all(g, ctx.axes, ctx.dim), None, None, None


class TensorParallel(Whole):
    """One rank's place on ``mesh`` under ``rules``.

    ``batch_axes``: the axes this rank's request lanes are split over
    (each rank the same count, in block order); by default the ``B``
    rule's axes in the mesh.  Lanes replicated over an axis (a batch of
    one) leave it out.  A weight whose rows (``D`` / ``DE``) are split
    over axes of the batch has them gathered before use (``rows``); one
    whose rows are split over axes the lanes are replicated over runs on
    the input's columns (``matmul``).  Rows over axes of both kinds are
    refused.
    """

    def __init__(self, mesh, rules: Dict[str, Tuple[str, ...]],
                 batch_axes: Optional[Sequence[str]] = None):
        names = tuple(mesh.mesh_dim_names)
        self.mesh, self.rules, self.names = mesh, rules, names
        self.sizes = dict(zip(names, (int(s) for s in mesh.shape)))
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.coord = dict(zip(names, coord))
        if batch_axes is None:
            batch_axes = rules.get("B", ())
        self.batch_axes = tuple(a for a in batch_axes if a in self.sizes)
        self._grid = mesh.mesh.numpy()
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._orders: Dict[Tuple[str, ...], Tuple[object, list]] = {}
        self._row_memo: Dict[Tuple, list] = {}

    def with_seq(self) -> "TensorParallel":
        """This plan with the residual split over the sequence: ``seq``
        the ``S`` rule's axes in the mesh that the lanes are not split
        over (the process groups are shared with this plan)."""
        out = copy.copy(self)
        axes = tuple(a for a in self.rules.get("S", ())
                     if a in self.sizes and a not in self.batch_axes)
        out.seq = Split(axes, *_shd().block_of(axes, self.mesh, self.coord))
        return out

    # -- blocks ---------------------------------------------------------------
    def split(self, dims, shape, i):
        axes = _shd().spec_for(dims, shape, self.mesh, self.rules)[i] or ()
        n, index = _shd().block_of(axes, self.mesh, self.coord)
        return Split(tuple(axes), n, index)

    def size(self, axes) -> int:
        """The ranks the axes hold (1: nothing is split over them)."""
        return math.prod(self.sizes[a] for a in axes or ())

    def _row_splits(self, dims, shape):
        """[(i, split, gathered)] of each of ``dims`` that is a row dim
        split over more than one rank: ``gathered`` where its axes are
        batch axes (the input differs over them)."""
        key = (tuple(dims), tuple(shape))
        if key in self._row_memo:
            return self._row_memo[key]
        out = []
        for i, dim in enumerate(dims):
            if dim not in ROW_DIMS:
                continue
            s = self.split(dims, shape, i)
            if s.n == 1:
                continue
            batch = set(s.axes) & set(self.batch_axes)
            if batch and batch != set(s.axes):
                raise ValueError(
                    f"{dim} over {s.axes}, the lanes over "
                    f"{self.batch_axes}: the rows are neither all over "
                    "the batch's axes nor all off them")
            out.append((i, s, bool(batch)))
        self._row_memo[key] = out
        return out

    def grad_sum_axes(self, dims, shape) -> Tuple[str, ...]:
        """The batch axes a weight's gradient is summed over after the
        backward: those its block is not split over (a row block gathered
        by ``rows`` had its gradient reduce-scattered).  None for the MoE
        block's weights (``E`` dims): they run on the whole token set, so
        each rank's gradient is already the whole batch's."""
        if "E" in dims:
            return ()
        spec = _shd().spec_for(dims, shape, self.mesh, self.rules)
        split = {a for axes in spec for a in axes or ()}
        return tuple(a for a in self.batch_axes if a not in split)

    # -- process groups -----------------------------------------------------
    def _members(self, axes, fixed) -> list:
        """The global ranks at coordinates ``fixed`` off ``axes``, one per
        block of a dim over ``axes`` (``block_of``'s order)."""
        coord = dict(fixed)
        out = []
        for block in itertools.product(*(range(self.sizes[a])
                                         for a in axes)):
            coord.update(zip(axes, block))
            out.append(int(self._grid[tuple(coord[a] for a in self.names)]))
        return out

    def _group(self, axes: Tuple[str, ...]):
        """(group, order): the process group of the ranks that differ
        from this one only on ``axes``, and the group rank that holds
        each block of a dim over ``axes`` (``block_of``'s order; a group's
        ranks are in global rank order).  A group of one axis is the
        mesh's; one of several is made with ``new_group`` at first use by
        every rank of the world, one per coordinate of the other axes,
        in a fixed order (every rank runs the same layers)."""
        axes = tuple(axes)
        if axes in self._orders:
            return self._orders[axes]
        key = tuple(a for a in self.names if a in axes)
        others = [a for a in self.names if a not in axes]
        if key not in self._groups:
            if len(key) == 1:
                self._groups[key] = self.mesh.get_group(key[0])
            else:
                for fixed in itertools.product(*(range(self.sizes[a])
                                                 for a in others)):
                    group = dist.new_group(sorted(self._members(
                        key, zip(others, fixed))))
                    if all(f == self.coord[a]
                           for a, f in zip(others, fixed)):
                        self._groups[key] = group
        members = self._members(axes, ((a, self.coord[a]) for a in others))
        ranked = sorted(members)
        self._orders[axes] = (self._groups[key],
                              [ranked.index(r) for r in members])
        return self._orders[axes]

    # -- collectives ------------------------------------------------------------
    def all_reduce(self, x, axes, scatter: bool = False):
        """The sum over ``axes`` of every rank's ``x``, in f32, rounded once
        to ``x``'s dtype (``x`` itself where the axes hold one rank); with
        ``scatter`` and the residual split over the sequence, this rank's
        block of the sum's sequence (``x`` [B, S, ...]: a reduce-scatter,
        ``_ScatterSeq``)."""
        if scatter and self.seq.n > 1:
            return _ScatterSeq.apply(x, self, tuple(axes)).to(x.dtype)
        if self.size(axes) == 1:
            return x
        return _AllReduce.apply(x, self, tuple(axes)).to(x.dtype)

    def matmul_sum(self, a, w, axes, scatter: bool = False):
        """``a @ w`` of a row-parallel weight block ``w`` (and ``a``'s
        matching columns), summed over ``axes``: each rank's product in
        f32, the sum rounded once to ``a``'s dtype, as one product of the
        whole weight rounds (the same product where the axes hold one
        rank); with ``scatter``, the sum's block of the sequence
        (``all_reduce``)."""
        if scatter and self.seq.n > 1:
            y = (a @ w if self.size(axes) == 1
                 else torch.matmul(a.float(), w.float()))
            return _ScatterSeq.apply(y, self, tuple(axes)).to(a.dtype)
        if self.size(axes) == 1:
            return a @ w
        y = torch.matmul(a.float(), w.float())
        return _AllReduce.apply(y, self, tuple(axes)).to(a.dtype)

    def matmul(self, x, w, dims, shape, axes=(), scatter: bool = False):
        """``x @ w`` for this rank's block ``w`` of a weight of ``shape``
        over the logical ``dims`` (``x``'s last dim against ``w``'s
        first), summed over ``axes`` (the axes that split the contraction
        besides the rows: ``wo``'s heads), with ``scatter`` cut to the
        rank's block of the sequence (``matmul_sum``).  Rows over batch
        axes are gathered (``rows``); rows over axes the input is the same
        on take the input's matching columns (a contraction over them: its
        partial products summed over their axes) or leave the output a
        block of columns (all-gathered)."""
        w = self.rows(w, dims, shape)
        axes = tuple(axes)
        out = []
        for i, s, gathered in self._row_splits(dims, shape):
            if gathered:
                continue
            if i == 0:
                lo, hi = s.bounds(shape[0])
                x = self.enter(x, s.axes)[..., lo:hi]
                axes += s.axes
            else:
                out.append(s.axes)
        y = self.matmul_sum(x, w, axes, scatter)
        for a in out:
            y = self.all_gather(y, a)
        return y

    def rows(self, w, dims, shape):
        """``w`` with its row dims that are split over batch axes gathered
        whole (ZeRO-3's gather; its backward reduce-scatters the
        gradient); ``w`` itself where none is."""
        for i, s, gathered in self._row_splits(dims, shape):
            if gathered:
                w = _AllGather.apply(w, self, s.axes, i, True)
        return w

    def product(self, w, dims, shape):
        """``x -> matmul(x, w, dims, shape)`` for a loop of products with
        one weight (the sLSTM's recurrence): rows over batch axes gathered
        once, before the loop."""
        if all(g for _, _, g in self._row_splits(dims, shape)):
            w = self.rows(w, dims, shape)
            return lambda x: x @ w
        return lambda x: self.matmul(x, w, dims, shape)

    def enter(self, x, axes):
        """``x``, the same on the ranks of ``axes``, where each of them
        starts a use of its own: the identity, whose backward sums the
        gradient over ``axes``."""
        if self.size(axes) == 1:
            return x
        return _Enter.apply(x, self, tuple(axes))

    def all_gather(self, x, axes, dim=-1, reduce: bool = False):
        """The blocks of ``x`` over ``axes`` joined along ``dim`` in block
        order (one all-gather of the bytes: any dtype, every bit); its
        backward takes the rank's block of the gradient, or, with
        ``reduce`` (each rank uses the whole on its own part: its
        gradient is a partial sum), reduce-scatters it."""
        if self.size(axes) == 1:
            return x
        return _AllGather.apply(x, self, tuple(axes), dim % x.dim(), reduce)

    def gather_seq(self, x, axes=()):
        """The residual's sequence blocks ``x`` [B, S/n, ...] joined whole
        (one all-gather; ``enter(x, axes)`` where the sequence is whole),
        used by the rank on its own work over ``axes``: its backward sums
        the gradient over ``axes`` and takes the rank's block (a
        reduce-scatter where the sequence's axes are among them)."""
        if self.seq.n == 1:
            return self.enter(x, axes)
        seq = self.seq.axes
        if set(seq) <= set(axes):
            return self.enter(_AllGather.apply(x, self, seq, SEQ_DIM, True),
                              _minus(axes, seq))
        return self.enter(_AllGather.apply(x, self, seq, SEQ_DIM, False),
                          axes)

    def own_seq(self, x):
        """This rank's block of the sequence of a whole ``x`` [B, S, ...]
        (positions, pool entries: no gradient)."""
        lo, hi = self.seq.bounds(x.shape[SEQ_DIM])
        return x.narrow(SEQ_DIM, lo, hi - lo)

    def seq_rows(self, x, pos):
        """Row ``pos[b]`` (a position of the whole sequence) of each lane
        of the residual's blocks ``x`` [B, S/n, D]: the rank that holds it
        gives it, the others zeros, summed over the sequence's axes."""
        if self.seq.n == 1:
            return super().seq_rows(x, pos)
        lo, hi = self.seq.bounds(x.shape[SEQ_DIM] * self.seq.n)
        mine = (pos >= lo) & (pos < hi)
        rows = super().seq_rows(x, torch.where(mine, pos - lo, 0))
        return self.all_reduce(torch.where(mine[:, None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device)), self.seq.axes)

    def on_slice(self, w):
        """A weight the same on every rank of the sequence's axes, used on
        the rank's own block of the residual: its gradient is summed over
        them."""
        return self.enter(w, self.seq.axes)

    def check_seq(self, S: int) -> None:
        """A sequence of ``S`` positions must split over the residual's
        sequence axes."""
        if S % self.seq.n:
            raise ValueError(
                f"a sequence of {S} positions does not split over the "
                f"{self.seq.n} ranks of {self.seq.axes}")

    def all_to_all(self, x, axes, dim=0):
        """``x``'s dim ``dim`` cut into one block per rank of ``axes``
        (``block_of``'s order), block k sent to the rank that holds block
        k, and the blocks received joined along ``dim`` in their senders'
        block order (one all-to-all of the bytes: any dtype, every bit);
        its backward is the reverse all-to-all."""
        if self.size(axes) == 1:
            return x
        return _AllToAll.apply(x, self, tuple(axes), dim % x.dim())

    def rms_norm(self, x, gamma, axes, width: int, eps: float = 1e-6):
        """``layers.rms_norm`` of a vector of ``width`` whose last-dim
        blocks (``x`` and ``gamma`` this rank's) lie over ``axes``: the
        squares summed in f32 on each block, one all-reduce of the sums
        (``_SumOver``), the mean over the whole width."""
        if self.size(axes) == 1:
            return super().rms_norm(x, gamma, axes, width, eps)
        xf = x.float()
        ss = _SumOver.apply(xf.square().sum(-1, keepdim=True), self,
                            tuple(axes))
        return (xf * torch.rsqrt(ss / width + eps)).to(x.dtype) * gamma

    def rec_block(self, shape, lane: int):
        """(axis, Split) of this rank's block of a recurrent-state leaf of
        ``shape`` (this rank's lanes on axis ``lane``, the rest whole), or
        None where ``model`` splits none of it: the axis the reference's
        ``_rec_pspec`` gives ``model`` on the leaf's global shape (the
        lanes times the batch axes' ranks).  An axis before the lanes'
        (a stacked layer axis) is refused: the port keeps each layer's
        state with its lanes."""
        m = self.sizes.get("model", 1)
        if m == 1:
            return None
        glob = list(shape)
        glob[lane] *= self.size(self.batch_axes)
        spec = _shd().rec_spec(glob, glob[lane], m)
        axis = next((i for i, a in enumerate(spec) if a == "model"), None)
        if axis is None:
            return None
        b_ax = spec.index("__B__")
        if axis <= lane or (b_ax != lane and self.size(self.batch_axes) > 1):
            raise ValueError(
                f"a recurrent-state leaf {tuple(glob)} with lanes on axis "
                f"{lane}: the reference's layout puts the batch on axis "
                f"{b_ax} and model on axis {axis}, a stacked layer axis")
        return axis, Split(("model",), m, self.coord["model"])

    def _gather(self, x, axes, dim):
        n = self.size(axes)
        group, order = self._group(axes)
        x = x.contiguous()
        out = x.new_empty((n,) + tuple(x.shape))
        dist.all_gather_into_tensor(out.view(-1).view(torch.uint8),
                                    x.view(-1).view(torch.uint8),
                                    group=group)
        if order != list(range(n)):     # group ranks -> block order
            out = out[torch.tensor(order, device=out.device)]
        return out.movedim(0, dim).reshape(*x.shape[:dim], n * x.shape[dim],
                                           *x.shape[dim + 1:])

    def _reduce_scatter(self, g, axes, dim):
        """The rank's block along ``dim`` of the sum over ``axes`` of every
        rank's ``g``, in f32, rounded once to ``g``'s dtype."""
        n = self.size(axes)
        group, order = self._group(axes)
        blocks = g.float().movedim(dim, 0)
        blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])
        if order != list(range(n)):     # block order -> group ranks
            inv = sorted(range(n), key=order.__getitem__)
            blocks = blocks[torch.tensor(inv, device=blocks.device)]
        out = blocks.new_empty(blocks.shape[1:])
        dist.reduce_scatter_tensor(out, blocks.reshape(-1, *out.shape[1:]),
                                   group=group)
        return out.movedim(0, dim).to(g.dtype)

    def _all_to_all(self, x, axes, dim):
        n = self.size(axes)
        group, order = self._group(axes)
        blocks = x.movedim(dim, 0)
        blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])
        if order != list(range(n)):     # block order -> group ranks
            inv = sorted(range(n), key=order.__getitem__)
            blocks = blocks[torch.tensor(inv, device=blocks.device)]
        flat = blocks.reshape(n, -1).contiguous()
        out = torch.empty_like(flat)
        dist.all_to_all_single(out.view(torch.uint8), flat.view(torch.uint8),
                               group=group)
        if order != list(range(n)):     # group ranks -> block order
            out = out[torch.tensor(order, device=out.device)]
        return out.view(-1, *blocks.shape[2:]).movedim(0, dim)

    def gather_lanes(self, x):
        """Every rank's lanes (dim 0) over the batch axes, in lane order."""
        return self.all_gather(x, self.batch_axes, dim=0)

    def own_lanes(self, x):
        """This rank's lanes of the whole batch ``x`` (dim 0), the same on
        every rank of the batch axes: its gradient is every rank's
        lanes' gradients, summed over them (``enter``)."""
        n, i = _shd().block_of(self.batch_axes, self.mesh, self.coord)
        b = x.shape[0] // n
        return self.enter(x, self.batch_axes)[i * b:(i + 1) * b]

    def block_sums(self, sq: torch.Tensor, dims_shapes) -> torch.Tensor:
        """Every leaf's squared sum over its whole tensor: ``sq`` [n]
        holds this rank's block's of each leaf, ``dims_shapes`` the
        leaves' (dims, shape).  One f32 all-reduce over the mesh, to which
        one rank of each block's replicas (the one at coordinate 0 on the
        axes that do not split it) gives the block's sum."""
        keep = []
        for dims, shape in dims_shapes:
            spec = _shd().spec_for(dims, shape, self.mesh, self.rules)
            split = {a for axes in spec for a in axes or ()}
            keep.append(all(self.coord[a] == 0 for a in self.names
                            if a not in split))
        y = sq.float() * torch.tensor(keep, dtype=torch.float32,
                                      device=sq.device)
        if self.size(self.names) > 1:
            dist.all_reduce(y, group=self._group(self.names)[0])
        return y


class RankView:
    """``cfg`` as one rank of ``tp`` runs it: every field and property
    of the config, and ``tp``.  The model builds it once per plan; the
    functions below the model read their rank's head counts from it
    (``gqa_layout``, ``mla_heads``, worked out once a view)."""

    def __init__(self, cfg, tp: TensorParallel):
        self.__dict__.update(_cfg=cfg, tp=tp, _memo={})

    def __getattr__(self, name):
        return getattr(self._cfg, name)


def rank_view(cfg, views: Dict, batch_axes=None, seq: bool = False):
    """The config this rank runs: ``cfg`` itself outside
    ``use_rules(rules, mesh)``, else a ``RankView`` with the mesh's
    ``TensorParallel`` plan (with ``seq``, its sequence-parallel form:
    ``with_seq``), made once a mesh and rule table and kept in the
    model's ``views``."""
    shd = _shd()
    mesh = shd._mesh()
    if mesh is None:
        return cfg
    rules = shd._rules()
    key = (id(mesh), tuple(sorted(rules.items())))
    if key not in views:
        views[key] = RankView(cfg, TensorParallel(mesh, rules, batch_axes))
    if not seq:
        return views[key]
    if key + ("seq",) not in views:
        views[key + ("seq",)] = RankView(cfg, views[key].tp.with_seq())
    return views[key + ("seq",)]


def _memo(cfg, name, fn):
    """``fn(cfg)``, kept on a ``RankView`` (a plain config is WHOLE's)."""
    memo = getattr(cfg, "_memo", None)
    if memo is None:
        return fn(cfg)
    if name not in memo:
        memo[name] = fn(cfg)
    return memo[name]


# ---------------------------------------------------------------------------
# the attention layouts a rank runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GQALayout:
    """How a rank runs a GQA layer: ``q`` the split of ``wq``'s (and
    ``wo``'s) fused head dim, ``kv`` of ``wk`` / ``wv``'s.  ``heads``:
    the rank's whole q heads ``[h0, h0 + n_h)`` attended over KV heads
    ``[kv0, kv0 + n_kv)``, or None where its ``wq`` columns are not whole
    heads of one GQA ratio: then q is all-gathered and every head
    attends, and the rank keeps its ``wo`` rows' block of the output."""
    q: Split
    kv: Split
    heads: Optional[Tuple[int, int, int, int]]     # h0, n_h, kv0, n_kv


def gqa_layout(cfg) -> GQALayout:
    return _memo(cfg, "gqa", _gqa_layout)


def _gqa_layout(cfg) -> GQALayout:
    tp = tp_of(cfg)
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = tp.split(("D", "H"), (d, nh * hd), 1)
    o = tp.split(("H", "D"), (nh * hd, d), 0)
    kv = tp.split(("D", "KV"), (d, nkv * hd), 1)
    if o != q:
        raise ValueError(f"wq's heads over {q.axes}, wo's over {o.axes}")
    n_rep = nh // nkv
    cols = nh * hd // q.n
    heads = None
    if cols % hd == 0:
        n_h = cols // hd
        h0 = q.index * n_h
        if n_h % n_rep == 0 or n_rep % n_h == 0:
            heads = (h0, n_h, h0 // n_rep, max(n_h // n_rep, 1))
    return GQALayout(q, kv, heads)


def mla_heads(cfg) -> Tuple[Split, int]:
    """(split, heads a rank) of an MLA layer: ``w_uq``, ``w_uk``,
    ``w_uv`` and ``wo`` must split the heads alike, in whole heads."""
    return _memo(cfg, "mla", _mla_heads)


def _mla_heads(cfg) -> Tuple[Split, int]:
    tp = tp_of(cfg)
    d, nh, hd, dr = cfg.d_model, cfg.n_heads, cfg.hd, cfg.qk_rope_dim
    dc, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    splits = [tp.split(("C", "H"), (qr, nh * (hd + dr)), 1),
              tp.split(("C", "H"), (dc, nh * hd), 1),
              tp.split(("H", "D"), (nh * hd, d), 0)]
    if any(s != splits[0] for s in splits) or nh % splits[0].n:
        raise ValueError(
            f"MLA's {nh} heads do not split in whole heads alike over "
            f"w_uq / w_uk / w_uv / wo ({[s.axes for s in splits]})")
    return splits[0], nh // splits[0].n
