"""Tensor and expert parallelism of the weights on the serving path: what
the reference gets from ``params_shardings`` and the collectives GSPMD
inserts (``repro/launch/dryrun.py:171-172``, the ``constrain`` calls of
``repro/models/{transformer,moe}.py``), written out for one rank.

Under ``sharding.use_rules(rules, mesh)`` the decoder-only models'
``prefill`` and ``decode`` (``models/transformer.py``) run on this rank's
block of every weight (``sharding.shard_params`` / ``init_shards``, the
blocks ``spec_for`` names) and read the config through ``RankView``: the
config's fields plus ``tp``, this object.  The model functions ask it
how a weight is split (``split``) and run its collectives, which move
activations only, never a weight:

- vocab-parallel embedding (an all-reduce of the looked-up rows) and
  column-parallel ``lm_head`` (an all-gather of the logits' blocks);
- column-parallel q / k / v / indexer-q / ``w_uq`` / ``w_gate`` /
  ``w_up`` (all-gathers of the small k / v / q blocks where the whole
  is needed), row-parallel ``wo`` / ``w_down`` (one all-reduce each);
- the experts: the tokens all-gathered over the batch axes, one
  dispatch of the whole token set with the reference's groups and
  capacity on every rank, the rank's experts on their slots, one
  all-reduce of the partial outputs over the axes that split the
  experts' work, then the rank's own lanes.

A partial sum is made and crosses in f32 and is rounded once, as the
unsharded product rounds its f32 accumulation once.  A collective over
axes whose sizes multiply to 1 is the identity, so a world of one runs
the unsharded path's arithmetic bit for bit.  ``WHOLE`` is the plan
without a mesh: every weight whole, every collective the identity.
"""
from __future__ import annotations

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


class Whole:
    """One rank holds every weight whole (the unsharded path)."""
    batch_axes: Tuple[str, ...] = ()

    def split(self, dims: Sequence[str], shape: Sequence[int],
              i: int) -> Split:
        return WHOLE_SPLIT

    def size(self, axes) -> int:
        return 1

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int = -1
                   ) -> torch.Tensor:
        return x

    def matmul_sum(self, a: torch.Tensor, w: torch.Tensor, axes
                   ) -> torch.Tensor:
        return a @ w

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def own_lanes(self, x: torch.Tensor) -> torch.Tensor:
        return x


WHOLE = Whole()


def tp_of(cfg):
    """The plan a config view carries (``WHOLE`` for a plain config)."""
    return getattr(cfg, "tp", WHOLE)


class TensorParallel(Whole):
    """One rank's place on ``mesh`` under ``rules``.

    ``batch_axes``: the axes this rank's request lanes are split over
    (each rank the same count, in block order); by default the ``B``
    rule's axes in the mesh.  Lanes replicated over an axis (a batch of
    one) leave it out.  Rules that split the d_model rows (``D`` over
    axes of more than one rank: the training rules, the serve cells
    whose batch does not split) are refused: a row-parallel weight needs
    its rows gathered or its inputs split, which this path does not do.
    """

    def __init__(self, mesh, rules: Dict[str, Tuple[str, ...]],
                 batch_axes: Optional[Sequence[str]] = None):
        names = tuple(mesh.mesh_dim_names)
        self.mesh, self.rules, self.names = mesh, rules, names
        self.sizes = dict(zip(names, (int(s) for s in mesh.shape)))
        rows = math.prod(self.sizes[a] for a in rules.get("D", ())
                         if a in self.sizes)
        if rows > 1:
            raise ValueError(
                f"rules that split the d_model rows (D over "
                f"{rules['D']}) are not served tensor-parallel: every "
                "row-parallel weight would need its rows gathered")
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

    # -- blocks ---------------------------------------------------------------
    def split(self, dims, shape, i):
        axes = _shd().spec_for(dims, shape, self.mesh, self.rules)[i] or ()
        n, index = _shd().block_of(axes, self.mesh, self.coord)
        return Split(tuple(axes), n, index)

    def size(self, axes) -> int:
        """The ranks the axes hold (1: nothing is split over them)."""
        return math.prod(self.sizes[a] for a in axes or ())

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
    def all_reduce(self, x, axes):
        """The sum over ``axes`` of every rank's ``x``, in f32, rounded once
        to ``x``'s dtype (``x`` itself where the axes hold one rank)."""
        if self.size(axes) == 1:
            return x
        group, _ = self._group(tuple(axes))
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    def matmul_sum(self, a, w, axes):
        """``a @ w`` of a row-parallel weight block ``w`` (and ``a``'s
        matching columns), summed over ``axes``: each rank's product in
        f32, the sum rounded once to ``a``'s dtype, as one product of the
        whole weight rounds (the same product where the axes hold one
        rank)."""
        if self.size(axes) == 1:
            return a @ w
        y = torch.matmul(a.float(), w.float())
        group, _ = self._group(tuple(axes))
        dist.all_reduce(y, group=group)
        return y.to(a.dtype)

    def all_gather(self, x, axes, dim=-1):
        """The blocks of ``x`` over ``axes`` joined along ``dim`` in block
        order (one all-gather of the bytes: any dtype, every bit)."""
        n = self.size(axes)
        if n == 1:
            return x
        group, order = self._group(tuple(axes))
        x = x.contiguous()
        out = x.new_empty((n,) + tuple(x.shape))
        dist.all_gather_into_tensor(out.view(torch.uint8).view(-1),
                                    x.view(torch.uint8).view(-1),
                                    group=group)
        if order != list(range(n)):     # group ranks -> block order
            out = out[torch.tensor(order, device=out.device)]
        d = dim % x.dim()
        return out.movedim(0, d).reshape(*x.shape[:d], n * x.shape[d],
                                         *x.shape[d + 1:])

    def gather_lanes(self, x):
        """Every rank's lanes (dim 0) over the batch axes, in lane order."""
        return self.all_gather(x, self.batch_axes, dim=0)

    def own_lanes(self, x):
        """This rank's lanes of the whole batch ``x`` (dim 0)."""
        n, i = _shd().block_of(self.batch_axes, self.mesh, self.coord)
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]


class RankView:
    """``cfg`` as one rank of ``tp`` runs it: every field and property
    of the config, and ``tp``.  The model builds it once per plan; the
    functions below the model read their rank's head counts from it
    (``gqa_layout``, ``mla_heads``, worked out once a view)."""

    def __init__(self, cfg, tp: TensorParallel):
        self.__dict__.update(_cfg=cfg, tp=tp, _memo={})

    def __getattr__(self, name):
        return getattr(self._cfg, name)


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
