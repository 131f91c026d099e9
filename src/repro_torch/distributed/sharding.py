"""Logical-axis -> DTensor placement rules (``repro/distributed/sharding.py``).

Every parameter / activation in the model zoo declares *logical dims*
(e.g. ``("D", "F")`` for an MLP weight, ``("L", "E", "D", "F")`` for stacked
MoE experts).  This module maps those names onto the axes of a
``torch.distributed`` ``DeviceMesh`` (``pod``/``data``/``model``) with
divisibility checks, greedy conflict resolution (one mesh axis may
appear at most once per tensor) and a context-managed rule table so
serving and training can use different layouts without touching model
code.  The rule tables are the reference's, copied as they are.

``spec_for`` returns, for each tensor dim, the tuple of mesh axes (or
None) that the reference's ``PartitionSpec`` holds.  A dim over several
axes is cut as JAX cuts it, the first axis major: over ``(a, b)`` the
rank at indices ``(i_a, i_b)`` holds block ``i_a * size_b + i_b``
(``block_of``).  ``placements_for`` turns a spec into DTensor
placements, one per mesh dim (``Shard(tensor dim)`` or
``Replicate()``); where the rule's order crosses the mesh's (experts
over ``("model", "data")`` on a ``(data, model)`` mesh) the mesh dim
that comes first but is minor in the block order is a
``_StridedShard`` whose ``split_factor`` is the product of the sizes of
the axes it must come after, which DTensor reads as that block order.

``shard_params`` cuts whole parameters (torch tensors or the bridge's
numpy arrays) to this rank's blocks and ``init_shards`` draws
``init_params``' values leaf by leaf, keeping each leaf's block: the
weights (and a train state's AdamW moments) of the tensor-parallel path
(``distributed/tp.py``).  ``gather_params`` is the inverse: every rank
gets each leaf whole (a checkpoint of a sharded train state is written
whole, as the reference saves its global arrays, and cut again at any
mesh).
``shard_serve_state`` cuts a serve state's pools to one rank's slice of
the pool axis (``core/pool.py``'s sharded pool); ``write_prefill_shard``
writes a split prefill's slices (an attention family's prefill over the
sharded pool) into such a state's slices of a longer pool.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.core.pool import PoolShard
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec

Spec = Tuple[Optional[Tuple[str, ...]], ...]


# ---------------------------------------------------------------------------
# rule table: logical dim -> ordered mesh-axis preference
# ---------------------------------------------------------------------------

# Axis name conventions used across the model zoo:
#   B   batch                      S   sequence (activations)
#   SP  pool sequence (KV pool)    D   d_model (rows)
#   H   attention heads (fused)    KV  kv heads (fused)
#   F   ffn hidden                 E   experts
#   V   vocab                      L   stacked layer axis (never sharded)
#   C   latent / small dims        Hm  ssm heads
#   K   top-k axis (never sharded)

TRAIN_RULES: Dict[str, Tuple[str, ...]] = {
    "B": ("pod", "data"),
    "S": ("model",),          # sequence-parallel residual stream
    "Sq": (),                 # sequence axis inside attention (heads take TP)
    "SP": ("model",),
    "D": ("data",),           # FSDP rows (ZeRO param+opt sharding)
    "DE": ("data",),          # expert-weight rows (always capacity-sharded)
    "H": ("model",),
    "Hq": ("model",),         # head axis of attention activations
    "KV": ("model",),
    "F": ("model",),
    "E": ("model", "data"),
    "V": ("model",),
    "Hm": ("model",),
    "G": (),                  # small/replicated dims (norm gammas, head_dim)
    "L": (),                  # stacked-layer axes are never sharded
    "C": (),                  # latent / low-rank dims
    "K": (),                  # top-k axis
}

SERVE_RULES: Dict[str, Tuple[str, ...]] = {
    "B": ("pod", "data"),     # DP attention: each request on one data shard
    "S": ("model",),
    "Sq": (),
    "SP": ("model",),         # pool pages spread over the pooled-HBM axis
    "D": (),                  # NO row-sharding at serve: FSDP rows force a
                              # per-layer weight all-gather in decode
                              # (§Perf iteration A1); TP over model suffices
    "DE": ("data",),          # expert rows stay sharded (capacity: MoE
                              # weights are the TB-scale tensors)
    "H": ("model",),
    "Hq": ("model",),
    "KV": ("model",),
    "F": ("model",),
    "E": ("model", "data"),
    "V": ("model",),
    "Hm": ("model",),
    "G": (),
    "L": (),
    "C": (),
    "K": (),
}

_state = threading.local()


def _rules() -> Dict[str, Tuple[str, ...]]:
    return getattr(_state, "rules", TRAIN_RULES)


def _mesh():
    """The mesh ``use_rules`` set (PyTorch has no ambient mesh)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, Tuple[str, ...]], mesh=None):
    old_r = getattr(_state, "rules", None)
    old_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        if old_r is None:
            del _state.rules
        else:
            _state.rules = old_r
        _state.mesh = old_m


# ---------------------------------------------------------------------------
# spec derivation
# ---------------------------------------------------------------------------


def spec_for(dims: Sequence[str], shape: Sequence[int], mesh=None,
             rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Spec:
    """The mesh axes of each of ``dims`` (of ``shape``) on ``mesh`` (a
    ``DeviceMesh``, or anything with ``mesh_dim_names`` and ``shape``).

    Greedy: walk dims left to right; give each dim the first mesh axis from
    its preference list that (a) is present in the mesh, (b) is still unused
    in this tensor, and (c) divides the dim size.  Multi-axis entries (e.g.
    batch over ("pod", "data")) are taken as a group when every member
    divides cumulatively.
    """
    if mesh is None:
        mesh = _mesh()
    rules = rules or _rules()
    if mesh is None:
        return (None,) * len(dims)
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    used: set = set()
    out: List[Optional[Tuple[str, ...]]] = []
    for dim, size in zip(dims, shape):
        prefs = rules.get(dim, ())
        picked: List[str] = []
        rem = size
        for ax in prefs:
            if ax not in axis_sizes or ax in used:
                continue
            n = axis_sizes[ax]
            if rem % n == 0:
                picked.append(ax)
                used.add(ax)
                rem //= n
        out.append(tuple(picked) if picked else None)
    return tuple(out)


def placements_for(mesh, dims: Sequence[str], shape: Sequence[int],
                   rules: Optional[Dict[str, Tuple[str, ...]]] = None
                   ) -> List[Any]:
    """DTensor placements (one per mesh dim) of ``spec_for``'s result, in
    its block order: a mesh dim that a more major axis of the rule
    follows in the mesh is a ``_StridedShard`` (split factor: those
    axes' sizes), the rest ``Shard``."""
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out: List[Any] = [Replicate()] * len(names)
    for tdim, axes in enumerate(spec_for(dims, shape, mesh, rules)):
        for j, ax in enumerate(axes or ()):
            m = names.index(ax)
            split = math.prod(sizes[b] for b in axes[:j]
                              if names.index(b) > m)
            out[m] = (Shard(tdim) if split == 1
                      else _StridedShard(tdim, split_factor=split))
    return out


def rec_spec(shape, batch: int, model_size: int):
    """The reference's spec of a recurrent-state leaf (its dry-run's
    ``_rec_pspec``): the batch axis, the first dim of ``shape`` equal to
    ``batch`` (``"__B__"``), plus the first later dim that divides by the
    model axis's size (``"model"``); None elsewhere."""
    spec = [None] * len(shape)
    b_ax = next((i for i, d in enumerate(shape) if d == batch), None)
    if b_ax is not None:
        spec[b_ax] = "__B__"
        for j in range(b_ax + 1, len(shape)):
            if shape[j] % model_size == 0 and shape[j] >= model_size:
                spec[j] = "model"
                break
    return spec


def block_of(axes, mesh, coord=None) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dim over ``axes`` (a ``spec_for``
    entry: None or a tuple, the first axis major) on ``mesh`` at the
    coordinate ``coord`` (``{axis: index}``, by default this rank's)."""
    if not axes:
        return 1, 0
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if coord is None:
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n, idx = 1, 0
    for ax in axes:
        idx = idx * sizes[ax] + coord[ax]
        n *= sizes[ax]
    return n, idx


def _cut(x, spec, mesh):
    """This rank's block of ``x``: each dim cut by ``block_of``."""
    index = []
    for size, axes in zip(x.shape, spec):
        n, i = block_of(axes, mesh)
        index.append(slice(i * (size // n), (i + 1) * (size // n)))
    block = x[tuple(index)]
    if isinstance(x, torch.Tensor):
        return block.contiguous().clone()
    return np.ascontiguousarray(block)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of leaves shaped as ``specs``."""
    if isinstance(specs, ParamSpec):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, tree[k], s) for k, s in specs.items()}
    return [map_specs(fn, t, s) for t, s in zip(tree, specs)]


def shard_params(params, specs, mesh=None, rules=None):
    """This rank's block of every leaf of ``params`` (torch tensors or
    numpy arrays, whole, in ``specs``' tree) under ``rules`` on ``mesh``
    (by default those ``use_rules`` set): each dim cut over the axes
    ``spec_for`` names, as the reference's ``jax.device_put(p,
    params_shardings(...))`` places it on the device at this rank's
    coordinate.  A dim the rules leave whole stays whole; every block is
    a copy."""
    mesh = mesh if mesh is not None else _mesh()
    return map_specs(
        lambda t, s: _cut(t, spec_for(s.dims, s.shape, mesh, rules), mesh),
        params, specs)


def gather_params(blocks, specs, mesh=None, rules=None):
    """The whole leaves of ``blocks`` (this rank's, ``shard_params``'
    cut of ``specs``' tree under ``rules`` on ``mesh``): each split dim
    all-gathered over its axes, in block order, every bit.  Every rank
    of the mesh calls it, and gets every leaf."""
    from repro_torch.distributed.tp import TensorParallel
    mesh = mesh if mesh is not None else _mesh()
    rules = rules or _rules()
    tp = TensorParallel(mesh, rules)

    def whole(t, s):
        for i, axes in enumerate(spec_for(s.dims, s.shape, mesh, rules)):
            if axes:
                t = tp._gather(t, tuple(axes), i)
        return t
    return map_specs(whole, blocks, specs)


def block_shape(spec: ParamSpec, mesh=None, rules=None) -> Tuple[int, ...]:
    """The shape of a rank's block of ``spec``."""
    mesh = mesh if mesh is not None else _mesh()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return tuple(size // math.prod(sizes[a] for a in axes or ())
                 for size, axes in zip(spec.shape, spec_for(
                     spec.dims, spec.shape, mesh, rules)))


def init_shards(specs, generator: torch.Generator, device, mesh=None,
                rules=None):
    """``init_params(specs, generator, device)``'s values, cut to this
    rank's blocks: each leaf is drawn whole (in ``init_params``' order,
    so the same generator gives the same bits) and cut before the next
    is drawn, so one whole leaf at a time is live."""
    mesh = mesh if mesh is not None else _mesh()
    return map_specs(
        lambda _, s: _cut(s.materialize(generator, device),
                          spec_for(s.dims, s.shape, mesh, rules), mesh),
        specs, specs)


def constrain(x, dims: Sequence[str]):
    """A DTensor redistributed to the placements of ``dims`` (on the mesh
    ``use_rules`` set, else its own); a plain tensor comes back as it is.
    The port's model code calls no ``constrain``: each rank runs on its
    own slices (the sharded pool's fetch, ``core/pool.py``)."""
    if not isinstance(x, DTensor):
        return x
    mesh = _mesh()
    if mesh is None:
        mesh = x.device_mesh
    return x.redistribute(mesh, placements_for(mesh, dims, x.shape))


def params_shardings(specs_tree, mesh, rules=None):
    """ParamSpec tree (dicts and lists) -> the same tree of placements."""
    if isinstance(specs_tree, ParamSpec):
        return placements_for(mesh, specs_tree.dims, specs_tree.shape,
                              rules)
    if isinstance(specs_tree, dict):
        return {k: params_shardings(v, mesh, rules)
                for k, v in specs_tree.items()}
    return [params_shardings(v, mesh, rules) for v in specs_tree]


# ---------------------------------------------------------------------------
# the serve state over a sharded pool
# ---------------------------------------------------------------------------


def shard_serve_state(state: Dict[str, Any], mesh,
                      pool_axis: str = "model") -> Dict[str, Any]:
    """This rank's serve state over a pool sharded on ``pool_axis``.

    ``state`` holds the rank's own request lanes (its slice over the
    batch axes) with whole pools ``[L, B, S, d]``, as a prefill, or a
    splice of prefills, made them; S must divide by the pool axis.  The
    result keeps every other entry (the hot tier's ``page_table`` stays
    over all S positions: its input is the all-reduced fetch; the
    recurrent state ``rec_*`` of the rank's lanes, as the model made it:
    whole, or, under ``use_rules``, already the rank's block of it; an
    encoder-decoder's whole ``self_kv``) and holds
    ``kv_pool`` / ``idx_pool`` (an encoder-decoder's cross-attention
    pools) cut to the slice [base, base + S_local), copied by the
    splice's shard form in one launch.  The whole pools exist until the
    caller drops ``state``."""
    shard = PoolShard.of(mesh, pool_axis)
    keys = [k for k in ("kv_pool", "idx_pool") if k in state]
    out = dict(state)
    if not keys:
        return out
    S = state[keys[0]].shape[2]
    if S % shard.size:
        raise ValueError(f"a pool of {S} positions does not split over "
                         f"{shard.size} ranks of {pool_axis!r}")
    S_local = S // shard.size
    for k in keys:
        L, B, _, d = state[k].shape
        out[k] = torch.empty((L, B, S_local, d), dtype=state[k].dtype,
                             device=state[k].device)
    ops.pool_splice_shard([out[k] for k in keys], [state[k] for k in keys],
                          shard.base(S_local))
    return out


def write_prefill_shard(state: Dict[str, Any], prefilled: Dict[str, Any],
                        mesh, pool_axis: str = "model") -> None:
    """Rows [0, S) of each lane of ``state``'s pools (this rank's slices
    ``[L, B, S'/n, d]`` over ``pool_axis``, as ``shard_serve_state`` cuts
    them, S' >= S) set from ``prefilled``'s (the rank's slices ``[L, B,
    S/n, d]`` of a prompt of S positions, as a split prefill makes them).
    A rank's serve slice holds other positions than its prompt slice, so
    each layer's prompt slices are all-gathered (their bytes: every bit)
    and the rank copies the rows its slice holds: one layer of the
    prompt is whole on a rank at a time.  Every rank of the axis calls
    it."""
    shard = PoolShard.of(mesh, pool_axis)
    for k in ("kv_pool", "idx_pool"):
        if k not in prefilled:
            continue
        dst, src = state[k], prefilled[k]
        rows = dst.shape[2]
        lo = shard.base(rows)
        hi = min(lo + rows, src.shape[2] * shard.size)
        for layer in range(src.shape[0]):
            whole = shard.gather_pool(src[layer])
            if hi > lo:
                dst[layer, :, :hi - lo] = whole[:, lo:hi]
