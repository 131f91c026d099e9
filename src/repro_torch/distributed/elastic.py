"""Elastic re-meshing + straggler mitigation (``repro/distributed/elastic.py``).

**Elastic re-mesh**: on device loss (or scale-up), pick the largest
well-formed ``(data, model)`` grid from the surviving ranks, rebuild
placements from the same logical rules, and ``distribute_tensor`` the
checkpointed state onto the new ``DeviceMesh``.  Because checkpoints are
plain host arrays + logical-dim specs, restore onto *any* mesh shape
works: atomic snapshots (training/checkpoint.py) + mesh-agnostic restore
(here).

**Straggler mitigation**: ``SkipSlowReducer`` models the skip-slow-host
gradient trick: hosts that miss the step deadline are dropped from the
all-reduce and the gradient is rescaled by the number of contributors
(at-least-K semantics).

``viable_mesh_shape``, ``StepReport`` and the reducer's rule are the
reference's, copied as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import params_shardings


def viable_mesh_shape(n_devices: int, *, model_pref: int = 16,
                      min_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) grid usable with ``n_devices`` devices.

    Keeps the model axis as close to ``model_pref`` as divisibility
    allows (TP degree is a property of the model fit, DP absorbs loss).
    May idle a remainder of devices (returned grid uses <= n_devices).
    """
    best = (1, 1)
    for model in range(min(model_pref, n_devices), min_model - 1, -1):
        data = n_devices // model
        if data * model > best[0] * best[1]:
            best = (data, model)
        if model <= model_pref and data >= 1:
            return (data, model)
    return best


def remesh(n_devices: int, *, axis_names=("data", "model"),
           ranks: Optional[Sequence[int]] = None,
           device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``viable_mesh_shape(n)`` over the first data x
    model of ``ranks`` (by default the process group's ranks 0..n-1).
    Every rank of the process group calls it; a rank outside the new
    mesh gets a mesh it has no coordinate in."""
    ranks = list(range(dist.get_world_size()) if ranks is None
                 else ranks)[:n_devices]
    shape = viable_mesh_shape(len(ranks))
    used = shape[0] * shape[1]
    arr = torch.tensor(ranks[:used], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device, arr, mesh_dim_names=tuple(axis_names))


def reshard_tree(tree: Any, specs_tree: Any, mesh: DeviceMesh,
                 rules=None) -> Any:
    """Host tensors + ParamSpec tree -> DTensors on the new mesh (this
    rank's slices of each leaf, as its placements name them)."""
    shardings = params_shardings(specs_tree, mesh, rules=rules)
    device = torch.device(mesh.device_type)

    def one(t, placements):
        return distribute_tensor(torch.as_tensor(t).to(device), mesh,
                                 placements)
    return _tree_map(one, tree, shardings)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees of dicts, lists and
    tuples (a list of placements is a leaf of the second tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


@dataclasses.dataclass
class StepReport:
    step: int
    contributors: int
    total_hosts: int
    skipped: List[int]


class SkipSlowReducer:
    """At-least-K gradient aggregation across hosts.

    Hosts report (host_id, grad, arrival_time); contributions arriving
    after ``deadline`` x median are dropped and the mean is rescaled.
    Pure-host logic (the cross-host reduce itself is an all-reduce in
    real deployment); deterministic and unit-testable.  A gradient tree is
    dicts, lists and tuples of tensors or arrays (the reference maps its
    pytrees with ``jax.tree.map``).
    """

    def __init__(self, n_hosts: int, *, deadline_factor: float = 2.0,
                 min_quorum_frac: float = 0.75):
        self.n_hosts = n_hosts
        self.deadline_factor = deadline_factor
        self.min_quorum = max(1, int(np.ceil(min_quorum_frac * n_hosts)))

    def aggregate(self, step: int,
                  contributions: Dict[int, Tuple[Any, float]]
                  ) -> Tuple[Any, StepReport]:
        """contributions: host_id -> (grad_tree, arrival_time_s)."""
        if not contributions:
            raise ValueError("no gradient contributions")
        times = sorted(t for _, t in contributions.values())
        med = times[len(times) // 2]
        deadline = med * self.deadline_factor + 1e-9
        keep = {h: g for h, (g, t) in contributions.items() if t <= deadline}
        if len(keep) < self.min_quorum:          # never drop below quorum
            order = sorted(contributions.items(), key=lambda kv: kv[1][1])
            keep = {h: g for h, (g, _) in order[: self.min_quorum]}
        grads = list(keep.values())
        n = len(grads)
        summed = _tree_map(lambda *xs: sum(xs) / n, *grads)
        skipped = sorted(set(contributions) - set(keep))
        return summed, StepReport(step, n, self.n_hosts, skipped)
