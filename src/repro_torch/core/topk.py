"""Top-k selection strategies over indexer scores (``repro/core/topk.py``).

``topk_select`` (re-exported from models/dsa.py) is the plain masked
top-k.  ``make_hierarchical_topk`` is the *distributed* variant: when
the scores live sharded over the pool axis, a local top-k on each shard
and a re-selection over the gathered candidates move ``shards * k``
score elements over the fabric instead of the full ``[B, S]`` scores.

The reference wraps its body in ``shard_map`` and takes global arrays;
the port's callable runs on each rank and takes that rank's LOCAL block
of scores ``[B_local, S_local]`` (its lanes, its slice of the pool
axis), which is what the decode hands a ``topk_fn`` that carries
``local_scores`` (``core/sac.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.pool import PoolShard
from repro_torch.models.dsa import (NEG_INF, _position_sort,  # noqa: F401
                                    topk_select)
from repro_torch.models.layers import top_k


class HierarchicalTopK:
    """(scores [B_l, S_l] of this rank's slice, cache_len [B_l]) ->
    (idx [B_l, k] global, valid [B_l, k]), the same on every rank of the
    pool axis.  Steps: a masked local top-k at global positions (ties to
    the lower index, as ``lax.top_k``), an all-gather of the candidates'
    scores and indices in rank order, a re-top-k over them (the rank
    order keeps the lower global index first on a tie), then the
    position sort of ``topk_select``."""

    #: the decode hands this top-k the rank's local block of scores
    local_scores = True

    def __init__(self, shard: PoolShard, k: int):
        self.shard, self.k = shard, k

    def __call__(self, scores: torch.Tensor, cache_len: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        S_local = scores.shape[-1]
        base = self.shard.base(S_local)
        pos = base + torch.arange(S_local, dtype=torch.int32,
                                  device=scores.device)
        masked = torch.where(pos[None, :] < cache_len[:, None], scores,
                             NEG_INF)
        loc_scores, loc_idx = top_k(masked, min(self.k, S_local))
        loc_idx = loc_idx.to(torch.int32) + base
        cand_scores = self.shard.all_gather(loc_scores)
        cand_idx = self.shard.all_gather(loc_idx)
        top_scores, in_cand = top_k(cand_scores,
                                    min(self.k, cand_scores.shape[-1]))
        idx = cand_idx.gather(-1, in_cand)
        return _position_sort(idx, top_scores > NEG_INF / 2,
                              self.shard.seq_len(S_local))


def make_hierarchical_topk(mesh, k: int, *, batch_axes=("pod", "data"),
                           pool_axis: str = "model") -> HierarchicalTopK:
    """The hierarchical top-k over ``mesh``'s pool axis (each rank passes
    its own lanes, its slice over ``batch_axes``, which ``PoolShard.of``
    checks)."""
    return HierarchicalTopK(PoolShard.of(mesh, pool_axis, batch_axes), k)
