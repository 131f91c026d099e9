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
                                    _spec_tail, topk_select)
from repro_torch.models.layers import top_k


class HierarchicalTopK:
    """(scores [B_l, S_l] of this rank's slice, cache_len [B_l]) ->
    (idx [B_l, k] global, valid [B_l, k]), the same on every rank of the
    pool axis.  Steps: a masked local top-k at global positions (ties to
    the lower index, as ``lax.top_k``), an all-gather of the candidates'
    scores and indices in rank order, a re-top-k over them (the rank
    order keeps the lower global index first on a tie), then the
    position sort of ``topk_select``.

    ``with_tail`` also gives the speculation tail, ranks [k, k+w) of the
    global scores, by the same steps at k+w: every element of the global
    top-(k+w) lies in its slice's local top-(k+w), so the re-selection is
    exactly the global one, and the result is bit for bit
    ``dsa.topk_select_with_tail`` on the gathered scores (the
    reference's hierarchical demand set beside ``speculate_next_topk``
    over its global scores)."""

    #: the decode hands this top-k the rank's local block of scores
    local_scores = True

    def __init__(self, shard: PoolShard, k: int):
        self.shard, self.k = shard, k

    def _top(self, scores: torch.Tensor, cache_len: torch.Tensor, kk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The global top-``kk`` (scores, int32 positions) of the masked
        scores, ranked by (score desc, position asc); fewer lanes where
        the pool holds fewer than ``kk`` positions."""
        S_local = scores.shape[-1]
        base = self.shard.base(S_local)
        pos = base + torch.arange(S_local, dtype=torch.int32,
                                  device=scores.device)
        masked = torch.where(pos[None, :] < cache_len[:, None], scores,
                             NEG_INF)
        loc_scores, loc_idx = top_k(masked, min(kk, S_local))
        loc_idx = loc_idx.to(torch.int32) + base
        cand_scores = self.shard.all_gather(loc_scores)
        cand_idx = self.shard.all_gather(loc_idx)
        top_scores, in_cand = top_k(cand_scores,
                                    min(kk, cand_scores.shape[-1]))
        return top_scores, cand_idx.gather(-1, in_cand)

    def __call__(self, scores: torch.Tensor, cache_len: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        top_scores, idx = self._top(scores, cache_len, self.k)
        return _position_sort(idx, top_scores > NEG_INF / 2,
                              self.shard.seq_len(scores.shape[-1]))

    def with_tail(self, scores: torch.Tensor, cache_len: torch.Tensor,
                  k: int, width: int, score_margin: float = -1.0):
        """(idx, valid) of this top-k and the speculation tail (tail_idx
        [B_l, width], tail_valid): ranks [k, k+width) of the global
        masked scores, cut by ``score_margin`` as ``dsa._spec_tail``
        cuts them (``k`` is the config's top-k, where the tail starts)."""
        top_scores, idx = self._top(scores, cache_len,
                                    max(self.k, k + width))
        lo = min(self.k, idx.shape[-1])
        d_idx, d_valid = _position_sort(
            idx[..., :lo], top_scores[..., :lo] > NEG_INF / 2,
            self.shard.seq_len(scores.shape[-1]))
        kk = min(k + width, idx.shape[-1])
        return d_idx, d_valid, *_spec_tail(top_scores[..., :kk],
                                           idx[..., :kk], k, width,
                                           score_margin)


def make_hierarchical_topk(mesh, k: int, *, batch_axes=("pod", "data"),
                           pool_axis: str = "model") -> HierarchicalTopK:
    """The hierarchical top-k over ``mesh``'s pool axis (each rank passes
    its own lanes; ``batch_axes`` changes no result, as in
    ``PoolShard.of``)."""
    return HierarchicalTopK(PoolShard.of(mesh, pool_axis, batch_axes), k)
