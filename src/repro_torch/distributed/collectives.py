"""The collectives the port issues, counted per execution
(``repro/distributed/collectives.py``).

The reference parses compiled HLO for its communication ops and
multiplies the ones inside ``lax.scan`` bodies by the loop's trip count.
Eager PyTorch has neither HLO nor loops to correct for: every
``torch.distributed`` call reaches the dispatcher as one ``c10d`` op
(``c10d._allgather_base_`` for ``all_gather_into_tensor``,
``c10d.allreduce_`` for ``all_reduce``, ...), on a ``fake`` process
group with ``meta`` tensors (the dry-run) as under NCCL or gloo on real
ones.  ``CollectiveCount`` classifies those ops into the reference's
kinds and keeps, per kind, the calls and the result bytes (the bytes of
the op's first argument: the output of a gather, a scatter or an
all-to-all, the buffers an all-reduce or a broadcast rewrites in place),
which is the reference's per-device traffic convention.
``distributed/cost_analysis.py::StepCost`` feeds it every op of a step.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import torch

# c10d op name -> the reference's kind
_KINDS = {"_allgather_base_": "all-gather", "allgather_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
          "_reduce_scatter_base_": "reduce-scatter",
          "reduce_scatter_": "reduce-scatter",
          "reduce_scatter_tensor_coalesced_": "reduce-scatter",
          "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
          "send": "collective-permute", "recv_": "collective-permute",
          "broadcast_": "collective-broadcast"}


def kind_of(func) -> Optional[str]:
    """The reference's kind of a dispatcher op, None for a non-collective
    (and for c10d's other ops: barriers, waits)."""
    if getattr(func, "namespace", None) != "c10d":
        return None
    return _KINDS.get(func._schema.name.split("::")[-1])


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


class CollectiveCount:
    """Calls and result bytes per kind; ``observe`` takes each op."""

    def __init__(self):
        self.breakdown: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, int] = defaultdict(int)

    def observe(self, func, args) -> Optional[int]:
        """The op's result bytes when it is a collective (counted), else
        None."""
        kind = kind_of(func)
        if kind is None:
            return None
        b = _tensor_bytes(args[0]) if args else 0
        self.breakdown[kind] += b
        self.counts[kind] += 1
        return b

    @property
    def total_bytes(self) -> int:
        return sum(self.breakdown.values())

    def as_dict(self) -> Dict:
        """The reference's keys: ``collective_bytes``,
        ``collective_breakdown``, ``collective_counts``."""
        return dict(collective_bytes=self.total_bytes,
                    collective_breakdown=dict(self.breakdown),
                    collective_counts=dict(self.counts))
