"""A step's FLOPs, bytes, collectives and memory, counted as it runs
(the counterpart of ``repro/distributed/hlo_analysis.py``).

The reference parses the compiled program's HLO: FLOPs of every ``dot``,
result plus operand bytes of every top-level (fused) kernel, result bytes
of every collective, each multiplied by its loop's trip count.  The port
has no compiled program to parse, so ``StepCost`` is a
``TorchDispatchMode`` that sees every operator the step runs, in order,
as eager PyTorch launches it (on the ``meta`` device for the dry-run,
with nothing allocated; on the card for the same count of a real run),
and keeps the reference's keys:

- ``flops``: the matmul family's FLOPs by ``torch.utils.flop_counter``'s
  registered formulas (mm, addmm, bmm, baddbmm, convolutions, SDPA),
  plus the FLOPs each hand-written kernel reports
  (``kernels/cost.py``).  Elementwise FLOPs are ignored, as there.
- ``bytes``: operand plus result bytes of every operator that launches
  work (views, metadata and allocations are free), plus each kernel's
  reported bytes, plus each collective's result bytes (as the reference
  adds them): eager PyTorch's counterpart of the reference's per-fused-
  kernel traffic model, so it counts every intermediate an unfused
  operator writes and the next one reads.
- ``collective_bytes``, ``collective_breakdown``, ``collective_counts``
  (``distributed/collectives.py``).
- ``ops``: the operators that launch work (collectives apart), and
  ``kernels``: the hand-written kernels' calls by ``ops.launch_counts()``
  name, as the wrappers report them (``kernels/cost.py::record``): a
  launch each on the card, on ``meta`` the launch the card would make.
- ``peak_bytes``: the most bytes of live storage through the step, the
  inputs (``track``) included; each storage counts from the operator that
  makes it to the moment its last tensor dies (a finalizer on the
  storage).  ``argument_bytes``: the tracked inputs' storage.

Eager PyTorch runs every layer's operators, so there is no trip count
to correct.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.collectives import CollectiveCount
from repro_torch.kernels import cost

# operators that launch nothing: allocations and aliases (every view op
# is free too: ``func.is_view``)
_FREE = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "detach", "alias", "_unsafe_view",
                   "lift_fresh", "_local_scalar_dense", "set_", "resize_",
                   "record_stream", "sym_size", "sym_stride", "sym_numel",
                   "sym_storage_offset", "is_same_size"))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class StepCost(TorchDispatchMode):
    """``with StepCost() as c: step()`` counts the step; ``c.track(inputs)``
    first (inside or before the block) counts the inputs' storage as
    live from the start.  ``c.result()`` is the record."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0
        self.ops = 0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0
        self.kernels: Counter = Counter()
        self.collectives = CollectiveCount()
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._storages: Dict[int, int] = {}

    # -- the counter's inputs ------------------------------------------------
    def __enter__(self):
        cost.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost.RECORDERS.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, c: cost.Cost) -> None:
        """A hand-written kernel's call (``kernels/cost.py::record``)."""
        self.kernels[name] += 1
        self.kernel_flops += c.flops
        self.kernel_bytes += c.bytes
        self.flops += c.flops
        self.bytes += c.bytes

    def track(self, tree: Any) -> int:
        """Count the storage of every tensor in ``tree`` (the step's
        inputs) as live; returns the bytes newly tracked."""
        before = self.live
        for t in _tensors(tree):
            self._alive(t)
        self.argument_bytes += self.live - before
        return self.live - before

    def _alive(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._dead, key)

    def _dead(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- each operator -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        moved = self.collectives.observe(func, args)
        if moved is not None:
            self.bytes += moved
        elif not (func.is_view
                  or func._schema.name.split("::")[-1] in _FREE):
            self.ops += 1
            self.bytes += _nbytes(_tensors((args, kwargs))) \
                + _nbytes(_tensors(out))
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        for t in _tensors(out):
            self._alive(t)
        return out

    def result(self) -> Dict[str, Any]:
        rec = dict(flops=self.flops, bytes=self.bytes, ops=self.ops,
                   kernels=dict(self.kernels),
                   kernel_flops=self.kernel_flops,
                   kernel_bytes=self.kernel_bytes,
                   argument_bytes=self.argument_bytes,
                   peak_bytes=self.peak)
        rec.update(self.collectives.as_dict())
        return rec
