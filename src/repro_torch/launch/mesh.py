"""Production mesh builders (``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the default process group, which the caller has initialised
(``init_process_group`` with its address, world size and rank).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axes, device: str = "cuda") -> DeviceMesh:
    """Arbitrary mesh (tests / elastic re-mesh) of ``shape`` over the
    process group's ranks, axes named ``axes``; on the card unless the
    caller asks for ``cpu``."""
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {need} ranks, not {have}")
    return make_mesh(shape, axes, device)
