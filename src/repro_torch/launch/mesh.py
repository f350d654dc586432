"""Production mesh construction over ``torch.distributed``.

Port of ``repro.launch.mesh``. A FUNCTION (not a module-level constant), so
importing this module touches no process group. Single pod: (data=16,
model=16) = 256 devices. Multi-pod: a leading pod axis, (pod=2, data=16,
model=16) = 512 devices; batch dims shard jointly over ("pod", "data").

A ``DeviceMesh`` needs an initialized process group whose world holds the
mesh. On real ranks that is the caller's ``init_process_group``; for a dry
run with no devices, ``fake_world(n)`` starts PyTorch's fake process group
of n ranks in this process (every collective a no-op, every rank's shapes
those of rank 0): the counterpart of the reference's forced host devices.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first prod(shape)
    ranks of the initialized world (all of them when the sizes agree)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise ValueError(f"need {n} devices for mesh {tuple(shape)}, have {have}")
    device_type = device_type or default_device_type()
    if have == n:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def describe(mesh) -> dict:
    axes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return {
        "axes": axes,
        "devices": int(np.prod(list(axes.values()))),
        "platform": mesh.device_type,
    }


@contextmanager
def fake_world(n: int):
    """PyTorch's fake process group of ``n`` ranks (this process is rank 0)
    for the body; destroyed after. Collectives record their calls and move
    no data, so a mesh of n devices traces in one process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
