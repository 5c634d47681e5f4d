"""A fake world for the dry run: one process as rank 0 of a mesh of any size.

``fake_world(shape, axes)`` initialises torch's fake process group (its
collectives return at once and move no data) with the mesh's product as the
world size, builds a ``"cuda"`` ``DeviceMesh`` over it and enters
``FakeTensorMode``, so tensors made inside have shapes, dtypes and devices
but no storage: a 256-rank mesh of 80 GB cards is costed on one host.  It
never claims to have run on a card.  On a build of torch without CUDA the
mesh and the fake tensors are on the CPU (``fake_device``): there, indexing
a fake CUDA tensor fails, and no count depends on the device.  This module
is the only one that imports the private ``FakeStore``.
"""

from __future__ import annotations

import contextlib
import math

__all__ = ["fake_world", "fake_device"]

_ACTIVE = []


def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


def fake_device() -> str:
    """The fake world's device type: "cuda", or "cpu" on a build of torch
    without CUDA."""
    import torch

    return "cuda" if torch.version.cuda else "cpu"


@contextlib.contextmanager
def fake_world(shape, axes):
    """Inside: this process is rank 0 of a fake process group of
    ``prod(shape)`` ranks, ``FakeTensorMode`` is on, and the value is the
    named ``DeviceMesh`` of ``shape`` on ``fake_device()``.  The group is
    destroyed on exit.  Refuses to start in a process that already has a process group
    (a real one would be replaced), or inside another fake world."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if dist.is_initialized() or _ACTIVE:
        raise RuntimeError("fake_world: this process already has a process group; the dry "
                           "run runs in a process of its own")
    world = math.prod(shape)
    dist.init_process_group("fake", store=_fake_store(), rank=0, world_size=world)
    _ACTIVE.append(shape)
    try:
        mesh = DeviceMesh(fake_device(), torch.arange(world).reshape(shape), mesh_dim_names=axes)
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield mesh
    finally:
        _ACTIVE.pop()
        dist.destroy_process_group()
