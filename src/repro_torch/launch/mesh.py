"""Device meshes over a torch process group.

Counterpart of ``repro/launch/mesh.py``.  Functions, never module-level
state: importing this module touches no process group and no device.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry
names (``mesh_dim_names``), over an initialised process group with one rank
per mesh position, ranks laid out row-major over the shape (as
``jax.make_mesh`` lays out devices).  Multi-rank runs start under
``python -m torch.distributed.run --nproc-per-node N ...``, rank r on
``cuda:LOCAL_RANK`` under NCCL; ``device_type="cpu"`` (gloo) is for tests.

Production topology, as in the reference: 16 x 16 per pod, a leading
``pod`` axis for several pods.  Axis roles: ``data`` = FSDP/DP, ``model`` =
TP/EP/SP, ``pod`` = pure DP.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import mesh_shape

__all__ = ["make_production_mesh", "make_mesh", "describe"]


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A named ``DeviceMesh`` of ``shape`` over the current process group,
    whose world size must be the shape's product.  ``device_type`` is
    ``"cuda"`` unless the caller asks for ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh{shape}: no process group; start the program under "
            "torch.distributed.run or call torch.distributed.init_process_group"
        )
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} ranks; "
            f"the process group has {world}"
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass device_type='cpu'")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def describe(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh_shape(mesh).items())
