"""Mesh construction on ``torch.distributed``'s ``DeviceMesh``.

Counterpart of ``repro/launch/mesh.py``.  Importing this module builds
nothing and touches no process group; meshes are built inside functions
only, over the default process group the caller initialized (one process
per device, or one process standing for a whole production world through
the ``"fake"`` backend, as the dry-run does).
"""
from __future__ import annotations

import math
from typing import Dict


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("initialize the default process group first "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def _mesh(device_type: str, shape, axes):
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    n = math.prod(shape)
    if _world() == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Production mesh: (data=16, model=16) single pod = 256 devices;
    (pod=2, data=16, model=16) = 512 devices across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world}; "
            f"run under dryrun.py (a process group of backend 'fake' and "
            f"world size {n})")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(data, model) mesh over the initialized world (tests, the training
    driver; one card is a world of one)."""
    world = _world()
    dp = world // model_parallel
    return _mesh(device_type, (dp, model_parallel), ("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of anything with the
    reference's ``axis_names`` and ``devices`` (a stand-in mesh)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))
