"""Device meshes of the launchers: the ranks of a ``torch.distributed`` world.

The torch counterpart of ``repro.launch.mesh``. ``make_host_mesh`` (the
DELEDA launchers) is :class:`repro_torch.core.comm.Mesh`, the world's
ranks laid out on named axes with one process group per line of each
axis. The LM scaffold's meshes are ``torch.distributed``
``DeviceMesh``es with named dims, on which ``launch.steps.build`` places
DTensors: ``make_production_mesh`` (16 x 16, or 2 x 16 x 16 across two
pods) and ``make_lm_host_mesh`` (the running world as one "data" dim).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.comm import Mesh

__all__ = ["make_host_mesh", "make_production_mesh", "make_lm_host_mesh"]


def make_host_mesh(axis_name: str = "data") -> Mesh:
    """The world of the running process group as a 1-D "data" mesh."""
    return Mesh((dist.get_world_size(),), (axis_name,))


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production mesh over the first ranks of the running world:
    ``(16, 16)`` on ``("data", "model")``, or ``(2, 16, 16)`` on
    ``("pod", "data", "model")``. "data" carries the batch (and FSDP),
    "model" tensor and expert parallelism, "pod" a data-parallel super
    axis. The world needs 256 (512) ranks: the dry run makes them with
    the fake backend."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() < n:
        raise RuntimeError(f"the production mesh {shape} needs {n} ranks, "
                           f"the world has {dist.get_world_size()}")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_lm_host_mesh(device_type=None):
    """The running world as a 1-D "data" ``DeviceMesh`` (one rank: the
    one-card mesh ``launch.steps.build`` runs a step on)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(device_type),
                      torch.arange(dist.get_world_size()),
                      mesh_dim_names=("data",))
