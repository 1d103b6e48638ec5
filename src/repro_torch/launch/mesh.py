"""Device meshes of the launchers: the ranks of a ``torch.distributed`` world.

The torch counterpart of ``repro.launch.mesh.make_host_mesh``. A mesh here
is :class:`repro_torch.core.comm.Mesh`, the world's ranks laid out on
named axes with one process group per line of each axis. The LM
scaffold's production meshes wait for its port.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.comm import Mesh

__all__ = ["make_host_mesh"]


def make_host_mesh(axis_name: str = "data") -> Mesh:
    """The world of the running process group as a 1-D "data" mesh."""
    return Mesh((dist.get_world_size(),), (axis_name,))
