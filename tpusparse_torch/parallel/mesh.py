"""Device meshes over ``torch.distributed``.

Counterpart of ``tpusparse/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions, one
process a rank; the names are the JAX package's:

- ``"n"``: the sharded dimension of a 1-D mesh. The ``n`` partitions shard
  A's output columns over it, the ``m`` partitions A's contraction rows
  (their partial products summed over its process group), the ``ring``
  partitions both (X's shards passed around it).
- ``("b", "n")``: a 2-D mesh for SpMM, X's batch rows over ``"b"``.

``compat_shard_map`` stays behind: a rank runs its own shard in its own
process, so there is no program to map over the mesh.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: dict[str, int], device_type: str | None = None
              ) -> DeviceMesh:
    """Mesh from ``{"n": d}`` or ``{"b": a, "n": b}``; its ranks are the
    whole world of ``initialize()``. ``device_type``: ``"cuda"`` or
    ``"cpu"`` (None: the device ``initialize`` picked)."""
    from tpusparse_torch.parallel import launch

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call tpusparse_torch.parallel."
                           "initialize() first (one process a rank)")
    names = tuple(shape)
    dims = tuple(int(v) for v in shape.values())
    total = math.prod(dims)
    world = dist.get_world_size()
    if total != world:
        raise ValueError(f"mesh {shape} needs {total} ranks, the world has "
                         f"{world}")
    if device_type is None:
        device_type = launch.device().type
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


def default_mesh(n_devices: int | None = None) -> DeviceMesh:
    """1-D mesh over the output dim, the natural SpMV partition: every rank
    of the world (``n_devices``, when given, must be that many)."""
    if not dist.is_initialized():
        from tpusparse_torch.parallel import launch

        launch.initialize()
    return make_mesh({"n": dist.get_world_size() if n_devices is None
                      else n_devices})


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along the mesh dimension ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: the current CUDA device for a
    ``"cuda"`` mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
