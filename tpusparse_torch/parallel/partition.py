"""Partitioned multi-rank dense SpMV/SpMM over a device mesh.

Counterpart of ``tpusparse/parallel/partition.py``. Three strategies, over
the mesh's ``"n"`` dimension of D ranks:

- ``n``: each rank owns a column slab of A and its slice of y; x is
  replicated. No communication until the result is gathered.
- ``m``: each rank owns a row slab of A and the matching slice of x; the
  partial y's are summed over the group (``comm.psum_y``).
- ``ring``: each rank owns a column slab of A and one chunk of x; the
  chunks pass around the ring (``comm.ring_shift``) while each rank
  multiplies the matching row band of its slab: D - 1 shifts, then the last
  band, as the JAX package does.

Each rank takes the same A and x and returns the full y (every rank the
same: the JAX function's replicated view), gathered over the group. A and
x may lie on the host, where each rank uploads only its own slab and
chunk on every call, or already on the rank's device (the JAX function's
placed arrays), where the slab is a view taken on the device and nothing
crosses to the host. Dimensions that do not split evenly are
zero-padded, as the JAX package pads them. The local product is
``torch.matmul`` in fp32 with TF32 off, as the JAX package leaves it to
``jnp.dot`` outside any kernel.
"""

from __future__ import annotations

import enum
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpusparse_torch.parallel import comm
from tpusparse_torch.parallel.mesh import (axis_size, default_mesh,
                                           mesh_device)


class Partition(str, enum.Enum):
    N = "n"
    M = "m"
    RING = "ring"


def _local_matvec(a_loc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(x, a_loc)


def spmv_sharded(a: Any, x: Any, mesh: DeviceMesh | None = None,
                 partition: str | Partition = Partition.N) -> torch.Tensor:
    """Multi-rank y = x @ a for dense ``a`` (m, n) and x (m,), on this
    rank's device. Sparse formats have their own sharded entry points with
    the same partition names (``parallel.sparse``)."""
    mesh = mesh or default_mesh()
    partition = Partition(partition)
    dev = mesh_device(mesh)
    group = mesh.get_group("n")
    d, me = axis_size(mesh, "n"), mesh.get_local_rank("n")
    a, x = torch.as_tensor(a), torch.as_tensor(x)
    m, n_orig = a.shape
    # rows and columns that do not split evenly are zero-padded, on the side
    # that holds A: padded rows multiply zero x entries, padded output
    # columns are cut off. Slicing comes before ``.to(dev)``, so a host A
    # uploads only the rank's slab and a device A is never copied.
    if partition in (Partition.M, Partition.RING) and m % d:
        a = F.pad(a, (0, 0, 0, -m % d))
        x = F.pad(x, (0, -m % d))
    if partition in (Partition.N, Partition.RING) and n_orig % d:
        a = F.pad(a, (0, -n_orig % d))
    rows, cols = a.shape[0] // d, a.shape[1] // d
    if partition == Partition.N:
        a_loc = a[:, me * cols:(me + 1) * cols].to(dev)
        y = comm.all_gather_x(_local_matvec(a_loc, x.to(dev)), group)
    elif partition == Partition.M:
        a_loc = a[me * rows:(me + 1) * rows].to(dev)
        x_loc = x[me * rows:(me + 1) * rows].to(dev)
        y = comm.psum_y(_local_matvec(a_loc, x_loc), group)
    else:
        a_loc = a[:, me * cols:(me + 1) * cols].to(dev)
        xc = x[me * rows:(me + 1) * rows].to(dev)

        def consume(s: int, xc: torch.Tensor) -> torch.Tensor:
            # xc is x's chunk (me + s) % d: multiply its row band
            r0 = ((me + s) % d) * rows
            return _local_matvec(a_loc[r0:r0 + rows], xc)

        y = torch.zeros(cols, dtype=a_loc.dtype, device=dev)
        for s in range(d - 1):      # d - 1 shifts; the last band needs none
            y = y + consume(s, xc)
            xc = comm.ring_shift(xc, group, shift=-1)
        y = comm.all_gather_x(y + consume(d - 1, xc), group)
    return y[:n_orig]
