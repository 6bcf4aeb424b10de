"""Collectives over one mesh dimension's process group, so the sharded
maps stay topology-agnostic.

Counterpart of ``tpusparse/parallel/comm.py`` (XLA collectives inside
``shard_map``): here each rank calls them on its own shard, with the
process group of a mesh dimension (``mesh.get_group("n")``).

Transport is chosen by the backend. NCCL moves CUDA tensors where they
lie. Gloo cannot send or receive a CUDA tensor, so on gloo alone every
collective here stages a CUDA tensor through host memory: a copy to the
host, the collective there, a copy back (``transport``). NCCL never takes
that path. A group of one rank moves nothing: its ring shift is the
identity, as a one-device ``ppermute`` is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ProcessGroup = dist.ProcessGroup


def staged(group: ProcessGroup | None, t: torch.Tensor) -> bool:
    """True where ``t`` goes through host memory: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def transport(group: ProcessGroup | None, device: torch.device) -> str:
    """How the group moves a tensor on ``device``: ``"<backend>"``, or
    ``"gloo via host"`` where it is staged."""
    backend = dist.get_backend(group)
    if device.type == "cuda" and backend == "gloo":
        return "gloo via host"
    return backend


def _stage(group, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if staged(group, t) else t


def all_gather_x(x: torch.Tensor, group: ProcessGroup,
                 axis: int = 0) -> torch.Tensor:
    """Gather the group's shards of ``x`` along ``axis`` into the full
    tensor, in group-rank order (every rank gets it)."""
    d = group.size()
    if d == 1:
        return x
    src = _stage(group, x.movedim(axis, 0).contiguous())
    out = src.new_empty((d * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, axis)


def reduce_scatter_y(y_partial: torch.Tensor,
                     group: ProcessGroup) -> torch.Tensor:
    """Sum the group's partial Y's, leaving each rank its own slice of dim
    0 (its length must divide by the group's size). Spelled
    ``reduce_scatter_tensor``: torch 2.11 has no ``reduce_scatter_single``,
    in whose favour torch 2.13 deprecates it (a FutureWarning there)."""
    d = group.size()
    if d == 1:
        return y_partial
    src = _stage(group, y_partial.contiguous())
    if src.shape[0] % d:
        raise ValueError(f"reduce_scatter_y: dim 0 of {tuple(src.shape)} "
                         f"does not split over {d} ranks")
    out = src.new_empty((src.shape[0] // d,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(y_partial.device)


def psum_y(y_partial: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Sum the group's partial Y's; every rank gets the sum."""
    if group.size() == 1:
        return y_partial
    buf = _stage(group, y_partial).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(y_partial.device)


def ring_shift(x: torch.Tensor, group: ProcessGroup,
               shift: int = 1) -> torch.Tensor:
    """Pass a buffer ``shift`` steps around the group's ring: group rank r
    sends to r + shift and receives from r - shift (mod the size)."""
    d = group.size()
    if d == 1:
        return x
    me = group.rank()
    src = _stage(group, x.contiguous())
    out = torch.empty_like(src)
    peer = dist.get_global_rank
    ops = [dist.P2POp(dist.isend, src, peer(group, (me + shift) % d), group),
           dist.P2POp(dist.irecv, out, peer(group, (me - shift) % d), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device)
