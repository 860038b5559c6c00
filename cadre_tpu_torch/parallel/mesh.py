"""The port's "mesh": one data-parallel process group (the counterpart of
cadre_tpu.parallel.mesh's 1-D `data` mesh).

The JAX package shards a batch over the devices of one program; here each
rank is a process with one device and its own rows. `make_mesh` joins the
group that `torchrun` describes (parallel/multihost.py), or, in a lone
process, makes a world of 1 over a FileStore in a temporary directory, so
`--mesh data` without torchrun runs as the JAX package's one-device mesh.

Collectives on lists of tensors, each one all_reduce over the tensors
flattened into one buffer (nothing at all in a world of one, where every
reduction is the identity):
  sum_reduce_   the sum over ranks (psum), in place;
  mean_reduce_  the sum divided by the world (pmean), in place;
  broadcast_    rank 0's values on every rank, in place.
`shard_rows` gives a rank its slice of a batch.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from cadre_tpu_torch.parallel.multihost import (
    PG_TIMEOUT,
    default_backend,
    initialize_multihost,
    local_rank,
)
from cadre_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: object              # the torch.distributed process group
    rank: int
    world: int
    device: torch.device       # this rank's device


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device="cuda") -> Mesh:
    """The data-parallel group of every rank, on `device` (a CUDA device
    without an index is cuda:LOCAL_RANK). `backend` defaults to NCCL for
    CUDA and gloo for the CPU; an explicit one (gloo ranks sharing a card)
    overrides it. Every collective fails after PG_TIMEOUT instead of
    hanging. A group already initialised is used as it is. Asking for
    more ranks than the world has raises, and so does asking for fewer:
    every rank of the group takes part."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    dev = resolve_device(dev)
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1")) \
            if "RANK" in os.environ else 1
    n = n_devices or world
    if n != world:                   # before any group is made
        raise ValueError(f"requested {n} devices, have {world} ranks "
                         "(torchrun --nproc-per-node sets the world)")
    if not initialize_multihost(backend, dev):
        fd, path = tempfile.mkstemp(prefix="cadre_mesh_")
        os.close(fd)
        os.remove(path)               # FileStore makes it; nothing is left
        dist.init_process_group(backend or default_backend(dev),
                                store=dist.FileStore(path, 1), rank=0,
                                world_size=1, timeout=PG_TIMEOUT)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, dist.get_rank(), world, dev)


@torch.no_grad()
def _unflatten_into(flat: torch.Tensor,
                    tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     scale: float = 1.0) -> None:
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    if scale != 1.0:
        flat.mul_(scale)
    _unflatten_into(flat, tensors)


def sum_reduce_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor becomes its sum over the ranks (psum). A world of one
    leaves them as they are."""
    if mesh.world > 1:
        _all_reduce_sum_(tensors, mesh)


def mean_reduce_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor becomes its mean over the ranks (pmean). A world of
    one leaves them as they are."""
    if mesh.world > 1:
        _all_reduce_sum_(tensors, mesh, 1.0 / mesh.world)


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor (a parameter too) takes rank 0's value."""
    if mesh.world == 1:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0, group=mesh.group)
    _unflatten_into(flat, tensors)


def shard_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of `x` along `dim`, whose length must
    divide by the world."""
    n = x.shape[dim]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not divide over {mesh.world} ranks")
    size = n // mesh.world
    return x.narrow(dim, mesh.rank * size, size)


def close_mesh() -> None:
    """Leave the process group (make_mesh's, or torchrun's)."""
    if dist.is_initialized():
        dist.destroy_process_group()
