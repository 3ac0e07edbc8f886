"""Device meshes of the port: the (users, tile) axes over process ranks.

Counterpart of ``deepmimo_tpu/parallel/mesh.py``. The natural parallel
axes of the workload:

- ``users``: every per-user computation is independent -> data parallel.
- ``tile``: the last axis of an output (subcarriers, snapshots, ...) ->
  model parallel.

PyTorch runs one process per device: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, and a sharding is a tuple of DTensor placements, one per
mesh dimension (users first, tile second).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

try:
    from torch.distributed.tensor import DTensor, Replicate, Shard
except ImportError:                       # PyTorch before 2.5
    from torch.distributed._tensor import DTensor, Replicate, Shard

from ..config import config

USERS_AXIS = "users"
TILE_AXIS = "tile"


def default_mesh_shape(n_devices: int, tile: int = 1) -> Tuple[int, int]:
    """Split devices into (users, tile) axes; tile divides n_devices."""
    if n_devices % tile != 0:
        raise ValueError(f"tile={tile} must divide n_devices={n_devices}")
    return (n_devices // tile, tile)


def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, end) of part ``index`` of ``n`` items cut into ``parts``
    blocks of ceil(n / parts): DTensor's ``Shard`` split."""
    per = -(-n // parts)
    start = min(index * per, n)
    return start, min(start + per, n)


def _start_group(dev: torch.device) -> None:
    """The default process group: from the environment under ``torchrun``
    (``init_method="env://"``), else one rank on an in-process store."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(devices: Optional[Sequence[int]] = None,
              tile: int = 1) -> DeviceMesh:
    """A (users, tile) mesh over the given (or all) ranks.

    Args:
        devices: global ranks of the mesh in row-major (users, tile)
            order, one device per rank; default every rank of the default
            process group.
        tile: size of the tile axis; it must divide the number of ranks.

    The device type is ``config['device']``'s ("cuda" unless the caller
    asks for the CPU). Like the JAX mesh it needs no set-up: with no
    process group initialised, it starts one, from the environment under
    ``torchrun`` and otherwise a one-rank group on an in-process store
    (NCCL for "cuda", gloo for "cpu"). An existing group is used as it is.
    On "cuda" the process's device is ``config['device']``'s index, or
    ``LOCAL_RANK`` (0 when unset) for a plain "cuda". The mesh's dimension
    names are ``config['mesh_axis_users']`` and ``config['mesh_axis_tile']``.
    """
    dev = torch.device(config.get("device"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        _start_group(dev)
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    shape = default_mesh_shape(len(ranks), tile)
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=(config.get("mesh_axis_users"),
                                      config.get("mesh_axis_tile")))


def user_sharding(mesh: DeviceMesh) -> tuple:
    """Shard the leading (user) axis; replicate over the tile axis."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


def channel_sharding(mesh: DeviceMesh, ndim: int = 4) -> tuple:
    """Shard channels [users, rx, tx, k(, t)]: users over the users axis,
    the last axis over the tile axis."""
    return (Shard(0), Shard(ndim - 1))
