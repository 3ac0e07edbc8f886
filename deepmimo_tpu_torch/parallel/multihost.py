"""Multi-process data loading: shard scenario path data across ranks.

Counterpart of ``deepmimo_tpu/parallel/multihost.py``. Each process
converts only its users' rows of a ``Dataset`` (no device holds the whole
scenario) and the global arrays are DTensors sharded over the mesh's users
axis, where the JAX package assembles them with
``jax.make_array_from_process_local_data``. One process is the same code
on a one-rank mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

from .. import consts as c
from ..ops.types import PathData
from .mesh import DeviceMesh, block, user_sharding
from .sharded import _user_rows, _wrap


def host_user_range(n_ue: int, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, end) of the users a process is responsible for: blocks of
    ceil(n_ue / process_count). The defaults are the default process
    group's rank and world size, or (0, 1) without a group."""
    group = dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if group else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if group else 1)
    return block(n_ue, pc, pi)


def load_paths_sharded(dataset, mesh: DeviceMesh,
                       num_paths: Optional[int] = None) -> PathData:
    """A user-sharded global PathData from a Dataset.

    Each rank converts only the rows of its users-axis coordinate on the
    mesh (ranks of one tile group share a block); every leaf is a DTensor
    of the global shape sharded on its user axis, on
    ``config['device']``. The Doppler rows are kept (the JAX package's
    multi-process branch drops them).
    """
    n_ue = dataset.n_ue
    u0, u1 = _user_rows(n_ue, mesh)

    def rows(key):
        x = dataset.get(key)
        return None if x is None else np.asarray(x)[u0:u1]

    local = PathData.from_numpy(
        power=rows(c.POWER_PARAM_NAME), phase=rows(c.PHASE_PARAM_NAME),
        delay=rows(c.DELAY_PARAM_NAME), aoa_az=rows(c.AOA_AZ_PARAM_NAME),
        aoa_el=rows(c.AOA_EL_PARAM_NAME), aod_az=rows(c.AOD_AZ_PARAM_NAME),
        aod_el=rows(c.AOD_EL_PARAM_NAME),
        doppler_vel=rows(c.DOPPLER_VEL_PARAM_NAME),
        doppler_acc=rows(c.DOPPLER_ACC_PARAM_NAME))
    if num_paths:
        local = local.trim_paths(num_paths)
    return local._map(lambda x: _wrap(x, mesh, user_sharding(mesh),
                                      (n_ue,) + tuple(x.shape[1:])))
