"""Sampling utilities: dBW to W conversion and uniform grid subsampling.

Copied from ``deepmimo_tpu.generator.sampling`` (numpy only).
"""

from __future__ import annotations

from typing import List

import numpy as np


def dbw2watt(val):
    """Convert dBW to Watts."""
    return 10 ** (np.asarray(val) / 10) if isinstance(val, np.ndarray) \
        else 10 ** (val / 10)


def get_uniform_idxs(n_ue: int, grid_size: np.ndarray,
                     steps: List[int]) -> np.ndarray:
    """Indices of users on a uniform [x_step, y_step] subgrid."""
    if list(steps) == [1, 1]:
        return np.arange(n_ue)

    grid_size = np.asarray(grid_size).copy()
    if np.prod(grid_size) != n_ue:
        print(f"Warning. Grid_size: {grid_size} = {np.prod(grid_size)} users "
              f"!= {n_ue} users in rx_pos")
        print("Computing pseudo-uniform indices.")
        while np.prod(grid_size) > n_ue:
            grid_size -= 1

    cols = np.arange(grid_size[0], step=steps[0])
    rows = np.arange(grid_size[1], step=steps[1])
    return np.array([j + i * grid_size[0] for i in rows for j in cols])
