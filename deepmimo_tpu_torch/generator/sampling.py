"""Sampling and selection utilities: dBW/W conversions, uniform grid
subsampling, coordinate-box filters and nearest-user paths.

Copied from ``deepmimo_tpu.generator.sampling`` (numpy only).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def dbw2watt(val):
    """Convert dBW to Watts."""
    return 10 ** (np.asarray(val) / 10) if isinstance(val, np.ndarray) \
        else 10 ** (val / 10)


def watt2dbw(val):
    """Convert Watts to dBW."""
    return 10 * np.log10(val)


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


def get_idxs_with_limits(data_pos: np.ndarray, **limits) -> np.ndarray:
    """Indices of users inside the given x/y/z min/max coordinate box."""
    valid_limits = {"x_min", "x_max", "y_min", "y_max", "z_min", "z_max"}
    if not all(key in valid_limits for key in limits):
        raise ValueError(f"Invalid limit key. Supported: {valid_limits}")

    valid_idxs = np.arange(len(data_pos))
    coord_map = {"x": 0, "y": 1, "z": 2}
    for limit_name, limit_value in limits.items():
        coord = coord_map[limit_name.split("_")[0]]
        if coord >= data_pos.shape[1]:
            raise ValueError(
                f"Cannot apply {limit_name} to {data_pos.shape[1]}D positions")
        vals = data_pos[valid_idxs, coord]
        mask = vals >= limit_value if limit_name.endswith("min") \
            else vals <= limit_value
        valid_idxs = valid_idxs[mask]
    return valid_idxs


class LinearPath:
    """Nearest-grid-point sampling of dataset users along a line segment.

    Walks from ``first_pos`` to ``last_pos`` at resolution ``res`` (or in
    ``n_steps`` steps) and snaps each step to the nearest receiver
    position; ``filter_repeated`` drops consecutive repeats ("hard": all
    repeats).
    """

    def __init__(self, rx_pos: np.ndarray, first_pos: np.ndarray,
                 last_pos: np.ndarray, res: float = 1,
                 n_steps: Optional[int] = None,
                 filter_repeated: bool = True) -> None:
        first_pos = np.asarray(first_pos, dtype=np.float64)
        last_pos = np.asarray(last_pos, dtype=np.float64)
        if len(first_pos) == 2:
            first_pos = np.concatenate((first_pos, [0]))
            last_pos = np.concatenate((last_pos, [0]))
        self.first_pos = first_pos
        self.last_pos = last_pos
        self._set_idxs(np.asarray(rx_pos), res, n_steps, filter_repeated)

    def _set_idxs(self, rx_pos, res, n_steps, filter_repeated):
        if not n_steps:
            data_res = np.linalg.norm(rx_pos[0] - rx_pos[1])
            if res < data_res and filter_repeated:
                print(f"Changing resolution to {data_res} to eliminate "
                      "repeated positions")
                res = data_res
            self.n = int(np.linalg.norm(self.first_pos - self.last_pos) / res)
        else:
            self.n = n_steps

        points = np.stack([
            np.linspace(self.first_pos[d], self.last_pos[d], self.n)
            for d in range(3)], axis=1)
        # Vectorized nearest-neighbour snap (one [n, n_ue] distance matrix).
        d2 = ((points[:, None, :] - rx_pos[None, :, :]) ** 2).sum(-1)
        idxs = np.argmin(d2, axis=1)

        if filter_repeated:
            idxs = np.concatenate(
                ([idxs[0]], idxs[1:][(idxs[1:] - idxs[:-1]) != 0]))
            if filter_repeated == "hard":
                idxs = np.unique(idxs)
            self.n = len(idxs)
        self.idxs = idxs
