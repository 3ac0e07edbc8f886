"""TX/RX placement: BS positions from GPS, uniform user grids.

Host numpy code, copied from ``deepmimo_tpu/pipelines/placement.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .geo_utils import gps_to_cartesian, bbox_center, bbox_size_meters


def gen_tx_pos(rt_params: Dict) -> np.ndarray:
    """BS positions [n_bs, 3] from GPS coordinates in the pipeline params.

    Expects keys: bs_lats, bs_lons, bs_heights, and either an
    origin_lat/origin_lon pair or a gps_bbox whose center becomes the
    scene origin.
    """
    if "origin_lat" in rt_params:
        origin_lat = rt_params["origin_lat"]
        origin_lon = rt_params["origin_lon"]
    else:
        origin_lat, origin_lon = bbox_center(rt_params["gps_bbox"])

    lats = np.atleast_1d(np.asarray(rt_params["bs_lats"], dtype=np.float64))
    lons = np.atleast_1d(np.asarray(rt_params["bs_lons"], dtype=np.float64))
    heights = np.atleast_1d(np.asarray(rt_params["bs_heights"],
                                       dtype=np.float64))
    x, y = gps_to_cartesian(lats, lons, origin_lat, origin_lon)
    return np.stack([x, y, heights], axis=1)


def gen_rx_grid(rt_params: Dict) -> np.ndarray:
    """Uniform user grid [n_ue, 3] covering the scene bbox.

    Expects keys: gps_bbox, grid_spacing (m), ue_height (m).
    """
    bbox = rt_params["gps_bbox"]
    spacing = float(rt_params.get("grid_spacing", 1.0))
    height = float(rt_params.get("ue_height", 1.5))

    width, depth = bbox_size_meters(bbox)
    nx = max(int(width // spacing) + 1, 1)
    ny = max(int(depth // spacing) + 1, 1)
    xs = np.arange(nx) * spacing - width / 2
    ys = np.arange(ny) * spacing - depth / 2
    xx, yy = np.meshgrid(xs, ys)
    zz = np.full_like(xx, height)
    return np.column_stack([xx.ravel(), yy.ravel(), zz.ravel()])


def gen_plane_grid(x_min: float, x_max: float, y_min: float, y_max: float,
                   spacing: float, height: float = 1.5) -> np.ndarray:
    """Uniform grid over an explicit cartesian rectangle."""
    xs = np.arange(x_min, x_max + spacing / 2, spacing)
    ys = np.arange(y_min, y_max + spacing / 2, spacing)
    xx, yy = np.meshgrid(xs, ys)
    return np.column_stack([xx.ravel(), yy.ravel(),
                            np.full(xx.size, height)])
