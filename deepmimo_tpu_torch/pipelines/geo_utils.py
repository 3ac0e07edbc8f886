"""Geographic utilities for scenario-acquisition pipelines.

GPS <-> local cartesian conversions, bounding-box manipulation, haversine
distances. Host numpy code, copied from
``deepmimo_tpu/pipelines/geo_utils.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

EARTH_RADIUS_M = 6_371_000.0
METERS_PER_DEG_LAT = 111_320.0


def haversine(lat1, lon1, lat2, lon2) -> float:
    """Great-circle distance in meters between two GPS points."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlat, dlon = lat2 - lat1, lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + \
        np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return float(2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(a)))


def meters_per_deg_lon(lat: float) -> float:
    return METERS_PER_DEG_LAT * np.cos(np.radians(lat))


def gps_to_cartesian(lat, lon, origin_lat: float, origin_lon: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Project GPS coordinates to local (x east, y north) meters.

    Equirectangular projection around the origin — accurate to well under
    a meter for city-scale scenes.
    """
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    x = (lon - origin_lon) * meters_per_deg_lon(origin_lat)
    y = (lat - origin_lat) * METERS_PER_DEG_LAT
    return x, y


def cartesian_to_gps(x, y, origin_lat: float, origin_lon: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lat = origin_lat + y / METERS_PER_DEG_LAT
    lon = origin_lon + x / meters_per_deg_lon(origin_lat)
    return lat, lon


def bbox_center(bbox: Sequence[float]) -> Tuple[float, float]:
    """Center of a (min_lat, min_lon, max_lat, max_lon) box."""
    return ((bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2)


def bbox_size_meters(bbox: Sequence[float]) -> Tuple[float, float]:
    """(width_east, height_north) of a GPS bbox in meters."""
    lat_c = (bbox[0] + bbox[2]) / 2
    width = (bbox[3] - bbox[1]) * meters_per_deg_lon(lat_c)
    height = (bbox[2] - bbox[0]) * METERS_PER_DEG_LAT
    return width, height


def pad_bbox(bbox: Sequence[float], pad_m: float
             ) -> Tuple[float, float, float, float]:
    """Grow a GPS bbox by ``pad_m`` meters on every side."""
    lat_c = (bbox[0] + bbox[2]) / 2
    dlat = pad_m / METERS_PER_DEG_LAT
    dlon = pad_m / meters_per_deg_lon(lat_c)
    return (bbox[0] - dlat, bbox[1] - dlon, bbox[2] + dlat, bbox[3] + dlon)
