"""Scenario-acquisition pipelines: OSM -> 3D scene -> ray tracer -> convert.

External tools (Blender, Wireless InSite, Sionna RT) are imported lazily
and fail with clear errors when absent; the geo/placement/orchestration
layers are self-contained host code, copied from ``deepmimo_tpu/pipelines``.
"""

from .geo_utils import (haversine, gps_to_cartesian, cartesian_to_gps,
                        bbox_center, bbox_size_meters, pad_bbox)
from .placement import gen_tx_pos, gen_rx_grid, gen_plane_grid
from .runner import run_pipeline, read_pipeline_csv, PipelineRow

__all__ = [
    "haversine", "gps_to_cartesian", "cartesian_to_gps", "bbox_center",
    "bbox_size_meters", "pad_bbox",
    "gen_tx_pos", "gen_rx_grid", "gen_plane_grid",
    "run_pipeline", "read_pipeline_csv", "PipelineRow",
]
