"""Engine-agnostic ray-tracing parameters (scenario-format schema).

Stored in params.json under ``rt_params``. Engine-specific converters
subclass this with their own ``read_parameters``. Copied from
``deepmimo_tpu/rt_params.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict, field
from pathlib import Path
from typing import Dict, Optional, Tuple


@dataclass
class RayTracingParameters:
    """Common ray-tracing configuration across engines."""

    raytracer_name: str
    raytracer_version: str

    frequency: float  # center frequency, Hz

    max_path_depth: int
    max_reflections: int
    max_diffractions: int
    max_scattering: int
    max_transmissions: int

    diffuse_reflections: int = 0
    diffuse_diffractions: int = 0
    diffuse_transmissions: int = 0
    diffuse_final_interaction_only: bool = False
    diffuse_random_phases: bool = False

    terrain_reflection: bool = False
    terrain_diffraction: bool = False
    terrain_scattering: bool = False

    num_rays: int = 1_000_000
    ray_casting_method: str = "uniform"
    synthetic_array: bool = True

    ray_casting_range_az: float = 360.0
    ray_casting_range_el: float = 180.0

    gps_bbox: Tuple[float, float, float, float] = (0, 0, 0, 0)

    raw_params: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, params_dict: Dict,
                  raw_params: Optional[Dict] = None) -> "RayTracingParameters":
        if raw_params is not None:
            params_dict = {**params_dict, "raw_params": raw_params}
        return cls(**params_dict)

    @classmethod
    def read_parameters(cls, load_folder: str | Path) -> "RayTracingParameters":
        raise NotImplementedError("Must be implemented by engine subclass")
