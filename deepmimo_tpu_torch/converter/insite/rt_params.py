"""Ray-tracing parameter extraction from Wireless InSite .setup files.

Field mapping per the InSite project format. Copied from
``deepmimo_tpu/converter/insite/rt_params.py``, on the port's
``rt_params.RayTracingParameters``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ... import consts as c
from ...config import config
from ...rt_params import RayTracingParameters
from .tokenfmt import parse_insite_file, InsiteNode


def gps_bbox_from_studyarea(origin_lat: float, origin_lon: float,
                            vertices: np.ndarray,
                            pad: float = c.BBOX_PAD
                            ) -> Tuple[float, float, float, float]:
    """Approximate GPS bbox of the (padded) cartesian study area."""
    if origin_lat == 0 and origin_lon == 0:
        return (0, 0, 0, 0)
    mins = np.min(vertices, axis=0)[:2]
    maxs = np.max(vertices, axis=0)[:2]
    x_range = maxs[0] - mins[0] - 2 * pad
    y_range = maxs[1] - mins[1] - 2 * pad

    meter_per_deg_lat = 111_320.0
    meter_per_deg_lon = 111_320.0 * np.cos(np.radians(origin_lat))
    lat_range = y_range / meter_per_deg_lat
    lon_range = x_range / meter_per_deg_lon
    return (origin_lat - lat_range / 2, origin_lon - lon_range / 2,
            origin_lat + lat_range / 2, origin_lon + lon_range / 2)


@dataclass
class InsiteRayTracingParameters(RayTracingParameters):
    """InSite-specific RT parameters (standard fields + raw dump)."""

    @classmethod
    def read_parameters(cls, load_folder: str | Path
                        ) -> "InsiteRayTracingParameters":
        folder = Path(load_folder)
        setup_files = list(folder.glob("*.setup"))
        if not setup_files:
            raise ValueError(f"No .setup file found in {folder}")
        if len(setup_files) > 1:
            raise ValueError(f"Multiple .setup files found in {folder}")

        top = parse_insite_file(str(setup_files[0]))[0]

        antenna = _first(top, "antenna")
        waveform = _first(top, "Waveform")
        studyarea = _first(top, "studyarea")
        model = studyarea.child("model")
        apg = studyarea.child("apg_acceleration")
        diffuse = studyarea.child("diffuse_scattering")

        ray_spacing = model.get("ray_spacing", 0.25)
        terrain_diffr = model.get("terrain_diffractions", "No")

        max_refl = model.get("max_reflections", 0)
        if "max_wedge_diffractions" in model.values:
            max_diffr = model["max_wedge_diffractions"]
        else:
            max_diffr = diffuse.get("diffuse_diffractions", 0)
            if max_diffr == 0:
                max_diffr = 1 if terrain_diffr == "Yes" else 0
        max_trans = model.get("max_transmissions", 0)

        depth_plain = max_refl + max_diffr + max_trans
        depth_scatter = 0
        if diffuse.get("enabled", False):
            depth_scatter = (diffuse.get("diffuse_reflections", 0) +
                             diffuse.get("diffuse_diffractions", 0) +
                             diffuse.get("diffuse_transmissions", 0))
        max_depth = min(apg.get("path_depth", depth_plain),
                        max(depth_plain, depth_scatter))

        boundary = studyarea.child("boundary")
        try:
            ref = boundary.child("reference")
            origin_lat = ref.get("latitude", 0)
            origin_lon = ref.get("longitude", 0)
        except KeyError:
            origin_lat = origin_lon = 0
        vertices = np.array(boundary.data) if boundary.data else \
            np.zeros((1, 3))
        gps_bbox = gps_bbox_from_studyarea(origin_lat, origin_lon, vertices)

        params = {
            "raytracer_name": c.RAYTRACER_NAME_WIRELESS_INSITE,
            "raytracer_version": config.get("wireless_insite_version"),
            "frequency": waveform.get("CarrierFrequency", 0.0),
            "max_path_depth": max_depth,
            "max_reflections": max_refl,
            "max_diffractions": max_diffr,
            "max_scattering": int(bool(diffuse.get("enabled", False))),
            "max_transmissions": max_trans,
            "diffuse_reflections": diffuse.get("diffuse_reflections", 0),
            "diffuse_diffractions": diffuse.get("diffuse_diffractions", 0),
            "diffuse_transmissions": diffuse.get("diffuse_transmissions", 0),
            "diffuse_final_interaction_only": bool(
                diffuse.get("final_interaction_only", False)),
            "diffuse_random_phases": False,
            "terrain_reflection": bool(model.get("terrain_reflections", 1)),
            "terrain_diffraction": terrain_diffr == "Yes",
            "terrain_scattering": bool(model.get("terrain_scattering", 0)),
            "num_rays": int(360 // ray_spacing * 180),
            "ray_casting_method": "uniform",
            "synthetic_array": True,
            "gps_bbox": gps_bbox,
            "raw_params": {
                "antenna": _raw(antenna),
                "waveform": _raw(waveform),
                "studyarea": _raw(studyarea),
                # Defaults injected when absent from the .setup, so the
                # raw dump is self-describing (the params.json format of
                # the upstream DeepMIMO converter).
                "model": _raw(model) | {
                    "ray_spacing": ray_spacing,
                    "terrain_diffractions": terrain_diffr,
                    "max_transmissions": max_trans,
                    "max_wedge_diffractions": max_diffr,
                },
                "apg_acceleration": _raw(apg),
                "diffuse_scattering": _raw(diffuse),
            },
        }
        return cls.from_dict(params)


def _first(top: InsiteNode, kind: str) -> InsiteNode:
    found = top.find_all(kind)
    if not found:
        raise KeyError(f"No <{kind}> node in setup file")
    return found[0]


def _raw(node: InsiteNode) -> Dict:
    """Node values as a JSON-able dict; child nodes recurse (each child
    appears once, under its kind)."""
    out: Dict = {}
    for k, v in node.values.items():
        if isinstance(v, InsiteNode):
            if k == v.kind:               # skip the name-keyed duplicate
                out[k] = _raw(v)
        else:
            out[k] = list(v) if isinstance(v, tuple) else v
    return out


def read_rt_params(sim_folder: str | Path) -> Dict:
    return InsiteRayTracingParameters.read_parameters(sim_folder).to_dict()
