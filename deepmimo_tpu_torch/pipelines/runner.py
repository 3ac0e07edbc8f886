"""Scenario-factory pipeline: CSV of city sites -> scenarios (-> upload).

Per row: fetch OSM scene (Blender), place TX/RX, run the external ray
tracer (Wireless InSite or Sionna RT), convert to the DeepMIMO format, and
optionally upload. External tools are invoked through the gated wrappers in
``blender_osm`` / ``raytracers``; the pipeline checkpoints per stage so a
failed row resumes at the failed stage. Copied from
``deepmimo_tpu/pipelines/runner.py``, on the port's ``convert`` and
``api.upload``.
"""

from __future__ import annotations

import csv
import json
import os
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import converter
from ..api import upload as api_upload


@dataclass
class PipelineRow:
    """One scenario site: name + GPS bbox + BS placements."""

    name: str
    min_lat: float
    min_lon: float
    max_lat: float
    max_lon: float
    bs_lats: List[float] = field(default_factory=list)
    bs_lons: List[float] = field(default_factory=list)
    bs_heights: List[float] = field(default_factory=list)

    @property
    def gps_bbox(self):
        return (self.min_lat, self.min_lon, self.max_lat, self.max_lon)


def read_pipeline_csv(path: str) -> List[PipelineRow]:
    """Parse the pipeline CSV (name, bbox corners, BS lat/lon/height lists).

    BS columns may hold single values or '|'-separated lists.
    """
    rows = []
    with open(path) as f:
        for rec in csv.DictReader(f):
            split = lambda key: [float(v) for v in
                                 str(rec.get(key, "")).split("|") if v]
            rows.append(PipelineRow(
                name=rec["name"],
                min_lat=float(rec["min_lat"]),
                min_lon=float(rec["min_lon"]),
                max_lat=float(rec["max_lat"]),
                max_lon=float(rec["max_lon"]),
                bs_lats=split("bs_lat"),
                bs_lons=split("bs_lon"),
                bs_heights=split("bs_height") or [6.0] * len(split("bs_lat")),
            ))
    return rows


class PipelineState:
    """Per-row stage checkpointing (resume after failures)."""

    def __init__(self, work_dir: str):
        self.path = os.path.join(work_dir, "pipeline_state.json")
        self.state: Dict[str, Dict[str, str]] = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.state = json.load(f)

    def done(self, row: str, stage: str) -> bool:
        return self.state.get(row, {}).get(stage) == "done"

    def mark(self, row: str, stage: str, status: str = "done") -> None:
        self.state.setdefault(row, {})[stage] = status
        with open(self.path, "w") as f:
            json.dump(self.state, f, indent=1)


def run_pipeline(csv_path: str, work_dir: str, raytracer: str = "sionna",
                 upload_key: Optional[str] = None,
                 grid_spacing: float = 2.0, ue_height: float = 1.5,
                 frequency: float = 3.5e9) -> List[str]:
    """Run the full scenario factory over every CSV row.

    Returns the list of successfully converted scenario names.
    """
    from .blender_osm import fetch_osm_scene
    from .raytracers import raytrace_insite, raytrace_sionna
    from .placement import gen_rx_grid, gen_tx_pos

    rows = read_pipeline_csv(csv_path)
    os.makedirs(work_dir, exist_ok=True)
    state = PipelineState(work_dir)
    completed = []

    for row in rows:
        row_dir = os.path.join(work_dir, row.name)
        os.makedirs(row_dir, exist_ok=True)
        rt_params = {
            "gps_bbox": row.gps_bbox,
            "bs_lats": row.bs_lats, "bs_lons": row.bs_lons,
            "bs_heights": row.bs_heights,
            "grid_spacing": grid_spacing, "ue_height": ue_height,
            "frequency": frequency,
        }
        try:
            if not state.done(row.name, "scene"):
                fetch_osm_scene(row.gps_bbox, row_dir)
                state.mark(row.name, "scene")

            rx_pos = gen_rx_grid(rt_params)
            tx_pos = gen_tx_pos(rt_params)

            if not state.done(row.name, "raytrace"):
                if raytracer == "insite":
                    raytrace_insite(row_dir, tx_pos, rx_pos, rt_params)
                else:
                    raytrace_sionna(row_dir, tx_pos, rx_pos, rt_params)
                state.mark(row.name, "raytrace")

            if not state.done(row.name, "convert"):
                scen_name = converter.convert(
                    os.path.join(row_dir, "rt_output"),
                    scenario_name=row.name, overwrite=True)
                state.mark(row.name, "convert")
            else:
                scen_name = row.name

            if upload_key and not state.done(row.name, "upload"):
                api_upload(scen_name, key=upload_key)
                state.mark(row.name, "upload")

            completed.append(scen_name)
        except Exception as e:
            print(f"[pipeline] row '{row.name}' failed: {e}")
            traceback.print_exc()
            state.mark(row.name, "error", status=str(e))
    return completed
