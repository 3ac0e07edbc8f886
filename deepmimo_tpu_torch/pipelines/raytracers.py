"""External ray-tracer runs (Wireless InSite CLI, Sionna RT).

Both engines are external dependencies; these wrappers stage the inputs,
invoke the engine, and leave raw outputs under ``<row_dir>/rt_output`` for
the converters. Copied from ``deepmimo_tpu/pipelines/raytracers.py``;
the Sionna run exports with the port's ``converter/sionna/exporter.py``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict

import numpy as np


class RaytracerNotAvailable(RuntimeError):
    pass


# ============================================================================
# Wireless InSite
# ============================================================================

def raytrace_insite(row_dir: str, tx_pos: np.ndarray, rx_pos: np.ndarray,
                    rt_params: Dict, insite_exe: str = "wibatch",
                    timeout: float = 24 * 3600.0) -> str:
    """Stage an InSite project from templates and run the CLI ray tracer.

    Requires the InSite batch executable (``wibatch``) on PATH or via
    rt_params['insite_exe'].
    """
    exe = shutil.which(rt_params.get("insite_exe", insite_exe))
    if exe is None:
        raise RaytracerNotAvailable(
            "Wireless InSite CLI (wibatch) not found. Install InSite or "
            "use raytracer='sionna'.")

    out_dir = os.path.join(row_dir, "rt_output")
    os.makedirs(out_dir, exist_ok=True)
    project = _stage_insite_project(row_dir, out_dir, tx_pos, rx_pos,
                                    rt_params)
    result = subprocess.run([exe, "-f", project, "-out", out_dir],
                            capture_output=True, text=True, timeout=timeout)
    log = os.path.join(out_dir, "insite.log")
    with open(log, "w") as f:
        f.write(result.stdout + "\n--- stderr ---\n" + result.stderr)
    if result.returncode != 0:
        raise RuntimeError(f"InSite run failed (see {log})")
    return out_dir


def _stage_insite_project(row_dir: str, out_dir: str, tx_pos, rx_pos,
                          rt_params) -> str:
    """Write .setup/.txrx files for the run from the scene + placements."""
    from .insite_project import write_insite_project
    return write_insite_project(row_dir, out_dir, tx_pos, rx_pos, rt_params)


# ============================================================================
# Sionna RT
# ============================================================================

def raytrace_sionna(row_dir: str, tx_pos: np.ndarray, rx_pos: np.ndarray,
                    rt_params: Dict, batch_size: int = 10_000) -> str:
    """Run Sionna RT over the exported Mitsuba scene and export pickles.

    Requires the ``sionna`` package (and its TF/drjit stack). Users are
    traced in batches; results are exported with
    ``deepmimo_tpu_torch.converter.sionna.exporter`` for offline
    conversion.
    """
    try:
        import sionna.rt as srt
    except ImportError as e:
        raise RaytracerNotAvailable(
            "sionna is not installed; install Sionna RT or use "
            "raytracer='insite'.") from e

    from ..converter.sionna.exporter import export_to_deepmimo

    scene_file = os.path.join(row_dir, "scene.xml")
    if not os.path.exists(scene_file):
        raise FileNotFoundError(f"Mitsuba scene not found: {scene_file}")

    scene = srt.load_scene(scene_file)
    scene.frequency = rt_params.get("frequency", 3.5e9)
    scene.synthetic_array = True
    ant_cfg = dict(num_rows=1, num_cols=1, vertical_spacing=0.5,
                   horizontal_spacing=0.5, pattern="iso",
                   polarization="V")
    scene.tx_array = srt.PlanarArray(**ant_cfg)
    scene.rx_array = srt.PlanarArray(**ant_cfg)

    for i, pos in enumerate(np.atleast_2d(tx_pos)):
        scene.add(srt.Transmitter(name=f"tx_{i}", position=pos.tolist()))

    compute_params = dict(
        max_depth=rt_params.get("max_depth", 5),
        los=True, reflection=True,
        diffraction=rt_params.get("diffraction", True),
        scattering=rt_params.get("scattering", False),
        num_samples=rt_params.get("num_samples", 1_000_000),
        method="fibonacci",
        scat_random_phases=False,
    )

    path_list = []
    rx_pos = np.atleast_2d(rx_pos)
    for start in range(0, len(rx_pos), batch_size):
        chunk = rx_pos[start:start + batch_size]
        for j, pos in enumerate(chunk):
            scene.add(srt.Receiver(name=f"rx_{j}", position=pos.tolist()))
        paths = scene.compute_paths(**compute_params)
        paths.normalize_delays = False
        path_list.append(paths)
        for j in range(len(chunk)):
            scene.remove(f"rx_{j}")

    out_dir = os.path.join(row_dir, "rt_output")
    export_to_deepmimo(scene, path_list, compute_params, out_dir)
    return out_dir
