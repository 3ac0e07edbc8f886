"""Sionna-side exporter: pickle Paths/Scene/materials for offline conversion.

Runs INSIDE a Sionna environment (TensorFlow / drjit present); everything
else in this package is Sionna-free. Produces the pickles consumed by
``sionna_rt_converter``. Copied from
``deepmimo_tpu/converter/sionna/exporter.py``.

Supports both Sionna 0.19.x (``scene.compute_paths`` -> ``Paths``) and
1.x (``PathSolver`` results) by duck-typing the fields we need.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np

from .. import converter_utils as cu


def _to_numpy(x):
    """TensorFlow / drjit / numpy tensors -> numpy."""
    if hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)


def paths_to_dict(paths) -> Dict[str, Any]:
    """Extract the per-path tensors from a Sionna Paths object.

    Handles both 0.19.x (complex ``a``) and 1.x (``a`` as a
    (real, imag) pair from the PathSolver).
    """
    out = {}
    a = getattr(paths, "a")
    if isinstance(a, (tuple, list)) and len(a) == 2:
        out["a"] = _to_numpy(a[0]) + 1j * _to_numpy(a[1])
    else:
        out["a"] = _to_numpy(a)
    for key in ("tau", "phi_r", "theta_r", "phi_t", "theta_t",
                "types", "vertices"):
        out[key] = _to_numpy(getattr(paths, key))
    out["sources"] = _to_numpy(paths.sources)
    out["targets"] = _to_numpy(paths.targets)
    return out


def scene_materials_to_list(scene) -> tuple:
    """Radio materials + per-object material indices from a Sionna Scene."""
    mat_names = []
    materials: List[Dict] = []
    for name, mat in scene.radio_materials.items():
        try:
            pattern = type(mat.scattering_pattern).__name__
        except Exception:
            pattern = "LambertianPattern"
        materials.append({
            "name": name,
            "relative_permittivity": float(_to_numpy(
                mat.relative_permittivity)),
            "conductivity": float(_to_numpy(mat.conductivity)),
            "scattering_coefficient": float(_to_numpy(
                mat.scattering_coefficient)),
            "xpd_coefficient": float(_to_numpy(mat.xpd_coefficient)),
            "scattering_pattern": pattern,
            "alpha_r": float(getattr(mat.scattering_pattern, "alpha_r", 4.0)),
            "alpha_i": float(getattr(mat.scattering_pattern, "alpha_i", 4.0)),
            "lambda_": float(_to_numpy(getattr(mat.scattering_pattern,
                                               "lambda_", 0.5))),
        })
        mat_names.append(name)

    indices = []
    for obj_name, obj in scene.objects.items():
        try:
            indices.append(mat_names.index(obj.radio_material.name))
        except (ValueError, AttributeError):
            indices.append(0)
    return materials, indices


def scene_geometry(scene) -> tuple:
    """Vertex soup + {object: (start, end)} vertex ranges from the scene."""
    all_vertices = []
    objects = {}
    cursor = 0
    for name, obj in scene.objects.items():
        try:
            verts = _to_numpy(obj.mitsuba_shape.vertex_positions_buffer()
                              ).reshape(-1, 3)
        except Exception:
            continue
        all_vertices.append(verts)
        objects[name] = (cursor, cursor + len(verts))
        cursor += len(verts)
    vertices = np.vstack(all_vertices) if all_vertices else \
        np.zeros((0, 3), dtype=np.float32)
    return vertices, objects


def rt_params_dict(scene, my_compute_path_params: Dict) -> Dict:
    """Collect the ray-tracing parameters used for the run."""
    tx_array = scene.tx_array
    rx_array = scene.rx_array
    params = {
        "frequency": float(_to_numpy(scene.frequency)),
        "synthetic_array": bool(getattr(scene, "synthetic_array", True)),
        "tx_array_size": int(tx_array.array_size),
        "tx_array_num_ant": int(tx_array.num_ant),
        "rx_array_size": int(rx_array.array_size),
        "rx_array_num_ant": int(rx_array.num_ant),
        "tx_array_ant_pos": _to_numpy(tx_array.positions).tolist(),
        "rx_array_ant_pos": _to_numpy(rx_array.positions).tolist(),
        "raytracer_version": _sionna_version(),
    }
    params.update(my_compute_path_params)
    return params


def _sionna_version() -> str:
    try:
        import sionna
        return sionna.__version__
    except Exception:
        return "unknown"


def export_to_deepmimo(scene, path_list: Sequence, my_compute_path_params:
                       Dict, save_folder: str) -> None:
    """Export everything needed by the offline converter into pickles.

    Args:
        scene: the Sionna Scene used for ray tracing.
        path_list: list of Paths objects (one per batch of users).
        my_compute_path_params: dict of compute_paths/PathSolver arguments
            actually used (max_depth, los, reflection, diffraction,
            scattering, num_samples, method, scat_random_phases, ...).
        save_folder: output folder for the pickles.
    """
    os.makedirs(save_folder, exist_ok=True)

    path_dicts = [paths_to_dict(p) for p in path_list]
    cu.save_pickle(path_dicts, os.path.join(save_folder,
                                            "sionna_paths.pkl"))

    params = rt_params_dict(scene, my_compute_path_params)
    cu.save_pickle(params, os.path.join(save_folder, "sionna_rt_params.pkl"))

    materials, indices = scene_materials_to_list(scene)
    cu.save_pickle(materials, os.path.join(save_folder,
                                           "sionna_materials.pkl"))
    cu.save_pickle(indices, os.path.join(save_folder,
                                         "sionna_material_indices.pkl"))

    vertices, objects = scene_geometry(scene)
    cu.save_pickle(vertices, os.path.join(save_folder,
                                          "sionna_vertices.pkl"))
    cu.save_pickle(objects, os.path.join(save_folder, "sionna_objects.pkl"))
