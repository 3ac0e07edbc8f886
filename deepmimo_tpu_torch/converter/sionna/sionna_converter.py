"""Sionna RT -> DeepMIMO scenario converter.

Reads the pickles produced by the exporter (sionna_paths.pkl,
sionna_rt_params.pkl, sionna_materials.pkl, sionna_material_indices.pkl,
sionna_vertices.pkl, sionna_objects.pkl) and assembles a standard
scenario. Copied from ``deepmimo_tpu/converter/sionna/sionna_converter.py``,
on the port's ``rt_params``, ``txrx``, ``materials`` and ``scene``.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

from ... import consts as c
from ...config import config
from ...materials import Material, MaterialList
from ...rt_params import RayTracingParameters
from ...scene import (Scene, Face, PhysicalElement, CAT_BUILDINGS,
                      CAT_TERRAIN, get_object_faces)
from ...txrx import TxRxSet
from .. import converter_utils as cu
from .sionna_paths import read_paths


# ============================================================================
# RT params
# ============================================================================

def read_rt_params(load_folder: str) -> Dict:
    raw = cu.load_pickle(os.path.join(load_folder, "sionna_rt_params.pkl"))

    if not raw.get("los", False):
        raise ValueError("Sionna exports must have LoS enabled")
    if not raw.get("synthetic_array", True):
        raise ValueError("Only synthetic arrays are supported")

    n_emitters = raw["tx_array_size"] * raw["tx_array_num_ant"]
    n_rays = raw["num_samples"] // max(n_emitters, 1)

    if raw.get("min_lat", 0) != 0:
        gps_bbox = (raw["min_lat"], raw["min_lon"],
                    raw["max_lat"], raw["max_lon"])
    else:
        gps_bbox = (0, 0, 0, 0)

    max_depth = int(raw["max_depth"])
    params = {
        "raytracer_name": c.RAYTRACER_NAME_SIONNA,
        "raytracer_version": raw.get("raytracer_version",
                                     config.get("sionna_version")),
        "frequency": int(raw["frequency"]),
        "max_path_depth": max_depth,
        "max_reflections": max_depth if raw.get("reflection") else 0,
        "max_diffractions": int(bool(raw.get("diffraction"))),
        "max_scattering": int(bool(raw.get("scattering"))),
        "max_transmissions": 0,
        "terrain_reflection": bool(raw.get("reflection")),
        "terrain_diffraction": bool(raw.get("diffraction")),
        "terrain_scattering": bool(raw.get("scattering")),
        "diffuse_reflections": max_depth - 1,
        "diffuse_diffractions": 0,
        "diffuse_transmissions": 0,
        "diffuse_final_interaction_only": True,
        "diffuse_random_phases": raw.get("scat_random_phases", True),
        "synthetic_array": raw.get("synthetic_array", True),
        "num_rays": n_rays if raw.get("method") == "fibonacci" else -1,
        "ray_casting_method": str(raw.get("method", "fibonacci")).replace(
            "fibonacci", "uniform"),
        "gps_bbox": gps_bbox,
        "raw_params": raw,
    }
    return RayTracingParameters.from_dict(params).to_dict()


# ============================================================================
# TX/RX sets
# ============================================================================

def read_txrx(rt_params_dict: Dict) -> Dict:
    raw = rt_params_dict["raw_params"]
    txrx_dict = {}
    for i, role in enumerate(("tx", "rx")):
        obj = TxRxSet(
            name=f"{role}_array",
            id_orig=i, id=i,
            is_tx=(role == "tx"), is_rx=(role == "rx"),
            num_ant=(1 if rt_params_dict["synthetic_array"]
                     else raw[f"{role}_array_num_ant"]),
            dual_pol=raw[f"{role}_array_num_ant"] !=
            raw[f"{role}_array_size"],
        )
        obj.ant_rel_positions = raw.get(f"{role}_array_ant_pos",
                                        [[0, 0, 0]])
        txrx_dict[f"txrx_set_{i}"] = obj.to_dict()
    return txrx_dict


# ============================================================================
# Materials + scene
# ============================================================================

_SCAT_PATTERNS = {
    "LambertianPattern": Material.SCATTERING_LAMBERTIAN,
    "DirectivePattern": Material.SCATTERING_DIRECTIVE,
    "BackscatteringPattern": Material.SCATTERING_DIRECTIVE,
}


def read_materials(load_folder: str, save_folder: str) -> Tuple[Dict, list]:
    props = cu.load_pickle(os.path.join(load_folder, "sionna_materials.pkl"))
    indices = cu.load_pickle(os.path.join(load_folder,
                                          "sionna_material_indices.pkl"))
    materials = []
    for i, p in enumerate(props):
        coeff = p.get("scattering_coefficient", 0.0)
        model = _SCAT_PATTERNS.get(p.get("scattering_pattern"),
                                   Material.SCATTERING_NONE)
        materials.append(Material(
            id=i, name=p.get("name", f"material_{i}"),
            permittivity=float(p["relative_permittivity"]),
            conductivity=float(p["conductivity"]),
            scattering_model=(model if coeff else Material.SCATTERING_NONE),
            scattering_coefficient=float(coeff),
            cross_polarization_coefficient=float(
                p.get("xpd_coefficient", 0.0)),
            alpha_r=float(p.get("alpha_r", 4.0)),
            alpha_i=float(p.get("alpha_i", 4.0)),
            lambda_param=float(p.get("lambda_", 0.5)),
        ))
    mlist = MaterialList()
    mlist.add_materials(materials)
    cu.save_mat(np.asarray(indices), "materials", save_folder,
                tx_set_idx=None)  # scene-level, unsuffixed (upstream naming)
    return mlist.to_dict(), indices


_TERRAIN_KEYWORDS = ("plane", "floor", "terrain", "roads", "paths")


def read_scene(load_folder: str, material_indices) -> Optional[Scene]:
    vpath = os.path.join(load_folder, "sionna_vertices.pkl")
    opath = os.path.join(load_folder, "sionna_objects.pkl")
    if not (os.path.exists(vpath) and os.path.exists(opath)):
        return None
    vertices = np.asarray(cu.load_pickle(vpath))
    objects = cu.load_pickle(opath)   # {name: (start_idx, end_idx)}

    scene = Scene()
    for obj_id, (name, (start, end)) in enumerate(objects.items()):
        obj_vertices = vertices[start:end]
        label = CAT_TERRAIN if any(w in name.lower()
                                   for w in _TERRAIN_KEYWORDS) \
            else CAT_BUILDINGS
        mat_idx = material_indices[obj_id] if obj_id < len(material_indices) \
            else 0
        try:
            face_polys = get_object_faces(obj_vertices)
        except Exception:
            face_polys = []
        if not face_polys:
            continue
        faces = [Face(vertices=poly, material_idx=mat_idx)
                 for poly in face_polys]
        scene.add_object(PhysicalElement(
            faces=faces, name=name, object_id=obj_id, label=label))
    return scene


# ============================================================================
# Orchestration
# ============================================================================

def sionna_rt_converter(rt_folder: str, copy_source: bool = False,
                        overwrite: Optional[bool] = None,
                        vis_scene: bool = False,
                        scenario_name: str = "",
                        print_params: bool = False) -> str:
    """Convert a Sionna RT export folder to a DeepMIMO scenario."""
    print("converting from sionna RT")
    scen_name = scenario_name or os.path.basename(rt_folder.rstrip("/"))
    output_folder = os.path.join(rt_folder, scen_name + "_deepmimo")
    if os.path.exists(output_folder):
        shutil.rmtree(output_folder)
    os.makedirs(output_folder)

    rt_params = read_rt_params(rt_folder)
    txrx_dict = read_txrx(rt_params)
    read_paths(rt_folder, output_folder, txrx_dict)
    materials_dict, material_indices = read_materials(rt_folder,
                                                      output_folder)
    scene = read_scene(rt_folder, material_indices)
    scene_dict = scene.export_data(output_folder) if scene else {
        c.SCENE_PARAM_NUMBER_SCENES: 1}
    if vis_scene and scene:
        scene.plot()

    params = {
        c.VERSION_PARAM_NAME: c.VERSION,
        c.RT_PARAMS_PARAM_NAME: rt_params,
        c.TXRX_PARAM_NAME: txrx_dict,
        c.MATERIALS_PARAM_NAME: materials_dict,
        c.SCENE_PARAM_NAME: scene_dict,
    }
    cu.save_params(params, output_folder)
    if print_params:
        from pprint import pprint
        pprint(params)

    return cu.save_scenario(output_folder, scen_name=scen_name,
                            overwrite=overwrite)
