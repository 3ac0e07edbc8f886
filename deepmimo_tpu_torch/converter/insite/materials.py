"""Material extraction from InSite geometry files (.city/.ter/.veg/...).

Each geometry file carries Material blocks with a DielectricLayer and
optional diffuse-scattering knobs; foliage files carry attenuation
instead. Copied from ``deepmimo_tpu/converter/insite/materials.py``, on
the port's ``materials``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from ...materials import Material, MaterialList
from .tokenfmt import parse_insite_file, InsiteNode

GEOMETRY_EXTS = (".city", ".ter", ".veg", ".flp", ".obj")

_SCATTERING_MODELS = {
    "": Material.SCATTERING_NONE,
    "lambertian": Material.SCATTERING_LAMBERTIAN,
    "directive": Material.SCATTERING_DIRECTIVE,
    "directive_with_backscatter": Material.SCATTERING_DIRECTIVE,
}


def _material_from_node(node: InsiteNode) -> Material:
    vals = node.values
    if "DielectricLayer" in vals or node.find_all("DielectricLayer"):
        layer = node.find_all("DielectricLayer")
        lv = layer[0].values if layer else {}
        # The scattering model name appears as a bare label under the
        # Material block (e.g. 'lambertian'); absent means none.
        model = ""
        for lbl in node.labels:
            if lbl in _SCATTERING_MODELS:
                model = lbl
        return Material(
            name=node.name,
            permittivity=float(lv.get("permittivity", 0.0)),
            conductivity=float(lv.get("conductivity", 0.0)),
            roughness=float(lv.get("roughness", -1.0)),
            thickness=float(lv.get("thickness", -1.0)),
            scattering_model=_SCATTERING_MODELS.get(
                vals.get("diffuse_scattering_model", model),
                Material.SCATTERING_NONE),
            scattering_coefficient=float(
                vals.get("fields_diffusively_scattered", 0.0)),
            cross_polarization_coefficient=float(
                vals.get("cross_polarized_power", 0.0)),
            alpha_r=float(vals.get("directive_alpha", 4.0)),
            alpha_i=float(vals.get("directive_beta", 4.0)),
            lambda_param=float(vals.get("directive_lambda", 0.5)),
        )
    # Foliage-style material: attenuation instead of dielectric layer
    return Material(
        name=node.name,
        permittivity=float(vals.get("permittivity_vr", 0.0)),
        thickness=float(vals.get("thickness", -1.0)),
        scattering_model=Material.SCATTERING_NONE,
        vertical_attenuation=float(vals.get("vertical_attenuation", 0.0)),
        horizontal_attenuation=float(vals.get("horizontal_attenuation", 0.0)),
    )


def parse_materials_from_file(path: str) -> List[Material]:
    materials = []
    for top in parse_insite_file(path):
        for node in top.find_all("Material"):
            materials.append(_material_from_node(node))
    return materials


def read_materials(sim_folder: str) -> Dict:
    """Collect deduplicated materials from all geometry files in a folder."""
    folder = Path(sim_folder)
    files = [f for ext in GEOMETRY_EXTS for f in folder.glob(f"*{ext}")]
    if not files:
        raise ValueError(f"No material files found in {folder}")
    mlist = MaterialList()
    for f in files:
        mlist.add_materials(parse_materials_from_file(str(f)))
    return mlist.to_dict()
