"""Conversion dispatcher: sniff a ray-tracer output folder and convert it.

Folder contents decide the engine: ``.aodt`` -> AODT, ``.pkl`` -> Sionna
RT, ``.setup`` -> Wireless InSite. Host code, copied from
``deepmimo_tpu/converter/converter.py``; it imports no torch.
"""

from __future__ import annotations

import os
from typing import Optional


def convert(path_to_rt_folder: str, **conversion_params) -> Optional[str]:
    """Convert a ray-tracer output folder into a DeepMIMO scenario.

    Args:
        path_to_rt_folder: folder with raw ray-tracer outputs.
        **conversion_params: engine-specific options (e.g. overwrite,
            scenario_name, vis_scene).

    Returns:
        The scenario name, loadable via ``deepmimo_tpu_torch.load()``.
    """
    if not os.path.isdir(path_to_rt_folder):
        raise ValueError(f"Not a directory: {path_to_rt_folder}")

    files = os.listdir(path_to_rt_folder)
    exts = {os.path.splitext(f)[1].lower() for f in files}

    if ".aodt" in exts:
        from .aodt.aodt_converter import aodt_rt_converter
        return aodt_rt_converter(path_to_rt_folder, **conversion_params)
    if ".pkl" in exts:
        from .sionna.sionna_converter import sionna_rt_converter
        return sionna_rt_converter(path_to_rt_folder, **conversion_params)
    if ".setup" in exts:
        from .insite.insite_converter import insite_rt_converter
        return insite_rt_converter(path_to_rt_folder, **conversion_params)

    raise ValueError(
        f"Could not identify a supported ray tracer in {path_to_rt_folder}. "
        "Expected one of: .setup (Wireless InSite), .pkl (Sionna RT), "
        ".aodt (AODT)")
