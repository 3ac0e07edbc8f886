"""Wireless InSite -> DeepMIMO scenario converter (orchestration).

Pipeline: .setup -> rt_params; project XML -> txrx sets; per TX-RX pair
.paths.p2m + .pl.p2m -> path matrices; .city/.ter/.veg -> materials +
scene; everything assembled into params.json + per-pair .mat files. Copied from
``deepmimo_tpu/converter/insite/insite_converter.py``.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ... import consts as c
from .. import converter_utils as cu
from .p2m import (parse_paths_p2m, parse_pl_p2m, extract_tx_pos,
                  tx_pos_from_swapped_pl)
from .txrx import read_txrx
from .rt_params import read_rt_params
from .materials import read_materials
from .scene import read_scene

INACTIVE_PATHLOSS_DB = 250.0
SOURCE_EXTS = (".setup", ".txrx", ".city", ".ter", ".veg", ".xml")


def _find_p2m_folder(rt_folder: str) -> Path:
    """The p2m study folder is the first subdirectory containing .p2m files."""
    root = Path(rt_folder)
    candidates = [root] + [p for p in sorted(root.iterdir()) if p.is_dir()]
    for cand in candidates:
        if list(cand.glob("*.p2m")):
            return cand
    raise FileNotFoundError(f"No .p2m files found under {rt_folder}")


def read_paths(rt_folder: str, output_folder: str, txrx_dict: Dict) -> None:
    """Parse and save path matrices for every TX point x RX set pair."""
    p2m_folder = _find_p2m_folder(rt_folder)
    proj_name = list(p2m_folder.glob("*.p2m"))[0].name.split(".")[0]

    tx_sets = [txrx_dict[k] for k in sorted(txrx_dict)
               if txrx_dict[k][c.TXRX_PARAM_IS_TX]]
    rx_sets = [txrx_dict[k] for k in sorted(txrx_dict)
               if txrx_dict[k][c.TXRX_PARAM_IS_RX]]

    tx_positions = {}
    for tx_set in tx_sets:
        for tx_idx in range(tx_set[c.TXRX_PARAM_NUM_POINTS]):
            for rx_set in rx_sets:
                fname = (f"{proj_name}.paths.t{tx_idx + 1:03}_"
                         f"{tx_set['id_orig']:02}.r{rx_set['id_orig']:03}"
                         ".p2m")
                paths_file = p2m_folder / fname
                if not paths_file.exists():
                    raise FileNotFoundError(
                        f"P2M path file not found: {paths_file}")

                data = parse_paths_p2m(str(paths_file))

                tx_key = (tx_set["id"], tx_idx)
                if tx_key not in tx_positions:
                    pos = extract_tx_pos(str(paths_file))
                    if pos is None:
                        pos = tx_pos_from_swapped_pl(str(paths_file))
                    if pos is not None:
                        tx_positions[tx_key] = pos
                data[c.TX_POS_PARAM_NAME] = tx_positions.get(
                    tx_key, np.zeros(3, dtype=np.float32))

                pl_file = str(paths_file).replace(".paths.", ".pl.")
                rx_pos, _, path_loss = parse_pl_p2m(pl_file)
                data[c.RX_POS_PARAM_NAME] = rx_pos

                # Update point counts from the pathloss file (ground truth)
                rx_key = f"txrx_set_{rx_set['id']}"
                n_points = rx_pos.shape[0]
                txrx_dict[rx_key][c.TXRX_PARAM_NUM_POINTS] = n_points
                inactive = int((path_loss == INACTIVE_PATHLOSS_DB).sum())
                txrx_dict[rx_key][c.TXRX_PARAM_NUM_ACTIVE_POINTS] = \
                    n_points - inactive

                for key, val in data.items():
                    cu.save_mat(val, key, output_folder,
                                tx_set["id"], tx_idx, rx_set["id"])

    # Drop TX sets that produced no paths at all
    for tx_set in tx_sets:
        if not any((tx_set["id"], i) in tx_positions
                   for i in range(tx_set[c.TXRX_PARAM_NUM_POINTS])):
            print(f"Warning: TX set {tx_set['id']} has no paths - removing")
            del txrx_dict[f"txrx_set_{tx_set['id']}"]


def insite_rt_converter(rt_folder: str, copy_source: bool = False,
                        overwrite: Optional[bool] = None,
                        vis_scene: bool = False,
                        scenario_name: str = "",
                        print_params: bool = False) -> str:
    """Convert a Wireless InSite project folder to a DeepMIMO scenario."""
    scen_name = scenario_name or os.path.basename(rt_folder.rstrip("/"))
    output_folder = os.path.join(os.path.dirname(rt_folder.rstrip("/")),
                                 scen_name + "_deepmimo")
    if os.path.exists(output_folder):
        shutil.rmtree(output_folder)
    os.makedirs(output_folder)

    rt_params = read_rt_params(rt_folder)
    txrx_dict, _ = read_txrx(rt_folder)
    read_paths(rt_folder, output_folder, txrx_dict)
    materials_dict = read_materials(rt_folder)

    scene = read_scene(rt_folder)
    scene_dict = scene.export_data(output_folder)
    if vis_scene:
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

    scen_name = cu.save_scenario(output_folder, scen_name=scen_name,
                                 overwrite=overwrite)
    if copy_source:
        cu.zip_rt_source(rt_folder, os.path.join(
            cu.get_scenarios_dir(), scen_name, "rt_source.zip"))
    return scen_name
