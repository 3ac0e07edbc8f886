"""Shared converter utilities: scenario writing, path compression, params.

The scenario-writing side of the on-disk format, copied from
``deepmimo_tpu/converter/converter_utils.py`` onto the port's
``utils.files`` helpers.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, Optional

import numpy as np

from .. import consts as c
from ..utils import (save_dict_as_json, save_mat as _save_mat,
                     get_scenarios_dir)


# ============================================================================
# Pickle / mat IO
# ============================================================================

def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_mat(data, key: str, folder: str, tx_set_idx: int = 0,
             tx_idx: int = 0, rx_set_idx: int = 1) -> str:
    """Save one scenario matrix (delegates to utils.files.save_mat)."""
    return _save_mat(data, key, folder, tx_set_idx, tx_idx, rx_set_idx)


# ============================================================================
# Path-matrix compression
# ============================================================================

def get_max_paths(path_dict: Dict[str, np.ndarray]) -> int:
    """Largest number of non-NaN paths observed across users."""
    power = path_dict[c.POWER_PARAM_NAME]
    if power.size == 0:
        return 0
    return int(np.max(np.sum(~np.isnan(power), axis=1), initial=0))


def compress_path_data(path_dict: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Trim path and interaction dimensions to the observed maxima.

    Converters allocate [n_ue, MAX_PATHS(, MAX_INTER...)] buffers; this
    shrinks them to what the data actually uses before saving.
    """
    max_paths = max(get_max_paths(path_dict), 1)

    inter = path_dict.get(c.INTERACTIONS_PARAM_NAME)
    max_inter = 1
    if inter is not None and inter.size:
        with np.errstate(invalid="ignore", divide="ignore"):
            n_int = np.where(inter > 0,
                             np.floor(np.log10(np.maximum(inter, 1))) + 1, 0)
        max_inter = int(np.nanmax(n_int, initial=1)) or 1

    out = {}
    for key, val in path_dict.items():
        if val is None:
            out[key] = val
            continue
        if key == c.INTERACTIONS_POS_PARAM_NAME and val.ndim >= 3:
            out[key] = val[:, :max_paths, :max_inter, ...]
        elif key in (c.RX_POS_PARAM_NAME, c.TX_POS_PARAM_NAME):
            out[key] = val
        elif val.ndim >= 2:
            out[key] = val[:, :max_paths, ...]
        else:
            out[key] = val
    return out


# ============================================================================
# Scenario assembly
# ============================================================================

def save_params(params: Dict[str, Any], folder: str) -> str:
    """Write params.json into a scenario folder."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{c.PARAMS_FILENAME}.json")
    save_dict_as_json(path, params)
    return path


def save_scenario(temp_folder: str, scen_name: Optional[str] = None,
                  overwrite: Optional[bool] = None) -> str:
    """Move a staged scenario folder into the scenarios directory.

    Args:
        temp_folder: folder containing the staged scenario files.
        scen_name: target name (defaults to the staged folder's name).
        overwrite: True replaces an existing scenario; None prompts;
            False aborts.

    Returns:
        The final scenario name.
    """
    scen_name = scen_name or os.path.basename(temp_folder.rstrip("/"))
    target = os.path.join(get_scenarios_dir(), scen_name)

    if os.path.exists(target):
        if overwrite is None:
            resp = input(f"Scenario '{scen_name}' exists. Overwrite? [y/N] ")
            overwrite = resp.strip().lower() in ("y", "yes")
        if not overwrite:
            raise FileExistsError(
                f"Scenario '{scen_name}' already exists at {target}")
        shutil.rmtree(target)

    os.makedirs(get_scenarios_dir(), exist_ok=True)
    shutil.move(temp_folder, target)
    return scen_name


def zip_rt_source(rt_folder: str, dest_zip: str) -> str:
    """Archive the raw ray-tracer source files alongside the scenario."""
    base = dest_zip[:-4] if dest_zip.endswith(".zip") else dest_zip
    return shutil.make_archive(base, "zip", rt_folder)
