"""Filesystem utilities: scenario folders, matrix file naming, mat and
JSON IO, zip.

The scenario-on-disk naming contract (``{key}_t{SSS}_tx{III}_r{RRR}.mat``),
copied from ``deepmimo_tpu.utils.files`` so the port reads and writes the
same scenarios without importing the JAX package.
"""

from __future__ import annotations

import json
import os
import zipfile as _zipfile
from typing import Any, Dict

import numpy as np
import scipy.io

from .. import consts as c
from ..config import config


def check_scen_name(scen_name: str) -> None:
    """Raise if the scenario name contains filesystem-invalid characters."""
    if any(ch in scen_name for ch in c.SCENARIO_NAME_INVALID_CHARS):
        raise ValueError(
            f"Invalid scenario name: {scen_name}. Contains one of "
            f"{c.SCENARIO_NAME_INVALID_CHARS}")


def get_scenarios_dir() -> str:
    """Absolute path of the folder holding extracted scenarios."""
    folder = config.get("scenarios_folder")
    if os.path.isabs(folder):
        return folder
    return os.path.join(os.getcwd(), folder)


def get_scenario_folder(scenario_name: str) -> str:
    check_scen_name(scenario_name)
    return os.path.join(get_scenarios_dir(), scenario_name)


def get_params_path(scenario_name: str) -> str:
    check_scen_name(scenario_name)
    return os.path.join(get_scenario_folder(scenario_name),
                        f"{c.PARAMS_FILENAME}.json")


def get_available_scenarios() -> list:
    scenarios_dir = get_scenarios_dir()
    if not os.path.exists(scenarios_dir):
        return []
    return sorted(
        f for f in os.listdir(scenarios_dir)
        if os.path.isdir(os.path.join(scenarios_dir, f)))


def save_dict_as_json(output_path: str, data_dict: Dict[str, Any]) -> None:
    """Save a dict as JSON, converting numpy arrays/scalars transparently."""

    def _handler(x):
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, (np.bool_,)):
            return bool(x)
        return str(x)

    with open(output_path, "w") as f:
        json.dump(data_dict, f, indent=2, default=_handler)


def load_dict_from_json(file_path: str) -> Dict[str, Any]:
    with open(file_path, "r") as f:
        return json.load(f)


def get_txrx_str_id(tx_set_idx: int, tx_idx: int, rx_set_idx: int) -> str:
    """Standard TX-RX pair string: t{SSS}_tx{III}_r{RRR}."""
    return f"t{tx_set_idx:03}_tx{tx_idx:03}_r{rx_set_idx:03}"


def get_mat_filename(key: str, tx_set_idx: int, tx_idx: int,
                     rx_set_idx: int) -> str:
    """Matrix filename for one quantity of one TX-RX pair."""
    return f"{key}_{get_txrx_str_id(tx_set_idx, tx_idx, rx_set_idx)}.mat"


def save_mat(data: np.ndarray, key: str, folder: str, tx_set_idx=0,
             tx_idx=0, rx_set_idx=1) -> str:
    """Save one matrix in the scenario .mat format. Returns the file path.

    ``tx_set_idx=None`` writes the scene-level unsuffixed form
    ``{key}.mat`` (scene-wide matrices such as the object->material index
    map are stored that way)."""
    os.makedirs(folder, exist_ok=True)
    fname = (f"{key}.mat" if tx_set_idx is None else
             get_mat_filename(key, tx_set_idx, tx_idx, rx_set_idx))
    path = os.path.join(folder, fname)
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(c.FP_TYPE)
    scipy.io.savemat(path, {key: arr})
    return path


def load_mat(path: str, key: str) -> np.ndarray:
    """Load one matrix from a scenario .mat file."""
    return scipy.io.loadmat(path)[key]


def zip(folder_path: str) -> str:
    """Zip a folder (recursively, structure preserved) next to itself."""
    zip_path = folder_path + ".zip"
    all_files = []
    for root, _, files in os.walk(folder_path):
        for file in files:
            file_path = os.path.join(root, file)
            rel_path = os.path.relpath(file_path, os.path.dirname(folder_path))
            all_files.append((file_path, rel_path))
    with _zipfile.ZipFile(zip_path, "w",
                          compression=_zipfile.ZIP_DEFLATED) as zf:
        for file_path, rel_path in all_files:
            zf.write(file_path, rel_path)
    return zip_path


def unzip(path_to_zip: str) -> str:
    """Extract a zip archive next to itself; returns the extraction folder."""
    extracted_path = path_to_zip.replace(".zip", "")
    with _zipfile.ZipFile(path_to_zip, "r") as zf:
        zf.extractall(extracted_path)
    return extracted_path
