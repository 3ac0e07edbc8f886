"""Filesystem utilities: scenario folders, matrix file naming, JSON.

The scenario-on-disk naming contract (``{key}_t{SSS}_tx{III}_r{RRR}.mat``),
copied from ``deepmimo_tpu.utils.files`` so the port reads the same
scenarios without importing the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

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
