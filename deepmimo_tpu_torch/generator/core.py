"""Scenario loading and one-shot generation entry points.

``load()`` reads a scenario from disk (params.json + per-pair .mat
matrices, the DeepMIMO scenario format) into a :class:`Dataset`, a
:class:`MacroDataset` of several TX-RX pairs, or a :class:`DynamicDataset`
of snapshots (``scene_i`` subfolders); a legacy v3 folder (params.mat +
``BS{i}_UE`` chunks) loads through the same entry point. The scenario's
``Scene`` and ``MaterialList`` are attached. ``generate()`` is load +
compute_channels. Counterpart of ``deepmimo_tpu/generator/core.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import scipy.io

from .. import consts as c
from ..materials import MaterialList
from ..scene import Scene
from ..utils import (get_mat_filename, get_scenario_folder,
                     load_dict_from_json)
from .dataset import Dataset, MacroDataset
from .params import ChannelGenParameters


def generate(scen_name: str, load_params: Dict[str, Any] = {},
             ch_gen_params: Dict[str, Any] = {}) -> Dataset:
    """Load a scenario and compute channels in one call."""
    dataset = load(scen_name, **load_params)
    ch_params = (ChannelGenParameters(ch_gen_params)
                 if not isinstance(ch_gen_params, ChannelGenParameters)
                 else ch_gen_params)
    dataset.compute_channels(ch_params)
    return dataset


def load(scen_name: str, **load_params) -> Dataset | MacroDataset:
    """Load a DeepMIMO scenario into a Dataset (or MacroDataset).

    Args:
        scen_name: scenario name (resolved under the scenarios folder) or an
            absolute path to a scenario folder. A folder that does not
            exist is downloaded from the scenario database into it first
            (``api.download``).
        **load_params: max_paths (int), tx_sets / rx_sets (dict | list |
            'all'), matrices (list | 'all').
    """
    if os.path.isabs(scen_name):
        scen_folder = scen_name
        scen_name = os.path.basename(scen_folder)
    else:
        scen_folder = get_scenario_folder(scen_name)
    if not os.path.exists(scen_folder):
        from ..api import download
        print(f"Scenario '{scen_name}' not found locally; "
              "attempting download...")
        download(scen_name, output_dir=os.path.dirname(scen_folder))
        if not os.path.exists(scen_folder):
            raise ValueError(f"Scenario {scen_name} not found")

    params_file = os.path.join(scen_folder, f"{c.PARAMS_FILENAME}.json")
    if not os.path.exists(params_file):
        # Published legacy-v3 scenarios (params.mat + BS{i}_UE chunks)
        # load through the same entry point.
        from ..converter.legacy_v3 import is_v3_scenario, load_v3_scenario
        if is_v3_scenario(scen_folder):
            dataset = load_v3_scenario(
                scen_folder, max_paths=load_params.get("max_paths",
                                                       c.MAX_PATHS))
            dataset[c.NAME_PARAM_NAME] = scen_name
            dataset[c.LOAD_PARAMS_PARAM_NAME] = load_params
            return dataset
        raise ValueError(f"Parameters file not found in {scen_folder}")
    params = load_dict_from_json(params_file)

    n_snapshots = params[c.SCENE_PARAM_NAME].get(c.SCENE_PARAM_NUMBER_SCENES,
                                                 1)
    if n_snapshots > 1:
        # Dynamic scenario: one dataset (or macro-dataset) per snapshot.
        snapshots = []
        for i in range(n_snapshots):
            snap_folder = os.path.join(scen_folder, f"scene_{i}")
            folder = snap_folder if os.path.isdir(snap_folder) else scen_folder
            snapshots.append(_load_raytracing_scene(
                folder, params[c.TXRX_PARAM_NAME], **load_params))
        dataset = DynamicDataset(snapshots)
    else:
        dataset = _load_raytracing_scene(scen_folder,
                                         params[c.TXRX_PARAM_NAME],
                                         **load_params)

    dataset[c.NAME_PARAM_NAME] = scen_name
    dataset[c.LOAD_PARAMS_PARAM_NAME] = load_params
    dataset[c.RT_PARAMS_PARAM_NAME] = params[c.RT_PARAMS_PARAM_NAME]
    dataset[c.SCENE_PARAM_NAME] = Scene.from_data(scen_folder)
    dataset[c.MATERIALS_PARAM_NAME] = MaterialList.from_dict(
        params.get(c.MATERIALS_PARAM_NAME, {}))
    return dataset


class DynamicDataset(MacroDataset):
    """Time-snapshot sequence of datasets (dynamic scenarios)."""

    @property
    def n_snapshots(self) -> int:
        return len(self.datasets)


def _load_raytracing_scene(scene_folder: str, txrx_dict: dict,
                           max_paths: int = c.MAX_PATHS,
                           tx_sets="all", rx_sets="all",
                           matrices="all") -> Dataset | MacroDataset:
    """Load all requested TX-RX pairs of one scene: a Dataset for one
    pair, else a MacroDataset."""
    tx_sets = _validate_txrx_sets(tx_sets, txrx_dict, "tx")
    rx_sets = _validate_txrx_sets(rx_sets, txrx_dict, "rx")
    datasets = []
    for tx_set_id, tx_idxs in tx_sets.items():
        for rx_set_id, rx_idxs in rx_sets.items():
            for tx_idx in tx_idxs:
                d = _load_tx_rx_raydata(scene_folder, tx_set_id, rx_set_id,
                                        tx_idx, rx_idxs, max_paths, matrices)
                d["txrx"] = {"tx_set_id": tx_set_id,
                             "rx_set_id": rx_set_id,
                             "tx_idx": int(tx_idx)}
                datasets.append(Dataset(d))
    return MacroDataset(datasets) if len(datasets) > 1 else datasets[0]


def _load_tx_rx_raydata(rayfolder: str, tx_set_id: int, rx_set_id: int,
                        tx_idx: int, rx_idxs, max_paths: int,
                        matrices_to_load="all") -> Dict[str, Any]:
    """Load the per-pair matrices from .mat files, filter users, trim paths."""
    keys = list(c.ALL_MATRIX_NAMES) + [c.DOPPLER_VEL_PARAM_NAME,
                                       c.DOPPLER_ACC_PARAM_NAME]
    optional = {c.DOPPLER_VEL_PARAM_NAME, c.DOPPLER_ACC_PARAM_NAME}

    if matrices_to_load == "all":
        matrices_to_load = keys
    else:
        matrices_to_load = matrices_to_load or []
        invalid = set(matrices_to_load) - set(keys)
        if invalid:
            raise ValueError(f"Invalid matrix names: {invalid}. "
                             f"Valid names are: {set(keys)}")

    out: Dict[str, Any] = {}
    for key in keys:
        if key not in matrices_to_load:
            if key not in optional:
                out[key] = None
            continue
        mat_path = os.path.join(
            rayfolder, get_mat_filename(key, tx_set_id, tx_idx, rx_set_id))
        if not os.path.exists(mat_path):
            if key not in optional:
                print(f"File {mat_path} could not be found")
                out[key] = None
            continue
        data = scipy.io.loadmat(mat_path)[key]
        if key != c.TX_POS_PARAM_NAME:
            data = data[np.asarray(rx_idxs)]
        if key not in (c.RX_POS_PARAM_NAME, c.TX_POS_PARAM_NAME):
            data = data[:, :max_paths, ...]
        out[key] = data
    return out


def _validate_txrx_sets(sets, txrx_dict: Dict[str, Any],
                        tx_or_rx: str = "tx") -> Dict[int, np.ndarray]:
    """Normalize tx/rx set selection (dict | list | 'all') to {id: idxs}."""
    role_key = c.TXRX_PARAM_IS_TX if tx_or_rx == "tx" else c.TXRX_PARAM_IS_RX
    valid_ids = [txrx_dict[key]["id"] for key in sorted(txrx_dict.keys())
                 if txrx_dict[key][role_key]]
    set_str = "Tx" if tx_or_rx == "tx" else "Rx"
    info_str = ("To see supported TX/RX sets and indices run "
                "dm.info(<scenario_name>)")

    def n_points(set_id):
        return txrx_dict[f"txrx_set_{set_id}"][c.TXRX_PARAM_NUM_POINTS]

    if isinstance(sets, dict):
        out = {}
        for set_id, idxs in sets.items():
            if set_id not in valid_ids:
                raise ValueError(f"{set_str} set {set_id} not in allowed sets "
                                 f"{valid_ids}\n{info_str}")
            all_idxs = np.arange(n_points(set_id))
            if isinstance(idxs, np.ndarray):
                out[set_id] = idxs
            elif isinstance(idxs, list):
                out[set_id] = np.array(idxs)
            elif isinstance(idxs, str):
                if idxs != "all":
                    raise ValueError(
                        f"String '{idxs}' not recognized for tx/rx indices")
                out[set_id] = all_idxs
            else:
                raise ValueError(
                    "Only list or np.ndarray allowed as tx/rx indices")
            if not set(out[set_id].tolist()).issubset(set(all_idxs.tolist())):
                raise ValueError(f"Some indices of {idxs} are not in "
                                 f"{all_idxs}. {info_str}")
        return out

    if isinstance(sets, list):
        out = {}
        for set_id in sets:
            if set_id not in valid_ids:
                raise ValueError(f"{set_str} set {set_id} not in allowed sets "
                                 f"{valid_ids}\n{info_str}")
            out[set_id] = np.arange(n_points(set_id))
        return out

    if isinstance(sets, str):
        if sets != "all":
            raise ValueError(f"String '{sets}' not understood. Only 'all' is "
                             "allowed to select every set")
        return {set_id: np.arange(n_points(set_id)) for set_id in valid_ids}

    raise ValueError(f"Unsupported tx/rx set specification: {sets!r}")
