"""Legacy v3 scenario loader: params.mat + BS{i}_UE chunks -> Dataset.

Many published DeepMIMO scenarios ship in the previous-generation format
(``<name>.params.mat`` or ``params.mat`` plus chunked
``BS{i}_UE_{start}-{end}.mat`` files of per-user path matrices with rows
[phase(deg); ToA(s); power(dBm); DoA az; DoA el; DoD az; DoD el; LoS
(; dop_vel; dop_acc)]). Chunk files hold a ``channels`` cell array of
structs with field ``p``, plus ``rx_locs`` [n x 5] and ``tx_loc``;
bare-matrix cells from older exports are also accepted.

Dual-polarization scenarios store four blocks ``channels_VV/VH/HH/HV``;
these are extracted into ``power_vv``/``phase_vv``/... matrices (shared
delays/angles from the VV block) so ``compute_channels(enable_dual_polar=1)``
works directly from disk; block ``channels_XX`` holds polarization XX for
every user. Several BS load into a :class:`MacroDataset`.

Host code, copied from ``deepmimo_tpu.converter.legacy_v3``; the inverse
of ``integrations.matlab_export``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

import numpy as np
import scipy.io

from .. import consts as c

POLS = ("VV", "VH", "HH", "HV")


def is_v3_scenario(folder: str) -> bool:
    """Does this folder hold a v3-format scenario?"""
    has_params = bool(glob.glob(os.path.join(folder, "*params.mat")))
    has_chunks = bool(glob.glob(os.path.join(folder, "BS*_UE_*.mat")))
    return has_params and has_chunks


def _load_params(folder: str) -> Dict:
    candidates = glob.glob(os.path.join(folder, "*params.mat"))
    if not candidates:
        raise FileNotFoundError(f"No params.mat in {folder}")
    data = scipy.io.loadmat(candidates[0])

    def item(key, default=None, cast=float):
        if key not in data:
            return default
        return cast(np.asarray(data[key]).ravel()[0])

    return {
        "carrier_freq": item("carrier_freq", 3.5e9),
        "transmit_power": item("transmit_power", 0.0),
        "num_bs": item("num_BS", 1, int),
        "doppler_available": item("doppler_available", 0, int),
        "dual_polar_available": item("dual_polar_available", 0, int),
        "user_grids": np.asarray(data.get("user_grids", [[1, 1, 1]]),
                                 dtype=np.int64),
    }


def _chunk_files(folder: str, bs_id: int) -> List[tuple]:
    files = []
    pattern = re.compile(rf"BS{bs_id}_UE_(\d+)-(\d+)\.mat$")
    for path in glob.glob(os.path.join(folder, f"BS{bs_id}_UE_*.mat")):
        m = pattern.search(os.path.basename(path))
        if m:
            files.append((int(m.group(1)), int(m.group(2)), path))
    return sorted(files)


def _unwrap(entry) -> np.ndarray:
    """Peel cell/struct nesting down to the 2D [rows x paths] matrix."""
    mat = np.asarray(entry)
    while True:
        if mat.dtype.names:           # MATLAB struct: take field 'p'
            name = "p" if "p" in mat.dtype.names else mat.dtype.names[0]
            mat = np.asarray(mat[name]).ravel()
            mat = np.asarray(mat[0]) if mat.dtype == object and mat.size \
                else mat
        elif mat.dtype == object:     # nested cell
            if mat.size == 0:
                return np.zeros((0, 0))
            mat = np.asarray(mat.ravel()[0])
        elif isinstance(mat.ravel()[0] if mat.size else None, np.void):
            mat = np.asarray(mat.ravel()[0])
        else:
            return np.asarray(mat, dtype=np.float64)


def _extract_cells(file_data: Dict, key: str = "channels") -> List:
    """Per-user path matrices from a chunk file (handles cell/struct
    layouts)."""
    arr = np.asarray(file_data[key], dtype=object)
    return [_unwrap(entry) for entry in arr.ravel()]


def load_v3_scenario(folder: str, max_paths: int = c.MAX_PATHS,
                     bs_ids: Optional[List[int]] = None,
                     tx_power_dbm: Optional[float] = None):
    """Load a v3-format scenario folder into Dataset/MacroDataset.

    Power re-referencing: v3 stores received power in dBm relative to the
    recorded transmit power; the standardized convention is dBW at 0 dBW
    transmit: power_dbw = power_dbm - tx_power (matching v3's
    dbm2watt(p + 30 - tx_pow) linear value, reference raytracing_v3.py:80).

    Dual-polar scenarios additionally get ``power_vv``/``phase_vv``/...
    matrices per polarization; the base ``power``/``phase`` come from the
    VV block (matching upstream's enable_dual_polar=0 read,
    raytracing_v3.py:136).
    """
    from ..generator.dataset import Dataset, MacroDataset

    params = _load_params(folder)
    tx_pow = params["transmit_power"] if tx_power_dbm is None \
        else tx_power_dbm
    if bs_ids is None:
        bs_ids = list(range(1, params["num_bs"] + 1))
    dual_polar = bool(params["dual_polar_available"])
    has_dop = params["doppler_available"]

    # RX positions if exported separately (else taken from chunk rx_locs)
    rx_pos = None
    ue_loc_file = os.path.join(folder, "UE_locations.mat")
    if os.path.exists(ue_loc_file):
        rx_pos = np.asarray(scipy.io.loadmat(ue_loc_file)["UE_loc"],
                            dtype=np.float32)

    datasets = []
    for bs_id in bs_ids:
        chunks = _chunk_files(folder, bs_id)
        if not chunks:
            raise FileNotFoundError(f"No BS{bs_id}_UE_*.mat chunks in "
                                    f"{folder}")
        # blocks: key -> list of per-user matrices; base block first.
        block_keys = [f"channels_{p}" for p in POLS] if dual_polar \
            else ["channels"]
        users: Dict[str, List[np.ndarray]] = {k: [] for k in block_keys}
        rx_locs_rows: List[np.ndarray] = []
        tx_loc_file = None
        for _, _, path in chunks:
            file_data = scipy.io.loadmat(path)
            for k in block_keys:
                users[k].extend(_extract_cells(file_data, k))
            if "rx_locs" in file_data:
                rx_locs_rows.append(np.asarray(file_data["rx_locs"],
                                               dtype=np.float64))
            if "tx_loc" in file_data:
                tx_loc_file = np.asarray(file_data["tx_loc"],
                                         dtype=np.float64).reshape(-1)[:3]
        base_key = block_keys[0]
        n_ue = len(users[base_key])

        nan = lambda: np.full((n_ue, max_paths), np.nan, dtype=np.float32)
        mats = {key: nan() for key in (
            c.PHASE_PARAM_NAME, c.DELAY_PARAM_NAME, c.POWER_PARAM_NAME,
            c.AOA_AZ_PARAM_NAME, c.AOA_EL_PARAM_NAME,
            c.AOD_AZ_PARAM_NAME, c.AOD_EL_PARAM_NAME,
            c.INTERACTIONS_PARAM_NAME)}
        if has_dop:
            mats[c.DOPPLER_VEL_PARAM_NAME] = nan()
            mats[c.DOPPLER_ACC_PARAM_NAME] = nan()
        if dual_polar:
            for pol in POLS:
                mats[f"power_{pol.lower()}"] = nan()
                mats[f"phase_{pol.lower()}"] = nan()

        for u, mat in enumerate(users[base_key]):
            if mat.size == 0 or mat.ndim != 2:
                continue
            n_p = min(mat.shape[1], max_paths)
            if n_p == 0:
                continue
            mats[c.PHASE_PARAM_NAME][u, :n_p] = mat[0, :n_p]
            mats[c.DELAY_PARAM_NAME][u, :n_p] = mat[1, :n_p]
            # v3 parity: linear power = dbm2watt(p + 30 - tx_pow)
            # = 10^((p - tx_pow)/10) W, i.e. dBW = p_dbm - tx_power
            mats[c.POWER_PARAM_NAME][u, :n_p] = mat[2, :n_p] - tx_pow
            mats[c.AOA_AZ_PARAM_NAME][u, :n_p] = mat[3, :n_p]
            mats[c.AOA_EL_PARAM_NAME][u, :n_p] = mat[4, :n_p]
            mats[c.AOD_AZ_PARAM_NAME][u, :n_p] = mat[5, :n_p]
            mats[c.AOD_EL_PARAM_NAME][u, :n_p] = mat[6, :n_p]
            if mat.shape[0] > 7:
                # LoS flag -> interaction code (0 = LoS, else unknown = 1)
                mats[c.INTERACTIONS_PARAM_NAME][u, :n_p] = \
                    np.where(mat[7, :n_p] > 0, 0.0, 1.0)
            if has_dop and mat.shape[0] > 9:
                mats[c.DOPPLER_VEL_PARAM_NAME][u, :n_p] = mat[8, :n_p]
                mats[c.DOPPLER_ACC_PARAM_NAME][u, :n_p] = mat[9, :n_p]

        if dual_polar:
            for pol in POLS:
                pkey, fkey = f"power_{pol.lower()}", f"phase_{pol.lower()}"
                for u, mat in enumerate(users[f"channels_{pol}"]):
                    if mat.size == 0 or mat.ndim != 2:
                        continue
                    n_p = min(mat.shape[1], max_paths)
                    if n_p == 0:
                        continue
                    mats[fkey][u, :n_p] = mat[0, :n_p]
                    mats[pkey][u, :n_p] = mat[2, :n_p] - tx_pow

        tx_pos = np.zeros((1, 3), dtype=np.float32)
        if tx_loc_file is not None:
            tx_pos = tx_loc_file.astype(np.float32).reshape(1, 3)
        else:
            bs_file = os.path.join(folder, f"BS{bs_id}_BS.mat")
            if os.path.exists(bs_file):
                bs_data = scipy.io.loadmat(bs_file)
                for key in ("BS_loc", "BS_location", "loc"):
                    if key in bs_data:
                        tx_pos = np.asarray(bs_data[key],
                                            dtype=np.float32).reshape(1, 3)
                        break

        d = Dataset(dict(mats))
        if rx_pos is not None:
            d[c.RX_POS_PARAM_NAME] = rx_pos
        elif rx_locs_rows:
            d[c.RX_POS_PARAM_NAME] = np.concatenate(
                rx_locs_rows, axis=0)[:, :3].astype(np.float32)
        else:
            d[c.RX_POS_PARAM_NAME] = np.zeros((n_ue, 3), dtype=np.float32)
        d[c.TX_POS_PARAM_NAME] = tx_pos
        d[c.RT_PARAMS_PARAM_NAME] = {
            c.RT_PARAM_FREQUENCY: params["carrier_freq"],
            c.RT_PARAM_RAYTRACER: "legacy-v3",
            c.RT_PARAM_RAYTRACER_VERSION: "3.x",
        }
        d["txrx"] = {"tx_set_id": 0, "rx_set_id": 1, "tx_idx": bs_id - 1}
        datasets.append(d)

    if len(datasets) == 1:
        return datasets[0]
    return MacroDataset(datasets)
