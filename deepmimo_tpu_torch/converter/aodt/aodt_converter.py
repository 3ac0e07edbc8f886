"""AODT (NVIDIA Aerial Omniverse Digital Twin) -> DeepMIMO scenario.

A minimal converter for the AODT parquet export layout, copied from
``deepmimo_tpu/converter/aodt/aodt_converter.py`` — the database tables AODT
writes per simulation, exported to parquet files in one folder (the
``.aodt`` marker file carries the scenario name):

- ``raypaths.parquet`` — one row per (time_idx, ru_id, ue_id, path_id)
  with ``points`` (flattened [n_vertices x 3] world coordinates of the
  ray polyline, TX end first), ``interaction_types`` (list of per-vertex
  interaction codes: 0 emission, 1 reflection, 2 diffraction,
  3 scattering, 4 transmission, 5 reception).
- ``cirs.parquet`` — one row per path: ``cir_re``/``cir_im`` (complex
  channel amplitude at the carrier) and ``cir_delay`` (s).
- ``rus.parquet`` / ``ues.parquet`` — radio-unit and UE positions
  (``id``, ``x``, ``y``, ``z``).
- ``scenario.parquet`` — one row of scenario settings (at least
  ``carrier_frequency`` in Hz).

Departure/arrival angles are derived from the first/last polyline
segments (AODT stores geometry, not angles); powers are ``20 log10 |a|``
dBW at 0 dBW transmit, phases ``angle(a)`` in degrees — the same
amplitude convention as the Sionna converter (sionna_paths.py).
Only time_idx 0 is converted (static snapshot), matching the
single-scene scenario format.

pandas and pyarrow are imported inside ``_read_parquet`` only, so the
package imports without them and ``convert`` of an AODT folder raises
ImportError where they are missing.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import numpy as np

from ... import consts as c
from ...config import config
from ...rt_params import RayTracingParameters
from ...txrx import TxRxSet
from .. import converter_utils as cu

TABLES = ("raypaths", "cirs", "rus", "ues")


def _read_parquet(folder: str, name: str):
    try:
        import pandas as pd
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "AODT conversion needs pandas+pyarrow to read the parquet "
            "export tables") from e
    path = os.path.join(folder, f"{name}.parquet")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"AODT export table missing: {path} (expected tables: "
            f"{', '.join(TABLES)})")
    return pd.read_parquet(path)


def _angles_deg(vec: np.ndarray):
    """(azimuth, elevation-from-z) of a direction vector, degrees."""
    r = np.linalg.norm(vec)
    if r == 0:
        return 0.0, 90.0
    az = np.degrees(np.arctan2(vec[1], vec[0]))
    el = np.degrees(np.arccos(np.clip(vec[2] / r, -1.0, 1.0)))
    return az, el


def _empty_matrices(n_rx: int) -> Dict[str, np.ndarray]:
    nanmat = lambda *shape: np.full(shape, np.nan, dtype=c.FP_TYPE)
    return {
        c.RX_POS_PARAM_NAME: np.zeros((n_rx, 3), dtype=c.FP_TYPE),
        c.TX_POS_PARAM_NAME: np.zeros((1, 3), dtype=c.FP_TYPE),
        c.AOA_AZ_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.AOA_EL_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.AOD_AZ_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.AOD_EL_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.DELAY_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.POWER_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.PHASE_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.INTERACTIONS_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS),
        c.INTERACTIONS_POS_PARAM_NAME: nanmat(n_rx, c.MAX_PATHS,
                                              c.MAX_INTER_PER_PATH, 3),
    }


def _interaction_code(types) -> float:
    """AODT per-vertex interaction list -> DeepMIMO digit code.

    Emission (0) / reception (5) bracket the bounce vertices; a direct
    emission->reception path is LoS (code 0). Bounce digits keep the
    shared convention: 1 reflection, 2 diffraction, 3 scattering,
    4 transmission (consts.py INTERACTION_*).
    """
    bounces = [int(t) for t in types if int(t) not in (0, 5)]
    if not bounces:
        return float(c.INTERACTION_LOS)
    return float(int("".join(str(b) for b in bounces)))


def read_paths(rt_folder: str, save_folder: str) -> Dict[int, np.ndarray]:
    """Convert raypaths+cirs tables into per-RU matrix files.

    Returns {ru_id: ru_pos} for the txrx metadata.
    """
    rays = _read_parquet(rt_folder, "raypaths")
    cirs = _read_parquet(rt_folder, "cirs")
    rus = _read_parquet(rt_folder, "rus")
    ues = _read_parquet(rt_folder, "ues")

    if "time_idx" in rays.columns:
        rays = rays[rays["time_idx"] == rays["time_idx"].min()]
    if "time_idx" in cirs.columns:
        cirs = cirs[cirs["time_idx"] == cirs["time_idx"].min()]

    ue_ids = sorted(int(i) for i in ues["id"].tolist())
    ue_row = {uid: i for i, uid in enumerate(ue_ids)}
    ue_pos = np.asarray(ues.sort_values("id")[["x", "y", "z"]],
                        dtype=np.float64)
    ru_pos = {int(r["id"]): np.array([r["x"], r["y"], r["z"]],
                                     dtype=np.float64)
              for _, r in rus.iterrows()}

    cir_key = cirs.set_index(["ru_id", "ue_id", "path_id"])

    for tx_idx, (ru_id, tx_pos) in enumerate(sorted(ru_pos.items())):
        data = _empty_matrices(len(ue_ids))
        data[c.RX_POS_PARAM_NAME] = ue_pos.astype(c.FP_TYPE)
        data[c.TX_POS_PARAM_NAME] = tx_pos.reshape(1, 3).astype(c.FP_TYPE)
        n_paths = np.zeros(len(ue_ids), dtype=int)

        sub = rays[rays["ru_id"] == ru_id]
        for _, row in sub.iterrows():
            u = ue_row.get(int(row["ue_id"]))
            if u is None:
                continue
            p_i = n_paths[u]
            if p_i >= c.MAX_PATHS:
                continue
            pts = np.asarray(row["points"], dtype=np.float64).reshape(-1, 3)
            if len(pts) < 2:
                continue
            try:
                cir = cir_key.loc[(ru_id, int(row["ue_id"]),
                                   int(row["path_id"]))]
            except KeyError:
                continue
            a = complex(float(cir["cir_re"]), float(cir["cir_im"]))
            if a == 0:
                continue
            aod_az, aod_el = _angles_deg(pts[1] - pts[0])
            aoa_az, aoa_el = _angles_deg(pts[-2] - pts[-1])
            data[c.POWER_PARAM_NAME][u, p_i] = 20 * np.log10(abs(a))
            data[c.PHASE_PARAM_NAME][u, p_i] = np.degrees(np.angle(a))
            data[c.DELAY_PARAM_NAME][u, p_i] = float(cir["cir_delay"])
            data[c.AOD_AZ_PARAM_NAME][u, p_i] = aod_az
            data[c.AOD_EL_PARAM_NAME][u, p_i] = aod_el
            data[c.AOA_AZ_PARAM_NAME][u, p_i] = aoa_az
            data[c.AOA_EL_PARAM_NAME][u, p_i] = aoa_el
            types = np.asarray(row.get("interaction_types", []), dtype=int) \
                if "interaction_types" in row else np.array([0, 5])
            data[c.INTERACTIONS_PARAM_NAME][u, p_i] = _interaction_code(
                types)
            inter = pts[1:-1][:c.MAX_INTER_PER_PATH]
            if len(inter):
                data[c.INTERACTIONS_POS_PARAM_NAME][
                    u, p_i, :len(inter)] = inter
            n_paths[u] += 1

        data = cu.compress_path_data(data)
        for key, val in data.items():
            cu.save_mat(val, key, save_folder, 0, tx_idx, 1)
    return ru_pos


def read_rt_params(rt_folder: str) -> Dict:
    try:
        scen = _read_parquet(rt_folder, "scenario")
        raw = {k: scen.iloc[0][k] for k in scen.columns}
    except FileNotFoundError:
        raw = {}
    params = {
        "raytracer_name": c.RAYTRACER_NAME_AODT,
        "raytracer_version": str(raw.get("version",
                                         config.get("aodt_version"))),
        "frequency": float(raw.get("carrier_frequency", 3.5e9)),
        "max_path_depth": int(raw.get("max_depth", 3)),
        "max_reflections": int(raw.get("max_depth", 3)),
        "max_diffractions": int(bool(raw.get("diffraction", True))),
        "max_scattering": int(bool(raw.get("scattering", False))),
        "max_transmissions": int(bool(raw.get("transmission", False))),
        "raw_params": {k: (v.item() if hasattr(v, "item") else v)
                       for k, v in raw.items()},
    }
    return RayTracingParameters.from_dict(params).to_dict()


def read_txrx(n_ru: int, n_ue: int) -> Dict:
    tx = TxRxSet(name="rus", id_orig=0, id=0, is_tx=True, is_rx=False,
                 num_ant=1)
    rx = TxRxSet(name="ues", id_orig=1, id=1, is_tx=False, is_rx=True,
                 num_ant=1)
    d = {"txrx_set_0": tx.to_dict(), "txrx_set_1": rx.to_dict()}
    d["txrx_set_0"][c.TXRX_PARAM_NUM_POINTS] = n_ru
    d["txrx_set_0"][c.TXRX_PARAM_NUM_ACTIVE_POINTS] = n_ru
    d["txrx_set_1"][c.TXRX_PARAM_NUM_POINTS] = n_ue
    d["txrx_set_1"][c.TXRX_PARAM_NUM_ACTIVE_POINTS] = n_ue
    return d


def aodt_rt_converter(rt_folder: str, overwrite: Optional[bool] = None,
                      scenario_name: str = "",
                      print_params: bool = False, **_) -> str:
    """Convert an AODT parquet export folder to a DeepMIMO scenario."""
    print("converting from aodt")
    scen_name = scenario_name or os.path.basename(rt_folder.rstrip("/"))
    output_folder = os.path.join(rt_folder, scen_name + "_deepmimo")
    if os.path.exists(output_folder):
        shutil.rmtree(output_folder)
    os.makedirs(output_folder)

    rt_params = read_rt_params(rt_folder)
    ru_pos = read_paths(rt_folder, output_folder)
    n_ue = len(_read_parquet(rt_folder, "ues"))
    txrx_dict = read_txrx(len(ru_pos), n_ue)

    params = {
        c.VERSION_PARAM_NAME: c.VERSION,
        c.RT_PARAMS_PARAM_NAME: rt_params,
        c.TXRX_PARAM_NAME: txrx_dict,
        c.MATERIALS_PARAM_NAME: {},
        c.SCENE_PARAM_NAME: {c.SCENE_PARAM_NUMBER_SCENES: 1},
    }
    cu.save_params(params, output_folder)
    if print_params:
        from pprint import pprint
        pprint(params)
    return cu.save_scenario(output_folder, scen_name=scen_name,
                            overwrite=overwrite)
