"""Export scenarios to the legacy v3 MATLAB format.

Writes ``params.mat`` + chunked ``BS{i}_UE_{start}-{end}.mat`` files in the
canonical published-v3 layout: each chunk holds a ``channels`` cell array
whose elements are structs with field ``p`` = the per-user path matrix of
rows [phase(deg); ToA(s); power(dBm); DoA az; DoA el; DoD az; DoD el; LoS
(; dop_vel; dop_acc)], plus ``rx_locs`` [n x 5] (x, y, z, distance,
pathloss) and ``tx_loc``; ``BS{i}_BS.mat`` and ``UE_locations.mat`` beside
them.

Dual-polarization: when the dataset carries per-polarization matrices
(``power_vv``/``phase_vv``, ...), four ``channels_VV/VH/HH/HV`` blocks are
written (shared delays/angles, per-polarization power/phase) and
``dual_polar_available`` is set.

Host code, copied from ``deepmimo_tpu.integrations.matlab_export``; the
inverse of ``converter.legacy_v3``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.io

from .. import consts as c

CHUNK = 10_000  # users per BS{i}_UE file

POLS = ("VV", "VH", "HH", "HV")


def _path_matrix(u, valid, phase, delay, power, aoa_az, aoa_el, aod_az,
                 aod_el, inter, dop_v, dop_a, tx_power_dbm):
    """One user's [rows x n_valid] v3 path matrix."""
    nv = int(valid.sum())
    rows = 10 if dop_v is not None else 8
    mat = np.zeros((rows, nv), dtype=np.float64)
    v = np.where(valid)[0][:nv]
    mat[0] = phase[u, v]
    mat[1] = delay[u, v]
    # dBW -> v3 dBm convention (inverse of the legacy_v3 loader:
    # dBW = p_dbm - tx_power)
    mat[2] = power[u, v] + tx_power_dbm
    mat[3] = aoa_az[u, v]
    mat[4] = aoa_el[u, v]
    mat[5] = aod_az[u, v]
    mat[6] = aod_el[u, v]
    mat[7] = (inter[u, v] == c.INTERACTION_LOS).astype(float)
    if dop_v is not None:
        mat[8] = dop_v[u, v]
        mat[9] = dop_a[u, v]
    return mat


def export_matlab(dataset, out_folder: str, tx_power_dbm: float = 0.0,
                  carrier_freq: Optional[float] = None,
                  chunk: int = CHUNK) -> str:
    """Export a Dataset (or MacroDataset) to the v3 MATLAB scenario layout.

    Args:
        dataset: loaded Dataset/MacroDataset.
        out_folder: destination folder (created).
        tx_power_dbm: transmit power reference for the dBm re-referencing.
        carrier_freq: carrier frequency (defaults to rt_params frequency).

    Returns:
        The output folder path.
    """
    from ..generator.dataset import MacroDataset

    datasets = dataset.datasets if isinstance(dataset, MacroDataset) \
        else [dataset]
    os.makedirs(out_folder, exist_ok=True)

    rt_params = datasets[0].get(c.RT_PARAMS_PARAM_NAME) or {}
    if carrier_freq is None:
        carrier_freq = float(rt_params.get(c.RT_PARAM_FREQUENCY, 3.5e9))

    has_doppler = c.DOPPLER_VEL_PARAM_NAME in datasets[0].keys()
    has_dual_polar = all(f"power_{p.lower()}" in datasets[0].keys() and
                         f"phase_{p.lower()}" in datasets[0].keys()
                         for p in POLS)
    n_ue = datasets[0].n_ue

    scipy.io.savemat(os.path.join(out_folder, "params.mat"), {
        "carrier_freq": carrier_freq,
        "transmit_power": tx_power_dbm,
        "num_BS": len(datasets),
        "user_grids": np.array([[1, n_ue, 1]], dtype=np.int64),
        "doppler_available": int(has_doppler),
        "dual_polar_available": int(has_dual_polar),
    })

    bs_locs = []
    for ds in datasets:
        bs_locs.append(np.asarray(ds[c.TX_POS_PARAM_NAME],
                                  dtype=np.float64).reshape(-1)[:3])

    for bs_i, ds in enumerate(datasets, start=1):
        f64 = lambda key: np.asarray(ds[key], dtype=np.float64)
        power = f64(c.POWER_PARAM_NAME)
        base = dict(
            phase=f64(c.PHASE_PARAM_NAME), delay=f64(c.DELAY_PARAM_NAME),
            power=power,
            aoa_az=f64(c.AOA_AZ_PARAM_NAME), aoa_el=f64(c.AOA_EL_PARAM_NAME),
            aod_az=f64(c.AOD_AZ_PARAM_NAME), aod_el=f64(c.AOD_EL_PARAM_NAME),
            inter=f64(c.INTERACTIONS_PARAM_NAME),
            dop_v=f64(c.DOPPLER_VEL_PARAM_NAME) if has_doppler else None,
            dop_a=f64(c.DOPPLER_ACC_PARAM_NAME) if has_doppler else None)

        # Per-polarization power/phase blocks share everything else.
        blocks = {"channels": base}
        if has_dual_polar:
            blocks = {}
            for pol in POLS:
                b = dict(base)
                b["power"] = f64(f"power_{pol.lower()}")
                b["phase"] = f64(f"phase_{pol.lower()}")
                blocks[f"channels_{pol}"] = b

        rx_pos = np.asarray(ds[c.RX_POS_PARAM_NAME], dtype=np.float64)
        tx_loc = bs_locs[bs_i - 1]
        dist = np.linalg.norm(rx_pos - tx_loc[None, :], axis=1)
        # v3 rx_locs column 4 = pathloss (dB); incoherent sum of linear
        # path powers re-referenced to the recorded transmit power.
        # Inactive users (no paths) use the InSite convention of 250 dB
        # (reference deepmimo/converter/wireless_insite/insite_paths.py:47).
        lin = np.nansum(10.0 ** (power / 10.0), axis=1)
        with np.errstate(divide="ignore"):
            pathloss = np.where(lin > 0, -10.0 * np.log10(lin), 250.0)
        rx_locs_full = np.concatenate(
            [rx_pos, dist[:, None], pathloss[:, None]], axis=1)

        n = power.shape[0]
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            payload = {"rx_locs": rx_locs_full[start:end],
                       "tx_loc": tx_loc}
            for key, b in blocks.items():
                cells = np.empty((1, end - start), dtype=object)
                for u in range(start, end):
                    valid = ~np.isnan(b["power"][u])
                    cells[0, u - start] = {
                        "p": _path_matrix(u, valid, tx_power_dbm=tx_power_dbm,
                                          **b)}
                payload[key] = cells
            fname = f"BS{bs_i}_UE_{start}-{end}.mat"
            scipy.io.savemat(os.path.join(out_folder, fname), payload)

        # BS location file; rx_locs rows make the upstream tx_loc
        # fallback (raytracing_v3.py:169-171) work.
        scipy.io.savemat(
            os.path.join(out_folder, f"BS{bs_i}_BS.mat"),
            {"BS_loc": tx_loc.reshape(1, 3),
             "rx_locs": np.concatenate(
                 [np.stack(bs_locs),
                  np.zeros((len(bs_locs), 2))], axis=1)})

    # RX locations
    rx_pos = np.asarray(datasets[0][c.RX_POS_PARAM_NAME], dtype=np.float64)
    scipy.io.savemat(os.path.join(out_folder, "UE_locations.mat"),
                     {"UE_loc": rx_pos})
    return out_folder
