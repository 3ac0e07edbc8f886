"""Sionna RT path conversion: pickled Paths dicts -> scenario matrices.

The Sionna export (see ``exporter.py`` beside this module) pickles a
list of path dicts with keys ``a`` (complex amplitudes,
[batch, n_rx, rx_ant, n_tx, tx_ant, paths, time]), ``tau``/angles/``types``
([batch, n_rx, n_tx, paths]), ``vertices`` ([depth, n_rx, n_tx, paths, 3]),
``sources``/``targets`` (positions). Conversion: |a| -> power dBW, angle(a)
-> phase, radians -> degrees, vertices -> interaction positions, Sionna
type enums -> DeepMIMO digit codes. Copied from
``deepmimo_tpu/converter/sionna/sionna_paths.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ... import consts as c
from .. import converter_utils as cu


def sionna_types_to_codes(types: np.ndarray,
                          inter_pos: np.ndarray) -> np.ndarray:
    """Map Sionna path-type enums to DeepMIMO interaction digit codes.

    Sionna reports one type per path: 0 LoS, 1 specular chain, 2 single
    diffraction, 3 scattering (possibly after reflections). The digit code
    expands the chain using the actual bounce count from ``inter_pos``.
    """
    types = np.atleast_1d(np.asarray(types))
    n_paths = len(types)
    out = np.zeros(n_paths, dtype=np.float32)

    if inter_pos.ndim == 2:
        inter_pos = inter_pos[None]
    n_bounces = (~np.isnan(inter_pos[..., 0])).sum(axis=1)

    for i in range(n_paths):
        t = types[i]
        if np.isnan(t):
            continue
        t = int(t)
        nb = int(n_bounces[i])
        if t == 0:
            out[i] = c.INTERACTION_LOS
        elif t == 1:
            out[i] = float("1" * nb) if nb else 0.0
        elif t == 2:
            out[i] = c.INTERACTION_DIFFRACTION
        elif t == 3:
            if nb == 0:
                continue
            out[i] = float("1" * (nb - 1) + "3")
        elif t == 4:
            raise NotImplementedError("RIS paths are not supported yet")
        else:
            raise ValueError(f"Unknown Sionna interaction type: {t}")
    return out


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


def _fill_batch(paths_dict: Dict, data: Dict, t: int, start_row: int) -> int:
    """Convert one batch's receivers for TX column ``t``; returns the number
    of receivers with zero paths."""
    a = np.asarray(paths_dict["a"])[0, :, 0, t, 0, :, 0]   # [n_rx, paths]
    tau = np.asarray(paths_dict["tau"])[0, :, t, :]
    phi_r = np.asarray(paths_dict["phi_r"])[0, :, t, :]
    theta_r = np.asarray(paths_dict["theta_r"])[0, :, t, :]
    phi_t = np.asarray(paths_dict["phi_t"])[0, :, t, :]
    theta_t = np.asarray(paths_dict["theta_t"])[0, :, t, :]
    types = np.asarray(paths_dict["types"])[0]
    vertices = np.asarray(paths_dict["vertices"])          # [depth,rx,tx,p,3]
    max_inter = min(c.MAX_INTER_PER_PATH, vertices.shape[0])

    n_rx = a.shape[0]
    inactive = 0
    for r in range(n_rx):
        row = start_row + r
        idxs = np.where(a[r] != 0)[0][:c.MAX_PATHS]
        n_p = len(idxs)
        if n_p == 0:
            inactive += 1
            continue
        amp = a[r, idxs]
        data[c.POWER_PARAM_NAME][row, :n_p] = 20 * np.log10(np.abs(amp))
        data[c.PHASE_PARAM_NAME][row, :n_p] = np.angle(amp, deg=True)
        data[c.DELAY_PARAM_NAME][row, :n_p] = tau[r, idxs]
        data[c.AOA_AZ_PARAM_NAME][row, :n_p] = np.rad2deg(phi_r[r, idxs])
        data[c.AOA_EL_PARAM_NAME][row, :n_p] = np.rad2deg(theta_r[r, idxs])
        data[c.AOD_AZ_PARAM_NAME][row, :n_p] = np.rad2deg(phi_t[r, idxs])
        data[c.AOD_EL_PARAM_NAME][row, :n_p] = np.rad2deg(theta_t[r, idxs])
        data[c.INTERACTIONS_POS_PARAM_NAME][row, :n_p, :max_inter] = \
            np.transpose(vertices[:max_inter, r, t, idxs, :], (1, 0, 2))
        data[c.INTERACTIONS_PARAM_NAME][row, :n_p] = sionna_types_to_codes(
            types[idxs], data[c.INTERACTIONS_POS_PARAM_NAME][row, :n_p])
    return inactive


def read_paths(load_folder: str, save_folder: str, txrx_dict: Dict) -> None:
    """Convert all TX-RX path data from sionna_paths.pkl to .mat matrices."""
    path_dicts: List[Dict] = cu.load_pickle(
        os.path.join(load_folder, "sionna_paths.pkl"))

    all_tx_pos = np.unique(
        np.vstack([np.asarray(d["sources"]) for d in path_dicts]), axis=0)
    n_tx = len(all_tx_pos)

    # A leading batch whose targets equal its sources holds BS-BS paths.
    bs_bs = bool(path_dicts) and np.array_equal(
        np.asarray(path_dicts[0]["sources"]),
        np.asarray(path_dicts[0]["targets"]))

    # The users are the targets of the other batches. (The JAX package
    # counts the BS-BS batch's targets too, which puts the BS position in
    # row 0 of the user set and every user's paths against the position
    # of the user before it.)
    user_dicts = path_dicts[1:] if bs_bs else path_dicts
    all_rx_pos = np.vstack([np.asarray(d["targets"]) for d in user_dicts]) \
        if user_dicts else np.zeros((0, 3))
    _, first_idx = np.unique(all_rx_pos, axis=0, return_index=True)
    rx_pos = all_rx_pos[np.sort(first_idx)]
    n_rx = len(rx_pos)

    inactive_rx = 0
    for tx_idx, tx_pos in enumerate(all_tx_pos):
        data = _empty_matrices(n_rx)
        data[c.RX_POS_PARAM_NAME] = rx_pos.astype(c.FP_TYPE)
        data[c.TX_POS_PARAM_NAME] = tx_pos.astype(c.FP_TYPE)

        row = 0
        for di, paths_dict in enumerate(path_dicts):
            if di == 0 and bs_bs:
                continue
            sources = np.asarray(paths_dict["sources"])
            hit = np.where(np.all(sources == tx_pos, axis=1))[0]
            if len(hit) == 0:
                continue
            t = int(hit[0])
            batch = np.asarray(paths_dict["a"]).shape[1]
            n_inactive = _fill_batch(paths_dict, data, t, row)
            if tx_idx == 0:
                inactive_rx += n_inactive
            row += batch

        data = cu.compress_path_data(data)
        for key, val in data.items():
            cu.save_mat(val, key, save_folder, 0, tx_idx, 1)

        if bs_bs:
            bs_dict = path_dicts[0]
            bs_pos = np.asarray(bs_dict["sources"])
            hit = np.where(np.all(bs_pos == tx_pos, axis=1))[0]
            data_bb = _empty_matrices(len(bs_pos))
            data_bb[c.RX_POS_PARAM_NAME] = bs_pos.astype(c.FP_TYPE)
            data_bb[c.TX_POS_PARAM_NAME] = tx_pos.astype(c.FP_TYPE)
            if len(hit):
                _fill_batch(bs_dict, data_bb, int(hit[0]), 0)
            data_bb = cu.compress_path_data(data_bb)
            for key, val in data_bb.items():
                cu.save_mat(val, key, save_folder, 0, tx_idx, 0)

    if bs_bs:
        txrx_dict["txrx_set_0"][c.TXRX_PARAM_IS_RX] = True

    txrx_dict["txrx_set_0"][c.TXRX_PARAM_NUM_POINTS] = n_tx
    txrx_dict["txrx_set_0"][c.TXRX_PARAM_NUM_ACTIVE_POINTS] = n_tx
    txrx_dict["txrx_set_1"][c.TXRX_PARAM_NUM_POINTS] = n_rx
    txrx_dict["txrx_set_1"][c.TXRX_PARAM_NUM_ACTIVE_POINTS] = \
        n_rx - inactive_rx
