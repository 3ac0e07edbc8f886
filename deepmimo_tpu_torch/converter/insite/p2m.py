"""Parsers for Wireless InSite .p2m output files (paths + pathloss).

File-format notes (from the InSite output spec; copied from
``deepmimo_tpu/converter/insite/p2m.py``):

``*.paths.p2m``: 21 header lines, then a line with the receiver count.
Per receiver: a ``<rx_idx> <n_paths>`` line; if n_paths > 0 an extra
summary line follows, then per path: a 9-field data line
(path#, n_interactions, power dBm, phase deg, ToA s, AoA-el, AoA-az,
AoD-el, AoD-az), an interaction-type line (``Tx-R-D-Rx``), the TX
position line, one line per interaction position, and the RX position
line.

``*.pl.p2m``: '#' comment lines, then per receiver:
``idx x y z distance pathloss``; inactive receivers carry 250 dB.

A native C++ fast parser is used when available (see
``deepmimo_tpu_torch/native``, built with g++ at first use); this
pure-Python implementation is the reference and fallback.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ... import consts as c
from ..converter_utils import compress_path_data

HEADER_LINES = 21  # info lines before the receiver-count line

# InSite interaction letters -> DeepMIMO digit codes
INTERACTIONS_MAP = {
    "R": c.INTERACTION_REFLECTION,
    "D": c.INTERACTION_DIFFRACTION,
    "DS": c.INTERACTION_SCATTERING,
    "T": c.INTERACTION_TRANSMISSION,
    "F": c.INTERACTION_TRANSMISSION,   # foliage transmission
    "X": c.INTERACTION_TRANSMISSION,
}


def _try_native():
    try:
        from ...native import p2m_native
        return p2m_native if p2m_native.available() else None
    except Exception:
        return None


def parse_paths_p2m(path: str, max_paths: int = c.MAX_PATHS,
                    max_inter: int = c.MAX_INTER_PER_PATH,
                    use_native: bool = True) -> Dict[str, np.ndarray]:
    """Parse a .paths.p2m file into the NaN-padded scenario matrices.

    Returns the 9 per-path matrices (powers re-referenced dBm->dBW is a
    no-op: both assume 0 dB transmit power, so relative values coincide).
    """
    native = _try_native() if use_native else None
    if native is not None:
        out = native.parse_paths(path, max_paths, max_inter)
        if out is not None:
            return compress_path_data(out)

    with open(path, "r") as f:
        lines = f.readlines()

    n_rxs = int(lines[HEADER_LINES])

    shape = (n_rxs, max_paths)
    data = {
        key: np.full(shape, np.nan, dtype=np.float32)
        for key in (c.AOA_AZ_PARAM_NAME, c.AOA_EL_PARAM_NAME,
                    c.AOD_AZ_PARAM_NAME, c.AOD_EL_PARAM_NAME,
                    c.DELAY_PARAM_NAME, c.POWER_PARAM_NAME,
                    c.PHASE_PARAM_NAME, c.INTERACTIONS_PARAM_NAME)
    }
    data[c.INTERACTIONS_POS_PARAM_NAME] = np.full(
        (n_rxs, max_paths, max_inter, 3), np.nan, dtype=np.float32)

    idx = HEADER_LINES + 1
    for rx_i in range(n_rxs):
        n_paths = int(lines[idx].split()[1])
        if n_paths == 0:
            idx += 1
            continue
        idx += 2  # skip rx header + per-rx summary line
        for p in range(n_paths):
            if p < max_paths:
                f = lines[idx].split()
                n_inter = int(f[1])
                data[c.POWER_PARAM_NAME][rx_i, p] = float(f[2])
                data[c.PHASE_PARAM_NAME][rx_i, p] = float(f[3])
                data[c.DELAY_PARAM_NAME][rx_i, p] = float(f[4])
                data[c.AOA_EL_PARAM_NAME][rx_i, p] = float(f[5])
                data[c.AOA_AZ_PARAM_NAME][rx_i, p] = float(f[6])
                data[c.AOD_EL_PARAM_NAME][rx_i, p] = float(f[7])
                data[c.AOD_AZ_PARAM_NAME][rx_i, p] = float(f[8])

                letters = lines[idx + 1].strip().split("-")[1:-1]
                code = "".join(str(INTERACTIONS_MAP[s]) for s in letters)
                data[c.INTERACTIONS_PARAM_NAME][rx_i, p] = \
                    float(code) if code else 0.0

                for b in range(min(n_inter, max_inter)):
                    xyz = lines[idx + 3 + b].split()
                    data[c.INTERACTIONS_POS_PARAM_NAME][rx_i, p, b] = \
                        [float(v) for v in xyz]
            else:
                n_inter = int(lines[idx].split()[1])
            idx += 4 + n_inter
    return compress_path_data(data)


def extract_tx_pos(path: str) -> Optional[np.ndarray]:
    """TX position from the first receiver with paths in a .paths.p2m file.

    The TX position line follows the first path's data + type lines.
    """
    with open(path, "r") as f:
        lines = f.readlines()
    n_rxs = int(lines[HEADER_LINES])
    idx = HEADER_LINES + 1
    for _ in range(n_rxs):
        n_paths = int(lines[idx].split()[1])
        if n_paths == 0:
            idx += 1
            continue
        # rx header -> summary -> data -> type -> TX position
        tx_line = lines[idx + 4]
        return np.array([float(v) for v in tx_line.split()],
                        dtype=np.float32)
    return None


def tx_pos_from_swapped_pl(paths_file: str) -> Optional[np.ndarray]:
    """Fallback: find the TX position via the swapped-index .pl file.

    When no receiver has paths, the TX position can be recovered from the
    pathloss file of the reciprocal link (tx and rx indices swapped in the
    filename): '<proj>.paths.tAAA_BB.rCCC.p2m' with AAA<->CCC swapped.
    """
    base = os.path.basename(paths_file)
    m = base.rsplit(".", 3)
    try:
        proj_and_kind, t_part, r_part, ext = m
        t_prefix, t_set = t_part.split("_")       # 't001', '01'
        r_num = r_part[1:]                        # '014'
        t_num = t_prefix[1:]                      # '001'
        swapped = (f"{proj_and_kind}.t{r_num[-len(t_num):].zfill(3)}_"
                   f"{t_set}.r{t_num.zfill(3)}.{ext}")
        pl_file = os.path.join(os.path.dirname(paths_file),
                               swapped.replace(".paths.", ".pl."))
        xyz, _, _ = parse_pl_p2m(pl_file)
        return xyz[0] if len(xyz) else None
    except Exception:
        return None


def parse_pl_p2m(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a .pl.p2m file -> (positions [N,3], distance [N,1], PL [N,1])."""
    xyz, dist, pl = [], [], []
    with open(path, "r") as f:
        for line in f:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            vals = line.split()
            xyz.append([float(vals[1]), float(vals[2]), float(vals[3])])
            dist.append([float(vals[4])])
            pl.append([float(vals[5])])
    return (np.asarray(xyz, dtype=np.float32),
            np.asarray(dist, dtype=np.float32),
            np.asarray(pl, dtype=np.float32))
