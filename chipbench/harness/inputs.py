"""Inputs made from the seed: NaN-padded path matrices and a codebook.

The recipe is the headline's synthetic site (``chip_smoke.make_data`` and
``chip_smoke.codebook``, frozen here): per user a number of valid paths
drawn from the mix's ``valid_paths`` range (uniformly, or with the
weights ``valid_paths_weights`` gives each count from the lowest up), and
each field that the mix's ``ranges`` names (power, phase, delay and
angles; any other per-path field of a dataset likewise) uniform in its
range, in the order the mix lists them, the rest NaN as a converted
scenario pads them. The same seed gives the same arrays, which both the program and
the reference are handed.
"""

from __future__ import annotations

import numpy as np

PATH_FIELDS = ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
               "aod_el")
STREAM_PATHS, STREAM_CODEBOOK = 0, 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one input stream of a seed (any whole number)."""
    return np.random.default_rng([seed % 2**64, stream])


def path_matrices(n_users: int, max_paths: int, seed: int,
                  mix: dict) -> dict:
    """float32 [n_users, max_paths] matrices, NaN past each user's paths,
    and ``n_valid`` [n_users]: the valid paths of each user."""
    r = rng(seed, STREAM_PATHS)
    lo, hi = mix["valid_paths"]
    weights = mix.get("valid_paths_weights")
    if weights is None:
        n_valid = r.integers(lo, hi + 1, size=n_users)
    else:
        w = np.asarray(weights, np.float64)
        if len(w) != hi - lo + 1:
            raise ValueError("valid_paths_weights needs one weight per count "
                             f"{lo}..{hi}")
        n_valid = lo + r.choice(len(w), size=n_users, p=w / w.sum())
    pad = np.arange(max_paths)[None, :] >= n_valid[:, None]
    out = {}
    for name, (a, b) in mix["ranges"].items():
        x = r.random((n_users, max_paths), dtype=np.float32)
        x *= np.float32(b - a)
        x += np.float32(a)
        x[pad] = np.nan
        out[name] = x
    out["n_valid"] = n_valid
    return out


def split(data: dict, n_parts: int) -> list:
    """``data`` cut into ``n_parts`` equal blocks of users (views)."""
    n = data["n_valid"].shape[0] // n_parts
    return [{k: v[i * n:(i + 1) * n] for k, v in data.items()}
            for i in range(n_parts)]


def codebook(n_beams: int, n_tx: int, seed: int) -> np.ndarray:
    """Random-phase codebook / sqrt(T), complex128 [B, T]."""
    r = rng(seed, STREAM_CODEBOOK)
    return np.exp(1j * r.uniform(-np.pi, np.pi, (n_beams, n_tx))) / \
        np.sqrt(n_tx)
