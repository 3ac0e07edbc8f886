"""Channel-generation parameters: user-facing config with validation.

``ChannelGenParameters`` keeps the key schema and defaults of
``deepmimo_tpu.generator.params`` so user code ports unchanged;
``to_config()`` splits them into the static ``ChannelConfig`` and the
two ``AntennaPanel`` tensors consumed by the PyTorch renderer, on the
configured device.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import consts as c
from ..config import config as _config
from ..ops.types import AntennaPanel, ChannelConfig
from ..utils import DotDict, compare_two_dicts


class ChannelGenParameters(DotDict):
    """Parameters controlling MIMO channel synthesis.

    Access with dot or dict notation: ``params.bs_antenna.shape`` /
    ``params['bs_antenna']['shape']``.
    """

    DEFAULT_PARAMS = {
        c.PARAMSET_ANT_BS: {
            c.PARAMSET_ANT_SHAPE: np.array([8, 1]),
            c.PARAMSET_ANT_SPACING: 0.5,
            c.PARAMSET_ANT_ROTATION: np.array([0, 0, 0]),
            c.PARAMSET_ANT_RAD_PAT: c.PARAMSET_ANT_RAD_PAT_VALS[0],
        },
        c.PARAMSET_ANT_UE: {
            c.PARAMSET_ANT_SHAPE: np.array([1, 1]),
            c.PARAMSET_ANT_SPACING: 0.5,
            c.PARAMSET_ANT_ROTATION: np.array([0, 0, 0]),
            c.PARAMSET_ANT_RAD_PAT: c.PARAMSET_ANT_RAD_PAT_VALS[0],
        },
        c.PARAMSET_DOPPLER_EN: 0,
        c.PARAMSET_POLAR_EN: 0,
        c.PARAMSET_NUM_PATHS: c.MAX_PATHS,
        c.PARAMSET_FD_CH: 1,
        c.PARAMSET_OFDM: {
            c.PARAMSET_OFDM_SC_NUM: 512,
            c.PARAMSET_OFDM_SC_SAMP: np.arange(1),
            c.PARAMSET_OFDM_BANDWIDTH: 10e6,
            c.PARAMSET_OFDM_LPF: 0,
        },
        # Doppler extension (used only when enable_doppler is set)
        c.PARAMSET_DOPPLER_TIMES: np.array([0.0]),
        c.PARAMSET_CARRIER_FREQ: 3.5e9,
    }

    def __init__(self, data: Optional[Dict] = None):
        super().__init__(deepcopy(self.DEFAULT_PARAMS))
        if data is not None:
            self.update(data)

    def validate(self, n_ues: int) -> "ChannelGenParameters":
        """Check consistency; normalizes missing antenna sub-keys."""
        extra = compare_two_dicts(self, ChannelGenParameters())
        if extra:
            print("The following parameters seem unnecessary:")
            print(extra)

        bs = self[c.PARAMSET_ANT_BS]
        ue = self[c.PARAMSET_ANT_UE]

        if c.PARAMSET_ANT_ROTATION in bs.keys() and \
                bs[c.PARAMSET_ANT_ROTATION] is not None:
            rot = np.asarray(bs[c.PARAMSET_ANT_ROTATION])
            if not (rot.ndim == 1 and rot.shape[0] == 3):
                raise ValueError("The BS antenna rotation must be a 3D vector")
        else:
            bs[c.PARAMSET_ANT_ROTATION] = np.array([0, 0, 0])

        # UE rotation: 3-vector | [3, 2] random-range spec | [n_ue, 3]
        if c.PARAMSET_ANT_ROTATION in ue.keys() and \
                ue[c.PARAMSET_ANT_ROTATION] is not None:
            rot = np.asarray(ue[c.PARAMSET_ANT_ROTATION])
            ok = ((rot.ndim == 1 and rot.shape[0] == 3) or
                  (rot.ndim == 2 and rot.shape == (3, 2)) or
                  (rot.ndim == 2 and rot.shape[0] == n_ues))
            if not ok:
                raise ValueError(
                    "The UE antenna rotation must either be a 3D vector for "
                    "constant values, a 3x2 matrix for random values, or an "
                    "[n_ue, 3] matrix of per-user rotations")
        else:
            ue[c.PARAMSET_ANT_ROTATION] = np.array([0, 0, 0])

        for side, name in ((bs, "BS"), (ue, "UE")):
            pat = side.get(c.PARAMSET_ANT_RAD_PAT,
                           c.PARAMSET_ANT_RAD_PAT_VALS[0])
            if pat not in c.PARAMSET_ANT_RAD_PAT_VALS:
                raise ValueError(
                    f"The {name} antenna radiation pattern must be one of "
                    f"{c.PARAMSET_ANT_RAD_PAT_VALS}")
            side[c.PARAMSET_ANT_RAD_PAT] = pat
        return self

    def resolve_ue_rotation(self, n_ues: int,
                            rng: Optional[np.random.RandomState] = None
                            ) -> np.ndarray:
        """Materialize the UE rotation spec into a concrete array.

        A [3, 2] spec draws per-user uniform rotations (numpy's global
        generator unless ``rng`` is given; the caller seeds it with 1001).
        Returns [3], or [n_ue, 3].
        """
        rot = np.asarray(self[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION],
                         dtype=np.float64)
        if rot.ndim == 2 and rot.shape == (3, 2):
            draw = rng.uniform if rng is not None else np.random.uniform
            return draw(rot[:, 0], rot[:, 1], (n_ues, 3))
        return rot

    def to_config(self, n_ues: int, bs_fov=None, ue_fov=None,
                  ue_rotation: Optional[np.ndarray] = None,
                  dtype="complex64", device=None,
                  ) -> Tuple[ChannelConfig, AntennaPanel, AntennaPanel]:
        """Split into (ChannelConfig, bs AntennaPanel, ue AntennaPanel).

        ``ue_rotation`` overrides the stored UE rotation (used after random
        per-user draws have been materialized). The panels are created on
        ``device`` (default: ``config['device']``).
        """
        bs_p = self[c.PARAMSET_ANT_BS]
        ue_p = self[c.PARAMSET_ANT_UE]
        ofdm = self[c.PARAMSET_OFDM]

        sel = np.atleast_1d(np.asarray(ofdm[c.PARAMSET_OFDM_SC_SAMP]))
        times = np.atleast_1d(np.asarray(
            self.get(c.PARAMSET_DOPPLER_TIMES, np.array([0.0]))))

        cfg = ChannelConfig(
            bs_shape=tuple(int(x) for x in
                           np.asarray(bs_p[c.PARAMSET_ANT_SHAPE])),
            ue_shape=tuple(int(x) for x in
                           np.asarray(ue_p[c.PARAMSET_ANT_SHAPE])),
            bs_pattern=bs_p[c.PARAMSET_ANT_RAD_PAT],
            ue_pattern=ue_p[c.PARAMSET_ANT_RAD_PAT],
            freq_domain=bool(self[c.PARAMSET_FD_CH]),
            subcarriers=int(ofdm[c.PARAMSET_OFDM_SC_NUM]),
            selected_subcarriers=tuple(int(k) for k in sel),
            bandwidth=float(ofdm[c.PARAMSET_OFDM_BANDWIDTH]),
            rx_filter=bool(ofdm[c.PARAMSET_OFDM_LPF]),
            num_paths=int(self[c.PARAMSET_NUM_PATHS]),
            bs_fov=None if bs_fov is None else tuple(float(x)
                                                     for x in bs_fov),
            ue_fov=None if ue_fov is None else tuple(float(x)
                                                     for x in ue_fov),
            enable_doppler=bool(self.get(c.PARAMSET_DOPPLER_EN, 0)),
            carrier_freq=float(self.get(c.PARAMSET_CARRIER_FREQ, 3.5e9)),
            doppler_times=tuple(float(t) for t in times),
            dtype=dtype,
            backend=_config.get("render_backend", "fused"),
            planes_layout=_config.get("planes_layout", "packed"),
            matmul_dtype=_config.get("matmul_dtype", "float32"),
            out_dtype=_config.get("planes_out_dtype", "float32"),
        )

        if ue_rotation is None:
            ue_rotation = self.resolve_ue_rotation(n_ues)

        rdt = torch.float32 if dtype == "complex64" else torch.float64
        bs_panel = AntennaPanel.make(
            rotation_deg=np.asarray(bs_p[c.PARAMSET_ANT_ROTATION],
                                    dtype=np.float64),
            spacing=float(bs_p[c.PARAMSET_ANT_SPACING]), dtype=rdt,
            device=device)
        ue_panel = AntennaPanel.make(
            rotation_deg=np.asarray(ue_rotation, dtype=np.float64),
            spacing=float(ue_p[c.PARAMSET_ANT_SPACING]), dtype=rdt,
            device=device)
        return cfg, bs_panel, ue_panel
