"""Dataset: dict-like view of one TX-RX pair's ray data, rendered on torch.

Counterpart of ``deepmimo_tpu/generator/dataset.py``: the same keys,
aliases and ``compute_channels`` / ``compute_beam_gains`` contracts, with
the renders running through the PyTorch renderer (the CUDA kernels on a
card) on masked ``PathData`` — in one launch, or streamed over user
blocks when the output exceeds ``config['max_device_output_bytes']``
(or, for a host result, whenever ``config['checkpoint_dir']`` is set: the
blocks are saved and a later render of the same inputs resumes from
them). Dual-polar scenarios render all four polarizations in one launch.
``MacroDataset`` holds the datasets of several TX-RX pairs or snapshots;
its batched renders take one launch for every child.

The derived attributes (rotated and FoV-filtered angles, ``apply_fov``,
pathloss, LoS, path and interaction counts, pattern-gain powers, the
array-response product, grid info, ``subset``) resolve through the same
registry, NaN-padded on the host; their angle, FoV and pattern math runs
in the port's own torch geometry in float64 on ``config['device']``.
``plot_coverage``, ``plot_rays`` and ``info`` pass through to
``generator/visualization.py`` and ``info.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import consts as c
from ..config import config
from ..info import info as _info
from ..ops import geometry as _geo
from ..ops.channel import (_fov_valid, _fused_n_snap, _rotated_angles,
                           _td_compact_active, planes_dtype,
                           polar_fused_eligible, polar_out_shape,
                           render_beam_gains, render_beam_gains_polar,
                           render_channels_planes,
                           render_channels_planes_polar, render_out_shape,
                           unpack_planes_np, unpack_polar_planes_np)
from ..ops.kernels.render import out_torch_dtype
from ..ops.patterns import pattern_gain
from ..ops.types import AntennaPanel, PathData, _small_tensor
from ..utils import DotDict
from ..utils.profiling import span
from .checkpoint import ChunkStore
from .params import ChannelGenParameters
from .sampling import dbw2watt, get_uniform_idxs

#: Polarizations of a dual-polar scenario, in slot order.
POLS = ("VV", "VH", "HH", "HV")

#: Parameters shared across the datasets of one scenario (kept by subset).
SHARED_PARAMS = [
    c.SCENE_PARAM_NAME,
    c.MATERIALS_PARAM_NAME,
    c.LOAD_PARAMS_PARAM_NAME,
    c.RT_PARAMS_PARAM_NAME,
]


class Dataset(DotDict):
    """Dict-like dataset with lazily computed attributes.

    Primary (loaded) keys: power, phase, delay, aoa_az/el, aod_az/el,
    rx_pos, tx_pos, inter, inter_pos. Derived keys are computed on first
    access and cached.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__(data or {})

    def __getattr__(self, key: str) -> Any:
        try:
            return super().__getitem__(key)
        except KeyError:
            pass
        try:
            return self._resolve_key(key)
        except KeyError:
            raise AttributeError(key) from None

    def __getitem__(self, key: str) -> Any:
        try:
            return super().__getitem__(key)
        except KeyError:
            return self._resolve_key(key)

    def _resolve_key(self, key: str) -> Any:
        resolved = c.DATASET_ALIASES.get(key, key)
        if resolved != key:
            key = resolved
            try:
                return super().__getitem__(key)
            except KeyError:
                pass
        if key in self._computed_attributes:
            value = getattr(self, self._computed_attributes[key])()
            if isinstance(value, dict):
                # Each key of a dict result is stored; a key that names
                # the whole dict ("fov") gets the dict.
                self.update(value)
                return value[key] if key in value else value
            self[key] = value
            return value
        raise KeyError(key)

    def __dir__(self):
        return list(set(list(super().__dir__()) +
                        list(self._computed_attributes.keys()) +
                        list(c.DATASET_ALIASES.keys())))

    # ------------------------------------------------------------------
    # Channel computation
    # ------------------------------------------------------------------

    def set_channel_params(self, params: Optional[ChannelGenParameters]
                           = None) -> ChannelGenParameters:
        """Validate and store (a copy of) the channel parameters; a change
        of either panel's rotation drops the cached rotated angles."""
        if params is None:
            params = ChannelGenParameters()
        params.validate(self.n_ue)
        old = self.get(c.CH_PARAMS_PARAM_NAME)
        self[c.CH_PARAMS_PARAM_NAME] = params.deepcopy()
        rot = c.PARAMSET_ANT_ROTATION
        if old is not None and any(
                not np.array_equal(np.asarray(old[side][rot]),
                                   np.asarray(params[side][rot]))
                for side in (c.PARAMSET_ANT_BS, c.PARAMSET_ANT_UE)):
            self._clear_cache_rotated_angles()
        return params

    def compute_channels(self, params: Optional[ChannelGenParameters] = None,
                         to_device: bool = False, out=None):
        """Compute MIMO channels for every user (the hot path).

        Renders on ``config['device']`` — in ONE kernel launch when the
        output fits ``config['max_device_output_bytes']``, otherwise over
        ``config['user_block']`` blocks with each block's device->host copy
        overlapping the next block's render — and returns a numpy complex
        array [n_ue, n_rx_ant, n_tx_ant, K], or [..., n_paths] in the time
        domain (``params['freq_domain'] = 0``; after :meth:`apply_fov`
        each user's surviving paths come first), cached under
        ``dataset.channel`` (with several Doppler snapshots a trailing
        time axis [..., S]). complex64, or complex128 from float64 planes
        with ``config['compute_dtype']`` "complex128". With
        ``config['planes_out_dtype']`` "bfloat16" the planes are rendered
        and copied to the host in bf16 (half the bytes) and widened
        there.

        Args:
            params: channel-generation parameters (defaults applied).
            to_device: return the raw planes tensor on the device instead
                (no host copy; not cached). Its layout is the renderer's
                (see ``ops.channel.render_channels_planes``); convert
                with ``ops.channel.unpack_planes_np``.
            out: a planes tensor from a previous identical call (float32,
                float64 for complex128, or bfloat16 in the bf16 output
                mode). When its shape,
                dtype and device match, the new result is written into it
                in place — the previous result is overwritten — so serving
                loops run in constant device memory. Ignored otherwise.

        With ``params['enable_dual_polar']`` the result is a dict
        {'VV', 'VH', 'HH', 'HV'} of such arrays, or with ``to_device`` the
        raw polar planes (``ops.channel.render_channels_planes_polar``;
        unpack with ``ops.channel.unpack_polar_planes_np``).
        """
        with span("dm.entry"):
            params, cfg, bs_panel, ue_panel = self._channel_config(params)
            if cfg.freq_domain:
                self._clipping_report(cfg)
            polar = bool(params.get(c.PARAMSET_POLAR_EN, 0))
            pd = None if polar else self._path_data()
        if polar:
            channel = self._compute_dual_polar(cfg, bs_panel, ue_panel,
                                               to_device=to_device, out=out)
        else:
            channel = _render_streamed(pd, bs_panel, ue_panel, cfg,
                                       to_device=to_device, out=out)
        if to_device:
            return channel
        self[c.CHANNEL_PARAM_NAME] = channel
        return channel

    def _clipping_report(self, cfg):
        """Sets ``clipping_report`` (and warns once) where paths arrive
        past the cyclic prefix; memoized per (n_fft, bandwidth): serving
        loops re-call compute_channels back-to-back."""
        cache = self.get("_clip_report_cache") or {}
        ck = (cfg.subcarriers, cfg.bandwidth)
        if ck not in cache:
            cache[ck] = delay_clipping_report(
                np.asarray(self[c.DELAY_PARAM_NAME]),
                np.asarray(self[c.POWER_PARAM_NAME]),
                cfg.subcarriers, cfg.bandwidth)
            self["_clip_report_cache"] = cache
            if cache[ck] is not None:
                _print_delay_clipping_warning(cache[ck])
        if cache[ck] is not None:
            self["clipping_report"] = cache[ck]

    def _channel_config(self, params):
        """(params, cfg, bs panel, ue panel) for a render: the stored
        parameters when ``params`` is None, validated and stored, with the
        per-user UE rotations drawn after ``np.random.seed(1001)``."""
        if params is None:
            stored = self.get(c.CH_PARAMS_PARAM_NAME)
            params = ChannelGenParameters() if stored is None else stored
        params = self.set_channel_params(params)
        # Deterministic per-user random rotations (toolchain convention).
        np.random.seed(1001)
        ue_rotation = params.resolve_ue_rotation(self.n_ue)
        cfg, bs_panel, ue_panel = params.to_config(
            self.n_ue, bs_fov=self.get("bs_fov"), ue_fov=self.get("ue_fov"),
            ue_rotation=ue_rotation, dtype=config.get("compute_dtype"))
        return params, cfg, bs_panel, ue_panel

    def _check_pols(self):
        """Raise unless the scenario has per-polarization matrices."""
        missing = [p for p in POLS
                   if f"power_{p.lower()}" not in self.keys()]
        if missing:
            raise ValueError(
                "Dual-polarization requested but the scenario has no "
                f"per-polarization matrices for {missing}. Expected keys "
                "like 'power_vv'/'phase_vv'.")

    def _compute_dual_polar(self, cfg, bs_panel, ue_panel,
                            to_device: bool = False, out=None):
        """Dual-polarization channels: {'VV', 'VH', 'HH', 'HV'} -> H.

        Needs per-polarization power/phase matrices (``power_vv``,
        ``phase_vv``, ...); angles and delays are shared across
        polarizations. Fused-eligible configs render all four in ONE kernel
        launch (the polarizations ride the kernel's slot axis); others
        render each polarization on its own, to the host only (the time
        domain, the receive filter and complex128 among them).
        """
        self._check_pols()
        if polar_fused_eligible(cfg, len(POLS)):
            res = _render_polar_streamed(self._path_data(), bs_panel,
                                         ue_panel, cfg, *self._polar_stacks(),
                                         to_device=to_device, out=out)
            return res if to_device else dict(zip(POLS, res))
        if to_device:
            raise ValueError(
                "to_device=True with dual-polarization requires a fused-"
                "eligible config (OFDM, no rx_filter, complex64, "
                "arithmetic subcarrier selection); call per polarization "
                "instead.")
        return {pol: _render_streamed(
            self._path_data(power=self[f"power_{pol.lower()}"],
                            phase=self._pol_phase(pol)),
            bs_panel, ue_panel, cfg) for pol in POLS}

    def _pol_phase(self, pol: str):
        return self.get(f"phase_{pol.lower()}", self[c.PHASE_PARAM_NAME])

    def _polar_stacks(self):
        """[N_pol, U, P] power and phase stacks on ``config['device']``,
        NaN-padded as loaded (cached per device and dtype: serving loops
        re-call back to back)."""
        dev, dtype = self._device_dtype()
        cached = self.get("_polar_data_cache")
        if cached is not None and cached[0] == (dev, dtype):
            return cached[1]

        def upload(mats):
            with span("dm.h2d") if dev.type == "cuda" else \
                    contextlib.nullcontext():
                return torch.as_tensor(np.stack([np.asarray(x, np.float64)
                                                 for x in mats]),
                                       dtype=dtype, device=dev)

        stacks = (upload([self[f"power_{p.lower()}"] for p in POLS]),
                  upload([self._pol_phase(p) for p in POLS]))
        self["_polar_data_cache"] = ((dev, dtype), stacks)
        return stacks

    def compute_beam_gains(self, params: Optional[ChannelGenParameters]
                           = None, codebook=None, to_device: bool = False,
                           out=None):
        """Codebook beam-gain maps G = |conj(W) . H|^2 without H.

        The codebook folds into the beam-gain kernel's path sum
        (``ops/kernels/beamgain.py``), so the channel tensor is never
        formed, on the device or on the host.

        Args:
            codebook: complex [n_beams, n_tx_ant] array, or a (wr, wi)
                tuple of real/imag planes. Gains match
                ``np.abs(H @ codebook.conj().T)**2``.
            to_device: return the raw tensor [U, R*B, S*K] on the device.
            out: a tensor from a previous identical call. When its shape,
                dtype and device match, the new result is written into it
                in place (the previous result is overwritten); ignored
                otherwise.

        On a card the kernel takes T*B <= 28,768 (TX elements times
        beams; 14,240 with complex128) in every mode, and with complex64
        and ``config['matmul_dtype']`` "float32" or "highest" any number
        of beams on panels of up to 256 TX elements (a 16x16 panel with
        its 256-beam grid of beams runs on the tensor cores); past that
        it raises ValueError there rather than form the channel on the
        device (``render_backend`` "xla" or the CPU take the plain
        version).

        Returns [n_ue, n_rx_ant, n_beams, K] float32 (float64, from a
        float64 codebook, with ``config['compute_dtype']`` "complex128"),
        with a trailing time axis [..., K, S] for several Doppler
        snapshots. Dual-polar scenarios
        (``params['enable_dual_polar']``) return a dict {'VV', 'VH', 'HH',
        'HV'} of such maps, all four from ONE kernel launch (with
        ``to_device``, the raw [U, R*B, 4*S*K], slot axis pol-major); ``out``
        is honoured there too.
        """
        if codebook is None:
            raise ValueError("compute_beam_gains requires a codebook "
                             "([n_beams, n_tx_ant] complex, or an "
                             "(wr, wi) tuple)")
        with span("dm.entry"):
            params, cfg, bs_panel, ue_panel = self._channel_config(params)
            pd = self._path_data()
            with span("dm.codebook"):
                w = _codebook_planes(codebook, cfg, pd.valid.device)
            polar = bool(params.get(c.PARAMSET_POLAR_EN, 0))
            if polar:
                self._check_pols()
            stacks = self._polar_stacks() if polar else None
        return _beam_gain_maps(pd, bs_panel, ue_panel, cfg, w, to_device,
                               out, stacks)

    def _device_dtype(self):
        dev = torch.device(config.get("device"))
        dtype = (torch.float64 if config.get("compute_dtype") == "complex128"
                 else torch.float32)
        return dev, dtype

    def _path_data(self, power=None, phase=None) -> PathData:
        """Masked PathData of this dataset on ``config['device']`` (cached
        per device and dtype); ``power``/``phase`` replace the dataset's
        own matrices (one polarization's), uncached."""
        dev, dtype = self._device_dtype()
        own = power is None
        cached = self.get("_path_data_cache")
        if own and cached is not None and cached[0] == (dev, dtype):
            return cached[1]
        pd = PathData.from_numpy(
            power=self[c.POWER_PARAM_NAME] if own else power,
            phase=self[c.PHASE_PARAM_NAME] if own else phase,
            delay=self[c.DELAY_PARAM_NAME],
            aoa_az=self[c.AOA_AZ_PARAM_NAME],
            aoa_el=self[c.AOA_EL_PARAM_NAME],
            aod_az=self[c.AOD_AZ_PARAM_NAME],
            aod_el=self[c.AOD_EL_PARAM_NAME],
            doppler_vel=self.get(c.DOPPLER_VEL_PARAM_NAME),
            doppler_acc=self.get(c.DOPPLER_ACC_PARAM_NAME),
            dtype=dtype, device=dev)
        if own:
            self["_path_data_cache"] = ((dev, dtype), pd)
        return pd

    # ------------------------------------------------------------------
    # Geometric computations
    # ------------------------------------------------------------------

    @property
    def tx_ori(self) -> np.ndarray:
        return np.asarray(
            self.ch_params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION]) \
            * np.pi / 180

    @property
    def bs_ori(self) -> np.ndarray:
        return self.tx_ori

    @property
    def rx_ori(self) -> np.ndarray:
        return np.asarray(
            self.ch_params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION]) \
            * np.pi / 180

    @property
    def ue_ori(self) -> np.ndarray:
        return self.rx_ori

    def _ensure_ch_params(self) -> ChannelGenParameters:
        stored = self.get(c.CH_PARAMS_PARAM_NAME)
        if stored is None:
            stored = self.set_channel_params(None)
            self[c.CH_PARAMS_PARAM_NAME] = stored
        return stored

    def _compute_rotated_angles(self) -> Dict[str, np.ndarray]:
        """Rotated AoD/AoA (radians, NaN-padded), with the per-user UE
        rotations drawn after ``np.random.seed(1001)`` as for a render."""
        params = self._ensure_ch_params()
        np.random.seed(1001)
        ue_rotation = params.resolve_ue_rotation(self.n_ue)
        bs_rotation = params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION]
        aod_t, aod_p = _rotate_np(bs_rotation, self[c.AOD_EL_PARAM_NAME],
                                  self[c.AOD_AZ_PARAM_NAME])
        aoa_t, aoa_p = _rotate_np(ue_rotation, self[c.AOA_EL_PARAM_NAME],
                                  self[c.AOA_AZ_PARAM_NAME])
        return {
            c.AOD_EL_ROT_PARAM_NAME: aod_t,
            c.AOD_AZ_ROT_PARAM_NAME: aod_p,
            c.AOA_EL_ROT_PARAM_NAME: aoa_t,
            c.AOA_AZ_ROT_PARAM_NAME: aoa_p,
        }

    def _compute_array_response_product(self) -> np.ndarray:
        """[n_ue, M_rx, M_tx, n_paths] complex64 RX x TX array-response
        product at the FoV-filtered rotated angles (invalid paths -> 0).

        A host presentation attribute of O(users x R x T x P) that the
        channel path never forms: sized against
        ``config['max_array_product_bytes']`` (MemoryError with guidance
        above it) and built in ``config['user_block']`` user blocks with
        :func:`ops.geometry.array_response` in float64 on
        ``config['device']``.
        """
        params = self._ensure_ch_params()
        bs_p = params[c.PARAMSET_ANT_BS]
        ue_p = params[c.PARAMSET_ANT_UE]
        bs_shape, ue_shape = (tuple(int(x) for x in np.asarray(
            p[c.PARAMSET_ANT_SHAPE])) for p in (bs_p, ue_p))

        el_fov = np.asarray(self[c.AOD_EL_FOV_PARAM_NAME])
        valid = ~np.isnan(el_fov)
        angles = [np.nan_to_num(np.asarray(self[k])) for k in (
            c.AOD_EL_FOV_PARAM_NAME, c.AOD_AZ_FOV_PARAM_NAME,
            c.AOA_EL_FOV_PARAM_NAME, c.AOA_AZ_FOV_PARAM_NAME)]

        n_ue, n_p = el_fov.shape
        r = ue_shape[0] * ue_shape[1]
        t = bs_shape[0] * bs_shape[1]
        out_bytes = n_ue * r * t * n_p * 8
        limit = int(config.get("max_array_product_bytes"))
        if out_bytes > limit:
            raise MemoryError(
                f"array_response_product would be [{n_ue}, {r}, {t}, "
                f"{n_p}] complex64 = {out_bytes / 2**30:.1f} GiB on the "
                f"host (limit {limit / 2**30:.1f} GiB, config "
                "'max_array_product_bytes'). Use dataset.subset(idxs) to "
                "restrict users, or compute channels directly — "
                "compute_channels never materializes this product.")

        def response(shape, spacing, theta, phi, v):
            resp = _geo.array_response(shape, float(spacing), _dev(theta),
                                       _dev(phi), _dev(v, torch.bool),
                                       torch.complex128)
            return resp.to(torch.complex64)

        out = np.empty((n_ue, r, t, n_p), dtype=np.complex64)
        block = max(1, int(config.get("user_block") or 16384))
        for s in range(0, n_ue, block):
            e = min(s + block, n_ue)
            aod_t, aod_p, aoa_t, aoa_p = (a[s:e] for a in angles)
            a_tx = response(bs_shape, bs_p[c.PARAMSET_ANT_SPACING], aod_t,
                            aod_p, valid[s:e])
            a_rx = response(ue_shape, ue_p[c.PARAMSET_ANT_SPACING], aoa_t,
                            aoa_p, valid[s:e])
            out[s:e] = (a_rx[:, :, None, :] *
                        a_tx[:, None, :, :]).cpu().numpy()
        return out

    def _clear_cache_rotated_angles(self) -> None:
        for k in {c.AOD_EL_ROT_PARAM_NAME, c.AOD_AZ_ROT_PARAM_NAME,
                  c.AOA_EL_ROT_PARAM_NAME, c.AOA_AZ_ROT_PARAM_NAME} & \
                set(super().keys()):
            super().__delitem__(k)
        self._clear_cache_fov()

    # ------------------------------------------------------------------
    # Field of view
    # ------------------------------------------------------------------

    def apply_fov(self, bs_fov: np.ndarray = np.array([360, 180]),
                  ue_fov: np.ndarray = np.array([360, 180])) -> None:
        """Set the BS and UE fields of view [horizontal, vertical] in
        degrees; the derived quantities and the channels recompute lazily
        (a time-domain render then packs the surviving paths to the
        front)."""
        self._clear_cache_fov()
        self["bs_fov"] = np.asarray(bs_fov)
        self["ue_fov"] = np.asarray(ue_fov)

    def _compute_fov(self) -> Dict[str, np.ndarray]:
        aod_t = self[c.AOD_EL_ROT_PARAM_NAME]
        aod_p = self[c.AOD_AZ_ROT_PARAM_NAME]
        aoa_t = self[c.AOA_EL_ROT_PARAM_NAME]
        aoa_p = self[c.AOA_AZ_ROT_PARAM_NAME]

        bs_fov, ue_fov = self.get("bs_fov"), self.get("ue_fov")
        bs_full = bs_fov is not None and _geo.is_full_fov(bs_fov)
        ue_full = ue_fov is not None and _geo.is_full_fov(ue_fov)

        if (bs_fov is None and ue_fov is None) or (bs_full and ue_full):
            return {
                c.FOV_MASK_PARAM_NAME: None,
                c.AOD_EL_FOV_PARAM_NAME: aod_t,
                c.AOD_AZ_FOV_PARAM_NAME: aod_p,
                c.AOA_EL_FOV_PARAM_NAME: aoa_t,
                c.AOA_AZ_FOV_PARAM_NAME: aoa_p,
            }

        mask = np.ones(aod_t.shape, dtype=bool)
        if bs_fov is not None and not bs_full:
            mask &= _fov_np(bs_fov, aod_t, aod_p)
        if ue_fov is not None and not ue_full:
            mask &= _fov_np(ue_fov, aoa_t, aoa_p)

        def nanw(a):
            return np.where(mask, a, np.nan)
        return {
            c.FOV_MASK_PARAM_NAME: mask,
            c.AOD_EL_FOV_PARAM_NAME: nanw(aod_t),
            c.AOD_AZ_FOV_PARAM_NAME: nanw(aod_p),
            c.AOA_EL_FOV_PARAM_NAME: nanw(aoa_t),
            c.AOA_AZ_FOV_PARAM_NAME: nanw(aoa_p),
        }

    def _clear_cache_fov(self) -> None:
        keys = {c.FOV_MASK_PARAM_NAME, c.NUM_PATHS_PARAM_NAME,
                c.LOS_PARAM_NAME, c.CHANNEL_PARAM_NAME,
                c.PWR_LINEAR_ANT_GAIN_PARAM_NAME,
                c.AOD_EL_FOV_PARAM_NAME, c.AOD_AZ_FOV_PARAM_NAME,
                c.AOA_EL_FOV_PARAM_NAME, c.AOA_AZ_FOV_PARAM_NAME}
        for k in keys & set(super().keys()):
            super().__delitem__(k)

    # ------------------------------------------------------------------
    # Path and power computations
    # ------------------------------------------------------------------

    def compute_pathloss(self, coherent: bool = True) -> np.ndarray:
        """Pathloss in dB from a coherent (or incoherent) path-gain sum."""
        powers_linear = 10 ** (np.asarray(self[c.POWER_PARAM_NAME]) / 10)
        phases_rad = np.deg2rad(np.asarray(self[c.PHASE_PARAM_NAME]))
        gains = np.sqrt(powers_linear).astype(np.complex64)
        if coherent:
            gains = gains * np.exp(1j * phases_rad)
        total_power = np.abs(np.nansum(gains, axis=1)) ** 2
        mask = total_power > 0
        pathloss = np.full_like(total_power, np.nan, dtype=np.float64)
        pathloss[mask] = -10 * np.log10(total_power[mask])
        self[c.PATHLOSS_PARAM_NAME] = pathloss
        return pathloss

    def _compute_los(self) -> np.ndarray:
        """LoS status per user: 1 LoS, 0 NLoS, -1 no paths (in the FoV)."""
        inter = np.asarray(self[c.INTERACTIONS_PARAM_NAME])
        los_status = np.full(inter.shape[0], -1)
        fov_mask = self[c.FOV_MASK_PARAM_NAME]
        if fov_mask is not None:
            has_paths = np.any(fov_mask, axis=1)
            first_idx = np.argmax(fov_mask, axis=1)      # first in-FoV path
            first_valid = np.where(
                has_paths, inter[np.arange(inter.shape[0]), first_idx], -1)
        else:
            has_paths = np.asarray(self[c.NUM_PATHS_PARAM_NAME]) > 0
            first_valid = inter[:, 0] if inter.shape[1] else \
                np.full(inter.shape[0], np.nan)
        los_status[has_paths] = 0
        los_status[(first_valid == c.INTERACTION_LOS) & has_paths] = 1
        return los_status

    def _compute_num_paths(self) -> np.ndarray:
        return (~np.isnan(np.asarray(self[c.AOA_AZ_FOV_PARAM_NAME]))).sum(
            axis=1)

    def _compute_num_interactions(self) -> np.ndarray:
        inter = np.asarray(self[c.INTERACTIONS_PARAM_NAME]).astype(np.float64)
        result = np.zeros_like(inter)
        result[np.isnan(inter)] = np.nan
        nz = inter > 0
        result[nz] = np.floor(np.log10(inter[nz])) + 1
        return result

    def _compute_inter_int(self) -> np.ndarray:
        inter = np.asarray(self[c.INTERACTIONS_PARAM_NAME]).astype(
            np.float64).copy()
        inter[np.isnan(inter)] = -1
        return inter.astype(int)

    def _compute_inter_str(self) -> np.ndarray:
        inter = np.asarray(self[c.INTERACTIONS_PARAM_NAME]).astype(np.float64)
        table = str.maketrans({"0": "", "1": "R", "2": "D", "3": "S",
                               "4": "T"})

        def translate(x):
            if np.isnan(x):
                return "n"
            if x == 0:
                return ""            # LoS: a single '0' digit, no bounce
            return str(int(x)).translate(table)

        return np.vectorize(translate, otypes=[object])(inter)

    def _compute_n_ue(self) -> int:
        return np.asarray(self[c.RX_POS_PARAM_NAME]).shape[0]

    def _compute_distances(self) -> np.ndarray:
        return np.linalg.norm(np.asarray(self[c.RX_POS_PARAM_NAME]) -
                              np.asarray(self[c.TX_POS_PARAM_NAME]), axis=1)

    def _compute_power_linear_ant_gain(self) -> np.ndarray:
        """Linear powers with the TX/RX pattern gains at the FoV-filtered
        angles (NaN where no path)."""
        params = self._ensure_ch_params()
        tx_pat = params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_RAD_PAT]
        rx_pat = params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_RAD_PAT]
        aoa_t = np.asarray(self[c.AOA_EL_FOV_PARAM_NAME])
        gain = (_pattern_np(tx_pat, self[c.AOD_EL_FOV_PARAM_NAME],
                            self[c.AOD_AZ_FOV_PARAM_NAME]) *
                _pattern_np(rx_pat, aoa_t, self[c.AOA_AZ_FOV_PARAM_NAME]))
        out = np.asarray(self[c.PWR_LINEAR_PARAM_NAME]) * gain
        out[np.isnan(aoa_t)] = np.nan
        return out

    def _compute_power_linear(self) -> np.ndarray:
        return dbw2watt(np.asarray(self[c.POWER_PARAM_NAME]))

    # ------------------------------------------------------------------
    # Grid and sampling
    # ------------------------------------------------------------------

    def _compute_grid_info(self) -> Dict[str, np.ndarray]:
        rx_pos = np.asarray(self[c.RX_POS_PARAM_NAME])
        xs, ys = np.unique(rx_pos[:, 0]), np.unique(rx_pos[:, 1])
        return {
            "grid_size": np.array([len(xs), len(ys)]),
            "grid_spacing": np.array([np.mean(np.diff(xs)),
                                      np.mean(np.diff(ys))]),
        }

    def _is_valid_grid(self) -> bool:
        return np.prod(self["grid_size"]) == self.n_ue

    def subset(self, idxs: np.ndarray) -> "Dataset":
        """New Dataset restricted to the selected user indices: per-user
        arrays are indexed, the shared scenario parameters shared, nested
        parameter sets copied with their type (``ch_params`` stays a
        ChannelGenParameters) and everything else carried over; caches
        (keys starting with "_") are not."""
        idxs = np.asarray(idxs)
        initial = {p: super(Dataset, self).__getitem__(p)
                   for p in SHARED_PARAMS if p in self.keys()}
        initial["n_ue"] = len(idxs)
        new = Dataset(initial)
        n_ue = self.n_ue
        for attr, value in self.items():
            if attr.startswith("_") or attr in SHARED_PARAMS + ["n_ue"]:
                continue
            if isinstance(value, np.ndarray) and value.ndim >= 1 and \
                    value.shape[0] == n_ue:
                new[attr] = value[idxs]
            elif isinstance(value, DotDict):
                new[attr] = value.deepcopy()
            else:
                new[attr] = value
        return new

    def get_active_idxs(self) -> np.ndarray:
        """Indices of the users with at least one path (in the FoV)."""
        return np.where(np.asarray(self[c.NUM_PATHS_PARAM_NAME]) > 0)[0]

    def get_uniform_idxs(self, steps: List[int]) -> np.ndarray:
        """Indices of the users on a uniform [x_step, y_step] subgrid."""
        return get_uniform_idxs(self.n_ue, self["grid_size"], steps)

    def plot_coverage(self, cov_map, **kwargs):
        """Users coloured by ``cov_map`` [n_ue], with the BS and its
        boresight (``visualization.plot_coverage``); returns the axes."""
        from .visualization import plot_coverage
        return plot_coverage(self[c.RX_POS_PARAM_NAME], cov_map,
                             bs_pos=np.asarray(self[c.TX_POS_PARAM_NAME]).T,
                             bs_ori=self.tx_ori, **kwargs)

    def plot_rays(self, idx: int, **kwargs):
        """The ray paths of user ``idx`` (``visualization.plot_rays``, 3D
        and coloured by first bounce unless ``kwargs`` say otherwise)."""
        from .visualization import plot_rays
        defaults = {"proj_3D": True, "color_by_type": True}
        defaults.update(kwargs)
        return plot_rays(np.asarray(self[c.RX_POS_PARAM_NAME])[idx],
                         np.asarray(self[c.TX_POS_PARAM_NAME])[0],
                         np.asarray(self[c.INTERACTIONS_POS_PARAM_NAME])[idx],
                         np.asarray(self[c.INTERACTIONS_PARAM_NAME])[idx],
                         **defaults)

    def info(self, param_name: Optional[str] = None) -> None:
        """Print help for one dataset key (an alias resolves to its key),
        or for all of them."""
        if param_name in c.DATASET_ALIASES:
            resolved = c.DATASET_ALIASES[param_name]
            print(f"'{param_name}' is an alias for '{resolved}'")
            param_name = resolved
        _info(param_name)

    _computed_attributes = {
        c.N_UE_PARAM_NAME: "_compute_n_ue",
        c.NUM_PATHS_PARAM_NAME: "_compute_num_paths",
        c.NUM_INTERACTIONS_PARAM_NAME: "_compute_num_interactions",
        c.DIST_PARAM_NAME: "_compute_distances",
        c.PATHLOSS_PARAM_NAME: "compute_pathloss",
        c.CHANNEL_PARAM_NAME: "compute_channels",
        c.LOS_PARAM_NAME: "_compute_los",
        c.CH_PARAMS_PARAM_NAME: "set_channel_params",
        c.PWR_LINEAR_PARAM_NAME: "_compute_power_linear",
        c.AOA_AZ_ROT_PARAM_NAME: "_compute_rotated_angles",
        c.AOA_EL_ROT_PARAM_NAME: "_compute_rotated_angles",
        c.AOD_AZ_ROT_PARAM_NAME: "_compute_rotated_angles",
        c.AOD_EL_ROT_PARAM_NAME: "_compute_rotated_angles",
        "array_response_product": "_compute_array_response_product",
        "fov": "_compute_fov",
        c.FOV_MASK_PARAM_NAME: "_compute_fov",
        c.AOA_AZ_FOV_PARAM_NAME: "_compute_fov",
        c.AOA_EL_FOV_PARAM_NAME: "_compute_fov",
        c.AOD_AZ_FOV_PARAM_NAME: "_compute_fov",
        c.AOD_EL_FOV_PARAM_NAME: "_compute_fov",
        c.PWR_LINEAR_ANT_GAIN_PARAM_NAME: "_compute_power_linear_ant_gain",
        "grid_size": "_compute_grid_info",
        "grid_spacing": "_compute_grid_info",
        c.INTER_STR_PARAM_NAME: "_compute_inter_str",
        c.INTER_INT_PARAM_NAME: "_compute_inter_int",
    }


# ============================================================================
# The port's torch geometry on host arrays (NaN-padded presentation)
# ============================================================================

def _dev(x, dtype=torch.float64) -> torch.Tensor:
    """A host array as a tensor on ``config['device']``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=torch.device(config.get("device")))


def _rotate_np(rotation_deg, el_deg, az_deg):
    """:func:`ops.geometry.rotate_angles` in float64 on host arrays (NaN
    slots stay NaN)."""
    el = np.asarray(el_deg, dtype=np.float64)
    az = np.asarray(az_deg, dtype=np.float64)
    nan = np.isnan(el)
    t, p = (x.cpu().numpy() for x in _geo.rotate_angles(
        _dev(rotation_deg), _dev(np.nan_to_num(el)), _dev(np.nan_to_num(az))))
    t[nan] = np.nan
    p[nan] = np.nan
    return t, p


def _fov_np(fov_deg, theta_rad, phi_rad):
    """:func:`ops.geometry.apply_fov` on host arrays (NaN slots are out)."""
    theta = np.asarray(theta_rad, dtype=np.float64)
    mask = _geo.apply_fov(np.asarray(fov_deg, dtype=np.float64),
                          _dev(np.nan_to_num(theta)),
                          _dev(np.nan_to_num(np.asarray(
                              phi_rad, dtype=np.float64)))).cpu().numpy()
    mask[np.isnan(theta)] = False
    return mask


def _pattern_np(name, theta_rad, phi_rad):
    """:func:`ops.patterns.pattern_gain` on host arrays (NaN slots stay
    NaN)."""
    theta = np.asarray(theta_rad, dtype=np.float64)
    out = pattern_gain(name, _dev(np.nan_to_num(theta)),
                       _dev(np.nan_to_num(np.asarray(
                           phi_rad, dtype=np.float64)))).cpu().numpy()
    out[np.isnan(theta)] = np.nan
    return out


# ============================================================================
# Delay clipping report
# ============================================================================

def delay_clipping_report(delays_s, powers_dbw, n_fft: int,
                          bandwidth: float):
    """Aggregate over-OFDM-symbol stats, or None when nothing clips.

    OFDM path construction zeroes paths whose delay exceeds the symbol
    duration N/B; this reports how many paths and how much power that
    drops.
    """
    delays = np.asarray(delays_s, dtype=np.float64)
    powers = np.asarray(powers_dbw, dtype=np.float64)
    symbol_t = n_fft / bandwidth
    valid = ~np.isnan(delays)
    clipped = valid & (delays >= symbol_t)
    if not clipped.any():
        return None

    p_lin = np.where(valid, 10.0 ** (powers / 10.0), 0.0)
    total_pwr = p_lin.sum(axis=1)
    clip_pwr = np.where(clipped, p_lin, 0.0).sum(axis=1)
    users_hit = clipped.any(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(total_pwr > 0, clip_pwr / total_pwr, 0.0)
    return {
        "symbol_duration_s": symbol_t,
        "subcarriers": n_fft,
        "bandwidth_hz": bandwidth,
        "max_delay_s": float(np.nanmax(delays)),
        "n_clipped_paths": int(clipped.sum()),
        "n_total_paths": int(valid.sum()),
        "n_users_affected": int(users_hit.sum()),
        "n_users": int(delays.shape[0]),
        "mean_clipped_power_pct": float(100 * frac[users_hit].mean()),
        "max_clipped_power_pct": float(100 * frac.max()),
    }


def _print_delay_clipping_warning(r: dict) -> None:
    sc_spacing = r["bandwidth_hz"] / r["subcarriers"]
    print("\nWarning: Some path delays exceed the OFDM symbol duration")
    print("-" * 50)
    print(f"- Subcarriers (N): {r['subcarriers']}, bandwidth (B): "
          f"{r['bandwidth_hz']/1e6:.1f} MHz, subcarrier spacing: "
          f"{sc_spacing/1e3:.1f} kHz")
    print(f"- Symbol duration (N/B): {r['symbol_duration_s']*1e6:.1f} us, "
          f"max path delay: {r['max_delay_s']*1e6:.1f} us")
    print(f"- Clipped paths: {r['n_clipped_paths']}/{r['n_total_paths']} "
          f"across {r['n_users_affected']}/{r['n_users']} users")
    print(f"- Clipped power (affected users): "
          f"mean {r['mean_clipped_power_pct']:.2f}%, "
          f"max {r['max_clipped_power_pct']:.2f}%")
    print("Paths arriving after the symbol duration are zeroed. To avoid "
          "clipping: increase subcarriers (N), decrease bandwidth (B), or "
          "switch to time-domain generation (ch_params['freq_domain'] = 0).")
    print("-" * 50)


# ============================================================================
# Beam-gain maps (Dataset and MacroDataset)
# ============================================================================

def _codebook_planes(codebook, cfg, dev):
    """(wr, wi) [n_beams, n_tx_ant] on ``dev`` in the config's real dtype,
    from a complex codebook or a (wr, wi) tuple; ValueError on a shape
    that does not fit the BS panel."""
    wdt = np.float64 if cfg.dtype == "complex128" else np.float32
    if isinstance(codebook, tuple):
        wr, wi = (np.asarray(x, wdt) for x in codebook)
    else:
        cb = np.asarray(codebook)
        wr = np.real(cb).astype(wdt)
        wi = np.imag(cb).astype(wdt)
    if wr.ndim != 2 or wr.shape != wi.shape or \
            wr.shape[1] != cfg.n_tx_ant:
        raise ValueError(
            f"codebook must be [n_beams, {cfg.n_tx_ant}] for this "
            f"antenna config; got {wr.shape}")
    return tuple(_small_tensor(x, cfg.rdtype, dev) for x in (wr, wi))


def _beam_gain_maps(pd: PathData, bs_panel, ue_panel, cfg, w,
                    to_device: bool, out=None, pol_stacks=None):
    """One beam-gain render of ``pd`` with the codebook planes ``w``:
    the raw [U, R*B, N_pol*S*K] tensor with ``to_device`` (written into
    ``out`` when it fits), else the host maps [U, R, B, K(, S)], a dict of
    them per polarization with ``pol_stacks`` (power, phase [4, U, P])."""
    n_pol = len(POLS) if pol_stacks is not None else 1
    n_ue, n_b, n_k = pd.n_ue, w[0].shape[0], cfg.n_sel_subcarriers
    n_s = _fused_n_snap(cfg)
    shape = (n_ue, cfg.n_rx_ant * n_b, n_pol * n_s * n_k)
    out = _reusable(out, shape, pd.valid.device, cfg.rdtype)
    if pol_stacks is not None:
        g = render_beam_gains_polar(pd, bs_panel, ue_panel, cfg,
                                    *pol_stacks, *w, out=out)
    else:
        g = render_beam_gains(pd, bs_panel, ue_panel, cfg, *w, out=out)
    if to_device:
        return g
    if g.is_cuda:
        with span("dm.d2h"):
            g = g.cpu()
    with span("dm.unpack"):
        arr = g.numpy().reshape(n_ue, cfg.n_rx_ant, n_b, n_pol, n_s, n_k)
        # [U, R, B, S, K] per polarization -> time axis last
        maps = [arr[:, :, :, i].transpose(0, 1, 2, 4, 3) if n_s > 1
                else arr[:, :, :, i, 0] for i in range(n_pol)]
    return dict(zip(POLS, maps)) if pol_stacks is not None else maps[0]


# ============================================================================
# Streaming renderer (host-side batching over user blocks)
# ============================================================================

def _reusable(out, shape, dev, dtype):
    """``out`` when it can take a result of ``shape`` and ``dtype`` on
    ``dev`` in place (contiguous), else None: the config changed and there
    is nothing to reuse."""
    if out is None or (tuple(out.shape) == tuple(shape) and
                       out.dtype == dtype and out.device == dev and
                       out.is_contiguous()):
        return out
    return None


def _fits_one_launch(shape, dtype, to_device: bool) -> bool:
    return to_device or int(np.prod(shape)) * dtype.itemsize <= int(
        config.get("max_device_output_bytes"))


def _chunk_store(cfg, path_data: PathData, bs_panel, ue_panel, *tensors,
                 **extra):
    """The checkpoint store of this render (``config['checkpoint_dir']``),
    or None without one. Its fingerprint hashes the configuration, the
    user count, the block size, every path matrix, both panels and
    ``tensors`` (the polarization stacks), once per call."""
    root = config.get("checkpoint_dir")
    if not root:
        return None
    block = int(config.get("user_block"))
    fields = [getattr(path_data, f.name)
              for f in dataclasses.fields(PathData)]
    store = ChunkStore(root, ChunkStore.fingerprint(
        cfg, path_data.n_ue, block,
        fields + [bs_panel.rotation_deg, bs_panel.spacing,
                  ue_panel.rotation_deg, ue_panel.spacing, *tensors],
        extra))
    store.write_manifest({"n_ue": path_data.n_ue, "block": block, **extra})
    return store


def _render_streamed(path_data: PathData, bs_panel, ue_panel, cfg,
                     to_device: bool = False, out=None):
    """Render all users' channels.

    Single launch (the output fits ``config['max_device_output_bytes']``,
    or ``to_device``): the whole user batch renders at once; ``out``, if
    its shape and dtype match, receives the result in place (the previous
    contents are overwritten), else it is ignored. Otherwise, and always
    for a host result with ``config['checkpoint_dir']`` set, streamed over
    user blocks (:func:`_stream_blocks`), resuming from the blocks already
    in the checkpoint store.
    """
    shape = render_out_shape(path_data.n_ue, cfg, path_data.max_paths)
    dtype = planes_dtype(cfg)
    store = None if to_device else _chunk_store(cfg, path_data, bs_panel,
                                                ue_panel)
    if store is None and _fits_one_launch(shape, dtype, to_device):
        h = render_channels_planes(
            path_data, bs_panel, ue_panel, cfg,
            out=_reusable(out, shape, path_data.valid.device, dtype))
        return h if to_device else unpack_planes_np(h, cfg)
    return _stream_blocks(
        path_data, bs_panel, ue_panel,
        lambda pd, bsp, uep, start, size: render_channels_planes(
            pd, bsp, uep, cfg),
        lambda planes: unpack_planes_np(planes, cfg), axis=0, store=store)


def _render_polar_streamed(path_data: PathData, bs_panel, ue_panel, cfg,
                           pol_power_dbw, pol_phase_deg,
                           to_device: bool = False, out=None):
    """Dual-polar render: one launch (with ``out`` reused as in
    :func:`_render_streamed`) or streamed over user blocks, with the same
    checkpoint rule as :func:`_render_streamed`.

    Returns host complex [N_pol, U, R, T, K], or with ``to_device`` the raw
    polar planes on the device.
    """
    n_pol = pol_power_dbw.shape[0]
    shape = polar_out_shape(path_data.n_ue, cfg, n_pol)
    dtype = out_torch_dtype(cfg.out_dtype)
    # The JAX dual-polar streamer consults its store only past the output
    # budget; here a checkpoint directory streams a host result whatever
    # its size, as for single-pol.
    store = None if to_device else _chunk_store(
        cfg, path_data, bs_panel, ue_panel, pol_power_dbw, pol_phase_deg,
        polar=n_pol)
    if store is None and _fits_one_launch(shape, dtype, to_device):
        h = render_channels_planes_polar(
            path_data, bs_panel, ue_panel, cfg, pol_power_dbw, pol_phase_deg,
            out=_reusable(out, shape, path_data.valid.device, dtype))
        if to_device:
            return h
        return unpack_polar_planes_np(h, cfg, n_pol)
    return _stream_blocks(
        path_data, bs_panel, ue_panel,
        lambda pd, bsp, uep, start, size: render_channels_planes_polar(
            pd, bsp, uep, cfg, pol_power_dbw[:, start:start + size],
            pol_phase_deg[:, start:start + size]),
        lambda planes: unpack_polar_planes_np(planes, cfg, n_pol), axis=1,
        store=store)


def _stream_blocks(path_data: PathData, bs_panel, ue_panel, render_block,
                   unpack, axis: int, store=None):
    """Render ``config['user_block']`` user blocks in turn on the current
    stream with ``render_block(pd, bs, ue, start, size)``; each block's
    device->host copy runs on a side stream into pinned memory (in the
    planes' own dtype, so bf16 planes move half the bytes) while the next
    block renders, with at most two blocks in flight. Returns the host
    blocks, each through ``unpack`` (which takes the host tensor), joined
    along ``axis``. With a checkpoint ``store``, a block already in it is
    loaded instead of rendered, and each rendered block is saved once its
    copy to the host has completed."""
    n_ue = path_data.n_ue
    block = int(config.get("user_block"))
    per_user_rot = bs_panel.rotation_deg.dim() == 2 or \
        ue_panel.rotation_deg.dim() == 2
    cuda = path_data.valid.device.type == "cuda"
    copy_stream = torch.cuda.Stream(path_data.valid.device) if cuda else None
    chunks: list = []
    inflight: list = []          # (chunk index, start, host planes, event)

    def collect(entry):
        idx, start, host, done = entry
        if done is not None:
            with span("dm.d2h"):
                done.synchronize()
        chunks[idx] = unpack(host)
        if store is not None:
            store.save_block(start, chunks[idx])

    for start in range(0, n_ue, block):
        size = min(block, n_ue - start)
        chunks.append(None)
        if store is not None and store.has_block(start):
            chunks[-1] = store.load_block(start)
            continue
        pd, bsp, uep = _slice_block(path_data, bs_panel, ue_panel,
                                    per_user_rot, start, size)
        h = render_block(pd, bsp, uep, start, size)
        if cuda:
            with span("dm.d2h"):
                host = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                copy_stream.wait_stream(torch.cuda.current_stream(h.device))
                with torch.cuda.stream(copy_stream):
                    host.copy_(h, non_blocking=True)
                    h.record_stream(copy_stream)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
        else:
            host, done = h, None
        inflight.append((len(chunks) - 1, start, host, done))
        if len(inflight) >= 2:           # bound the blocks in flight
            collect(inflight.pop(0))
    for entry in inflight:
        collect(entry)
    return np.concatenate(chunks, axis=axis)


def _slice_block(path_data: PathData, bs_panel: AntennaPanel,
                 ue_panel: AntennaPanel, per_user_rot: bool, start: int,
                 size: int):
    """Users [start, start + size) of the path data and of per-user panel
    rotations. Eager PyTorch needs no fixed block shape, so the last block
    is not padded."""
    pd = path_data.slice_users(start, size)
    if not per_user_rot:
        return pd, bs_panel, ue_panel

    def panel(p):
        if p.rotation_deg.dim() != 2:
            return p
        return AntennaPanel(rotation_deg=p.rotation_deg[start:start + size],
                            spacing=p.spacing)
    return pd, panel(bs_panel), panel(ue_panel)


# ============================================================================
# MacroDataset
# ============================================================================

def _join_paths(pds: List[PathData]) -> PathData:
    """Path data of several datasets joined on the user axis, path slots
    padded to the widest (invalid, zero); Doppler arrays kept when any
    dataset has them (zero, no Doppler phase, for the others)."""
    pmax = max(pd.max_paths for pd in pds)

    def pad(x):
        if x.shape[1] == pmax:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], pmax - x.shape[1]))],
                         dim=1)

    fields = {}
    for f in dataclasses.fields(PathData):
        xs = [getattr(pd, f.name) for pd in pds]
        if all(x is None for x in xs):
            fields[f.name] = None
            continue
        fields[f.name] = torch.cat([pad(torch.zeros_like(pd.power_dbw)
                                        if x is None else x)
                                    for x, pd in zip(xs, pds)], dim=0)
    return PathData(**fields)


def _join_panels(parts, side: str, sizes: List[int]):
    """One panel of ``side`` (bs or ue) for the joined users, from each
    child's (params, cfg, bs panel, ue panel): the first child's when
    every child has the same single rotation, else per-user rotations
    [U, 3]. Decided on the host parameters, so no device sync."""
    specs = [p[side] for p, *_ in parts]
    if len({float(s[c.PARAMSET_ANT_SPACING]) for s in specs}) > 1:
        raise ValueError("the children's antenna spacings differ; render "
                         "them one by one")
    panels = [q[2] if side == c.PARAMSET_ANT_BS else q[3] for q in parts]
    rots = [np.asarray(s[c.PARAMSET_ANT_ROTATION], np.float64)
            for s in specs]
    if all(r.shape == (3,) and np.array_equal(r, rots[0]) for r in rots):
        return panels[0]
    return AntennaPanel(
        rotation_deg=torch.cat([p.rotation_deg.expand(n, 3)
                                for p, n in zip(panels, sizes)], dim=0),
        spacing=panels[0].spacing)


class MacroDataset:
    """Container propagating attribute/method access to child Datasets
    (the TX-RX pairs of a scenario, or the snapshots of a dynamic one),
    with one-launch renders of every child."""

    SINGLE_ACCESS_METHODS = {"info"}

    PROPAGATE_METHODS = {
        name for name, _ in inspect.getmembers(Dataset,
                                               predicate=inspect.isfunction)
        if not name.startswith("__")
    }

    def __init__(self, datasets=None):
        self.datasets = datasets if datasets is not None else []

    def _get_single(self, key):
        if not self.datasets:
            raise IndexError("MacroDataset is empty")
        return self.datasets[0][key]

    def __getattr__(self, name):
        if name == "datasets":           # not set yet (copy, unpickling)
            raise AttributeError(name)
        if name in self.PROPAGATE_METHODS:
            if name in self.SINGLE_ACCESS_METHODS:
                def single_method(*args, **kwargs):
                    return getattr(self.datasets[0], name)(*args, **kwargs)
                return single_method

            def propagated(*args, **kwargs):
                results = [getattr(d, name)(*args, **kwargs)
                           for d in self.datasets]
                return results[0] if len(results) == 1 else results
            return propagated

        if name in SHARED_PARAMS:
            return self._get_single(name)

        results = [getattr(d, name) for d in self.datasets]
        return results[0] if len(results) == 1 else results

    def __getitem__(self, idx):
        if isinstance(idx, (int, slice)):
            return self.datasets[idx]
        if idx in SHARED_PARAMS:
            return self._get_single(idx)
        results = [d[idx] for d in self.datasets]
        return results[0] if len(results) == 1 else results

    def __setitem__(self, key, value):
        for d in self.datasets:
            d[key] = value

    def __len__(self):
        return len(self.datasets)

    def append(self, dataset):
        self.datasets.append(dataset)

    def _joined(self, params):
        """(cfg, path data, bs panel, ue panel) of one render of every
        child, built from the children as they are now (nothing is cached
        here: each child keeps its own device path data).

        Each child resolves (and stores) the parameters as its own
        ``compute_channels`` would, per-user UE rotations drawn for its
        own users. The configurations must agree but for the fields of
        view; where those differ, each child's FoV is folded into its
        path mask and the joined render runs without one (time-domain
        compaction on when any child's would be)."""
        for d in self.datasets:
            p = d.get(c.CH_PARAMS_PARAM_NAME) if params is None else params
            if p is not None and p.get(c.PARAMSET_POLAR_EN, 0):
                raise ValueError("the batched renders do not support "
                                 "dual-polarization; call per dataset.")
        parts = [d._channel_config(params) for d in self.datasets]
        cfgs = [p[1] for p in parts]
        cfg = cfgs[0]

        def no_fov(x):
            return x.replace(bs_fov=None, ue_fov=None)
        if any(no_fov(x) != no_fov(cfg) for x in cfgs):
            raise ValueError("the children's channel parameters differ; "
                             "render them one by one")
        pds = [d._path_data() for d in self.datasets]
        if any(x != cfg for x in cfgs):
            pds = [dataclasses.replace(pd, valid=_fov_valid(
                x, pd.valid, *_rotated_angles(pd, bs, ue)))
                for pd, (_, x, bs, ue) in zip(pds, parts)]
            compact = cfg.compact_td_paths
            if compact == "auto":
                compact = any(_td_compact_active(x) for x in cfgs)
            cfg = no_fov(cfg).replace(compact_td_paths=compact)
        sizes = [pd.n_ue for pd in pds]
        return (cfg, _join_paths(pds),
                _join_panels(parts, c.PARAMSET_ANT_BS, sizes),
                _join_panels(parts, c.PARAMSET_ANT_UE, sizes))

    def _split(self, arr, widths=None):
        """Per-child slices of a joined host result (the time domain's
        path axis cut to each child's own width)."""
        out, start = [], 0
        for i, d in enumerate(self.datasets):
            part = arr[start:start + d.n_ue]
            if widths is not None:
                part = part[:, :, :, :widths[i]]
            out.append(part)
            start += d.n_ue
        return out

    def compute_channels_batched(self, params=None, to_device: bool = False,
                                 out=None):
        """Channels of every child in ONE render: the children's path data
        joined on the user axis (path slots padded to the widest child),
        one launch of the render kernel on a card.

        Returns a list of per-child channel arrays, each equal to the
        child's own ``compute_channels`` (not cached on the child), or
        with ``to_device`` the joined planes (children in order on the
        user axis), written into ``out`` when it fits. Dual-polarization
        raises ValueError (call per dataset).
        """
        if not self.datasets:
            raise IndexError("MacroDataset is empty")
        if len(self.datasets) == 1:
            res = self.datasets[0].compute_channels(
                params, to_device=to_device, out=out)
            return res if to_device else [res]
        cfg, pd, bs, ue = self._joined(params)
        ch = _render_streamed(pd, bs, ue, cfg, to_device=to_device, out=out)
        if to_device:
            return ch
        widths = None if cfg.freq_domain else [
            min(cfg.num_paths, d._path_data().max_paths)
            for d in self.datasets]
        return self._split(ch, widths)

    def compute_beam_gains_batched(self, params=None, codebook=None,
                                   to_device: bool = False):
        """Beam-gain maps of every child in ONE launch of the beam-gain
        kernel (children joined on the user axis as in
        :meth:`compute_channels_batched`; H is never formed). Returns a
        list of per-child [n_ue, R, B, K] maps, or with ``to_device`` the
        joined raw tensor."""
        if not self.datasets:
            raise IndexError("MacroDataset is empty")
        if len(self.datasets) == 1:
            res = self.datasets[0].compute_beam_gains(
                params, codebook=codebook, to_device=to_device)
            return res if to_device else [res]
        if codebook is None:
            raise ValueError("compute_beam_gains_batched requires a "
                             "codebook")
        cfg, pd, bs, ue = self._joined(params)
        g = _beam_gain_maps(pd, bs, ue, cfg,
                            _codebook_planes(codebook, cfg, pd.valid.device),
                            to_device)
        return g if to_device else self._split(g)
