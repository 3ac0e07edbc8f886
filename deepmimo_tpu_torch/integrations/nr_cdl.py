"""5G NR CDL channel-parameter export (Python-native nrCDLChannel bridge).

The reference's only NR-grade channel model lives in its MATLAB 5G Toolbox
bridge: per-user `nrCDLChannel` objects built from ray data with Doppler
from UE velocity, array orientation, and polarization (reference
deepmimo/integrations/matlab/DeepMIMO-5GNR/DeepMIMO_functions/
construct_DeepMIMO_CDL_channel.m:8-56, parameters.m:28-121). This module
produces the same per-user parameter set natively:

- `export_cdl(dataset, cfg)` -> list of per-user dicts whose keys mirror the
  nrCDLChannel property names (PathDelays, AveragePathGains, AnglesAoD/ZoD/
  AoA/ZoA, HasLOSCluster, MaximumDopplerShift, UTDirectionOfTravel,
  TransmitArrayOrientation, ...), ready for scipy.io.savemat or JSON.
- `save_cdl_mat(users, path)` -> one .mat file MATLAB can feed straight
  into nrCDLChannel('DelayProfile','Custom', ...).
- `synthesize_cdl_cir(user, t)` -> numpy consumer: evaluates the exported
  parameters into a time-varying CIR, proving the export is complete.

NR OFDM numerology follows TS 38.211: sample rate = FFT size x SCS with the
FFT the smallest power of two fitting 12*NRB subcarriers at 85% occupancy
(what MATLAB's nrOFDMInfo computes for normal CP).

Host numpy code, copied from ``deepmimo_tpu/integrations/nr_cdl.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import consts as c

LIGHTSPEED = c.LIGHTSPEED


@dataclasses.dataclass
class CDLConfig:
    """Knobs of the reference's params.CDL_5G block (parameters.m:28-121)."""

    nrb: int = 24                     # NR resource blocks
    scs_khz: int = 30                 # subcarrier spacing (kHz)
    num_slots: int = 4
    # UE velocity in km/h: scalar, or (lo, hi) drawn per user
    velocity_kmh: object = (1.0, 20.0)
    # UT direction of travel (degrees): (az, el), or ((az_lo, az_hi),
    # (el_lo, el_hi)) drawn per user
    travel_dir_deg: object = ((0.0, 360.0), (90.0, 90.0))
    xpr_db: float = 10.0
    polarization: int = 0             # 0 -> single, 1 -> dual (cross-pol)
    bs_ant_size: Tuple[int, int] = (4, 8)
    ue_ant_size: Tuple[int, int] = (2, 2)
    bs_orientation_deg: Tuple[float, float] = (0.0, 0.0)   # (bearing, el)
    ue_orientation_deg: Tuple[float, float] = (-180.0, 0.0)
    seed: int = 5                     # nrCDLChannel RandomStream seed

    @property
    def sample_rate(self) -> float:
        """NR OFDM sample rate for (nrb, scs): fft_size * scs."""
        n_sc = 12 * self.nrb
        fft = 128
        while fft < n_sc / 0.85:
            fft *= 2
        return fft * self.scs_khz * 1e3

    @property
    def slots_per_subframe(self) -> int:
        return self.scs_khz // 15

    @property
    def num_time_samples(self) -> int:
        """Samples covering num_slots (+10% guard), one subframe = 1 ms."""
        return int(np.ceil((self.num_slots + 0.1) * self.sample_rate /
                           self.slots_per_subframe * 1e-3))


def _draw(spec, rng, n):
    """Materialize a scalar / (lo, hi) range spec into [n] draws."""
    arr = np.asarray(spec, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(n, float(arr))
    return rng.uniform(arr[0], arr[1], n)


def export_cdl(dataset, cfg: Optional[CDLConfig] = None,
               rng: Optional[np.random.RandomState] = None
               ) -> List[Dict]:
    """Build per-user nrCDLChannel parameter dicts from a Dataset.

    Angle/zenith conventions follow the MATLAB bridge
    (construct_DeepMIMO_CDL_channel.m:16-21): ray elevations feed the
    Zo* properties directly, azimuths the Ao* properties; array
    orientations are [bearing; -elevation; 0] (downtilt sign flip);
    MaximumDopplerShift = v/3.6 / c * fc.
    """
    cfg = cfg or CDLConfig()
    rng = rng or np.random.RandomState(cfg.seed)

    power = np.asarray(dataset[c.POWER_PARAM_NAME], dtype=np.float64)
    delay = np.asarray(dataset[c.DELAY_PARAM_NAME], dtype=np.float64)
    phase = np.asarray(dataset[c.PHASE_PARAM_NAME], dtype=np.float64)
    aoa_az = np.asarray(dataset[c.AOA_AZ_PARAM_NAME], dtype=np.float64)
    aoa_el = np.asarray(dataset[c.AOA_EL_PARAM_NAME], dtype=np.float64)
    aod_az = np.asarray(dataset[c.AOD_AZ_PARAM_NAME], dtype=np.float64)
    aod_el = np.asarray(dataset[c.AOD_EL_PARAM_NAME], dtype=np.float64)
    try:
        los = np.asarray(dataset["los"])
    except (KeyError, AttributeError):
        los = None

    rt = dataset.get(c.RT_PARAMS_PARAM_NAME) if hasattr(dataset, "get") \
        else None
    fc = float(rt[c.RT_PARAM_FREQUENCY]) if rt else 3.5e9

    n_ue = power.shape[0]
    vel = _draw(cfg.velocity_kmh, rng, n_ue)
    trav = np.asarray(cfg.travel_dir_deg, dtype=np.float64)
    if trav.ndim == 1:
        trav_az = np.full(n_ue, trav[0])
        trav_el = np.full(n_ue, trav[1])
    else:
        trav_az = rng.uniform(trav[0, 0], trav[0, 1], n_ue)
        trav_el = rng.uniform(trav[1, 0], trav[1, 1], n_ue)

    bs_orient = [cfg.bs_orientation_deg[0], -cfg.bs_orientation_deg[1], 0.0]
    ue_orient = [cfg.ue_orientation_deg[0], -cfg.ue_orientation_deg[1], 0.0]
    n_pol = cfg.polarization + 1

    users = []
    for u in range(n_ue):
        m = ~np.isnan(power[u])
        if not m.any():
            users.append(None)
            continue
        has_los = bool(los[u] == 1) if los is not None else False
        users.append({
            "DelayProfile": "Custom",
            "PathDelays": delay[u][m],
            "AveragePathGains": power[u][m],          # dB (ray power dBW)
            "PathPhases": phase[u][m],                # extra info (degrees)
            "AnglesAoD": aod_az[u][m],
            "AnglesZoD": aod_el[u][m],
            "AnglesAoA": aoa_az[u][m],
            "AnglesZoA": aoa_el[u][m],
            "HasLOSCluster": has_los,
            "CarrierFrequency": fc,
            "MaximumDopplerShift": (vel[u] / 3.6) / LIGHTSPEED * fc,
            "UTVelocityKmh": vel[u],
            "UTDirectionOfTravel": [trav_az[u], trav_el[u]],
            "NormalizeChannelOutputs": False,
            "NormalizePathGains": False,
            "RandomStream": "mt19937ar with seed",
            "Seed": cfg.seed,
            "XPR": cfg.xpr_db,
            "TransmitArrayOrientation": bs_orient,
            "ReceiveArrayOrientation": ue_orient,
            "TransmitAntennaArraySize":
                list(cfg.bs_ant_size) + [n_pol, 1, 1],
            "ReceiveAntennaArraySize":
                list(cfg.ue_ant_size) + [n_pol, 1, 1],
            "SampleRate": cfg.sample_rate,
            "SampleDensity": 64,
            "ChannelFiltering": False,
            "NumTimeSamples": cfg.num_time_samples,
        })
    return users


def save_cdl_mat(users: Sequence[Optional[Dict]], path: str) -> str:
    """Write the per-user CDL parameters as one MATLAB struct array.

    MATLAB consumption: ``s = load(path); p = s.cdl_users(u);`` then assign
    each field onto an nrCDLChannel (the field names are the property
    names). Inactive users carry NumPaths=0.
    """
    import scipy.io

    records = []
    for user in users:
        if user is None:
            records.append({"NumPaths": 0})
        else:
            records.append({k: v for k, v in user.items()} |
                           {"NumPaths": len(user["PathDelays"])})
    scipy.io.savemat(path, {"cdl_users": records}, long_field_names=True)
    return path


def synthesize_cdl_cir(user: Dict, t: np.ndarray) -> np.ndarray:
    """Numpy consumer: per-path complex gains over time from CDL params.

    a_p(t) = 10^(G_p/20) * exp(j phi_p) * exp(j 2 pi f_d cos(alpha_p) t)
    with f_d the exported MaximumDopplerShift and alpha_p the angle between
    the path's arrival direction and the UT travel direction — the standard
    CDL per-path Doppler (TS 38.901 eq. 7.5-22 simplified to the ray's
    plane wave). Returns [len(t), n_paths].
    """
    gains = 10.0 ** (np.asarray(user["AveragePathGains"]) / 20.0)
    phases = np.deg2rad(np.asarray(user.get(
        "PathPhases", np.zeros_like(gains))))
    fd = float(user["MaximumDopplerShift"])

    zoa = np.deg2rad(np.asarray(user["AnglesZoA"]))
    aoa = np.deg2rad(np.asarray(user["AnglesAoA"]))
    trav_az, trav_el = np.deg2rad(np.asarray(
        user["UTDirectionOfTravel"], dtype=np.float64))

    # Unit vectors: ray arrival direction and UT travel direction
    ray = np.stack([np.sin(zoa) * np.cos(aoa),
                    np.sin(zoa) * np.sin(aoa),
                    np.cos(zoa)], axis=-1)              # [P, 3]
    ut = np.array([np.sin(trav_el) * np.cos(trav_az),
                   np.sin(trav_el) * np.sin(trav_az),
                   np.cos(trav_el)])
    cos_alpha = ray @ ut                                 # [P]

    t = np.asarray(t, dtype=np.float64)[:, None]
    return (gains * np.exp(1j * phases) *
            np.exp(2j * np.pi * fd * cos_alpha * t))
