"""Parameter help registry: shapes, units, and meaning of every dataset key.

Exposed as ``info()`` / ``Dataset.info()``. Copied from
``deepmimo_tpu/info.py``.
"""

from __future__ import annotations

from typing import Optional

from . import consts as c

_INFO = {
    c.POWER_PARAM_NAME: (
        "Path received powers in dBW, shape [n_ue, n_paths]. Assumes 0 dBW "
        "(1 W) transmit power; padded path slots are NaN."),
    c.PHASE_PARAM_NAME: (
        "Path phases in degrees, shape [n_ue, n_paths]."),
    c.DELAY_PARAM_NAME: (
        "Path propagation delays (times of arrival) in seconds, shape "
        "[n_ue, n_paths]."),
    c.AOA_AZ_PARAM_NAME: (
        "Azimuth angles of arrival in degrees, shape [n_ue, n_paths]."),
    c.AOA_EL_PARAM_NAME: (
        "Elevation angles of arrival in degrees (measured from the z-axis), "
        "shape [n_ue, n_paths]."),
    c.AOD_AZ_PARAM_NAME: (
        "Azimuth angles of departure in degrees, shape [n_ue, n_paths]."),
    c.AOD_EL_PARAM_NAME: (
        "Elevation angles of departure in degrees, shape [n_ue, n_paths]."),
    c.RX_POS_PARAM_NAME: (
        "Receiver (user) positions in meters, shape [n_ue, 3]."),
    c.TX_POS_PARAM_NAME: (
        "Transmitter position in meters, shape [1, 3]."),
    c.INTERACTIONS_PARAM_NAME: (
        "Path interaction codes, shape [n_ue, n_paths]. Each digit (left to "
        "right from the TX) encodes a bounce: 0=LoS, 1=reflection, "
        "2=diffraction, 3=scattering, 4=transmission. E.g. 112 = "
        "reflection, reflection, diffraction."),
    c.INTERACTIONS_POS_PARAM_NAME: (
        "3D positions of each path interaction, shape "
        "[n_ue, n_paths, max_inter, 3]."),
    c.CHANNEL_PARAM_NAME: (
        "MIMO channel matrices. OFDM: [n_ue, n_rx_ant, n_tx_ant, "
        "n_subcarriers]; time domain: [n_ue, n_rx_ant, n_tx_ant, n_paths]. "
        "With multi-snapshot Doppler an extra trailing time axis is added."),
    c.NUM_PATHS_PARAM_NAME: (
        "Number of valid (in-FoV) paths per user, shape [n_ue]."),
    c.NUM_INTERACTIONS_PARAM_NAME: (
        "Number of interactions of each path, shape [n_ue, n_paths]."),
    c.PWR_LINEAR_PARAM_NAME: (
        "Path powers in linear scale (Watts), shape [n_ue, n_paths]."),
    c.PATHLOSS_PARAM_NAME: (
        "Path loss in dB from the coherent sum of path gains, shape [n_ue]."),
    c.DIST_PARAM_NAME: (
        "3D TX-RX distances in meters, shape [n_ue]."),
    c.LOS_PARAM_NAME: (
        "Line-of-sight status per user: 1 = LoS, 0 = NLoS, -1 = no paths."),
    c.INTER_STR_PARAM_NAME: (
        "Interaction strings per path, e.g. '' (LoS), 'RRD', 'n' (no path)."),
    c.INTER_INT_PARAM_NAME: (
        "Interaction codes as integers with NaN replaced by -1."),
    c.N_UE_PARAM_NAME: "Number of users (receivers) in the dataset.",
    c.CH_PARAMS_PARAM_NAME: (
        "ChannelGenParameters used for the last channel computation."),
    c.AOA_AZ_ROT_PARAM_NAME: (
        "Azimuth AoA after UE array rotation, radians, [n_ue, n_paths]."),
    c.AOA_EL_ROT_PARAM_NAME: (
        "Elevation AoA after UE array rotation, radians, [n_ue, n_paths]."),
    c.AOD_AZ_ROT_PARAM_NAME: (
        "Azimuth AoD after BS array rotation, radians, [n_ue, n_paths]."),
    c.AOD_EL_ROT_PARAM_NAME: (
        "Elevation AoD after BS array rotation, radians, [n_ue, n_paths]."),
    c.FOV_MASK_PARAM_NAME: (
        "Boolean field-of-view mask, [n_ue, n_paths] (None if FoV unset)."),
    c.PWR_LINEAR_ANT_GAIN_PARAM_NAME: (
        "Linear powers with antenna pattern gains applied, [n_ue, n_paths]."),
    "grid_size": "User grid dimensions [n_x, n_y] inferred from rx_pos.",
    "grid_spacing": "User grid spacing [dx, dy] in meters.",
    c.DOPPLER_VEL_PARAM_NAME: (
        "Per-path radial velocity in m/s (mobility scenarios), "
        "[n_ue, n_paths]."),
    c.DOPPLER_ACC_PARAM_NAME: (
        "Per-path radial acceleration in m/s^2 (mobility scenarios), "
        "[n_ue, n_paths]."),
    # Scenario metadata attached by load()
    "txrx_sets": (
        "Transmitter/receiver set definitions from params.json: per-set "
        "id, role (tx/rx), number of points and antennas."),
    "rt_params": (
        "Ray-tracing parameters the scenario was generated with: carrier "
        "frequency, bounce limits (reflection/diffraction/scattering/"
        "transmission), ray counts, GPS bounding box."),
    "scene": (
        "Scene object holding the 3D geometry (vertices, faces, objects) "
        "used by the ray tracer; supports 2D/3D plotting."),
    "materials": (
        "MaterialList of electromagnetic materials in the scene: "
        "permittivity, conductivity, scattering model and coefficients."),
    # ChannelGenParameters fields
    "bs_antenna": (
        "BS antenna settings group: shape, spacing, rotation, "
        "radiation_pattern (and FoV when set)."),
    "bs_antenna.shape": (
        "BS panel dimensions [horizontal, vertical]; e.g. [8, 1] is an "
        "8-element uniform linear array. Default [8, 1]."),
    "bs_antenna.spacing": (
        "BS element spacing in wavelengths. Default 0.5."),
    "bs_antenna.rotation": (
        "BS array rotation [az, el, tilt] in degrees. Default [0, 0, 0]."),
    "bs_antenna.radiation_pattern": (
        "BS element pattern: 'isotropic' (default) or 'halfwave-dipole'."),
    "ue_antenna": (
        "UE antenna settings group: same fields as bs_antenna; rotation "
        "may be a [3, 2] range to draw one random rotation per user. "
        "Default shape [1, 1]."),
    "ofdm": (
        "OFDM settings group: subcarriers, selected_subcarriers, "
        "bandwidth, rx_filter."),
    "ofdm.subcarriers": (
        "FFT size (total number of subcarriers). Default 512."),
    "ofdm.selected_subcarriers": (
        "Indices of the subcarriers to generate (subset of the FFT). "
        "Default [0]."),
    "ofdm.bandwidth": (
        "Total OFDM bandwidth in Hz; sets the subcarrier spacing "
        "(bandwidth / subcarriers). Default 10e6."),
    "ofdm.rx_filter": (
        "Receive low-pass (sinc) filter applied to path delays before the "
        "subcarrier DFT. 0 = off (default), 1 = on."),
    "freq_domain": (
        "1 = OFDM frequency-domain channels (default); 0 = time-domain "
        "per-path complex gains."),
    "enable_doppler": (
        "1 = apply per-path Doppler phase rotations from path velocity/"
        "acceleration over time snapshots. Default 0."),
    "enable_dual_polar": (
        "1 = generate dual-polarized (VV/VH/HV/HH) channels when the "
        "scenario provides cross-polarized path data. Default 0."),
}


def info(param_name: Optional[str] = None) -> None:
    """Print help for one dataset parameter, or all of them."""
    if param_name is None or param_name == "all":
        print("DeepMIMO dataset parameters:\n")
        for name, text in _INFO.items():
            print(f"{name}:\n  {text}\n")
        return
    resolved = c.DATASET_ALIASES.get(param_name, param_name)
    if resolved in _INFO:
        print(f"{resolved}:\n  {_INFO[resolved]}")
    else:
        print(f"No info available for '{param_name}'. "
              f"Known parameters: {sorted(_INFO)}")
