"""Schema constants for the DeepMIMO-TPU framework.

These string keys define the on-disk scenario format (params.json keys, matrix
file names) and the channel-generation parameter schema. The values must match
the DeepMIMO scenario format so that scenarios produced by either toolchain are
interchangeable (format parity with reference deepmimo/consts.py:1-334).

Everything here is *data schema*, not code: interaction codes, matrix names,
parameter-set keys, and user-facing aliases.
"""

import numpy as np

__version__ = "0.1.0"

# =============================================================================
# 1. Core configuration
# =============================================================================

VERSION_PARAM_NAME = "version"
VERSION = __version__

SCENARIOS_FOLDER = "deepmimo_scenarios"
PARAMS_FILENAME = "params"

# Floating point precision for values saved to disk
FP_TYPE = np.float32

NAME_PARAM_NAME = "name"
LOAD_PARAMS_PARAM_NAME = "load_params"

# Supported ray tracers (same engine names as the scenario format)
RAYTRACER_NAME_WIRELESS_INSITE = "Remcom Wireless Insite"
RAYTRACER_VERSION_WIRELESS_INSITE = "3.3.0"
RAYTRACER_NAME_SIONNA = "Sionna Ray Tracing"
RAYTRACER_VERSION_SIONNA = "0.19.2"
RAYTRACER_NAME_AODT = "Aerial Omniverse Digital Twin"
RAYTRACER_VERSION_AODT = "1.x"

SUPPORTED_RAYTRACERS = [RAYTRACER_NAME_WIRELESS_INSITE, RAYTRACER_NAME_SIONNA]
SUPPORTED_WIRELESS_INSITE_VERSIONS = ["3.3.x", "4.0.x"]
SUPPORTED_SIONNA_VERSIONS = ["0.19.x"]
SUPPORTED_AODT_VERSIONS = []

# =============================================================================
# 2. Ray-tracing parameters (params.json keys)
# =============================================================================

RT_PARAMS_PARAM_NAME = "rt_params"

RT_PARAM_FREQUENCY = "frequency"
RT_PARAM_RAYTRACER = "raytracer_name"
RT_PARAM_RAYTRACER_VERSION = "raytracer_version"

RT_PARAM_PATH_DEPTH = "max_path_depth"
RT_PARAM_MAX_REFLECTIONS = "max_reflections"
RT_PARAM_MAX_DIFFRACTIONS = "max_diffractions"
RT_PARAM_MAX_SCATTERING = "max_scattering"
RT_PARAM_MAX_TRANSMISSIONS = "max_transmissions"

RT_PARAM_DIFFUSE_REFLECTIONS = "diffuse_reflections"
RT_PARAM_DIFFUSE_DIFFRACTIONS = "diffuse_diffractions"
RT_PARAM_DIFFUSE_TRANSMISSIONS = "diffuse_transmissions"
RT_PARAM_DIFFUSE_FINAL_ONLY = "diffuse_final_interaction_only"
RT_PARAM_DIFFUSE_RANDOM_PHASES = "diffuse_random_phases"

RT_PARAM_TERRAIN_REFLECTION = "terrain_reflection"
RT_PARAM_TERRAIN_DIFFRACTION = "terrain_diffraction"
RT_PARAM_TERRAIN_SCATTERING = "terrain_scattering"

RT_PARAM_NUM_RAYS = "num_rays"
RT_PARAM_RAY_CASTING_METHOD = "ray_casting_method"
RT_PARAM_SYNTHETIC_ARRAY = "synthetic_array"
RT_PARAM_RAY_CASTING_RANGE_AZ = "ray_casting_range_az"
RT_PARAM_RAY_CASTING_RANGE_EL = "ray_casting_range_el"

RT_PARAM_GPS_BBOX = "gps_bbox"

# =============================================================================
# 3. Scene parameters
# =============================================================================

SCENE_PARAM_NAME = "scene"
SCENE_PARAM_NUMBER_SCENES = "num_scenes"
SCENE_PARAM_OBJECTS = "objects"
SCENE_PARAM_FACES = "faces"
SCENE_PARAM_N_OBJECTS = "n_objects"
SCENE_PARAM_N_VERTICES = "n_vertices"
SCENE_PARAM_N_FACES = "n_faces"
SCENE_PARAM_N_TRIANGULAR_FACES = "n_triangular_faces"

# =============================================================================
# 4. Materials parameters
# =============================================================================

MATERIALS_PARAM_NAME = "materials"
MATERIALS_PARAM_NAME_FIELD = "name"
MATERIALS_PARAM_PERMITTIVITY = "permittivity"
MATERIALS_PARAM_CONDUCTIVITY = "conductivity"
MATERIALS_PARAM_SCATTERING_MODEL = "scattering_model"
MATERIALS_PARAM_SCATTERING_COEF = "scattering_coefficient"
MATERIALS_PARAM_CROSS_POL_COEF = "cross_polarization_coefficient"

# =============================================================================
# 5. TXRX parameters
# =============================================================================

TXRX_PARAM_NAME = "txrx_sets"
TXRX_PARAM_NAME_FIELD = "name"
TXRX_PARAM_IS_TX = "is_tx"
TXRX_PARAM_IS_RX = "is_rx"
TXRX_PARAM_NUM_POINTS = "num_points"
TXRX_PARAM_NUM_ACTIVE_POINTS = "num_active_points"
TXRX_PARAM_NUM_ANT = "num_ant"
TXRX_PARAM_DUAL_POL = "dual_pol"
TXRX_PARAM_ANT_REL_POS = "ant_rel_pos"
TXRX_PARAM_ANT_ARRAY_ORIENTATION = "ant_array_orientation"

# =============================================================================
# 6. Path parameters
# =============================================================================

# Interaction codes: each digit of the per-path integer encodes one bounce,
# read left-to-right starting at the transmitter.
INTERACTION_LOS = 0
INTERACTION_REFLECTION = 1
INTERACTION_DIFFRACTION = 2
INTERACTION_SCATTERING = 3
INTERACTION_TRANSMISSION = 4

MAX_PATHS = 25
MAX_INTER_PER_PATH = 10

# =============================================================================
# 7. DeepMIMO matrices (on-disk + derived names)
# =============================================================================

# Fundamental per-scenario matrices (11)
POWER_PARAM_NAME = "power"          # dBW
PHASE_PARAM_NAME = "phase"          # degrees
DELAY_PARAM_NAME = "delay"          # seconds
AOA_AZ_PARAM_NAME = "aoa_az"        # degrees
AOA_EL_PARAM_NAME = "aoa_el"        # degrees
AOD_AZ_PARAM_NAME = "aod_az"        # degrees
AOD_EL_PARAM_NAME = "aod_el"        # degrees
RX_POS_PARAM_NAME = "rx_pos"
TX_POS_PARAM_NAME = "tx_pos"
INTERACTIONS_PARAM_NAME = "inter"
INTERACTIONS_POS_PARAM_NAME = "inter_pos"

ALL_MATRIX_NAMES = [
    AOA_AZ_PARAM_NAME, AOA_EL_PARAM_NAME,
    AOD_AZ_PARAM_NAME, AOD_EL_PARAM_NAME,
    POWER_PARAM_NAME, PHASE_PARAM_NAME, DELAY_PARAM_NAME,
    RX_POS_PARAM_NAME, TX_POS_PARAM_NAME,
    INTERACTIONS_PARAM_NAME, INTERACTIONS_POS_PARAM_NAME,
]

# Optional extra matrices (Doppler-capable scenarios)
DOPPLER_VEL_PARAM_NAME = "doppler_vel"   # radial velocity per path [m/s]
DOPPLER_ACC_PARAM_NAME = "doppler_acc"   # radial acceleration per path [m/s^2]

# Derived quantities
CHANNEL_PARAM_NAME = "channel"
CH_PARAMS_PARAM_NAME = "ch_params"
LOS_PARAM_NAME = "los"
NUM_PATHS_PARAM_NAME = "num_paths"
PWR_LINEAR_PARAM_NAME = "power_linear"
PATHLOSS_PARAM_NAME = "pathloss"
DIST_PARAM_NAME = "distance"
INTER_STR_PARAM_NAME = "inter_str"
INTER_INT_PARAM_NAME = "inter_int"
N_UE_PARAM_NAME = "n_ue"
NUM_INTERACTIONS_PARAM_NAME = "num_interactions"
NUM_PATHS_FOV_PARAM_NAME = "_num_paths_fov"

# Rotated angles (radians, after antenna rotation)
AOA_AZ_ROT_PARAM_NAME = "_aoa_az_rot"
AOA_EL_ROT_PARAM_NAME = "_aoa_el_rot"
AOD_AZ_ROT_PARAM_NAME = "_aod_az_rot"
AOD_EL_ROT_PARAM_NAME = "_aod_el_rot"

# FoV-filtered rotated angles (radians)
AOD_EL_FOV_PARAM_NAME = "_aod_el_rot_fov"
AOD_AZ_FOV_PARAM_NAME = "_aod_az_rot_fov"
AOA_EL_FOV_PARAM_NAME = "_aoa_el_rot_fov"
AOA_AZ_FOV_PARAM_NAME = "_aoa_az_rot_fov"
FOV_MASK_PARAM_NAME = "_fov_mask"

PWR_LINEAR_ANT_GAIN_PARAM_NAME = "_power_linear_ant_gain"

# =============================================================================
# 8. Channel generation parameters
# =============================================================================

PARAMSET_POLAR_EN = "enable_dual_polar"
PARAMSET_DOPPLER_EN = "enable_doppler"
PARAMSET_FD_CH = "freq_domain"
PARAMSET_NUM_PATHS = "num_paths"

PARAMSET_OFDM = "ofdm"
PARAMSET_OFDM_SC_NUM = "subcarriers"
PARAMSET_OFDM_SC_SAMP = "selected_subcarriers"
PARAMSET_OFDM_BANDWIDTH = "bandwidth"
PARAMSET_OFDM_LPF = "rx_filter"

PARAMSET_ANT_BS = "bs_antenna"
PARAMSET_ANT_UE = "ue_antenna"
PARAMSET_ANT_SHAPE = "shape"
PARAMSET_ANT_SPACING = "spacing"
PARAMSET_ANT_ROTATION = "rotation"
PARAMSET_ANT_RAD_PAT = "radiation_pattern"
PARAMSET_ANT_RAD_PAT_VALS = ["isotropic", "halfwave-dipole"]

# Doppler extension (time-snapshot axis)
PARAMSET_DOPPLER_TIMES = "doppler_times"        # sample instants [s]
PARAMSET_CARRIER_FREQ = "carrier_freq"          # Hz (for Doppler phase)

# =============================================================================
# 9. Dataset attribute aliases
# =============================================================================

DATASET_ALIASES = {
    "los_status": LOS_PARAM_NAME,

    "ch": CHANNEL_PARAM_NAME,
    "chs": CHANNEL_PARAM_NAME,
    "channels": CHANNEL_PARAM_NAME,

    "channel_params": CH_PARAMS_PARAM_NAME,

    "pwr": POWER_PARAM_NAME,
    "powers": POWER_PARAM_NAME,
    "lin_pwr": PWR_LINEAR_PARAM_NAME,
    "linear_power": PWR_LINEAR_PARAM_NAME,
    "pwr_lin": PWR_LINEAR_PARAM_NAME,
    "pwr_ant_gain": PWR_LINEAR_ANT_GAIN_PARAM_NAME,

    "ue_pos": RX_POS_PARAM_NAME,
    "rx_loc": RX_POS_PARAM_NAME,
    "rx_position": RX_POS_PARAM_NAME,
    "rx_locations": RX_POS_PARAM_NAME,
    "bs_pos": TX_POS_PARAM_NAME,
    "tx_loc": TX_POS_PARAM_NAME,
    "tx_position": TX_POS_PARAM_NAME,
    "tx_locations": TX_POS_PARAM_NAME,

    "pl": PATHLOSS_PARAM_NAME,
    "path_loss": PATHLOSS_PARAM_NAME,

    "dist": DIST_PARAM_NAME,
    "distance": DIST_PARAM_NAME,
    "dists": DIST_PARAM_NAME,

    "aoa_phi": AOA_AZ_PARAM_NAME,
    "aoa_theta": AOA_EL_PARAM_NAME,
    "aod_phi": AOD_AZ_PARAM_NAME,
    "aod_theta": AOD_EL_PARAM_NAME,

    "n_paths": NUM_PATHS_PARAM_NAME,

    "toa": DELAY_PARAM_NAME,
    "time_of_arrival": DELAY_PARAM_NAME,

    "bounce_type": INTERACTIONS_PARAM_NAME,
    "interactions": INTERACTIONS_PARAM_NAME,
    "bounce_pos": INTERACTIONS_POS_PARAM_NAME,
    "interaction_positions": INTERACTIONS_POS_PARAM_NAME,
    "interaction_locations": INTERACTIONS_POS_PARAM_NAME,

    "tx_rx": TXRX_PARAM_NAME,
}

# =============================================================================
# 10. Physical constants & misc
# =============================================================================

LIGHTSPEED = 299_792_458.0  # m/s

SCENARIO_NAME_INVALID_CHARS = [
    "/", "\\", ":", "*", "?", '"', "'", "<", ">", "|", "\n",
]

BBOX_PAD = 30  # meters of padding around OSM bounding boxes
