"""PyTorch compute core: channel synthesis on tensors.

Counterpart of ``deepmimo_tpu.ops``. Inside ops: radians and linear power;
validity masks instead of NaN padding. The hand-written CUDA kernels live
in ``ops.kernels``.
"""

from .types import (AntennaPanel, ChannelConfig, PathData,
                    calib_params_from_numpy, state_from_numpy)
from .geometry import (
    ant_indices,
    apply_fov,
    array_response,
    array_response_planes,
    rotate_angles,
    rotate_unit_vec,
    safe_arccos,
    steering_vec,
)
from .patterns import PATTERN_REGISTRY, pattern_gain
from .channel import (beam_gain_eligible, polar_fused_eligible,
                      render_beam_gains, render_beam_gains_polar,
                      render_channels, render_channels_and_grads,
                      render_channels_planes, render_channels_planes_polar,
                      unpack_planes_np, unpack_polar_planes_np)

__all__ = [
    "AntennaPanel", "ChannelConfig", "PathData", "state_from_numpy",
    "calib_params_from_numpy",
    "ant_indices", "apply_fov", "array_response", "array_response_planes",
    "rotate_angles", "rotate_unit_vec", "safe_arccos", "steering_vec",
    "PATTERN_REGISTRY", "pattern_gain",
    "render_channels", "render_channels_and_grads",
    "render_channels_planes", "unpack_planes_np", "beam_gain_eligible",
    "render_beam_gains", "polar_fused_eligible",
    "render_channels_planes_polar", "render_beam_gains_polar",
    "unpack_polar_planes_np",
]
