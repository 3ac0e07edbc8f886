"""DeepMIMO-TPU, PyTorch/CUDA port: site-specific MIMO channel generation.

The second package of the repository, beside the JAX reference
``deepmimo_tpu``: the same scenario format, parameters and channel math,
with plain tensor code in PyTorch and the hot paths in hand-written CUDA
kernels for NVIDIA Hopper: the render (also of all four polarizations
of a dual-polar scenario in one launch), its backward for the
differentiable calibration step (``deepmimo_tpu_torch.parallel``), the
path sum, and codebook beam-gain maps that never form the channel. It imports torch and numpy/scipy, never jax. Tensors live on
``config['device']`` (default ``"cuda"``).
"""

__version__ = "0.1.0"

from . import consts
from .config import config
from .ops import (AntennaPanel, ChannelConfig, PathData, render_beam_gains,
                  render_beam_gains_polar, render_channels,
                  render_channels_and_grads, render_channels_planes_polar)
from .generator import ChannelGenParameters, Dataset, generate, load

__all__ = [
    "Dataset", "ChannelGenParameters", "load", "generate",
    "PathData", "AntennaPanel", "ChannelConfig", "render_channels",
    "render_channels_and_grads", "render_beam_gains",
    "render_beam_gains_polar", "render_channels_planes_polar", "config",
    "consts",
]
