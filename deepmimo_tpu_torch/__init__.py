"""DeepMIMO-TPU, PyTorch/CUDA port: site-specific MIMO channel generation.

The second package of the repository, beside the JAX reference
``deepmimo_tpu``: the same scenario format, parameters and channel math,
with plain tensor code in PyTorch and the hot render in a hand-written
CUDA kernel for NVIDIA Hopper. It imports torch and numpy/scipy, never
jax. Tensors live on ``config['device']`` (default ``"cuda"``).
"""

__version__ = "0.1.0"

from . import consts
from .config import config
from .ops import AntennaPanel, ChannelConfig, PathData
from .generator import ChannelGenParameters, Dataset, generate, load

__all__ = [
    "Dataset", "ChannelGenParameters", "load", "generate",
    "PathData", "AntennaPanel", "ChannelConfig", "config", "consts",
]
