"""Generator layer: scenario loading, datasets, channel computation."""

from .params import ChannelGenParameters
from .dataset import Dataset
from .core import load, generate
from .sampling import dbw2watt, get_uniform_idxs

__all__ = [
    "ChannelGenParameters", "Dataset", "load", "generate", "dbw2watt",
    "get_uniform_idxs",
]
