"""Generator layer: scenario loading, datasets, channel computation."""

from .params import ChannelGenParameters
from .dataset import Dataset, MacroDataset
from .core import DynamicDataset, load, generate
from .sampling import dbw2watt, get_uniform_idxs

__all__ = [
    "ChannelGenParameters", "Dataset", "MacroDataset", "DynamicDataset",
    "load", "generate", "dbw2watt", "get_uniform_idxs",
]
