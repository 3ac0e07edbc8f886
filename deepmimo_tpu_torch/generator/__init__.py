"""Generator layer: scenario loading, datasets, channel computation,
sampling; ``generator.visualization`` plots (matplotlib imported inside
its functions)."""

from .params import ChannelGenParameters
from .dataset import Dataset, MacroDataset
from .core import DynamicDataset, load, generate
from .sampling import (LinearPath, dbw2watt, get_idxs_with_limits,
                       get_uniform_idxs, watt2dbw)

__all__ = [
    "ChannelGenParameters", "Dataset", "MacroDataset", "DynamicDataset",
    "load", "generate", "LinearPath", "dbw2watt", "get_idxs_with_limits",
    "get_uniform_idxs", "watt2dbw",
]
