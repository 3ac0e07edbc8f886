"""DeepMIMO-TPU, PyTorch/CUDA port: site-specific MIMO channel generation.

The second package of the repository, beside the JAX reference
``deepmimo_tpu``: the same scenario format, parameters and channel math,
with plain tensor code in PyTorch and the hot paths in hand-written CUDA
kernels for NVIDIA Hopper: the render (also of all four polarizations
of a dual-polar scenario in one launch), its backward for the
differentiable calibration step (``deepmimo_tpu_torch.parallel``), the
path sum, and codebook beam-gain maps that never form the channel.
Scenarios load from disk with several TX-RX pairs (``MacroDataset``, whose
batched renders take one launch for every pair), as dynamic snapshots or
from legacy v3 folders, with their scene and materials; the streamed
render resumes from a checkpoint directory. The rest of the JAX package's
public surface is here too: steering vectors, sampling, ``info``,
``summary``, plots (matplotlib is imported inside the plotting functions
only), the scenario database client (``upload``, ``download``, ``search``;
``load`` of a missing scenario downloads it) and profiling on the card
(``utils.profiling``). ``convert`` turns Wireless InSite (with a native
C++ .p2m parser, built with g++ at first use), Sionna RT and AODT output
folders into scenarios, and ``scripts.convert_cli`` converts a folder of
runs in a loop. Upstream of conversion, ``pipelines`` is the scenario
factory (city sites, placements, InSite projects, the Blender OSM script,
the gated ray-tracer runs, a resumable runner that converts and uploads);
downstream, ``integrations`` hands channels to link-level simulators
(``DeepMIMOSionnaAdapter`` for Sionna, the NR CDL export and the MATLAB
generator files). ``scripts`` holds the CLIs (convert, pipeline, stats,
csvgen, insite-ops). ``parallel`` spreads renders and the calibration
step over devices: a (users, tile) ``DeviceMesh`` over
``torch.distributed`` ranks, one device each, with sharded results as
DTensors. ``examples`` holds the worked examples and ``docs`` the
documentation. It imports torch and numpy/scipy, never jax.
Tensors live on ``config['device']`` (default ``"cuda"``).
"""

__version__ = "0.1.0"

from . import consts
from .config import config
from .ops import (AntennaPanel, ChannelConfig, PathData, render_beam_gains,
                  render_beam_gains_polar, render_channels,
                  render_channels_and_grads, render_channels_planes_polar,
                  steering_vec)
from .utils import (DotDict, get_available_scenarios, get_params_path,
                    get_scenario_folder, load_dict_from_json, unzip, zip)
from .generator import (ChannelGenParameters, Dataset, LinearPath,
                        MacroDataset, generate, get_idxs_with_limits,
                        get_uniform_idxs, load)
from .generator.visualization import (plot_coverage, plot_power_discarding,
                                      plot_rays)
from .txrx import (TxRxPair, TxRxSet, get_txrx_pairs, get_txrx_sets,
                   print_available_txrx_pair_ids)
from .materials import Material, MaterialList
from .scene import Face, PhysicalElement, PhysicalElementGroup, Scene
from .integrations import DeepMIMOSionnaAdapter, export_matlab
from .converter import convert
from .info import info
from .summary import plot_summary, summary
from .api import download, search, upload, upload_images, upload_rt_source

# Module attributes of the JAX package's surface.
from . import rt_params
from . import utils as general_utils

__all__ = [
    "Dataset", "MacroDataset", "ChannelGenParameters", "load", "generate",
    "info", "PathData", "AntennaPanel", "ChannelConfig", "render_channels",
    "render_channels_and_grads", "render_beam_gains",
    "render_beam_gains_polar", "render_channels_planes_polar",
    "steering_vec", "TxRxSet", "TxRxPair", "get_txrx_sets",
    "get_txrx_pairs", "print_available_txrx_pair_ids", "plot_coverage",
    "plot_rays", "plot_power_discarding", "LinearPath",
    "get_idxs_with_limits", "get_uniform_idxs", "DotDict",
    "get_available_scenarios", "get_params_path", "get_scenario_folder",
    "load_dict_from_json", "zip", "unzip", "Face", "PhysicalElement",
    "PhysicalElementGroup", "Scene", "Material", "MaterialList",
    "DeepMIMOSionnaAdapter", "export_matlab", "convert", "summary", "plot_summary", "upload",
    "upload_rt_source", "upload_images", "download", "search", "consts",
    "config",
]
