"""Documentation of the PyTorch port (``deepmimo_tpu_torch/docs``), as
tests/test_docs.py checks the JAX package's: the page tree exists, every
public name of ``deepmimo_tpu_torch`` and of its ``parallel`` and ``ops``
packages is documented under ``docs/api/``, the documented attributes
exist on the port's objects, the notebook is in sync with ``manual.md``,
and the pages state no TPU figure.
"""

import glob
import importlib.util
import json
import os
import re

import pytest

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import ops, parallel

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "deepmimo_tpu_torch", "docs")
API = os.path.join(DOCS, "api")
PAGES = ("index.md", "generator.md", "ops.md", "parallel.md",
         "converter.md", "database.md", "scene.md", "materials.md",
         "config.md", "utils.md", "visualization.md", "integrations.md",
         "pipelines.md")


def _api_text():
    text = ""
    for path in glob.glob(os.path.join(API, "*.md")):
        with open(path) as f:
            text += f.read()
    return text


def test_docs_tree_exists():
    pages = {os.path.basename(p) for p in glob.glob(os.path.join(API,
                                                                 "*.md"))}
    for page in PAGES:
        assert page in pages, page
    for page in ("index.md", "installation.md", "quickstart.md",
                 "manual.md", "manual.ipynb", "make_manual_ipynb.py"):
        assert os.path.isfile(os.path.join(DOCS, page)), page
    for img in ("coverage.png", "rays.png", "scene.png",
                "power_discarding.png"):
        assert os.path.isfile(os.path.join(DOCS, "imgs", img)), img


@pytest.mark.parametrize("module", ["deepmimo_tpu_torch", "parallel", "ops"])
def test_every_public_symbol_documented(module):
    names = {"deepmimo_tpu_torch": dmt, "parallel": parallel,
             "ops": ops}[module].__all__
    text = _api_text()
    missing = [name for name in names if name not in text]
    assert not missing, f"undocumented {module} names: {missing}"


def test_parallel_and_ops_surfaces_documented():
    text = _api_text()
    for name in ("make_mesh", "render_channels_sharded", "shard_paths",
                 "load_paths_sharded", "host_user_range",
                 "make_sharded_training_step", "dryrun_multichip",
                 "user_sharding", "channel_sharding",
                 "training_step_planes", "render_channels_planes",
                 "unpack_planes_np", "rotate_angles", "rotate_unit_vec",
                 "apply_fov", "array_response", "pattern_gain",
                 "PathData", "AntennaPanel", "ChannelConfig",
                 "export_cdl", "load_v3_scenario", "export_matlab",
                 "StageTimer", "xla_trace", "renderer_roofline"):
        assert name in text, name


def test_doc_examples_name_real_attributes():
    """The documented attribute and method names exist."""
    from deepmimo_tpu_torch.generator.dataset import Dataset, MacroDataset
    for attr in ("compute_channels", "compute_beam_gains", "subset",
                 "apply_fov", "get_uniform_idxs", "get_active_idxs",
                 "plot_coverage", "plot_rays", "info",
                 "set_channel_params"):
        assert hasattr(Dataset, attr), attr
    for attr in ("compute_channels_batched", "compute_beam_gains_batched"):
        assert hasattr(MacroDataset, attr), attr
    for attr in ("make_mesh", "render_channels_sharded",
                 "render_polar_sharded", "render_beam_gains_sharded",
                 "render_beam_gains_polar_sharded",
                 "make_sharded_training_step", "training_step_planes"):
        assert hasattr(parallel, attr), attr
    from deepmimo_tpu_torch.parallel import dryrun, mesh
    assert hasattr(dryrun, "dryrun_multichip")
    for attr in ("user_sharding", "replicated", "channel_sharding"):
        assert hasattr(mesh, attr), attr
    from deepmimo_tpu_torch.utils import profiling
    for attr in ("StageTimer", "xla_trace", "renderer_roofline",
                 "annotate"):
        assert hasattr(profiling, attr), attr
    for key in ("device", "mesh_axis_users", "mesh_axis_tile",
                "render_backend", "planes_layout", "checkpoint_dir"):
        assert key in dmt.config, key


def test_manual_notebook_in_sync():
    """manual.ipynb is generated from manual.md; the committed notebook
    must equal a fresh build."""
    # Loaded under its own name: tests/test_docs.py imports the JAX docs'
    # make_manual_ipynb, and both may run in one process.
    spec = importlib.util.spec_from_file_location(
        "torch_make_manual_ipynb", os.path.join(DOCS, "make_manual_ipynb.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(DOCS, "manual.md")) as f:
        fresh = gen.build_notebook(f.read())
    with open(os.path.join(DOCS, "manual.ipynb")) as f:
        committed = json.load(f)
    assert committed == fresh
    kinds = [c["cell_type"] for c in committed["cells"]]
    assert "code" in kinds and "markdown" in kinds


def test_docs_state_no_tpu_figure():
    """The port's pages speak of the port: no TPU speed or a TPU chip's
    name."""
    for path in glob.glob(os.path.join(DOCS, "**", "*.md"), recursive=True):
        with open(path) as f:
            text = f.read()
        assert not re.search(r"\bTPU v\d|users/s|TFLOP/s on|VMEM|MXU",
                             text), path
