"""The port's public surface against the JAX package's.

- Every name of ``deepmimo_tpu.__all__`` and the ``rt_params`` /
  ``general_utils`` module attributes exist in the port, except the ones
  still to port; the package imports without JAX, the JAX package and
  matplotlib.
- Host helpers fed the same inputs give the same results: ``steering_vec``
  (within 1e-12), ``watt2dbw``, ``get_idxs_with_limits`` (and its
  ValueErrors), ``LinearPath`` in every ``filter_repeated`` mode,
  ``zip``/``unzip`` (archive listings), ``PrintIfVerbose``,
  ``RayTracingParameters``, ``summary`` text, ``info`` output and the
  database key components of a summary.
- The plots (``plot_coverage``, ``plot_rays``, ``plot_power_discarding``,
  ``plot_summary`` and the ``Dataset`` passthroughs) return axes or saved
  paths under matplotlib's Agg backend, from numpy arrays and tensors, and
  the GIS export writes the same CSV as the JAX package's.
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import consts as c

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from scenario_utils import write_synthetic_scenario  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STILL_TO_PORT = {"DeepMIMOSionnaAdapter"}


@pytest.fixture
def dm():
    """The JAX package (imported here only)."""
    import deepmimo_tpu
    return deepmimo_tpu


@pytest.fixture(autouse=True)
def port_on_cpu():
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


@pytest.fixture
def plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


@pytest.fixture
def scen_dir(tmp_path, monkeypatch):
    """A synthetic scenario ``surf_scen`` under ``deepmimo_scenarios`` of a
    temporary working directory, with materials and a GPS box in its
    params.json (so every section of the summary is written)."""
    monkeypatch.chdir(tmp_path)
    folder = str(tmp_path / "deepmimo_scenarios" / "surf_scen")
    write_synthetic_scenario(folder, n_ue=16, max_paths=6, seed=55,
                             grid=(4, 4))
    path = os.path.join(folder, "params.json")
    with open(path) as f:
        params = json.load(f)
    params[c.MATERIALS_PARAM_NAME] = {
        "material_1": {"name": "glass", "permittivity": 6.27,
                       "conductivity": 0.0043, "scattering_model": "none"},
        "material_0": {"name": "concrete", "permittivity": 5.24,
                       "conductivity": 0.123,
                       "scattering_model": "lambertian"}}
    params[c.RT_PARAMS_PARAM_NAME][c.RT_PARAM_GPS_BBOX] = [
        33.41, -111.93, 33.42, -111.92]
    with open(path, "w") as f:
        json.dump(params, f)
    return folder


# ----------------------------------------------------------------------------
# The surface
# ----------------------------------------------------------------------------

def test_every_public_name_is_ported(dm):
    missing = {n for n in dm.__all__ if not hasattr(dmt, n)}
    assert missing == STILL_TO_PORT
    assert set(dmt.__all__) >= set(dm.__all__) - STILL_TO_PORT
    for name in ("rt_params", "general_utils"):
        assert hasattr(dm, name) and hasattr(dmt, name)
    assert dmt.general_utils is dmt.utils
    assert dmt.rt_params.RayTracingParameters.__module__ == \
        "deepmimo_tpu_torch.rt_params"
    from deepmimo_tpu_torch import ops
    assert ops.steering_vec is dmt.steering_vec
    assert callable(ops.array_response)
    for name in ("plot_coverage", "plot_rays", "info"):
        assert callable(getattr(dmt.Dataset, name))


def test_imports_without_jax_or_matplotlib():
    """The package, its converters (InSite, Sionna, AODT), the native
    parser's loader and the batch CLI import without JAX, the JAX package
    and matplotlib, and import no pandas (the card's machine has none)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'deepmimo_tpu', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import deepmimo_tpu_torch as dmt\n"
        "from deepmimo_tpu_torch.utils.profiling import (StageTimer, "
        "xla_trace, annotate, renderer_roofline)\n"
        "import deepmimo_tpu_torch.api, deepmimo_tpu_torch.api_validators\n"
        "import deepmimo_tpu_torch.generator.visualization\n"
        "import deepmimo_tpu_torch.converter\n"
        "import deepmimo_tpu_torch.converter.insite.insite_converter\n"
        "import deepmimo_tpu_torch.converter.sionna.sionna_converter\n"
        "import deepmimo_tpu_torch.converter.sionna.exporter\n"
        "import deepmimo_tpu_torch.converter.aodt.aodt_converter\n"
        "import deepmimo_tpu_torch.native\n"
        "import deepmimo_tpu_torch.scripts.convert_cli\n"
        "assert callable(dmt.convert)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'deepmimo_tpu', 'matplotlib', 'pandas') and "
        "sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok', len(dmt.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# ----------------------------------------------------------------------------
# Compute and sampling helpers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("panel", [(1, 1), (8, 1), (4, 4), (8, 8), (16, 2)])
@pytest.mark.parametrize("spacing", [0.5, 0.25, 1.0])
def test_steering_vec_matches_reference(dm, panel, spacing):
    for phi, theta in [(0, 0), (30, -45), (90, 90), (-60, 170),
                       (123.4, 7.5)]:
        ours = dmt.steering_vec(panel, phi=phi, theta=theta,
                                spacing=spacing)
        theirs = np.asarray(dm.steering_vec(panel, phi=phi, theta=theta,
                                            spacing=spacing))
        assert isinstance(ours, np.ndarray) and ours.dtype == np.complex128
        assert ours.shape == (panel[0] * panel[1],)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
        assert np.linalg.norm(ours) == pytest.approx(1.0, abs=1e-12)


def test_watt2dbw_matches_reference(dm):
    from deepmimo_tpu.generator.sampling import watt2dbw as ref
    from deepmimo_tpu_torch.generator.sampling import dbw2watt, watt2dbw
    x = np.random.RandomState(0).uniform(1e-12, 10, 50)
    np.testing.assert_array_equal(watt2dbw(x), ref(x))
    assert watt2dbw(2.0) == ref(2.0)
    np.testing.assert_allclose(dbw2watt(watt2dbw(x)), x, rtol=1e-12)


def _grid(nx=20, ny=12, z=True):
    xs, ys = np.meshgrid(np.arange(nx) * 1.0, np.arange(ny) * 2.0)
    pos = np.stack([xs.ravel(), ys.ravel()], 1)
    if z:
        pos = np.concatenate([pos, np.full((len(pos), 1), 1.5)], 1)
    return pos


@pytest.mark.parametrize("limits", [
    {"x_max": 7}, {"x_min": 3, "x_max": 11.5, "y_min": 4},
    {"y_max": 10, "z_min": 1.5}, {"z_max": 1.0}, {}])
def test_get_idxs_with_limits_matches_reference(dm, limits):
    pos = _grid()
    ours = dmt.get_idxs_with_limits(pos, **limits)
    np.testing.assert_array_equal(ours, dm.get_idxs_with_limits(pos,
                                                                **limits))


@pytest.mark.parametrize("limits,dims", [({"w_min": 0}, 3),
                                         ({"z_max": 1}, 2)])
def test_get_idxs_with_limits_errors_match_reference(dm, limits, dims):
    pos = _grid(z=dims == 3)
    with pytest.raises(ValueError) as ours:
        dmt.get_idxs_with_limits(pos, **limits)
    with pytest.raises(ValueError) as theirs:
        dm.get_idxs_with_limits(pos, **limits)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [
    {"res": 1}, {"res": 0.3}, {"n_steps": 57}, {"res": 0.5,
                                                "filter_repeated": False},
    {"n_steps": 200, "filter_repeated": "hard"},
    {"n_steps": 200, "filter_repeated": True},
    {"n_steps": 33, "filter_repeated": False}])
def test_linear_path_matches_reference(dm, kw, capsys):
    pos = _grid()
    for first, last in [((0, 0), (19, 22)), ((3, 20, 0), (15, 1, 1.5)),
                        ((19, 0), (0, 22))]:
        ours = dmt.LinearPath(pos, first, last, **kw)
        theirs = dm.LinearPath(pos, first, last, **kw)
        np.testing.assert_array_equal(ours.idxs, theirs.idxs)
        assert ours.n == theirs.n
        np.testing.assert_array_equal(ours.first_pos, theirs.first_pos)
        np.testing.assert_array_equal(ours.last_pos, theirs.last_pos)
    out = capsys.readouterr().out.splitlines()
    assert out[::2] == out[1::2]   # the same resolution notes, in turn


# ----------------------------------------------------------------------------
# Utilities
# ----------------------------------------------------------------------------

def test_zip_unzip_match_reference(dm, tmp_path):
    listings = []
    for name, pkg in (("ours", dmt), ("theirs", dm)):
        folder = tmp_path / name / "scen_z"
        (folder / "sub").mkdir(parents=True)
        (folder / "params.json").write_text('{"a": 1}')
        (folder / "sub" / "power_t001_tx000_r001.mat").write_bytes(
            bytes(range(256)) * 8)
        zip_path = pkg.zip(str(folder))
        assert zip_path == str(folder) + ".zip"
        with zipfile.ZipFile(zip_path) as zf:
            listings.append(sorted((i.filename, i.file_size)
                                   for i in zf.infolist()))
        shutil.rmtree(folder)          # as after a download
        out = pkg.unzip(zip_path)
        assert out == str(folder)
        listings.append(sorted(
            os.path.relpath(os.path.join(r, f), out)
            for r, _, files in os.walk(out) for f in files))
    assert listings[0] == listings[2] and listings[1] == listings[3]
    assert listings[0][0][0] == "scen_z/params.json"
    # unzip extracts next to the archive: the top folder is kept.
    assert listings[1][0] == os.path.join("scen_z", "params.json")


def test_print_if_verbose_matches_reference(dm, capsys):
    from deepmimo_tpu.utils import PrintIfVerbose as Ref
    from deepmimo_tpu_torch.utils import PrintIfVerbose
    for verbose in (True, False, 1, 0):
        PrintIfVerbose(verbose)("message A")
        ours = capsys.readouterr().out
        Ref(verbose)("message A")
        assert ours == capsys.readouterr().out
        assert PrintIfVerbose(verbose).verbose == verbose


def test_rt_params_match_reference(dm):
    kw = dict(raytracer_name="Sionna RT", raytracer_version="0.19.2",
              frequency=28e9, max_path_depth=5, max_reflections=4,
              max_diffractions=1, max_scattering=1, max_transmissions=0,
              num_rays=4_000_000, gps_bbox=(1.0, 2.0, 3.0, 4.0))
    ours = dmt.rt_params.RayTracingParameters(**kw)
    theirs = dm.rt_params.RayTracingParameters(**kw)
    assert ours.to_dict() == theirs.to_dict()
    back = dmt.rt_params.RayTracingParameters.from_dict(
        {k: v for k, v in ours.to_dict().items() if k != "raw_params"},
        raw_params={"engine": "x"})
    assert back.raw_params == {"engine": "x"}
    assert back.to_dict() == dm.rt_params.RayTracingParameters.from_dict(
        {k: v for k, v in theirs.to_dict().items() if k != "raw_params"},
        raw_params={"engine": "x"}).to_dict()
    with pytest.raises(NotImplementedError):
        dmt.rt_params.RayTracingParameters.read_parameters("x")


# ----------------------------------------------------------------------------
# summary, info and the database key components
# ----------------------------------------------------------------------------

def test_summary_matches_reference(dm, scen_dir, capsys):
    ours = dmt.summary("surf_scen")
    printed = capsys.readouterr().out
    theirs = dm.summary("surf_scen")
    assert printed == capsys.readouterr().out
    assert ours == theirs and printed == ours + "\n"
    for section in ("[Materials]", "[GPS Bounding Box]",
                    "[TX/RX Configuration]"):
        assert section in ours
    assert dmt.summary("surf_scen", print_summary=False) == ours
    assert capsys.readouterr().out == ""


def test_key_components_match_reference(dm, scen_dir):
    from deepmimo_tpu.api import generate_key_components as ref
    from deepmimo_tpu_torch.api import generate_key_components
    text = dmt.summary("surf_scen", print_summary=False)
    ours = generate_key_components(text)
    assert ours == ref(text)
    names = [s["name"] for s in ours["sections"]]
    assert names[0] == "Ray-Tracing Configuration"
    assert "GPS Bounding Box" in names


@pytest.mark.parametrize("name", [None, "all", "power", "pwr", "channel",
                                  "ofdm.bandwidth", "rt_params", "nothing"])
def test_info_matches_reference(dm, capsys, name):
    dmt.info(name)
    ours = capsys.readouterr().out
    dm.info(name)
    assert ours == capsys.readouterr().out and ours


@pytest.mark.parametrize("name", [None, "pwr", "power", "los", "nothing"])
def test_dataset_info_matches_reference(dm, scen_dir, capsys, name):
    dmt.load("surf_scen").info(name)
    ours = capsys.readouterr().out
    dm.load("surf_scen").info(name)
    assert ours == capsys.readouterr().out and ours


# ----------------------------------------------------------------------------
# Plots (matplotlib's Agg backend)
# ----------------------------------------------------------------------------

def test_plot_coverage(scen_dir, plt):
    ds = dmt.load("surf_scen")
    ax = ds.plot_coverage(ds.pathloss, cbar_title="PL (dB)")
    assert ax is not None and ax.get_title() == "Coverage map"
    # A tensor metric (as a device result would be) goes to the host.
    ax2 = dmt.plot_coverage(torch.as_tensor(ds.rx_pos),
                            torch.as_tensor(ds.pathloss), proj_3D=True,
                            bs_pos=ds.tx_pos.T, legend=True)
    assert ax2.name == "3d"
    ax3 = dmt.plot_coverage(ds.rx_pos, ds.los, bs_pos=ds.tx_pos.T,
                            bs_ori=np.array([0.0, 0.0, 0.5]),
                            lims=[(0, 8), (0, 8)], equal_aspect=True)
    assert ax3.get_xlim() == (0, 8)


def test_plot_rays(scen_dir, plt):
    ds = dmt.load("surf_scen")
    idx = int(np.argmax(np.asarray(ds.num_paths)))
    assert ds.plot_rays(idx) is not None
    ax = dmt.plot_rays(ds.rx_pos[idx], ds.tx_pos[0],
                       torch.as_tensor(ds.inter_pos[idx]),
                       torch.as_tensor(ds.inter[idx]), proj_3D=False,
                       color_by_type=False)
    assert ax.get_title() == "Ray paths"


def test_plot_power_discarding(scen_dir, plt):
    ds = dmt.load("surf_scen")
    ds.compute_channels(dmt.ChannelGenParameters())
    ax = dmt.plot_power_discarding(ds)
    assert ax.get_title() == "OFDM delay-trimming power loss"


def test_plot_summary_matches_reference(dm, scen_dir, plt):
    paths = dmt.plot_summary("surf_scen", save_imgs=True, show_plots=False)
    theirs = dm.plot_summary("surf_scen", save_imgs=True, show_plots=False)
    assert paths == theirs
    assert [os.path.basename(p) for p in paths][:2] == [
        "summary_los.png", "summary_pathloss.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert dmt.plot_summary("surf_scen", save_imgs=False,
                            show_plots=False) is None


@pytest.mark.parametrize("gps", [False, True])
def test_export_xyz_csv_matches_reference(dm, scen_dir, tmp_path, gps):
    from deepmimo_tpu.generator.visualization import export_xyz_csv as ref
    from deepmimo_tpu_torch.generator.visualization import export_xyz_csv
    ours_ds, theirs_ds = dmt.load("surf_scen"), dm.load("surf_scen")
    if not gps:
        for ds in (ours_ds, theirs_ds):
            ds[c.RT_PARAMS_PARAM_NAME] = {}
    metric = np.asarray(theirs_ds.pathloss)
    a = export_xyz_csv(ours_ds, torch.as_tensor(metric),
                       str(tmp_path / "ours.csv"))
    b = ref(theirs_ds, metric, str(tmp_path / "theirs.csv"))
    with open(a) as fa, open(b) as fb:
        text = fa.read()
        assert text == fb.read()
    assert text.startswith("lat,lon,alt,value" if gps else "x,y,z,value")
