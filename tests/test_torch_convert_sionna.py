"""PyTorch port vs the JAX package: the Sionna RT converter, ``convert``'s
dispatch and the batch-conversion CLI.

The same Sionna export folder (``_make_sionna_export``, copied from
``tests/test_sionna_converter.py`` so that the card-side test needs no
JAX) goes through ``convert`` of each package in turn, each into its own
scenarios folder: every ``.mat`` matrix equal bit for bit, ``params.json``
equal, and channels within 5e-5 * max|H|; with two TX positions, with a
leading BS-BS batch, and without scene pickles. ``sionna_types_to_codes``
and ``export_to_deepmimo`` (of duck-typed Sionna 0.19 and 1.x objects)
give the JAX package's results; ``convert`` dispatches by the folder's
files and raises the same errors; ``convert_folder_loop`` and ``main``
give the JAX package's report (timings aside), error log and ``--retry``.
The shared checks (``convert_both``, ``same_scenario_files``,
``same_channels``) serve the InSite and AODT parity files too.

JAX is imported only inside the tests that use it, so the ``gpu`` test
also runs where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_convert_sionna.py``.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import scipy.io
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import consts as c
from deepmimo_tpu_torch.converter.sionna import exporter as texp
from deepmimo_tpu_torch.converter.sionna.sionna_paths import \
    sionna_types_to_codes
from deepmimo_tpu_torch.ops.kernels import render as kr
from deepmimo_tpu_torch.utils import compare_two_dicts

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from oracle import oracle_channels  # noqa: E402

torch.set_num_threads(1)


# ----------------------------------------------------------------------------
# Shared checks of the converter parity tests (also used by
# test_torch_convert_insite.py and test_torch_convert_aodt.py)
# ----------------------------------------------------------------------------

RTOL = 5e-5          # channels, relative to max|H| (tests/test_pallas.py:177)


def same_scenario_files(folder_a, folder_b):
    """Every file of two scenario folders: .mat matrices bit for bit (and
    dtype), JSON equal (``params.json``: ``compare_two_dicts`` finds no
    key missing on either side, then the values), any other file byte for
    byte."""
    names = sorted(os.listdir(folder_a))
    assert names == sorted(os.listdir(folder_b))
    assert "params.json" in names
    for name in names:
        a, b = (os.path.join(f, name) for f in (folder_a, folder_b))
        if name.endswith(".mat"):
            ma, mb = scipy.io.loadmat(a), scipy.io.loadmat(b)
            keys = sorted(k for k in ma if not k.startswith("__"))
            assert keys == sorted(k for k in mb if not k.startswith("__"))
            for k in keys:
                assert ma[k].dtype == mb[k].dtype, (name, k)
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=name)
        elif name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                da, db = json.load(fa), json.load(fb)
            if isinstance(da, dict):
                assert compare_two_dicts(da, db) == set()
                assert compare_two_dicts(db, da) == set()
            assert da == db, name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def convert_both(dm, rt_folder, tmp_path, name, **kw):
    """``convert`` of ``rt_folder`` by the JAX package ``dm``, then by the
    port, each into its own scenarios folder under ``tmp_path``; returns
    both scenario folders (JAX, port)."""
    from deepmimo_tpu.config import config as jconfig
    out = []
    for pkg, conf, tag in ((dm, jconfig, "jax"), (dmt, dmt.config, "port")):
        old = conf.get("scenarios_folder")
        conf.set("scenarios_folder", str(tmp_path / f"{tag}_scenarios"))
        try:
            assert pkg.convert(rt_folder, overwrite=True, scenario_name=name,
                               **kw) == name
        finally:
            conf.set("scenarios_folder", old)
        out.append(str(tmp_path / f"{tag}_scenarios" / name))
    return tuple(out)


def channel_params(pkg, n_sc=16):
    """A 4 x 2 BS, 16 of 512 subcarriers."""
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 2])
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(n_sc)
    return p


def same_channels(dm, jax_folder, port_folder):
    """Both packages ``load`` their scenario and render it: every child's
    channels within ``RTOL`` * max|H| (exactly zero where there is no
    path). Returns the two datasets (JAX, port)."""
    jds, tds = dm.load(jax_folder), dmt.load(port_folder)
    jh = jds.compute_channels(channel_params(dm))
    th = tds.compute_channels(channel_params(dmt))
    if not isinstance(jh, list):
        jh, th = [jh], [th]
    assert len(jh) == len(th)
    for j, t in zip(jh, th):
        j, t = np.asarray(j), np.asarray(t)
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, rtol=0, atol=RTOL * np.abs(j).max())
    return jds, tds


@pytest.fixture
def dm():
    """The JAX package (imported here only, so the gpu test needs no
    JAX)."""
    import deepmimo_tpu
    return deepmimo_tpu


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port renders on the CPU here (its config default is "cuda")."""
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


def _make_sionna_export(folder, n_rx=6, n_paths=4, seed=5):
    """Write a minimal but complete Sionna RT export pickle set (copied
    from ``tests/test_sionna_converter.py``)."""
    rng = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)

    tx_pos = np.array([[0.0, 0.0, 20.0]])
    rx_pos = np.stack([np.arange(n_rx), np.zeros(n_rx),
                       np.full(n_rx, 1.5)], axis=1)

    # a: [batch, n_rx, rx_ant, n_tx, tx_ant, paths, time]
    a = (rng.normal(size=(1, n_rx, 1, 1, 1, n_paths, 1)) +
         1j * rng.normal(size=(1, n_rx, 1, 1, 1, n_paths, 1))) * 1e-5
    a[0, 0, 0, 0, 0, 2:, 0] = 0          # rx0 has 2 paths
    a[0, 1, :, :, :, :, :] = 0           # rx1 inactive

    shape = (1, n_rx, 1, n_paths)
    tau = rng.uniform(1e-7, 1e-5, shape)
    angles = {k: rng.uniform(-np.pi, np.pi, shape)
              for k in ("phi_r", "phi_t")}
    angles.update({k: rng.uniform(0, np.pi, shape)
                   for k in ("theta_r", "theta_t")})
    types = np.ones((1, n_paths))        # all reflection chains
    vertices = np.full((2, n_rx, 1, n_paths, 3), np.nan)
    vertices[0, :, 0, :, :] = rng.uniform(-50, 50, (n_rx, n_paths, 3))

    paths_dict = dict(a=a, tau=tau, types=types, vertices=vertices,
                      sources=tx_pos, targets=rx_pos, **angles)

    with open(os.path.join(folder, "sionna_paths.pkl"), "wb") as f:
        pickle.dump([paths_dict], f)

    rt_params = {
        "frequency": 3.5e9, "los": True, "synthetic_array": True,
        "max_depth": 3, "reflection": True, "diffraction": False,
        "scattering": False, "num_samples": 1_000_000,
        "method": "fibonacci", "scat_random_phases": False,
        "tx_array_size": 1, "tx_array_num_ant": 1,
        "rx_array_size": 1, "rx_array_num_ant": 1,
        "tx_array_ant_pos": [[0, 0, 0]], "rx_array_ant_pos": [[0, 0, 0]],
    }
    with open(os.path.join(folder, "sionna_rt_params.pkl"), "wb") as f:
        pickle.dump(rt_params, f)

    materials = [{
        "name": "itu_concrete", "relative_permittivity": 5.24,
        "conductivity": 0.123, "scattering_coefficient": 0.0,
        "xpd_coefficient": 0.0, "scattering_pattern": "LambertianPattern",
        "alpha_r": 4.0, "alpha_i": 4.0, "lambda_": 0.5,
    }]
    with open(os.path.join(folder, "sionna_materials.pkl"), "wb") as f:
        pickle.dump(materials, f)
    with open(os.path.join(folder, "sionna_material_indices.pkl"),
              "wb") as f:
        pickle.dump([0], f)

    # one cube object as a vertex soup of triangles
    tri = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0],
                    [0, 0, 0], [10, 10, 0], [0, 10, 0]], dtype=np.float64)
    with open(os.path.join(folder, "sionna_vertices.pkl"), "wb") as f:
        pickle.dump(tri, f)
    with open(os.path.join(folder, "sionna_objects.pkl"), "wb") as f:
        pickle.dump({"building_1": (0, 6)}, f)

    return paths_dict


def _load_paths(folder):
    with open(os.path.join(folder, "sionna_paths.pkl"), "rb") as f:
        return pickle.load(f)


def _save_paths(folder, dicts):
    with open(os.path.join(folder, "sionna_paths.pkl"), "wb") as f:
        pickle.dump(dicts, f)


def _export(folder, case):
    """A Sionna export folder:

    - "fixture": the JAX tests' export (6 receivers, one inactive);
    - "two_tx": the same receivers seen from two TX positions;
    - "bs_bs": a leading batch whose targets are its sources (the BS-BS
      pair, as ``test_sionna_bs_bs_paths`` builds it);
    - "no_scene": without the vertex and object pickles.
    """
    ref = _make_sionna_export(folder)
    if case == "two_tx":
        rng = np.random.RandomState(9)
        d = dict(ref)
        d["sources"] = np.array([[0.0, 0.0, 20.0], [40.0, -5.0, 15.0]])
        d["a"] = np.concatenate([ref["a"], ref["a"][:, ::-1] * 0.5], axis=3)
        for k in ("tau", "phi_r", "phi_t", "theta_r", "theta_t"):
            d[k] = np.concatenate([ref[k], rng.permutation(
                ref[k].ravel()).reshape(ref[k].shape)], axis=2)
        d["vertices"] = np.concatenate([ref["vertices"]] * 2, axis=2)
        _save_paths(folder, [d])
    elif case == "bs_bs":
        dicts = _load_paths(folder)
        bsbs = dict(dicts[0])
        bsbs["targets"] = bsbs["sources"]
        bsbs["a"] = np.ones((1, 1, 1, 1, 1, 1, 1), dtype=complex) * 1e-6
        bsbs["tau"] = np.full((1, 1, 1, 1), 1e-7)
        for k in ("phi_r", "phi_t", "theta_r", "theta_t"):
            bsbs[k] = np.full((1, 1, 1, 1), 0.5)
        bsbs["types"] = np.zeros((1, 1))
        bsbs["vertices"] = np.full((1, 1, 1, 1, 3), np.nan)
        _save_paths(folder, [bsbs] + dicts)
    elif case == "no_scene":
        for name in ("vertices", "objects"):
            os.remove(os.path.join(folder, f"sionna_{name}.pkl"))
    return folder


# ----------------------------------------------------------------------------
# Interaction codes and the exporter
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("types,bounces", [
    ([0, 1, 2, 3], [0, 2, 1, 3]),
    ([3], [1]),
    ([1, 1, 3, 0], [1, 3, 0, 2]),
    ([np.nan, 1], [1, 1]),
    ([4], [1]),
    ([7], [1]),
])
def test_sionna_types_to_codes(dm, types, bounces):
    """Types 0-3 give the JAX package's codes (a scattering type without a
    bounce and a NaN type leave 0); type 4 (RIS) and unknown types raise
    the same errors in both."""
    from deepmimo_tpu.converter.sionna.sionna_paths import \
        sionna_types_to_codes as jcodes
    inter_pos = np.full((len(types), 3, 3), np.nan)
    for i, b in enumerate(bounces):
        inter_pos[i, :b] = 1.0
    types = np.array(types, dtype=float)
    if types[0] in (4, 7):
        errors = []
        for fn in (sionna_types_to_codes, jcodes):
            with pytest.raises((NotImplementedError, ValueError)) as e:
                fn(types, inter_pos)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]
        return
    got, want = sionna_types_to_codes(types, inter_pos), \
        jcodes(types, inter_pos)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Tensor:
    """A framework tensor: numpy by ``.numpy()``."""

    def __init__(self, x):
        self.x = np.asarray(x)

    def numpy(self):
        return self.x


def _fake_scene_and_paths(version):
    """Duck-typed Sionna objects: a scene of two objects and two radio
    materials, and one Paths batch; ``version`` "0.19" carries a complex
    ``a`` as a tensor, "1.x" a (real, imag) pair."""
    rng = np.random.RandomState(3)
    pattern = type("DirectivePattern", (), {"alpha_r": 3.0, "alpha_i": 5.0,
                                            "lambda_": _Tensor(0.25)})()
    mats = {"itu_glass": _Obj(relative_permittivity=_Tensor(6.27),
                              conductivity=_Tensor(0.0043),
                              scattering_coefficient=_Tensor(0.2),
                              xpd_coefficient=_Tensor(0.1),
                              scattering_pattern=pattern),
            "itu_concrete": _Obj(relative_permittivity=5.24,
                                 conductivity=0.123,
                                 scattering_coefficient=0.0,
                                 xpd_coefficient=0.0,
                                 scattering_pattern=None)}
    for name, m in mats.items():
        m.name = name

    def shape(verts):
        return _Obj(vertex_positions_buffer=lambda: _Tensor(verts.ravel()))

    objects = {
        "building": _Obj(radio_material=mats["itu_concrete"],
                         mitsuba_shape=shape(np.array(
                             [[0, 0, 0], [8, 0, 0], [8, 8, 0], [0, 0, 0],
                              [8, 8, 0], [0, 8, 0]], np.float32))),
        "ground_plane": _Obj(radio_material=mats["itu_glass"],
                             mitsuba_shape=shape(np.array(
                                 [[0, 0, 5], [4, 0, 5], [4, 4, 5]],
                                 np.float32))),
        "broken": _Obj(radio_material=None, mitsuba_shape=None)}
    array = _Obj(array_size=1, num_ant=1, positions=_Tensor([[0, 0, 0]]))
    scene = _Obj(radio_materials=mats, objects=objects,
                 frequency=_Tensor(28e9), synthetic_array=True,
                 tx_array=array, rx_array=array)
    n_rx, n_p = 5, 3
    a = (rng.normal(size=(1, n_rx, 1, 1, 1, n_p, 1)) +
         1j * rng.normal(size=(1, n_rx, 1, 1, 1, n_p, 1))) * 1e-6
    a[0, 2] = 0
    shape4 = (1, n_rx, 1, n_p)
    vertices = np.full((2, n_rx, 1, n_p, 3), np.nan)
    vertices[0] = rng.uniform(-20, 20, (n_rx, 1, n_p, 3))
    fields = dict(
        a=(_Tensor(a.real), _Tensor(a.imag)) if version == "1.x"
        else _Tensor(a),
        tau=_Tensor(rng.uniform(1e-7, 1e-6, shape4)),
        phi_r=rng.uniform(-3, 3, shape4), theta_r=rng.uniform(0, 3, shape4),
        phi_t=rng.uniform(-3, 3, shape4), theta_t=rng.uniform(0, 3, shape4),
        types=np.array([[0.0, 1.0, 1.0]]), vertices=_Tensor(vertices),
        sources=_Tensor([[0.0, 0.0, 12.0]]),
        targets=_Tensor(np.stack([np.arange(n_rx), np.ones(n_rx),
                                  np.full(n_rx, 1.5)], 1)))
    return scene, [_Obj(**fields)]


COMPUTE_PARAMS = {"max_depth": 2, "los": True, "reflection": True,
                  "diffraction": False, "scattering": False,
                  "num_samples": 200_000, "method": "fibonacci",
                  "scat_random_phases": True}


@pytest.mark.parametrize("version", ["0.19", "1.x"])
def test_export_to_deepmimo_matches_jax(dm, tmp_path, version):
    """``export_to_deepmimo`` of the same duck-typed scene and paths by
    both packages writes equal pickles, which then convert alike."""
    from deepmimo_tpu.converter.sionna import exporter as jexp
    folders = {}
    for name, mod in (("jax", jexp), ("port", texp)):
        scene, paths = _fake_scene_and_paths(version)
        folders[name] = str(tmp_path / f"{name}_export")
        mod.export_to_deepmimo(scene, paths, dict(COMPUTE_PARAMS),
                               folders[name])
    names = sorted(os.listdir(folders["port"]))
    assert names == sorted(os.listdir(folders["jax"])) and len(names) == 6
    for name in names:
        got, want = (_pickled(os.path.join(folders[k], name))
                     for k in ("port", "jax"))
        _same_tree(got, want)
    jf, tf = convert_both(dm, folders["port"], tmp_path, f"exp_{version}")
    same_scenario_files(jf, tf)
    same_channels(dm, jf, tf)


def _pickled(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(got, dict):
        assert list(got) == list(want)
        for k in got:
            _same_tree(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_tree(a, b)
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ----------------------------------------------------------------------------
# The whole conversion
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fixture", "two_tx", "no_scene"])
def test_convert_matches_jax(dm, tmp_path, case):
    """``convert`` of one Sionna export by both packages: equal scenario
    folders, then equal channels."""
    folder = _export(str(tmp_path / "rt" / "sionna_run"), case)
    jf, tf = convert_both(dm, folder, tmp_path, f"sionna_{case}")
    same_scenario_files(jf, tf)
    jds, tds = same_channels(dm, jf, tf)
    with open(os.path.join(tf, "params.json")) as f:
        sets = json.load(f)[c.TXRX_PARAM_NAME]
    assert sets["txrx_set_1"][c.TXRX_PARAM_NUM_POINTS] == 6
    assert sets["txrx_set_1"][c.TXRX_PARAM_NUM_ACTIVE_POINTS] == 5
    if case == "two_tx":
        assert isinstance(tds, dmt.MacroDataset) and len(tds) == 2
        np.testing.assert_array_equal(np.asarray(tds[1].tx_pos).ravel(),
                                      [40.0, -5.0, 15.0])
    if case == "no_scene":
        assert tds.scene is None and jds.scene is None


def test_bs_bs_batch_keeps_user_rows(dm, tmp_path):
    """A leading BS-BS batch becomes the BS set's own RX pair, equal to the
    JAX package's. The users keep their rows: the port's user set holds the
    fixture's 6 targets, each beside its own paths. (The JAX package also
    counts the BS-BS targets as a user: its user set has 7 rows, the BS
    position first, and each user's paths sit against the position of
    the user before it; the port's rows are its first 6 path rows and its
    last 6 positions.)"""
    folder = _export(str(tmp_path / "rt" / "sionna_run"), "bs_bs")
    ref = _make_sionna_export(str(tmp_path / "ref"))
    jf, tf = convert_both(dm, folder, tmp_path, "sionna_bs_bs")
    assert sorted(os.listdir(jf)) == sorted(os.listdir(tf))
    params = []
    for f in (jf, tf):
        with open(os.path.join(f, "params.json")) as fp:
            params.append(json.load(fp))
    jsets, tsets = (p.pop(c.TXRX_PARAM_NAME) for p in params)
    assert params[0] == params[1]
    assert jsets["txrx_set_0"] == tsets["txrx_set_0"]
    assert tsets["txrx_set_0"][c.TXRX_PARAM_IS_RX]
    assert (jsets["txrx_set_1"][c.TXRX_PARAM_NUM_POINTS],
            tsets["txrx_set_1"][c.TXRX_PARAM_NUM_POINTS]) == (7, 6)
    assert tsets["txrx_set_1"][c.TXRX_PARAM_NUM_ACTIVE_POINTS] == 5
    jb, tb = dm.load(jf, rx_sets=[0]), dmt.load(tf, rx_sets=[0])
    assert tb.n_ue == 1
    for k in ("power", "phase", "delay", "aoa_az", "rx_pos", "tx_pos"):
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]),
                                      err_msg=k)
    ju, tu = dm.load(jf, rx_sets=[1]), dmt.load(tf, rx_sets=[1])
    np.testing.assert_array_equal(np.asarray(tu.rx_pos),
                                  ref["targets"].astype(np.float32))
    np.testing.assert_array_equal(np.asarray(ju.rx_pos)[1:],
                                  np.asarray(tu.rx_pos))
    for k in ("power", "phase", "delay", "aoa_az", "aod_el", "inter"):
        np.testing.assert_array_equal(np.asarray(tu[k]),
                                      np.asarray(ju[k])[:6], err_msg=k)
    a0 = ref["a"][0, 0, 0, 0, 0, :2, 0]
    np.testing.assert_array_equal(np.asarray(tu.power)[0, :2],
                                  (20 * np.log10(np.abs(a0))).astype(
                                      np.float32))
    th = tu.compute_channels(channel_params(dmt))
    jh = np.asarray(ju.compute_channels(channel_params(dm)))[:6]
    np.testing.assert_allclose(th, jh, rtol=0, atol=RTOL * np.abs(jh).max())


@pytest.mark.parametrize("kind", [".setup", ".pkl", ".aodt", "none",
                                  "file"])
def test_convert_dispatch(dm, tmp_path, monkeypatch, kind):
    """``convert`` picks the engine from the folder's files (AODT before
    Sionna before InSite) and passes its arguments on; a folder no engine
    claims, or a path that is not a folder, raises the JAX package's
    ValueError."""
    import deepmimo_tpu_torch.converter.aodt.aodt_converter as ta
    import deepmimo_tpu_torch.converter.insite.insite_converter as ti
    import deepmimo_tpu_torch.converter.sionna.sionna_converter as ts
    calls = []
    for mod, fn in ((ta, "aodt_rt_converter"), (ts, "sionna_rt_converter"),
                    (ti, "insite_rt_converter")):
        monkeypatch.setattr(mod, fn, lambda path, _fn=fn, **kw: (
            calls.append((_fn, path, kw)), "name")[1])
    folder = tmp_path / "run"
    folder.mkdir()
    (folder / "notes.txt").write_text("x")
    exts = {".setup": [".setup", ".xml"], ".pkl": [".pkl", ".setup"],
            ".aodt": [".aodt", ".pkl", ".setup"]}.get(kind, [])
    for ext in exts:
        (folder / f"a{ext.upper() if ext == '.pkl' else ext}").write_text("")
    path = str(folder / "notes.txt") if kind == "file" else str(folder)
    if kind in ("none", "file"):
        msgs = []
        for pkg in (dmt, dm):
            with pytest.raises(ValueError) as e:
                pkg.convert(path, overwrite=True)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return
    assert dmt.convert(path, overwrite=True, scenario_name="x") == "name"
    want = {".setup": "insite_rt_converter", ".pkl": "sionna_rt_converter",
            ".aodt": "aodt_rt_converter"}[kind]
    assert calls == [(want, path, {"overwrite": True, "scenario_name": "x"})]


# ----------------------------------------------------------------------------
# The batch-conversion CLI
# ----------------------------------------------------------------------------

def _cli_runs(base):
    _make_sionna_export(str(base / "run_a"))
    _make_sionna_export(str(base / "run_c"), seed=6)
    (base / "run_bad").mkdir(parents=True)      # nothing to sniff
    (base / "run_bad" / "readme.txt").write_text("no outputs")


@pytest.mark.parametrize("entry", ["convert_folder_loop", "main"])
def test_convert_cli_matches_jax(dm, tmp_path, capsys, entry):
    """Both packages' batch converters over the same runs: the same report
    (timings aside) and error log; ``--retry`` converts only the logged
    folder and removes the log."""
    from deepmimo_tpu.config import config as jconfig
    from deepmimo_tpu.scripts import convert_cli as jcli
    from deepmimo_tpu_torch.scripts import convert_cli as tcli
    reports = {}
    for name, cli, conf in (("jax", jcli, jconfig),
                            ("port", tcli, dmt.config)):
        base = tmp_path / name / "runs"
        _cli_runs(base)
        log = str(tmp_path / name / "errors.json")
        old = conf.get("scenarios_folder")
        conf.set("scenarios_folder", str(tmp_path / name / "scenarios"))
        try:
            if entry == "main":
                capsys.readouterr()
                assert cli.main([str(base), "--error-log", log]) == 1
                report = json.loads(
                    capsys.readouterr().out.strip().splitlines()[-1])
            else:
                report = cli.convert_folder_loop(str(base), error_log=log)
            with open(log) as f:
                logged = json.load(f)
            _make_sionna_export(str(base / "run_bad"), seed=7)
            capsys.readouterr()
            assert cli.main([str(base), "--retry", "--error-log", log]) == 0
            retry = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert not os.path.exists(log)
        finally:
            conf.set("scenarios_folder", old)
        for r in (report, retry):                   # timings aside
            r["timing_s"] = sorted(r["timing_s"])
        reports[name] = json.dumps([report, logged, retry]).replace(
            str(base), "<base>")
    assert reports["port"] == reports["jax"]
    report, logged, retry = json.loads(reports["port"])
    assert report["converted"] == report["timing_s"] == ["run_a", "run_c"]
    assert [e[0] for e in report["errors"]] == ["run_bad"]
    assert logged == report["errors"]
    assert retry == {"converted": ["run_bad"], "errors": [],
                     "timing_s": ["run_bad"]}


# ----------------------------------------------------------------------------
# On the card (skipped without one)
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dmt.config.set("device", "cuda")
    yield torch.device("cuda")


@pytest.mark.gpu
def test_card_converted_sionna_renders(cuda, tmp_path):
    """A converted Sionna export renders on the card in one render launch,
    within 5e-5 * max|H| of the float64 oracle."""
    folder = _export(str(tmp_path / "rt" / "sionna_run"), "fixture")
    dmt.config.set("scenarios_folder", str(tmp_path / "scenarios"))
    name = dmt.convert(folder, overwrite=True, scenario_name="card_sionna")
    ds = dmt.load(name)
    p = dmt.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([8, 8])
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(64)
    before = kr.LAUNCHES
    h = ds.compute_channels(p)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == before + 1
    want = oracle_channels(
        *(np.asarray(ds[k]) for k in ("power", "phase", "delay", "aoa_az",
                                      "aoa_el", "aod_az", "aod_el")),
        bs_shape=(8, 8), ue_shape=(1, 1), n_fft=512,
        selected_subcarriers=tuple(range(64)), bandwidth=10e6,
        num_paths=np.asarray(ds["power"]).shape[1])
    h = np.asarray(h)
    assert h.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(h, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
