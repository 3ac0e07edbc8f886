"""PyTorch port vs the JAX package: every scenario ``load`` takes.

Scenario folders are written with the port's own writers (``save_mat``,
``save_dict_as_json``, ``Scene.export_data``) and legacy v3 folders with
either package's ``export_matlab``, then loaded by both packages from the
same disk state and compared as raw arrays:

- the host data model: ``Scene`` export/import across the packages,
  ``get_object_faces`` in every mode, ``MaterialList.from_dict``, the
  txrx sets and pairs;
- several TX points (``MacroDataset``): the children's arrays, per-child
  channels, ``compute_channels_batched`` and ``compute_beam_gains_batched``
  (host and device), and the batched renders equal to the per-child ones
  after ``append``, after one child's ``apply_fov``, with per-user UE
  rotations and in the time domain (held against per-child renders, not
  against the JAX package's batched cache, which goes stale);
- dynamic scenarios (``DynamicDataset``) with a scene and materials;
- legacy v3 folders (single-pol with Doppler rows, dual-polar, two BS),
  and the port's ``export_matlab`` read by the JAX loader.

Tolerances: channels 5e-5 * max|H| (tests/test_pallas.py:177), beam gains
1e-4 * max|G|; loaded matrices exactly.

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_scenarios.py``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import consts as c
from deepmimo_tpu_torch.generator.core import DynamicDataset
from deepmimo_tpu_torch.ops.kernels import beamgain as kb
from deepmimo_tpu_torch.ops.kernels import render as kr
from deepmimo_tpu_torch.utils import save_dict_as_json, save_mat

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import make_synthetic_paths  # noqa: E402

torch.set_num_threads(1)
RTOL = 5e-5
BG_RTOL = 1e-4
POLS = ("VV", "VH", "HH", "HV")
PATH_KEYS = ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
             "aod_el")


@pytest.fixture
def dm():
    """The JAX package (imported here only, so the gpu tests need no
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


# ----------------------------------------------------------------------------
# Scenario writers (the port's own)
# ----------------------------------------------------------------------------

def _pair_data(n_ue, max_paths, seed, with_doppler=False):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed,
                             with_doppler=with_doppler)
    n_valid = d.pop("n_valid")
    rng = np.random.RandomState(seed + 1)
    inter = np.full((n_ue, max_paths), np.nan)
    for u in range(n_ue):
        inter[u, :n_valid[u]] = rng.choice([0, 1, 21, 113], n_valid[u])
    d["inter"] = inter
    d["inter_pos"] = np.full((n_ue, max_paths, 3, 3), np.nan)
    return d


def _write_pairs(folder, datas, grid, tx_pos=None):
    """The matrices of TX points 0.. (one ``datas`` entry each) of TX set
    0 against RX set 1, users on a ``grid``."""
    n_ue = grid[0] * grid[1]
    xs, ys = np.meshgrid(np.arange(grid[0]) * 2.0, np.arange(grid[1]) * 2.0)
    rx_pos = np.stack([xs.ravel(), ys.ravel(), np.full(n_ue, 1.5)], 1)
    for i, d in enumerate(datas):
        tx = (np.array([[5.0 * i, -10.0, 25.0]]) if tx_pos is None
              else tx_pos[i])
        mats = dict(d, rx_pos=rx_pos, tx_pos=tx)
        for key, value in mats.items():
            save_mat(value, key, folder, tx_set_idx=0, tx_idx=i,
                     rx_set_idx=1)


def _box(x, y, w, l, h, oid, mat=0):
    """A box building: 6 quad faces."""
    lo, hi = np.array([x, y, 0.0]), np.array([x + w, y + l, h])
    corners = lambda z: [[lo[0], lo[1], z], [hi[0], lo[1], z],
                         [hi[0], hi[1], z], [lo[0], hi[1], z]]
    b, t = corners(0.0), corners(h)
    quads = [b, t] + [[b[i], b[(i + 1) % 4], t[(i + 1) % 4], t[i]]
                      for i in range(4)]
    faces = [dmt.Face(np.array(q), material_idx=mat) for q in quads]
    return dmt.PhysicalElement(faces, object_id=oid, label="buildings",
                               name=f"building_{oid}")


MATERIALS = {
    "material_0": {"id": 0, "name": "concrete", "permittivity": 5.24,
                   "conductivity": "0.123", "scattering_model": "none"},
    "material_1": {"id": 1, "name": "glass", "permittivity": 6.27,
                   "conductivity": 0.0043, "scattering_model": "lambertian",
                   "scattering_coefficient": 0.2},
    "material_2": {"id": 2, "name": "concrete", "permittivity": 5.24,
                   "conductivity": 0.123, "scattering_model": "none"},
}


def _write_params(folder, n_tx, n_ue, n_scenes=1, scene_meta=None):
    txrx = {
        "txrx_set_0": {"name": "bs", "id": 0, "id_orig": 0, "is_tx": True,
                       "is_rx": False, "num_points": n_tx,
                       "num_active_points": n_tx, "num_ant": 1,
                       "dual_pol": False},
        "txrx_set_1": {"name": "users", "id": 1, "id_orig": 1,
                       "is_tx": False, "is_rx": True, "num_points": n_ue,
                       "num_active_points": n_ue, "num_ant": 1,
                       "dual_pol": False},
    }
    scene = {c.SCENE_PARAM_NUMBER_SCENES: n_scenes}
    scene.update(scene_meta or {})
    scene[c.SCENE_PARAM_NUMBER_SCENES] = n_scenes
    save_dict_as_json(os.path.join(folder, "params.json"), {
        c.VERSION_PARAM_NAME: "0.1.0",
        c.RT_PARAMS_PARAM_NAME: {c.RT_PARAM_FREQUENCY: 3.5e9,
                                 c.RT_PARAM_RAYTRACER: "synthetic"},
        c.TXRX_PARAM_NAME: txrx, c.SCENE_PARAM_NAME: scene,
        c.MATERIALS_PARAM_NAME: MATERIALS})


GRID = (4, 4)
N_UE = 16


@pytest.fixture(scope="module")
def multi_tx(tmp_path_factory):
    """Three TX points with their own paths (6, 4 and 5 path slots)."""
    folder = str(tmp_path_factory.mktemp("scen") / "multi_tx")
    datas = [_pair_data(N_UE, p, 60 + i) for i, p in enumerate((6, 4, 5))]
    _write_pairs(folder, datas, GRID)
    _write_params(folder, 3, N_UE)
    return folder, datas


def _params(pkg, ue_rotation=(0, 10, -5), **kw):
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 2])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 15, -30])
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION] = np.array(ue_rotation)
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(16)
    for k, v in kw.items():
        p[k] = v
    return p


def _codebook(n_beams=3, n_tx=8, seed=5):
    rng = np.random.RandomState(seed)
    return np.exp(1j * rng.uniform(-np.pi, np.pi, (n_beams, n_tx))) / \
        np.sqrt(n_tx)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _same_arrays(tds, jds, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(tds[k]), np.asarray(jds[k]),
                                      err_msg=k)


# ----------------------------------------------------------------------------
# Scene, materials, txrx
# ----------------------------------------------------------------------------

def _scene(pkg):
    """Box buildings and a terrain patch, built with ``pkg``'s classes."""
    scene = pkg.Scene()
    for i in range(4):
        box = _box(10.0 * i, 3.0 * i, 6.0, 8.0 + i, 12.0 + 3 * i, i, i % 2)
        scene.add_object(pkg.PhysicalElement(
            [pkg.Face(f.vertices, f.material_idx) for f in box.faces],
            object_id=i, label="buildings", name=box.name))
    ground = pkg.Face(np.array([[-5, -5, 0], [60, -5, 0], [60, 40, 0],
                                [-5, 40, 0]], dtype=np.float32), 2)
    scene.add_object(pkg.PhysicalElement([ground], label="terrain",
                                         name="ground"))
    return scene


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_scene_round_trips_between_packages(dm, tmp_path, direction):
    """One package's ``Scene.export_data`` is read by the other's
    ``Scene.from_data``: the same objects, faces, vertices and boxes."""
    writer, reader = (dm, dmt) if direction == "jax_to_port" else (dmt, dm)
    folder = str(tmp_path / "scene")
    meta = _scene(writer).export_data(folder)
    assert meta == _scene(reader).export_data(str(tmp_path / "again"))
    got = reader.Scene.from_data(folder)
    want = _scene(reader)
    assert len(got.objects) == len(want.objects) == 5
    assert got.face_indices == want.face_indices
    for a, b in zip(got.objects, want.objects):
        assert (a.name, a.label, a.object_id, a.materials) == \
            (b.name, b.label, b.object_id, b.materials)
        assert len(a.faces) == len(b.faces)
        for fa, fb in zip(a.faces, b.faces):
            np.testing.assert_array_equal(fa.vertices, fb.vertices)
            assert fa.material_idx == fb.material_idx
        np.testing.assert_array_equal(a.bounding_box.bounds,
                                      b.bounding_box.bounds)
    np.testing.assert_array_equal(got.bounding_box.bounds,
                                  want.bounding_box.bounds)
    assert len(got.get_objects(label="buildings")) == 4
    assert len(got.get_objects(material=1)) == 2
    assert reader.Scene.from_data(str(tmp_path)) is None


def _soups():
    rng = np.random.RandomState(8)
    building = np.concatenate([
        np.column_stack([rng.uniform(0, 10, 40), rng.uniform(0, 6, 40),
                         rng.choice([0.0, 15.0], 40)]),
        [[0, 0, 0], [10, 0, 15], [0, 6, 15], [10, 6, 0]]])
    angle = np.sort(rng.uniform(0, 2 * np.pi, 30))
    road = np.column_stack([20 * np.cos(angle) * (1 + 0.3 * np.sin(
        3 * angle)), 8 * np.sin(angle), np.full(30, 0.2)])
    tris = rng.uniform(-5, 5, (6, 3, 3))
    tris[3:] = tris[:3] + np.array([0.0, 0.0, 4.0])
    return {True: building, False: road, None: tris}


@pytest.mark.parametrize("fast", [True, False, None])
def test_get_object_faces_matches_jax(fast):
    """Convex-hull prism, planar outline and coplanar clustering on the
    same vertex soups give the same faces."""
    from deepmimo_tpu.scene import get_object_faces as jax_faces
    from deepmimo_tpu_torch.scene import get_object_faces
    verts = _soups()[fast]
    got, want = get_object_faces(verts, fast=fast), jax_faces(verts,
                                                               fast=fast)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_materials_and_txrx_match_jax(dm, multi_tx, monkeypatch):
    """``MaterialList.from_dict`` (strings parsed, duplicates dropped),
    the txrx sets and pairs of a scenario, and the scenario-path
    helpers."""
    got = dmt.MaterialList.from_dict(MATERIALS)
    want = dm.MaterialList.from_dict(MATERIALS)
    assert len(got) == len(want) == 2
    assert [dataclasses.asdict(m) for m in got] == \
        [dataclasses.asdict(m) for m in want]
    assert got.to_dict() == want.to_dict()
    assert [m.name for m in got[[1]]] == ["glass"]

    folder, _ = multi_tx
    root, name = os.path.split(folder)
    old = (dmt.config.get("scenarios_folder"),
           dm.config.get("scenarios_folder"))
    dmt.config.set("scenarios_folder", root)
    dm.config.set("scenarios_folder", root)
    try:
        assert dmt.get_params_path(name) == dm.get_params_path(name)
        assert dmt.get_available_scenarios() == \
            dm.get_available_scenarios()
        tsets, jsets = dmt.get_txrx_sets(name), dm.get_txrx_sets(name)
        assert [dataclasses.asdict(s) for s in tsets] == \
            [dataclasses.asdict(s) for s in jsets]
        tpairs = dmt.get_txrx_pairs(tsets)
        assert len(tpairs) == 3
        assert [(p.get_ids(), p.tx_idx, repr(p)) for p in tpairs] == \
            [(p.get_ids(), p.tx_idx, repr(p))
             for p in dm.get_txrx_pairs(jsets)]
    finally:
        dmt.config.set("scenarios_folder", old[0])
        dm.config.set("scenarios_folder", old[1])


def test_txrx_pair_table_matches_jax(dm, multi_tx, capsys):
    folder, _ = multi_tx
    root, name = os.path.split(folder)
    old = (dmt.config.get("scenarios_folder"),
           dm.config.get("scenarios_folder"))
    dmt.config.set("scenarios_folder", root)
    dm.config.set("scenarios_folder", root)
    try:
        dm.print_available_txrx_pair_ids(name)
        want = capsys.readouterr().out
        dmt.print_available_txrx_pair_ids(name)
        assert capsys.readouterr().out == want
    finally:
        dmt.config.set("scenarios_folder", old[0])
        dm.config.set("scenarios_folder", old[1])


# ----------------------------------------------------------------------------
# Several TX points: MacroDataset
# ----------------------------------------------------------------------------

def test_multi_tx_load_matches_jax(dm, multi_tx):
    folder, datas = multi_tx
    jds, tds = dm.load(folder), dmt.load(folder)
    assert isinstance(tds, dmt.MacroDataset) and len(tds) == len(jds) == 3
    for i, (t, j) in enumerate(zip(tds.datasets, jds.datasets)):
        assert isinstance(t, dmt.Dataset)
        assert t["txrx"] == j["txrx"] == {"tx_set_id": 0, "rx_set_id": 1,
                                          "tx_idx": i}
        _same_arrays(t, j, c.ALL_MATRIX_NAMES)
        np.testing.assert_array_equal(t["power"], datas[i]["power"]
                                      .astype(np.float32))
    assert tds.n_ue == [N_UE] * 3
    assert tds["name"] == jds["name"] == ["multi_tx"] * 3
    assert tds.scene is None and jds.scene is None
    assert len(tds.materials) == len(jds.materials) == 2
    assert tds[0].materials is tds[2].materials
    assert tds.rt_params == jds.rt_params


@pytest.mark.parametrize("to_device", [False, True])
def test_multi_tx_channels_match_jax(dm, multi_tx, to_device):
    """Per-child channels and ``compute_channels_batched`` against the JAX
    package's (a fresh JAX MacroDataset, whose batched cache is right on
    its first call)."""
    folder, _ = multi_tx
    jds, tds = dm.load(folder), dmt.load(folder)
    for t, j in zip(tds.compute_channels(_params(dmt)),
                    jds.compute_channels(_params(dm))):
        _close(t, j)
    got = tds.compute_channels_batched(_params(dmt), to_device=to_device)
    want = jds.compute_channels_batched(_params(dm), to_device=to_device)
    if to_device:
        assert isinstance(got, torch.Tensor)
        _close(got.numpy(), np.asarray(want))
    else:
        assert len(got) == 3
        for t, j in zip(got, want):
            _close(t, j)


@pytest.mark.parametrize("to_device", [False, True])
def test_multi_tx_beam_gains_match_jax(dm, multi_tx, to_device):
    folder, _ = multi_tx
    jds, tds = dm.load(folder), dmt.load(folder)
    w = _codebook()
    got = tds.compute_beam_gains_batched(_params(dmt), codebook=w,
                                         to_device=to_device)
    want = jds.compute_beam_gains_batched(_params(dm), codebook=w,
                                          to_device=to_device)
    if to_device:
        _close(got.numpy(), np.asarray(want).reshape(got.shape), BG_RTOL)
        return
    for t, j, child in zip(got, want, tds.datasets):
        _close(t, j, BG_RTOL)
        # the plain version's batched products round by batch on the CPU
        _close(t, child.compute_beam_gains(_params(dmt), codebook=w), 1e-6)


def _extra_child(tmp_path, n_ue=8, max_paths=7, seed=70):
    folder = str(tmp_path / "extra")
    _write_pairs(folder, [_pair_data(n_ue, max_paths, seed)], (4, 2))
    _write_params(folder, 1, n_ue)
    return folder


BATCH_CASES = ["append", "child_fov", "random_ue_rotation",
               "time_domain_fov"]


@pytest.mark.parametrize("case", BATCH_CASES)
def test_batched_equals_per_child(dm, multi_tx, tmp_path, case):
    """The batched renders see the children as they are at the call: after
    ``append`` of a child with another user count and path width, after
    one child's ``apply_fov`` (also in the time domain, whose compaction
    packs that child's surviving paths), and with per-user UE rotations
    drawn per child. Held against the port's and the JAX package's
    per-child renders."""
    folder, _ = multi_tx
    tds, jds = dmt.load(folder), dm.load(folder)
    kw = {}
    if case == "random_ue_rotation":
        kw["ue_rotation"] = [[0, 30], [-20, 20], [0, 360]]
    if case == "time_domain_fov":
        kw[c.PARAMSET_FD_CH] = 0
    tds.compute_channels_batched(_params(dmt, **kw))    # a first call
    if case == "append":
        tds.append(dmt.load(_extra_child(tmp_path)))
        jds.append(dm.load(_extra_child(tmp_path)))
    if case in ("child_fov", "time_domain_fov"):
        for ds in (tds[1], jds[1]):
            ds.apply_fov(bs_fov=np.array([150, 120]),
                         ue_fov=np.array([300, 160]))
    got = tds.compute_channels_batched(_params(dmt, **kw))
    assert len(got) == len(tds) == (4 if case == "append" else 3)
    jwant = [d.compute_channels(_params(dm, **kw)) for d in jds.datasets]
    for g, t, j in zip(got, tds.datasets, jwant):
        own = t.compute_channels(_params(dmt, **kw))
        assert g.shape == own.shape
        _close(g, own, 1e-6)
        _close(g, j)
    if case == "time_domain_fov":
        return
    w = _codebook()
    gains = tds.compute_beam_gains_batched(_params(dmt, **kw), codebook=w)
    for g, t in zip(gains, tds.datasets):
        own = t.compute_beam_gains(_params(dmt, **kw), codebook=w)
        _close(g, own, 1e-6)


def test_batched_refusals(multi_tx):
    folder, _ = multi_tx
    tds = dmt.load(folder)
    p = _params(dmt)
    p[c.PARAMSET_POLAR_EN] = 1
    with pytest.raises(ValueError, match="dual-polar"):
        tds.compute_channels_batched(p)
    with pytest.raises(ValueError, match="codebook"):
        tds.compute_beam_gains_batched(_params(dmt))
    tds[0].set_channel_params(_params(dmt, **{c.PARAMSET_NUM_PATHS: 3}))
    with pytest.raises(ValueError, match="differ"):
        tds.compute_channels_batched()
    with pytest.raises(IndexError):
        dmt.MacroDataset().compute_channels_batched()


# ----------------------------------------------------------------------------
# Dynamic scenarios
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dynamic(tmp_path_factory):
    """Three snapshots (seeds 13-15) in scene_0..2, a scene of box
    buildings and three materials (two alike) at the root."""
    root = str(tmp_path_factory.mktemp("scen") / "dynamic")
    for i in range(3):
        _write_pairs(os.path.join(root, f"scene_{i}"),
                     [_pair_data(N_UE, 5, 13 + i)], GRID)
    scene = dmt.Scene()
    for i in range(6):
        scene.add_object(_box(12.0 * i, 0.0, 8.0, 8.0, 10.0 + i, i))
    meta = scene.export_data(root)
    _write_params(root, 1, N_UE, n_scenes=3, scene_meta=meta)
    return root


def test_dynamic_load_matches_jax(dm, dynamic):
    from deepmimo_tpu.generator.core import DynamicDataset as JaxDynamic
    jds, tds = dm.load(dynamic), dmt.load(dynamic)
    assert isinstance(tds, DynamicDataset) and isinstance(jds, JaxDynamic)
    assert tds.n_snapshots == jds.n_snapshots == 3
    assert isinstance(tds.scene, dmt.Scene)
    assert len(tds.scene.objects) == len(jds.scene.objects) == 6
    assert isinstance(tds.materials, dmt.MaterialList)
    assert len(tds.materials) == 2
    assert all(s.scene is tds.scene for s in tds.datasets)
    for t, j in zip(tds.datasets, jds.datasets):
        _same_arrays(t, j, c.ALL_MATRIX_NAMES)
    p0, p1 = (np.nan_to_num(tds[i].power) for i in (0, 1))
    assert not np.array_equal(p0, p1)
    got = tds.compute_channels(_params(dmt))
    want = jds.compute_channels(_params(dm))
    assert len(got) == 3
    for t, j in zip(got, want):
        _close(t, j)


# ----------------------------------------------------------------------------
# Legacy v3 folders
# ----------------------------------------------------------------------------

def _v3_source(pkg, n_ue, seed, doppler=False, polar=False, tx=(1, 2, 3)):
    d = _pair_data(n_ue, 6, seed, with_doppler=doppler)
    d.pop("inter_pos")
    data = {k: np.asarray(v, np.float32) for k, v in d.items()}
    data["rx_pos"] = np.arange(n_ue * 3, dtype=np.float32).reshape(n_ue, 3)
    data["tx_pos"] = np.array([tx], dtype=np.float32)
    if polar:
        rng = np.random.RandomState(seed + 7)
        nan = np.isnan(data["power"])
        for pol in POLS:
            for k, lo, hi in (("power", -130, -60), ("phase", -180, 180)):
                data[f"{k}_{pol.lower()}"] = np.where(
                    nan, np.nan, rng.uniform(lo, hi, nan.shape)).astype(
                        np.float32)
    return pkg.Dataset(data)


def _v3_folder(pkg, path, kind):
    """A v3 folder written by ``pkg``'s ``export_matlab``."""
    if kind == "single_doppler":
        ds = _v3_source(pkg, 20, 80, doppler=True)
        return pkg.export_matlab(ds, path, tx_power_dbm=30.0, chunk=8)
    if kind == "dual_polar":
        return pkg.export_matlab(_v3_source(pkg, 12, 81, polar=True), path)
    macro = pkg.MacroDataset([_v3_source(pkg, 10, 82),
                              _v3_source(pkg, 10, 83, tx=(40, 5, 20))])
    return pkg.export_matlab(macro, path, tx_power_dbm=10.0)


V3_KEYS = list(PATH_KEYS) + ["inter", "rx_pos", "tx_pos"]


def _v3_children(ds):
    return ds.datasets if type(ds).__name__ == "MacroDataset" else [ds]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["single_doppler", "dual_polar", "two_bs"])
def test_v3_folders_load_like_jax(dm, tmp_path, kind, writer):
    """v3 folders written by either package's ``export_matlab`` load in
    both packages through ``load`` (no params.json) to the same matrices
    (power re-referenced by the recorded transmit power) and channels."""
    folder = _v3_folder(dm if writer == "jax" else dmt,
                        str(tmp_path / f"v3_{kind}"), kind)
    assert not os.path.exists(os.path.join(folder, "params.json"))
    jds, tds = dm.load(folder), dmt.load(folder)
    assert isinstance(tds, dmt.MacroDataset) == (kind == "two_bs")
    keys = list(V3_KEYS)
    if kind == "single_doppler":
        keys += ["doppler_vel", "doppler_acc"]
        # written in dBm at 30 dBm transmit power, read back in dBW
        np.testing.assert_array_equal(
            tds["power"][:, :6], _v3_source(dmt, 20, 80, doppler=True).power)
    if kind == "dual_polar":
        keys += [f"{k}_{p.lower()}" for p in POLS for k in ("power",
                                                            "phase")]
    for t, j in zip(_v3_children(tds), _v3_children(jds)):
        _same_arrays(t, j, keys)
        assert t["txrx"] == j["txrx"] and t.rt_params == j.rt_params
    kw = {}
    if kind == "single_doppler":
        kw = {c.PARAMSET_DOPPLER_EN: 1,
              c.PARAMSET_DOPPLER_TIMES: np.array([0.0, 2e-3])}
    if kind == "dual_polar":
        kw = {c.PARAMSET_POLAR_EN: 1}
    got = tds.compute_channels(_params(dmt, **kw))
    want = jds.compute_channels(_params(dm, **kw))
    if kind == "two_bs":
        for t, j in zip(got, want):
            _close(t, j)
    elif kind == "dual_polar":
        for pol in POLS:
            _close(got[pol], want[pol])
    else:
        assert got.shape[-1] == 2
        _close(got, want)


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
def test_card_batched_renders_take_one_launch(cuda, multi_tx, tmp_path):
    """On the card, ``compute_channels_batched`` and
    ``compute_beam_gains_batched`` each launch their kernel once for all
    children, equal to the children's own renders bit for bit (each user
    is computed alone), also after ``append``."""
    folder, _ = multi_tx
    tds = dmt.load(folder)
    params, w = _params(dmt), _codebook()
    before = kr.LAUNCHES
    planes = tds.compute_channels_batched(params, to_device=True)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == before + 1 and planes.device.type == "cuda"
    start = 0
    for child in tds.datasets:
        own = child.compute_channels(params, to_device=True)
        n = child.n_ue
        assert torch.equal(planes[:, start:start + n]
                           if planes.shape[0] == 2 else
                           planes[start:start + n], own)
        start += n
    before = kb.LAUNCHES
    gains = tds.compute_beam_gains_batched(params, codebook=w)
    assert kb.LAUNCHES == before + 1
    for g, child in zip(gains, tds.datasets):
        np.testing.assert_array_equal(
            g, child.compute_beam_gains(params, codebook=w))
    tds.append(dmt.load(_extra_child(tmp_path)))
    got = tds.compute_channels_batched(params)
    assert len(got) == 4 and got[3].shape[0] == 8
    np.testing.assert_array_equal(got[3],
                                  tds[3].compute_channels(params))
