"""PyTorch port vs the JAX package: the scenario-factory pipelines.

- ``geo_utils`` and ``placement`` give the JAX package's numbers exactly;
  GPS round trips; the port's GIS export (``transform_coordinates``, now on
  ``geo_utils.cartesian_to_gps``) gives the coordinates it gave before.
- ``read_pipeline_csv`` reads the JAX rows; ``PipelineState`` persists
  across instances.
- ``write_insite_project`` writes the JAX package's files byte for byte
  (grid and point-list receivers), and the port's InSite converter reads
  them back.
- ``build_blender_script`` emits the JAX package's text except for two
  fixes, compiles, and names no package. ``trim_to_bounds`` is held
  against a fake ``bpy`` whose removed objects raise ReferenceError on
  ``.name``: the JAX script raises
  (``test_reference_trim_to_bounds_reads_removed_road``), the port's
  skips the removed road (``test_trim_to_bounds_skips_removed_road``).
  The constants at the script's head evaluate without numpy in the port's
  script; under numpy 2 the JAX script writes ``np.float64(...)`` there
  (``test_reference_script_head_needs_numpy``).
- The gated tools raise without Blender, ``wibatch`` or Sionna.
- ``run_pipeline`` on a resumed state converts the Sionna export of one row
  (as the JAX runner converts it, file for file), uploads it to a loopback
  mock of the database and marks a row without state ``error``. Without
  matplotlib the JAX runner marks the uploaded row ``error`` (its
  ``upload`` lets the plot's ImportError through after the submission;
  ``test_reference_upload_without_matplotlib_fails_the_row``); the port
  skips the images and completes the row.
"""

import ast
import os
import re
import shutil
import sys
import types

import numpy as np
import pytest

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.pipelines import blender_osm, geo_utils, placement
from deepmimo_tpu_torch.pipelines import insite_project
from deepmimo_tpu_torch.pipelines.raytracers import (RaytracerNotAvailable,
                                                     raytrace_insite,
                                                     raytrace_sionna)
from deepmimo_tpu_torch.pipelines.runner import (PipelineState,
                                                 read_pipeline_csv)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from mock_db_server import MockDatabase  # noqa: E402
from test_torch_convert_sionna import same_scenario_files  # noqa: E402

BBOX = (40.68503298, -73.84682129, 40.68597435, -73.84336302)


@pytest.fixture
def dm():
    """The JAX package (imported here only)."""
    import deepmimo_tpu
    return deepmimo_tpu


@pytest.fixture(autouse=True)
def port_on_cpu():
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    dmt.config.set("api_endpoint", "http://127.0.0.1:1")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


# ----------------------------------------------------------------------------
# geo_utils, placement
# ----------------------------------------------------------------------------

GEO_CASES = {
    "haversine": (33.42, -111.93, 33.43, -111.92),
    "meters_per_deg_lon": (40.7,),
    "gps_to_cartesian": ([33.43, 33.42, 33.4], [-111.92, -111.94, -111.9],
                         33.42, -111.93),
    "cartesian_to_gps": ([10.5, -300.25, 0.0], [44.0, 1e3, -7.5], 33.42,
                         -111.93),
    "bbox_center": (BBOX,),
    "bbox_size_meters": (BBOX,),
    "pad_bbox": (BBOX, 40.0),
}


@pytest.mark.parametrize("fn", list(GEO_CASES))
def test_geo_utils_match_jax(fn):
    from deepmimo_tpu.pipelines import geo_utils as jgeo
    got = getattr(geo_utils, fn)(*GEO_CASES[fn])
    want = getattr(jgeo, fn)(*GEO_CASES[fn])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_geo_roundtrip():
    lat0, lon0 = 33.42, -111.93
    x, y = geo_utils.gps_to_cartesian([33.43, 33.42], [-111.92, -111.94],
                                      lat0, lon0)
    lat, lon = geo_utils.cartesian_to_gps(x, y, lat0, lon0)
    np.testing.assert_allclose(lat, [33.43, 33.42], atol=1e-9)
    np.testing.assert_allclose(lon, [-111.92, -111.94], atol=1e-9)
    assert abs(geo_utils.haversine(33.42, -111.93, 33.43, -111.93) -
               1113.2) < 5
    padded = geo_utils.pad_bbox((33.42, -111.93, 33.43, -111.92), 100)
    assert padded[0] < 33.42 and padded[2] > 33.43


RT = {"gps_bbox": (33.42, -111.93, 33.423, -111.927), "grid_spacing": 20.0,
      "ue_height": 1.5, "bs_lats": [33.4215, 33.422],
      "bs_lons": [-111.9285, -111.928], "bs_heights": [10.0, 12.0]}

PLACEMENT_CASES = {
    "tx_bbox_origin": ("gen_tx_pos", (RT,)),
    "tx_explicit_origin": ("gen_tx_pos", ({**RT, "origin_lat": 33.421,
                                           "origin_lon": -111.929},)),
    "rx_grid": ("gen_rx_grid", (RT,)),
    "rx_grid_2m": ("gen_rx_grid", ({**RT, "grid_spacing": 2.0},)),
    "rx_grid_defaults": ("gen_rx_grid", ({"gps_bbox": BBOX},)),
    "plane_grid": ("gen_plane_grid", (-10.0, 12.0, 0.0, 7.0, 2.5, 3.0)),
}


@pytest.mark.parametrize("case", list(PLACEMENT_CASES))
def test_placement_matches_jax(case):
    from deepmimo_tpu.pipelines import placement as jplacement
    fn, args = PLACEMENT_CASES[case]
    got = getattr(placement, fn)(*args)
    want = getattr(jplacement, fn)(*args)
    assert got.dtype == want.dtype and got.shape[1] == 3
    np.testing.assert_array_equal(got, want)


def test_gis_coordinates_unchanged(dm):
    """``transform_coordinates`` now converts through ``geo_utils``: the
    JAX package's rows, and the formula of the helper it replaced."""
    from deepmimo_tpu_torch.generator.visualization import \
        transform_coordinates
    pos = np.random.RandomState(2).uniform(-500, 500, (40, 3))
    got = transform_coordinates(pos, 33.42, -111.93)
    np.testing.assert_array_equal(got, dm.generator.visualization
                                  .transform_coordinates(pos, 33.42,
                                                         -111.93))
    m = 111_320.0
    np.testing.assert_array_equal(got[:, 0], 33.42 + pos[:, 1] / m)
    np.testing.assert_array_equal(
        got[:, 1], -111.93 + pos[:, 0] / (m * np.cos(np.radians(33.42))))


# ----------------------------------------------------------------------------
# Runner CSV and state
# ----------------------------------------------------------------------------

CSV = ("name,min_lat,min_lon,max_lat,max_lon,bs_lat,bs_lon,bs_height\n"
       "city_a,33.42,-111.93,33.43,-111.92,33.425|33.426,"
       "-111.925|-111.924,6|8\n"
       "city_b,40.1,-73.9,40.2,-73.8,40.15,-73.85,\n")


def test_pipeline_csv_matches_jax(tmp_path):
    from deepmimo_tpu.pipelines import read_pipeline_csv as jread
    path = tmp_path / "rows.csv"
    path.write_text(CSV)
    rows = read_pipeline_csv(str(path))
    want = jread(str(path))
    assert [r.__dict__ for r in rows] == [r.__dict__ for r in want]
    assert rows[0].bs_lats == [33.425, 33.426]
    assert rows[0].bs_heights == [6.0, 8.0]
    assert rows[1].bs_heights == [6.0]                  # the default
    assert rows[1].gps_bbox == (40.1, -73.9, 40.2, -73.8)


def test_pipeline_state_persists(tmp_path):
    state = PipelineState(str(tmp_path))
    assert not state.done("city_a", "scene")
    state.mark("city_a", "scene")
    state.mark("city_b", "error", status="boom")
    again = PipelineState(str(tmp_path))
    assert again.done("city_a", "scene")
    assert not again.done("city_b", "error")
    assert again.state["city_b"]["error"] == "boom"


# ----------------------------------------------------------------------------
# InSite project
# ----------------------------------------------------------------------------

RT_PARAMS = {"name": "autogen", "frequency": 28e9, "bandwidth": 50e6,
             "max_reflections": 3, "max_diffractions": 1,
             "max_transmissions": 0, "ray_spacing": 0.2,
             "origin_lat": 33.42, "origin_lon": -111.93, "zmin": -2.0,
             "zmax": 120.0}
TX = np.array([[0.0, -10.0, 25.0]])


def _grid_rx(nx=4, ny=3, sp=2.0, z=1.5):
    xs, ys = np.meshgrid(np.arange(nx) * sp, np.arange(ny) * sp)
    return np.stack([xs.ravel(), ys.ravel(), np.full(nx * ny, z)], axis=1)


RX_CASES = {
    "grid": (_grid_rx(), RT_PARAMS, ("city.city",)),
    "points": (np.array([[0, 0, 1.5], [3, 1, 1.5], [7, 2, 2.0]]),
               {**RT_PARAMS, "bbox_xy": [[-5, -5], [-5, 9], [9, 9], [9, -5]],
                "bs_rotation": (10.0, -5.0, 0.0)}, ()),
    "defaults": (_grid_rx(5, 2, 1.5), {}, ("a.ter", "b.city")),
}


@pytest.mark.parametrize("case", list(RX_CASES))
def test_insite_project_matches_jax(tmp_path, case):
    from deepmimo_tpu.pipelines.insite_project import \
        write_insite_project as jwrite
    from deepmimo_tpu_torch.converter.insite.rt_params import read_rt_params
    from deepmimo_tpu_torch.converter.insite.txrx import read_txrx
    rx, rt, features = RX_CASES[case]
    got = insite_project.write_insite_project(
        "row", str(tmp_path / "port"), TX, rx, rt, feature_files=features)
    want = jwrite("row", str(tmp_path / "jax"), TX, rx, rt,
                  feature_files=features)
    assert os.path.basename(got) == os.path.basename(want)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 3
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name

    out = str(tmp_path / "port")
    params = read_rt_params(out)
    assert params["frequency"] == rt.get("frequency", 3.5e9)
    assert params["max_reflections"] == rt.get("max_reflections", 4)
    sets, locations = read_txrx(out)
    sets = list(sets.values())
    rx_sets = [s for s in sets if s["is_rx"]]
    assert len(rx_sets) == 1 and len([s for s in sets if s["is_tx"]]) == 1
    assert rx_sets[0]["num_points"] == len(rx)
    np.testing.assert_allclose(locations[sets.index(rx_sets[0])], rx,
                               atol=1e-9)


def test_infer_grid_matches_jax():
    from deepmimo_tpu.pipelines.insite_project import infer_grid as jinfer
    for rx in (_grid_rx(5, 4, 1.5), _grid_rx(2, 2, 3.0),
               np.random.RandomState(0).uniform(0, 1, (8, 3)),
               _grid_rx(4, 3, 2.0)[::-1]):
        got, want = insite_project.infer_grid(rx), jinfer(rx)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]


# ----------------------------------------------------------------------------
# Blender OSM script
# ----------------------------------------------------------------------------

FORMATS = {"insite": ("insite",), "sionna": ("insite", "sionna")}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_blender_script_matches_jax_but_the_fix(tmp_path, fmt):
    import difflib
    from deepmimo_tpu.pipelines.blender_osm import \
        build_blender_script as jbuild
    kw = {"formats": FORMATS[fmt], "addons_dir": str(tmp_path / "addons")}
    got = blender_osm.build_blender_script(BBOX, str(tmp_path), **kw)
    # numpy 2 writes a numpy float as "np.float64(x)"; the port writes x.
    want = re.sub(r"np\.float64\(([^()]*)\)", r"\1",
                  jbuild(BBOX, str(tmp_path), **kw))
    compile(got, "osm_export.py", "exec")
    assert "deepmimo" not in got
    changed = [line for line in difflib.unified_diff(
        want.splitlines(), got.splitlines(), lineterm="", n=0)
        if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert changed == [
        "-    outright when fully outside.\"\"\"",
        "+    outright when fully outside. Returns False when it deleted "
        "the object",
        "+    (its Python handle is then invalid), True otherwise.\"\"\"",
        "-            return",
        "+            return False",
        "-            return                       # fully inside: nothing "
        "to trim",
        "+            return True                  # fully inside: nothing "
        "to trim",
        "+    return True",
        "-        trim_to_bounds(obj, *XY_BOUNDS)",
        "-        if obj.name in bpy.data.objects:",
        "+        if trim_to_bounds(obj, *XY_BOUNDS):",
    ]


def _head(script):
    """The constants at the head of a generated script, evaluated in a
    namespace without numpy."""
    tree = ast.parse(script)
    body = [n for n in tree.body if isinstance(n, ast.Assign)]
    ns = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), "osm", "exec"), ns)
    return ns


def test_script_head_evaluates(tmp_path):
    ns = _head(blender_osm.build_blender_script(BBOX, str(tmp_path)))
    xy = blender_osm.xy_bounds_from_bbox(BBOX, pad_m=40.0)
    assert ns["XY_BOUNDS"] == xy
    assert all(type(v) is float for v in ns["XY_BOUNDS"] +
               ns["TERRAIN_SIZE"])
    sx, sy = geo_utils.bbox_size_meters(BBOX)
    assert ns["TERRAIN_SIZE"] == (sx * 1.2, sy * 1.2)
    assert ns["MIN_LAT"] == BBOX[0] and ns["WANT_SIONNA"] is False


def test_reference_script_head_needs_numpy(tmp_path):
    """Under numpy 2 the JAX script's head reads ``np.float64(...)``, a
    name Blender's run of it lacks: NameError before any import. Held as
    the reference's behaviour, not as right."""
    from deepmimo_tpu.pipelines.blender_osm import \
        build_blender_script as jbuild
    script = jbuild(BBOX, str(tmp_path))
    if repr(np.float64(1.5)) == "1.5":           # numpy 1 writes floats
        assert _head(script)["XY_BOUNDS"] == \
            blender_osm.xy_bounds_from_bbox(BBOX, pad_m=40.0)
    else:
        assert "XY_BOUNDS = (np.float64(" in script
        with pytest.raises(NameError):
            _head(script)


def test_blender_constants_match_jax():
    from deepmimo_tpu.pipelines import blender_osm as jb
    for name in ("ADDON_ZIPS", "MATERIALS", "ROAD_TIERS",
                 "REJECTED_ROAD_KEYWORDS"):
        assert getattr(blender_osm, name) == getattr(jb, name), name
    for pad in (0.0, 40.0):
        assert blender_osm.xy_bounds_from_bbox(BBOX, pad) == \
            jb.xy_bounds_from_bbox(BBOX, pad)


class _Removed:
    """What a Python handle of a deleted Blender object does: any
    attribute read raises ReferenceError."""

    def __getattr__(self, name):
        raise ReferenceError("StructRNA of type Object has been removed")


class _Identity:
    def __matmul__(self, co):
        return co


class _Obj:
    def __init__(self, name, xy):
        self.name = name
        self.type = "MESH"
        self.matrix_world = _Identity()
        self.data = types.SimpleNamespace(
            vertices=[types.SimpleNamespace(co=types.SimpleNamespace(
                x=x, y=y)) for x, y in xy],
            materials=[])


class _Objects:
    """``bpy.data.objects``: name lookup, iteration, removal (a removed
    object's handle turns into a ``_Removed``)."""

    def __init__(self, objs):
        self._objs = {o.name: o for o in objs}

    def __iter__(self):
        return iter(list(self._objs.values()))

    def __contains__(self, name):
        return name in self._objs

    def __getitem__(self, name):
        return self._objs[name]

    def remove(self, obj, do_unlink=True):
        del self._objs[obj.name]
        obj.__class__ = _Removed
        obj.__dict__.clear()


def _roads(script, ns=None):
    """``trim_to_bounds`` and ``process_roads`` of a generated script, run
    against a fake ``bpy`` holding a road inside the bounds, one fully
    outside and one rejected auxiliary. Returns (process_roads, the
    objects, the material)."""
    tree = ast.parse(script)
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in
                ("trim_to_bounds", "process_roads")) or
            (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
             and n.targets[0].id in ("ROAD_TIERS", "REJECTED_ROAD_KEYWORDS",
                                     "XY_BOUNDS"))]
    inside = _Obj("map.osm_roads_primary", [(0.0, 0.0), (5.0, 5.0)])
    outside = _Obj("map.osm_roads_secondary", [(1e4, 1e4), (1e4 + 5, 1e4)])
    aux = _Obj("map.profile_x", [(0.0, 0.0)])
    objects = _Objects([inside, outside, aux])
    bpy = types.SimpleNamespace(data=types.SimpleNamespace(objects=objects))
    ns = dict(ns or {}, bpy=bpy)
    exec(compile(ast.Module(body=keep, type_ignores=[]), "osm", "exec"), ns)
    return ns["process_roads"], (inside, outside), "road_material"


def test_reference_trim_to_bounds_reads_removed_road(tmp_path):
    """The JAX script removes the road lying fully outside the bounds, then
    reads its ``.name``: ReferenceError, which aborts Blender's export.
    Held as the reference's behaviour, not as right."""
    from deepmimo_tpu.pipelines.blender_osm import \
        build_blender_script as jbuild
    process_roads, _, mat = _roads(jbuild(BBOX, str(tmp_path)),
                                   {"np": np})
    with pytest.raises(ReferenceError):
        process_roads(mat)


def test_trim_to_bounds_skips_removed_road(tmp_path):
    process_roads, (inside, outside), mat = _roads(
        blender_osm.build_blender_script(BBOX, str(tmp_path)))
    assert process_roads(mat) is True
    assert inside.data.materials == [mat]
    assert isinstance(outside, _Removed)


# ----------------------------------------------------------------------------
# Gated tools
# ----------------------------------------------------------------------------

def test_gated_tools_raise(tmp_path, monkeypatch):
    monkeypatch.delenv("BLENDER_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    assert blender_osm.find_blender() is None
    with pytest.raises(blender_osm.BlenderNotAvailable):
        blender_osm.fetch_osm_scene(BBOX, str(tmp_path / "new"))
    with pytest.raises(RaytracerNotAvailable):
        raytrace_sionna(str(tmp_path), np.zeros((1, 3)), np.zeros((2, 3)),
                        {})
    with pytest.raises(RaytracerNotAvailable):
        raytrace_insite(str(tmp_path), np.zeros((1, 3)), np.zeros((2, 3)),
                        {})


def test_fetch_skips_existing(tmp_path):
    (tmp_path / "buildings.ply").write_text("ply")
    assert blender_osm.fetch_osm_scene(BBOX, str(tmp_path)) == str(tmp_path)


# ----------------------------------------------------------------------------
# run_pipeline
# ----------------------------------------------------------------------------

SITES = ("name,min_lat,min_lon,max_lat,max_lon,bs_lat,bs_lon,bs_height\n"
         "site_a,40.7,-73.9,40.70009,-73.89988,40.700045,-73.89994,25\n"
         "site_b,40.8,-73.9,40.801,-73.899,40.8005,-73.8995,10\n")


def _resumed_work(root):
    """A pipeline work folder: the sites CSV, ``site_a``'s Sionna export
    at its placement (``chip_smoke.py``'s writers) with ``scene`` and
    ``raytrace`` marked done, nothing for ``site_b``. Returns (csv, work,
    users)."""
    os.makedirs(root)
    csv_path = os.path.join(root, "sites.csv")
    with open(csv_path, "w") as f:
        f.write(SITES)
    work = os.path.join(root, "work")
    row = read_pipeline_csv(csv_path)[0]
    rt = {"gps_bbox": row.gps_bbox, "bs_lats": row.bs_lats,
          "bs_lons": row.bs_lons, "bs_heights": row.bs_heights,
          "grid_spacing": 2.0, "ue_height": 1.5}
    rx = placement.gen_rx_grid(rt)
    src = chip_smoke.conv_source(len(rx), seed=31)
    src["rx_pos"], src["tx_pos"] = rx, placement.gen_tx_pos(rt)
    chip_smoke.write_sionna_export(os.path.join(work, "site_a",
                                                "rt_output"), src)
    os.makedirs(work, exist_ok=True)
    state = PipelineState(work)
    for stage in ("scene", "raytrace"):
        state.mark("site_a", stage)
    return csv_path, work, len(rx)


@pytest.fixture
def no_blender(monkeypatch):
    monkeypatch.delenv("BLENDER_PATH", raising=False)
    monkeypatch.setenv("PATH", "")


def _run(pkg, conf, csv_path, work, scen_dir, **kw):
    old = {k: conf.get(k) for k in ("scenarios_folder", "api_endpoint")}
    conf.set("scenarios_folder", scen_dir)
    try:
        with MockDatabase() as db:
            conf.set("api_endpoint", db.url)
            done = pkg.pipelines.run_pipeline(csv_path, work, **kw)
            return done, db.received
    finally:
        for k, v in old.items():
            conf.set(k, v)


def test_run_pipeline_converts_uploads_and_marks_errors(dm, tmp_path,
                                                        no_blender):
    from deepmimo_tpu.config import config as jconfig
    csv_path, work, n_ue = _resumed_work(str(tmp_path / "run"))
    jax_work = str(tmp_path / "jax_work")
    shutil.copytree(work, jax_work)
    assert n_ue == 36                        # 6 x 6 users at 2 m

    done, sent = _run(dmt, dmt.config, csv_path, work,
                      str(tmp_path / "port_scen"), upload_key="k")
    assert done == ["site_a"]
    state = PipelineState(work).state
    assert state["site_a"] == {"scene": "done", "raytrace": "done",
                               "convert": "done", "upload": "done"}
    assert set(state["site_b"]) == {"error"}
    assert "Blender" in state["site_b"]["error"]
    assert sent["submission"]["scenario"] == "site_a"
    assert sent["zip"]

    jdone, _ = _run(dm, jconfig, csv_path, jax_work,
                    str(tmp_path / "jax_scen"))
    assert jdone == ["site_a"]
    port = str(tmp_path / "port_scen" / "site_a")
    for png in [f for f in os.listdir(port) if f.endswith(".png")]:
        os.remove(os.path.join(port, png))      # the upload's images
    same_scenario_files(str(tmp_path / "jax_scen" / "site_a"), port)
    ds = dmt.load(port)
    assert ds.n_ue == n_ue
    np.testing.assert_allclose(ds.rx_pos[:, :2], placement.gen_rx_grid(
        {"gps_bbox": read_pipeline_csv(csv_path)[0].gps_bbox,
         "grid_spacing": 2.0})[:, :2], atol=1e-4)

    # A second run resumes: nothing is converted or uploaded again.
    done, sent = _run(dmt, dmt.config, csv_path, work,
                      str(tmp_path / "port_scen"), upload_key="k")
    assert done == ["site_a"] and "zip" not in sent


def test_reference_upload_without_matplotlib_fails_the_row(
        dm, tmp_path, no_blender, monkeypatch):
    """Without matplotlib the JAX runner's upload sends the archive and
    the submission, then raises the plot's ImportError, so the uploaded
    row is marked ``error`` (and a resume uploads it again). Held as the
    reference's behaviour, not as right."""
    from deepmimo_tpu.config import config as jconfig
    csv_path, work, _ = _resumed_work(str(tmp_path / "run"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    done, sent = _run(dm, jconfig, csv_path, work,
                      str(tmp_path / "jax_scen"), upload_key="k")
    assert done == []
    assert sent["submission"]["scenario"] == "site_a"
    state = PipelineState(work).state["site_a"]
    assert state["convert"] == "done" and "upload" not in state
    assert "matplotlib" in state["error"]


def test_upload_without_matplotlib_completes_the_row(tmp_path, no_blender,
                                                     monkeypatch, capsys):
    csv_path, work, _ = _resumed_work(str(tmp_path / "run"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    done, sent = _run(dmt, dmt.config, csv_path, work,
                      str(tmp_path / "port_scen"), upload_key="k")
    assert done == ["site_a"]
    assert "images" not in sent
    assert PipelineState(work).done("site_a", "upload")
    assert "Image upload skipped" in capsys.readouterr().out
