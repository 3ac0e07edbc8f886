"""PyTorch port vs the JAX package: the Wireless InSite converter.

The same InSite project folder (the JAX tests' fixture writers, with a
.setup from ``deepmimo_tpu.pipelines.insite_project.build_setup_nodes``)
goes through ``convert`` of each package in turn, each into its own
scenarios folder. Every ``.mat`` matrix must be equal bit for bit,
``params.json`` (and the scene's ``objects.json``) equal, with
``compare_two_dicts`` finding no key on either side that the other lacks,
and both scenarios ``load`` to channels within 5e-5 * max|H|
(``tests/test_pallas.py:177``).

The port parses .paths.p2m files with its native C++ parser (built with
g++ into ``build/native/``); the JAX package's conversions here take its
Python parser (its ``_try_native`` is patched out, so no test builds or
loads the JAX package's shared library), which the native parse must
equal bit for bit, also past ``MAX_PATHS`` paths and
``MAX_INTER_PER_PATH`` interactions and with receivers that have no path.
A TX without any path takes its position from the swapped-index .pl file.
``chip_smoke.py`` phase 5j's writers (one path set as an InSite project
and as a Sionna export) convert to equal matrices in both packages.
"""

import os
import sys

import numpy as np
import pytest
import scipy.io
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import consts as c
from deepmimo_tpu_torch import native
from deepmimo_tpu_torch.converter.insite import p2m as tp2m

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.dirname(TESTS))
import chip_smoke  # noqa: E402
from test_torch_convert_sionna import (  # noqa: E402
    channel_params, convert_both, same_channels, same_scenario_files)
from test_insite_converter import (RX_POS, TX_POS,  # noqa: E402
                                   _city_text, _paths_p2m_text,
                                   _pl_p2m_text, _project_xml)

torch.set_num_threads(1)
RT_PARAMS = {"name": "canyon", "frequency": 2.4e9, "max_reflections": 4,
             "max_diffractions": 1, "ray_spacing": 0.25,
             "origin_lat": 33.42, "origin_lon": -111.93}
LETTERS = ("R", "D", "DS", "T", "F", "X")


@pytest.fixture
def dm(monkeypatch):
    """The JAX package (imported here only), converting with its Python
    p2m parser."""
    import deepmimo_tpu
    from deepmimo_tpu.converter.insite import p2m as jp2m
    monkeypatch.setattr(jp2m, "_try_native", lambda: None)
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
# Project writers (the JAX fixture's formats, with any paths and sets)
# ----------------------------------------------------------------------------

def _setup_text():
    from deepmimo_tpu.converter.insite.tokenfmt import serialize_insite_text
    from deepmimo_tpu.pipelines.insite_project import build_setup_nodes
    return serialize_insite_text(build_setup_nodes(RT_PARAMS))


def _paths_text(paths, tx_pos, rx_pos):
    """A .paths.p2m file in the layout of ``_paths_p2m_text``, for
    ``paths`` {rx: [(power, phase, delay, aoa_el, aoa_az, aod_el, aod_az,
    chain, bounces)]}."""
    lines = [f"# header {i}" for i in range(21)] + [str(len(paths))]
    for rx, plist in paths.items():
        lines.append(f"{rx + 1} {len(plist)}")
        if not plist:
            continue
        lines.append(f"{max(p[0] for p in plist)!r} 0.0 0.0")
        for i, (*vals, chain, bounces) in enumerate(plist):
            lines.append(f"{i + 1} {len(bounces)} " +
                         " ".join(repr(float(v)) for v in vals))
            lines.append(chain)
            lines.append(" ".join(repr(float(v)) for v in tx_pos))
            lines += [" ".join(repr(float(v)) for v in b) for b in bounces]
            lines.append(" ".join(repr(float(v)) for v in rx_pos[rx]))
    return "\n".join(lines) + "\n"


def _pl_text(paths, tx_pos, rx_pos):
    lines = ["# <rx> <x> <y> <z> <distance> <pathloss>"]
    for rx, pos in enumerate(rx_pos):
        pl = 250.0 if not paths.get(rx) else 80.0 + rx
        dist = float(np.linalg.norm(np.subtract(pos, tx_pos)))
        lines.append(f"{rx + 1} {pos[0]:.4f} {pos[1]:.4f} {pos[2]:.4f} "
                     f"{dist:.4f} {pl:.4f}")
    return "\n".join(lines) + "\n"


def _random_paths(n_rx, seed, max_n=30, max_chain=12):
    """Receivers with 0 to ``max_n`` paths (two with none; one with
    ``max_n`` > MAX_PATHS), each a chain of up to ``max_chain`` >
    MAX_INTER_PER_PATH interactions of every InSite letter."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, max_n + 1, n_rx)
    counts[1] = counts[n_rx - 2] = 0
    counts[0] = max_n
    paths = {}
    for rx, n in enumerate(counts):
        plist = []
        for p in range(n):
            chain = [LETTERS[i] for i in rng.randint(0, len(LETTERS),
                                                      rng.randint(0, 4))]
            if p == 1:
                chain = ["R"] * max_chain
            vals = (rng.uniform(-140, -60), rng.uniform(-180, 180),
                    rng.uniform(1e-7, 5e-6), rng.uniform(0, 180),
                    rng.uniform(-180, 180), rng.uniform(0, 180),
                    rng.uniform(-180, 180))
            bounces = [tuple(rng.uniform(-50, 50, 3)) for _ in chain]
            plist.append((*vals, "-".join(["Tx"] + chain + ["Rx"]),
                          bounces))
        paths[rx] = plist
    return paths


def _grid_positions(nx, ny):
    return [(float(x), float(y), 1.5) for y in range(ny) for x in range(nx)]


def _write(folder, files):
    for name, text in files.items():
        path = os.path.join(folder, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return folder


def _project(tmp_path, case):
    """An InSite project folder ``<tmp>/rt/canyon``:

    - "fixture": the JAX tests' fixture (4 receivers; LoS, R, RD, DS);
    - "deep": 6 receivers with up to 30 paths of up to 12 interactions
      (past MAX_PATHS and MAX_INTER_PER_PATH), two without paths;
    - "silent_tx": two TX points; the second reaches no receiver and
      takes its position from the swapped-index .pl file.
    """
    folder = str(tmp_path / "rt" / "canyon")
    files = {"canyon.setup": _setup_text(), "canyon.city": _city_text()}
    study = "study_area/canyon"
    if case == "fixture":
        files.update({"canyon.xml": _project_xml(),
                      f"{study}.paths.t001_01.r002.p2m": _paths_p2m_text(),
                      f"{study}.pl.t001_01.r002.p2m": _pl_p2m_text()})
        return _write(folder, files)
    rx_pos = _grid_positions(3, 2)
    if case == "deep":
        paths = _random_paths(len(rx_pos), seed=31)
        files.update({"canyon.xml": chip_smoke.project_xml([TX_POS], 3, 2),
                      f"{study}.paths.t001_01.r002.p2m":
                      _paths_text(paths, TX_POS, rx_pos),
                      f"{study}.pl.t001_01.r002.p2m":
                      _pl_text(paths, TX_POS, rx_pos)})
        return _write(folder, files)
    assert case == "silent_tx"
    tx2 = (30.0, 40.0, 12.0)
    paths = _random_paths(len(rx_pos), seed=32, max_n=6, max_chain=3)
    none = {rx: [] for rx in range(len(rx_pos))}
    files.update({
        "canyon.xml": chip_smoke.project_xml([TX_POS, tx2], 3, 2,
                                             rx_id=3),
        f"{study}.paths.t001_01.r003.p2m": _paths_text(paths, TX_POS,
                                                       rx_pos),
        f"{study}.pl.t001_01.r003.p2m": _pl_text(paths, TX_POS, rx_pos),
        f"{study}.paths.t002_01.r003.p2m": _paths_text(none, tx2, rx_pos),
        f"{study}.pl.t002_01.r003.p2m": _pl_text(none, tx2, rx_pos),
        # the reciprocal link's .pl file: its first receiver is TX 2
        f"{study}.pl.t003_01.r002.p2m": _pl_text({}, TX_POS,
                                                 [tx2] + rx_pos)})
    return _write(folder, files)


# ----------------------------------------------------------------------------
# Parsers
# ----------------------------------------------------------------------------

def _same_mats(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["fixture", "deep", "silent_tx"])
def test_p2m_native_matches_python_and_jax(dm, tmp_path, case):
    """The port's native parse == its Python parse == the JAX package's
    Python parse, bit for bit; with a receiver of 30 paths (cut to
    MAX_PATHS) and chains of 12 interactions (positions cut to
    MAX_INTER_PER_PATH)."""
    from deepmimo_tpu.converter.insite import p2m as jp2m
    folder = _project(tmp_path, case)
    study = os.path.join(folder, "study_area")
    files = sorted(f for f in os.listdir(study) if ".paths." in f)
    for name in files:
        path = os.path.join(study, name)
        before = native.NATIVE_PARSES
        nat = tp2m.parse_paths_p2m(path)
        assert native.NATIVE_PARSES == before + 1
        py = tp2m.parse_paths_p2m(path, use_native=False)
        assert native.NATIVE_PARSES == before + 1
        _same_mats(nat, py)
        _same_mats(nat, jp2m.parse_paths_p2m(path, use_native=False))
        jtx, ttx = jp2m.extract_tx_pos(path), tp2m.extract_tx_pos(path)
        assert (jtx is None) == (ttx is None)
        if ttx is not None:
            np.testing.assert_array_equal(ttx, jtx)
        pl = path.replace(".paths.", ".pl.")
        for a, b in zip(tp2m.parse_pl_p2m(pl), jp2m.parse_pl_p2m(pl)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if case == "deep":
        power = nat[c.POWER_PARAM_NAME]
        assert power.shape[1] == c.MAX_PATHS
        assert (~np.isnan(power[0])).sum() == c.MAX_PATHS
        assert np.isnan(power[1]).all() and np.isnan(power[4]).all()
        assert nat[c.INTERACTIONS_POS_PARAM_NAME].shape[2] == \
            c.MAX_INTER_PER_PATH
        assert nat[c.INTERACTIONS_PARAM_NAME][0, 1] == \
            np.float32(float("1" * 12))


@pytest.mark.parametrize("present", [True, False])
def test_tx_pos_from_swapped_pl(dm, tmp_path, present):
    """A TX without paths: its position from the reciprocal link's .pl
    file, or None where that file is missing, in both packages."""
    from deepmimo_tpu.converter.insite import p2m as jp2m
    folder = _project(tmp_path, "silent_tx")
    study = os.path.join(folder, "study_area")
    path = os.path.join(study, "canyon.paths.t002_01.r003.p2m")
    assert tp2m.extract_tx_pos(path) is None
    if not present:
        os.remove(os.path.join(study, "canyon.pl.t003_01.r002.p2m"))
    got, want = tp2m.tx_pos_from_swapped_pl(path), \
        jp2m.tx_pos_from_swapped_pl(path)
    if present:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.float32([30.0, 40.0, 12.0]))
    else:
        assert got is None and want is None


# ----------------------------------------------------------------------------
# The readers and the whole conversion
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["rt_params", "txrx", "materials", "scene",
                                  "tokenfmt"])
def test_readers_match_jax(dm, tmp_path, part):
    """Each reader of the InSite converter gives the JAX package's result
    on the fixture project."""
    import importlib
    folder = _project(tmp_path, "fixture")
    jm = importlib.import_module(f"deepmimo_tpu.converter.insite.{part}")
    tm = importlib.import_module(
        f"deepmimo_tpu_torch.converter.insite.{part}")
    if part == "rt_params":
        assert tm.read_rt_params(folder) == jm.read_rt_params(folder)
    elif part == "txrx":
        (td, tp), (jd, jp) = tm.read_txrx(folder), jm.read_txrx(folder)
        assert td == jd and sorted(tp) == sorted(jp)
        for k in tp:
            np.testing.assert_array_equal(tp[k], jp[k])
    elif part == "materials":
        assert tm.read_materials(folder) == jm.read_materials(folder)
    elif part == "scene":
        ts, js = tm.read_scene(folder), jm.read_scene(folder)
        assert len(ts.objects) == len(js.objects) == 2
        for a, b in zip(ts.objects, js.objects):
            assert (a.name, a.object_id, a.label) == \
                (b.name, b.object_id, b.label)
            for fa, fb in zip(a.faces, b.faces):
                np.testing.assert_array_equal(fa.vertices, fb.vertices)
                assert fa.material_idx == fb.material_idx
    else:
        for text in (_setup_text(), _city_text()):
            tn, jn = tm.parse_insite_text(text), jm.parse_insite_text(text)
            assert [n.kind for n in tn] == [n.kind for n in jn]
            assert tm.serialize_insite_text(tn) == \
                jm.serialize_insite_text(jn)


@pytest.mark.parametrize("case", ["fixture", "deep", "silent_tx"])
def test_convert_matches_jax(dm, tmp_path, case):
    """``convert`` of one InSite project by both packages: equal scenario
    folders, then equal channels."""
    folder = _project(tmp_path, case)
    before = native.NATIVE_PARSES
    jax_folder, port_folder = convert_both(dm, folder, tmp_path,
                                           f"canyon_{case}")
    n_files = 2 if case == "silent_tx" else 1
    assert native.NATIVE_PARSES == before + n_files
    same_scenario_files(jax_folder, port_folder)
    jds, tds = same_channels(dm, jax_folder, port_folder)
    if case == "fixture":
        assert tds.n_ue == 4 and tds.rt_params[c.RT_PARAM_FREQUENCY] == 2.4e9
        assert len(tds.scene.objects) == 2
        np.testing.assert_allclose(np.asarray(tds.rx_pos), RX_POS)
    if case == "silent_tx":
        assert isinstance(tds, dmt.MacroDataset) and len(tds) == 2
        np.testing.assert_array_equal(np.asarray(tds[1].tx_pos).ravel(),
                                      [30.0, 40.0, 12.0])
        assert np.isnan(np.asarray(tds[1].power)).all()


def test_chip_smoke_exports_convert_alike(dm, tmp_path):
    """``chip_smoke.py`` phase 5j's writers: one path set as an InSite
    project and as a Sionna export converts to the same path matrices, bit
    for bit, in the port (native parser) and in the JAX package, and the
    port's two scenarios render to equal channels."""
    src = chip_smoke.conv_source(512, seed=41)
    insite = str(tmp_path / "rt" / "smoke_insite")
    sionna = str(tmp_path / "rt" / "smoke_sionna")
    chip_smoke.write_insite_project(insite, src)
    chip_smoke.write_sionna_export(sionna, src)
    folders = {}
    for engine, rt in (("insite", insite), ("sionna", sionna)):
        jf, tf = convert_both(dm, rt, tmp_path, f"smoke_{engine}")
        for key in chip_smoke.CONV_PATH_KEYS:
            fname = dmt.utils.get_mat_filename(key, 0, 0, 1)
            np.testing.assert_array_equal(
                scipy.io.loadmat(os.path.join(tf, fname))[key],
                scipy.io.loadmat(os.path.join(jf, fname))[key], err_msg=key)
        folders[engine] = tf
    for key in chip_smoke.CONV_PATH_KEYS:
        fname = dmt.utils.get_mat_filename(key, 0, 0, 1)
        a, b = (scipy.io.loadmat(os.path.join(f, fname))[key]
                for f in folders.values())
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=key)
    h = [dmt.load(f).compute_channels(channel_params(dmt)) for f in
         folders.values()]
    np.testing.assert_array_equal(h[0], h[1])
    assert np.abs(h[0]).max() > 0
