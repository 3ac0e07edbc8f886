"""PyTorch port vs the JAX package: the pipeline, stats, csvgen and
insite-ops CLIs (``deepmimo_tpu_torch/scripts``).

- ``csv_gen_cli`` writes the JAX package's pipeline CSV byte for byte (and
  fails alike when no city passes the filter); the runner reads it back.
- ``pipeline_cli`` runs the port's pipeline: rc 1 when no row completes,
  rc 0 and the completed list when a resumed row converts.
- ``stats_cli --json`` prints the JAX package's statistics of one
  scenario; the table and an unknown name behave alike.
- ``insite_ops_cli``: every subcommand's dry run touches nothing and
  prints the JAX package's plan; ``--apply`` leaves the JAX package's
  tree; ``rename-param-key`` defaults to the port's scenarios folder;
  ``zoom-image`` needs Pillow.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.scripts import (csv_gen_cli, insite_ops_cli,
                                        pipeline_cli, stats_cli)

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)


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


CITIES = ("city,city_ascii,lat,lng,population\n"
          "Tokyo,Tokyo,35.6897,139.6922,37977000\n"
          "Smallville,Smallville,40.0,-90.0,1200\n"
          "São Paulo,Sao Paulo,-23.5504,-46.6339,22046000\n"
          "Mexico City,,19.4333,-99.1333,21804000\n")

CSVGEN_ARGS = {
    "defaults": [],
    "two_bs": ["--box-m", "400", "--num-bs", "2", "--bs-height", "12"],
    "one_bs_capped": ["--box-m", "1023", "--num-bs", "1", "--max-cities",
                      "2", "--min-population", "1000"],
}


@pytest.mark.parametrize("case", list(CSVGEN_ARGS))
def test_csv_gen_matches_jax(tmp_path, capsys, case):
    from deepmimo_tpu.scripts.csv_gen_cli import main as jmain
    cities = tmp_path / "worldcities.csv"
    cities.write_text(CITIES, encoding="utf-8")
    port, jax = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert csv_gen_cli.main([str(cities), str(port)] +
                            CSVGEN_ARGS[case]) == 0
    out = capsys.readouterr().out
    assert jmain([str(cities), str(jax)] + CSVGEN_ARGS[case]) == 0
    assert out == capsys.readouterr().out.replace(str(jax), str(port))
    assert port.read_bytes() == jax.read_bytes()
    rows = dmt.pipelines.read_pipeline_csv(str(port))
    assert rows and all(r.name.startswith("city_") for r in rows)
    for row in rows:
        for blat, blon in zip(row.bs_lats, row.bs_lons):
            assert row.min_lat < blat < row.max_lat
            assert row.min_lon < blon < row.max_lon


def test_csv_gen_no_match(tmp_path, capsys):
    from deepmimo_tpu.scripts.csv_gen_cli import main as jmain
    cities = tmp_path / "c.csv"
    cities.write_text(CITIES, encoding="utf-8")
    args = [str(cities), str(tmp_path / "o.csv"), "--min-population", "1e9"]
    assert csv_gen_cli.main(args) == jmain(args) == 1
    assert not os.path.exists(tmp_path / "o.csv")
    assert capsys.readouterr().err.count("no cities matched") == 2


def test_pipeline_cli(tmp_path, monkeypatch, capsys):
    from test_torch_pipelines import _resumed_work
    monkeypatch.delenv("BLENDER_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    dmt.config.set("scenarios_folder", str(tmp_path / "scen"))
    csv_path, work, _ = _resumed_work(str(tmp_path / "run"))
    fresh = str(tmp_path / "fresh")
    assert pipeline_cli.main([csv_path, "--work-dir", fresh]) == 1
    assert "Completed 0 scenario(s): []" in capsys.readouterr().out
    assert pipeline_cli.main([csv_path, "--work-dir", work,
                              "--grid-spacing", "2.0"]) == 0
    assert "Completed 1 scenario(s): ['site_a']" in \
        capsys.readouterr().out
    assert os.path.isfile(str(tmp_path / "scen" / "site_a" / "params.json"))


@pytest.fixture
def stats_scen(tmp_path, monkeypatch):
    """Scenario ``stats_scen`` under ``deepmimo_scenarios`` of a temporary
    working directory (both packages' default scenarios folder)."""
    from scenario_utils import write_synthetic_scenario
    monkeypatch.chdir(tmp_path)
    write_synthetic_scenario(
        str(tmp_path / "deepmimo_scenarios" / "stats_scen"), n_ue=16,
        max_paths=6, seed=2, grid=(4, 4))
    return "stats_scen"


@pytest.mark.parametrize("args", [["--json"], []])
def test_stats_matches_jax(stats_scen, capsys, args):
    from deepmimo_tpu.scripts.stats_cli import main as jmain
    assert stats_cli.main([stats_scen] + args) == 0
    got = capsys.readouterr().out
    assert jmain([stats_scen] + args) == 0
    assert got == capsys.readouterr().out
    if args:
        stats = json.loads(got)
        assert stats[0]["n_ue"] == 16 and stats[0]["frequency_ghz"] == 3.5
        assert 0 < stats[0]["coverage_pct"] <= 100


def test_stats_default_lists_local_and_reports_failures(stats_scen, capsys):
    assert stats_cli.main(["--json"]) == 0
    assert [s["scenario"] for s in json.loads(
        capsys.readouterr().out)] == [stats_scen]
    assert stats_cli.main(["missing_scen", "--json"]) == 0
    captured = capsys.readouterr()
    assert json.loads(captured.out.splitlines()[-1]) == []
    assert "[stats] missing_scen failed" in captured.err


# ----------------------------------------------------------------------------
# insite-ops
# ----------------------------------------------------------------------------

def _mk(path, content=""):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)


def _farm(base):
    """A farm with a bbox-named InSite run, a project tree to prune, an
    insite subfolder to hoist and two scenarios' params.json; returns the
    argument lists of every subcommand, relative to ``base``."""
    bbox = os.path.join(base, "farm", "bbox_city_40-68_-73-84_40-69_-73-85_x")
    _mk(os.path.join(bbox, "insite_28", "proj.setup"))
    _mk(os.path.join(bbox, "insite_28", "study", "p.paths.t001_01.r002.p2m"))
    _mk(os.path.join(bbox, "osm", "buildings.ply"))
    _mk(os.path.join(bbox, "parameters.txt"))
    _mk(os.path.join(base, "cities.csv"),
        "name,bbox_minlat,bbox_minlon,bbox_maxlat,bbox_maxlon\n"
        "NewYork,40.68,-73.84,40.69,-73.85\nNowhere,1.0,2.0,3.0,4.0\n")
    proj = os.path.join(base, "projects", "city_a")
    _mk(os.path.join(proj, "scene.xml"), '<x Value="./keep.city"/>\n')
    for name in ("scene.diag", "stale.diag", "keep.city", "orphan.ter",
                 "study/p.paths.t001.p2m", "study/p.pl.t001.p2m",
                 "study/p.doa.t001.p2m"):
        _mk(os.path.join(proj, name))
    os.makedirs(os.path.join(proj, "old_deepmimo"))
    _mk(os.path.join(base, "scen", "insite", "a.setup"))
    _mk(os.path.join(base, "scen", "insite", "sub", "b.p2m"))
    for name, keys in (("a", {"txrx": {"x": 1}, "other": 2}),
                       ("b", {"txrx_sets": {}})):
        _mk(os.path.join(base, "scenarios", name, "params.json"),
            json.dumps(keys))
    return {
        "clean-city": ["clean-city", "cities.csv", "farm", "--suffix", "_28"],
        "clean-sources": ["clean-sources", "projects", "--p2m", "--objects",
                          "--extra-deepmimo"],
        "move-insite-out": ["move-insite-out", "scen"],
        "rename-param-key": ["rename-param-key", "--root", "scenarios"],
    }


def _tree(base):
    """Every file and folder under ``base`` with the file contents."""
    out = {}
    for d, dirs, files in os.walk(base):
        rel = os.path.relpath(d, base)
        out[rel] = None
        for f in files:
            with open(os.path.join(d, f)) as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


@pytest.mark.parametrize("cmd", ["clean-city", "clean-sources",
                                 "move-insite-out", "rename-param-key"])
@pytest.mark.parametrize("apply", [False, True])
def test_insite_ops_matches_jax(tmp_path, monkeypatch, capsys, cmd, apply):
    from deepmimo_tpu.scripts.insite_ops_cli import main as jmain
    trees, outs = {}, {}
    for tag, main in (("port", insite_ops_cli.main), ("jax", jmain)):
        base = str(tmp_path / tag)
        args = _farm(base)[cmd] + (["--apply"] if apply else [])
        monkeypatch.chdir(base)
        before = _tree(base)
        assert main(args) == 0
        outs[tag] = capsys.readouterr().out
        trees[tag] = _tree(base)
        if not apply:
            assert trees[tag] == before
            assert "dry run" in outs[tag]
        else:
            assert trees[tag] != before
    assert outs["port"] == outs["jax"]
    assert trees["port"] == trees["jax"]


def test_rename_param_key_reads_the_ports_folder(tmp_path):
    root = tmp_path / "scenarios"
    _mk(str(root / "a" / "params.json"), json.dumps({"txrx": {}}))
    _mk(str(root / "skip" / "params.json"), json.dumps({"txrx": {}}))
    dmt.config.set("scenarios_folder", str(root))
    assert insite_ops_cli.rename_param_key(apply=True, skip={"skip"}) == 1
    with open(root / "a" / "params.json") as f:
        assert json.load(f) == {"txrx_sets": {}}
    with open(root / "skip" / "params.json") as f:
        assert json.load(f) == {"txrx": {}}


def test_zoom_image_gated(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        insite_ops_cli.zoom_image("in.png", "out.png")
    monkeypatch.undo()
    try:
        from PIL import Image
    except ImportError:
        return
    src = tmp_path / "in.png"
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (64, 96, 3), np.uint8)).save(str(src))
    dst = tmp_path / "out.png"
    assert insite_ops_cli.main(["zoom-image", str(src), str(dst), "--zoom",
                                "2"]) == 0
    assert Image.open(str(dst)).size == (1920, 1080)


def test_move_insite_out_is_idempotent(tmp_path):
    folder = tmp_path / "scen"
    _mk(str(folder / "insite" / "a.setup"))
    assert insite_ops_cli.move_insite_out(str(folder), apply=True)
    assert os.path.exists(str(folder / "a.setup"))
    assert not insite_ops_cli.move_insite_out(str(folder), apply=True)
    shutil.rmtree(folder)
