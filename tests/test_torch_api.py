"""The port's scenario database client (``api``, ``api_validators``)
against the JAX package's, on a loopback mock of the database
(``tests/mock_db_server.py``).

- ``upload``, ``upload_images``, ``upload_rt_source``, ``search`` and
  ``download`` make the same requests with the same headers and send the
  same archive and submission payload as the JAX client.
- A closed port raises ``ApiError``.
- ``validate_scenario_zip`` and the CLI ``main`` give the same results on
  good and bad archives.
- ``download`` returns the folder that holds ``params.json``, so
  ``load(name)`` works after it, and ``load(name)`` of a missing scenario
  downloads it and gives the channels of the scenario that was uploaded.
  The JAX client extracts the archive one level too deep
  (``<name>/<name>/params.json``, held in
  ``test_reference_download_is_nested``), so its ``load(name)`` cannot
  follow its ``download``.
"""

import os
import shutil
import sys
import zipfile

import numpy as np
import pytest

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import api_validators
from deepmimo_tpu_torch.api import ApiError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mock_db_server import MockDatabase  # noqa: E402
from scenario_utils import write_synthetic_scenario  # noqa: E402

NAME = "api_scen"


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
def scen(tmp_path, monkeypatch):
    """Scenario ``api_scen`` under ``deepmimo_scenarios`` of a temporary
    working directory; returns its folder."""
    monkeypatch.chdir(tmp_path)
    folder = str(tmp_path / "deepmimo_scenarios" / NAME)
    write_synthetic_scenario(folder, n_ue=8, max_paths=4, seed=57,
                             grid=(4, 2))
    return folder


@pytest.fixture
def db():
    """A mock database that the port's client talks to."""
    with MockDatabase() as server:
        dmt.config.set("api_endpoint", server.url)
        yield server


@pytest.fixture
def ref_db(dm):
    """A second mock database, for the JAX client."""
    with MockDatabase() as server:
        old = dm.config.get("api_endpoint")
        dm.config.set("api_endpoint", server.url)
        yield server
        dm.config.set("api_endpoint", old)


def _params():
    p = dmt.ChannelGenParameters()
    p["bs_antenna"]["shape"] = np.array([4, 2])
    p["ofdm"]["selected_subcarriers"] = np.arange(8)
    return p


# ----------------------------------------------------------------------------
# The same requests and payloads as the JAX client
# ----------------------------------------------------------------------------

def test_upload_and_search_match_reference(dm, scen, db, ref_db):
    ours = dmt.upload(NAME, key="k-1", include_images=False)
    theirs = dm.upload(NAME, key="k-1", include_images=False)
    assert ours == theirs == {"id": 42, "status": "created"}
    assert db.received["submission"] == ref_db.received["submission"]
    assert db.received["zip"] == ref_db.received["zip"]
    assert len(db.received["zip"]) > 1000
    assert db.requests == ref_db.requests
    sub = db.received["submission"]
    assert sub["scenario"] == NAME
    assert sub["summary"] == dmt.summary(NAME, print_summary=False)
    names = [s["name"] for s in sub["key_components"]["sections"]]
    assert "Ray-Tracing Configuration" in names
    assert "TX/RX Configuration" in names

    query = {"environment": "outdoor", "min_users": 10000}
    assert dmt.search(query) == dm.search(query) == ["city_a", "city_b"]
    assert db.received["query"] == ref_db.received["query"] == query


def test_upload_images_match_reference(dm, scen, db, ref_db):
    pytest.importorskip("matplotlib")
    dmt.upload(NAME, key="k-2", include_images=True)
    pngs = sorted(f for f in os.listdir(scen) if f.endswith(".png"))
    for f in pngs:            # the second upload zips the same folder
        os.remove(os.path.join(scen, f))
    dm.upload(NAME, key="k-2", include_images=True)
    assert sorted(f for f in os.listdir(scen) if f.endswith(".png")) == pngs
    assert db.requests == ref_db.requests
    assert db.received["submission"] == ref_db.received["submission"]
    assert [p for p, _ in db.received["images"]] == \
        [p for p, _ in ref_db.received["images"]]
    assert all(n > 0 for _, n in db.received["images"])
    paths = [os.path.join(scen, "summary_los.png")]
    dmt.upload_images(NAME, "k-3", img_paths=paths)
    dm.upload_images(NAME, "k-3", img_paths=paths)
    assert db.received["images"][-1] == ref_db.received["images"][-1]
    assert db.requests == ref_db.requests


def test_upload_rt_source_matches_reference(dm, scen, db, ref_db, tmp_path):
    rt_zip = str(tmp_path / "rt_source.zip")
    with zipfile.ZipFile(rt_zip, "w") as zf:
        zf.writestr("project.setup", "x" * 5000)
    assert dmt.upload_rt_source(NAME, rt_zip, "k-4") is None
    dm.upload_rt_source(NAME, rt_zip, "k-4")
    with open(rt_zip, "rb") as f:
        data = f.read()
    assert db.received["zip"] == ref_db.received["zip"] == data
    assert db.requests == ref_db.requests
    assert db.requests[0][1] == f"/api/presign_rt?scenario={NAME}"


def test_closed_port_raises_api_error(scen):
    dmt.config.set("api_endpoint", "http://127.0.0.1:1")
    with pytest.raises(ApiError):
        dmt.search({"q": 1})
    with pytest.raises(ApiError):
        dmt.download("missing_scen")
    with pytest.raises(ApiError):
        dmt.load("missing_scen")
    with pytest.raises(ApiError):
        dmt.upload(NAME, key="k", include_images=False)
    with pytest.raises(ApiError, match="not found"):
        dmt.upload("no_such_scen", key="k")


# ----------------------------------------------------------------------------
# download and load
# ----------------------------------------------------------------------------

def test_load_of_missing_scenario_downloads_it(scen, db, capsys):
    want = dmt.load(NAME).compute_channels(_params())
    dmt.upload(NAME, key="k", include_images=False)
    shutil.rmtree(scen)
    os.remove(scen + ".zip")
    ds = dmt.load(NAME)
    assert "attempting download" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(scen, "params.json"))
    assert not os.path.exists(os.path.join(scen, NAME))
    assert not os.path.exists(scen + ".zip")
    assert ds.n_ue == 8
    np.testing.assert_array_equal(ds.compute_channels(_params()), want)


def test_load_after_download(scen, db, tmp_path):
    want = dmt.load(NAME).compute_channels(_params())
    dmt.upload(NAME, key="k", include_images=False)
    shutil.rmtree(scen)
    out = dmt.download(NAME)
    assert out == scen and os.path.isfile(os.path.join(out, "params.json"))
    np.testing.assert_array_equal(
        dmt.load(NAME).compute_channels(_params()), want)
    # Into another folder, and an absolute path that is missing.
    other = str(tmp_path / "elsewhere")
    out = dmt.download(NAME, output_dir=other)
    assert out == os.path.join(other, NAME)
    np.testing.assert_array_equal(
        dmt.load(out).compute_channels(_params()), want)
    absent = str(tmp_path / "abs_dir" / NAME)
    np.testing.assert_array_equal(
        dmt.load(absent).compute_channels(_params()), want)
    assert os.path.isfile(os.path.join(absent, "params.json"))


def test_reference_download_is_nested(dm, scen, ref_db):
    """The JAX client's layout, held without loading it: the archive's top
    folder lands one level below the scenario folder."""
    dm.upload(NAME, key="k", include_images=False)
    shutil.rmtree(scen)
    out = dm.download(NAME)
    assert out == scen
    assert os.path.isfile(os.path.join(scen, NAME, "params.json"))
    assert not os.path.exists(os.path.join(scen, "params.json"))


@pytest.mark.parametrize("layout", ["flat", "other_top"])
def test_download_of_other_archive_layouts(scen, db, tmp_path, layout):
    """An archive without a top folder, or with a top folder of another
    name, still puts params.json in ``<out>/<name>``."""
    want = dmt.load(NAME).compute_channels(_params())
    zip_path = str(tmp_path / "custom.zip")
    with zipfile.ZipFile(zip_path, "w") as zf:
        for f in sorted(os.listdir(scen)):
            arc = f if layout == "flat" else f"renamed/{f}"
            zf.write(os.path.join(scen, f), arc)
    with open(zip_path, "rb") as f:
        db.received["zip"] = f.read()
    shutil.rmtree(scen)
    out = dmt.download(NAME)
    assert sorted(os.listdir(out)) == sorted(
        n.split("/")[-1] for n in zipfile.ZipFile(zip_path).namelist())
    np.testing.assert_array_equal(
        dmt.load(NAME).compute_channels(_params()), want)


# ----------------------------------------------------------------------------
# Upload validators
# ----------------------------------------------------------------------------

def _bad_zips(scen, tmp_path):
    """name -> path of an archive each validator should refuse."""
    out = {}

    def make(name, entries):
        path = str(tmp_path / f"{name}.zip")
        with zipfile.ZipFile(path, "w") as zf:
            for arc, data in entries:
                zf.writestr(arc, data)
        out[name] = path

    files = {f: open(os.path.join(scen, f), "rb").read()
             for f in sorted(os.listdir(scen))}
    make("bad_ext", [("s/params.json", files["params.json"]),
                     ("s/run.exe", b"MZ")])
    make("no_params", [(f"s/{f}", d) for f, d in files.items()
                       if f != "params.json"])
    make("no_power", [(f"s/{f}", d) for f, d in files.items()
                      if not f.startswith("power_")])
    make("params_missing_key", [("s/params.json", b'{"rt_params": {}}')] +
         [(f"s/{f}", d) for f, d in files.items() if f != "params.json"])
    make("bad_json", [("s/params.json", b"{not json")])
    path = str(tmp_path / "not_a_zip.zip")
    with open(path, "wb") as f:
        f.write(b"plain bytes")
    out["not_a_zip"] = path
    return out


def test_validators_match_reference(dm, scen, tmp_path, capsys):
    from deepmimo_tpu import api_validators as ref
    good = dmt.zip(scen)
    cases = dict(_bad_zips(scen, tmp_path), good=good)
    for name, path in cases.items():
        for fn in ("validate_extensions", "validate_structure",
                   "validate_scenario_zip"):
            ours = getattr(api_validators, fn)(path)
            assert ours == getattr(ref, fn)(path), (name, fn)
        verdict = api_validators.validate_scenario_zip(path)
        assert verdict["valid"] == (name == "good"), (name, verdict)
        assert api_validators.main([path]) == ref.main([path])
        printed = capsys.readouterr().out.splitlines()
        assert printed[0] == printed[1]
    assert api_validators.main([]) == ref.main([]) == 2
