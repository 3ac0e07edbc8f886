"""PyTorch port vs the JAX package: the AODT converter.

The same AODT parquet export (``_write_fixture`` of
``tests/test_aodt_converter.py``) goes through ``convert`` of each package
in turn, each into its own scenarios folder: every ``.mat`` matrix equal
bit for bit, ``params.json`` equal, channels within 5e-5 * max|H|; also
without the optional ``scenario`` table, with a second time index and
with a second RU. A missing required table raises the same
FileNotFoundError in both; the interaction codes and the polyline angles
agree. The tables need pandas and pyarrow (imported by the converters only
inside their table reader), so these tests skip without them.
"""

import os
import sys

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")
pytest.importorskip("pyarrow")

import deepmimo_tpu_torch as dmt  # noqa: E402
from deepmimo_tpu_torch.converter.aodt import aodt_converter as tac  # noqa: E402,E501

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_convert_sionna import (  # noqa: E402
    convert_both, same_channels, same_scenario_files)
from test_aodt_converter import _write_fixture  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def dm():
    """The JAX package (imported here only)."""
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


def _table(folder, name):
    return pd.read_parquet(os.path.join(folder, f"{name}.parquet"))


def _export(folder, case):
    """The AODT fixture, then:

    - "no_scenario": without ``scenario.parquet`` (default parameters);
    - "two_times": a second time index, which the converter drops;
    - "two_rus": a second RU with its own paths to both UEs.
    """
    _write_fixture(folder)
    if case == "no_scenario":
        os.remove(os.path.join(folder, "scenario.parquet"))
    elif case == "two_times":
        for name in ("raypaths", "cirs"):
            t = _table(folder, name)
            later = t.copy()
            later["time_idx"] = 1
            if name == "cirs":
                later["cir_re"] *= 2.0
            pd.concat([t, later]).to_parquet(
                os.path.join(folder, f"{name}.parquet"))
    elif case == "two_rus":
        rus = _table(folder, "rus")
        pd.concat([rus, pd.DataFrame([{"id": 7, "x": 40.0, "y": 40.0,
                                       "z": 15.0}])]).to_parquet(
            os.path.join(folder, "rus.parquet"))
        rays, cirs = _table(folder, "raypaths"), _table(folder, "cirs")
        ru = np.array([40.0, 40.0, 15.0])
        ues = _table(folder, "ues").set_index("id")
        new_rays, new_cirs = [], []
        for ue in (0, 1):
            pos = ues.loc[ue, ["x", "y", "z"]].to_numpy(float)
            new_rays.append({"time_idx": 0, "ru_id": 7, "ue_id": ue,
                             "path_id": 0, "points": np.concatenate(
                                 [ru, pos]).tolist(),
                             "interaction_types": [0, 5]})
            amp = 4e-6 * np.exp(1j * (0.3 + ue))
            new_cirs.append({"time_idx": 0, "ru_id": 7, "ue_id": ue,
                             "path_id": 0, "cir_re": amp.real,
                             "cir_im": amp.imag,
                             "cir_delay": np.linalg.norm(pos - ru) / 3e8})
        pd.concat([rays, pd.DataFrame(new_rays)]).to_parquet(
            os.path.join(folder, "raypaths.parquet"))
        pd.concat([cirs, pd.DataFrame(new_cirs)]).to_parquet(
            os.path.join(folder, "cirs.parquet"))
    return folder


@pytest.mark.parametrize("case", ["fixture", "no_scenario", "two_times",
                                  "two_rus"])
def test_convert_matches_jax(dm, tmp_path, case):
    """``convert`` of one AODT export by both packages: equal scenario
    folders, then equal channels."""
    folder = _export(str(tmp_path / "rt" / "aodt_sim"), case)
    jf, tf = convert_both(dm, folder, tmp_path, f"aodt_{case}")
    same_scenario_files(jf, tf)
    jds, tds = same_channels(dm, jf, tf)
    if case == "two_rus":
        assert isinstance(tds, dmt.MacroDataset) and len(tds) == 2
    else:
        assert tds.n_ue == 2
        assert np.asarray(tds.inter)[1, 0] == 12


@pytest.mark.parametrize("table", tac.TABLES)
def test_missing_table_raises(dm, tmp_path, table):
    """A missing required table raises the JAX package's
    FileNotFoundError, naming the table and the expected set."""
    folder = _export(str(tmp_path / "rt" / "aodt_sim"), "fixture")
    os.remove(os.path.join(folder, f"{table}.parquet"))
    msgs = []
    for pkg in (dm, dmt):
        with pytest.raises(FileNotFoundError) as e:
            pkg.convert(folder, overwrite=True, scenario_name="x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and f"{table}.parquet" in msgs[1]


@pytest.mark.parametrize("types", [[0, 5], [0, 1, 5], [0, 1, 2, 5],
                                   [0, 3, 4, 1, 5], [], [5]])
def test_interaction_code(dm, types):
    from deepmimo_tpu.converter.aodt import aodt_converter as jac
    assert tac._interaction_code(types) == jac._interaction_code(types)


@pytest.mark.parametrize("vec", [(1.0, 0.0, 0.0), (0.0, 0.0, -2.0),
                                 (0.0, 0.0, 0.0), (-3.0, 4.0, 5.0)])
def test_polyline_angles(dm, vec):
    from deepmimo_tpu.converter.aodt import aodt_converter as jac
    assert tac._angles_deg(np.array(vec)) == jac._angles_deg(np.array(vec))
