"""PyTorch port vs the JAX package: the downstream integrations.

- ``DeepMIMOSionnaAdapter``: the yielded ``(a, tau)`` within 5e-5 *
  max|a| of the JAX adapter's, ``tau`` bit for bit, over every user of one
  BS, over ``ue_idx`` rows, over a two-BS ``MacroDataset`` whose children
  differ in width (``num_paths`` is BS 0's) and over v3-style dicts.
- The field-of-view defect of the JAX adapter: its time-domain channel
  packs each user's kept paths to the front, but its ``tau`` is the raw
  delay matrix, so a column's delay belongs to another path
  (``test_reference_fov_tau_is_misaligned`` holds that without asserting
  it as right). The port packs the delays as the render packs the paths
  (``test_fov_tau_follows_its_column``), in the JAX package's cumsum-rank
  order, ties included (``test_compaction_order_matches_jax``).
- ``export_cdl`` equal to JAX's dict for dict at the same ``RandomState``;
  ``save_cdl_mat`` read back by ``scipy.io.loadmat`` equal to JAX's file;
  ``synthesize_cdl_cir`` within 1e-12; ``CDLConfig``'s numerology.
- ``matlab_code_path()`` lists the JAX package's 8 ``.m`` files, byte for
  byte.
- On the card (``gpu``): the adapter over a dataset rendered on the card
  equals the adapter over the same dataset on the CPU. JAX is imported
  only inside the tests that use it, so that test also runs where JAX is
  not installed: ``python -m pytest -m gpu --noconftest
  tests/test_torch_integrations.py``.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import scipy.io
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.integrations import (CDLConfig, export_cdl,
                                             matlab_code_path, save_cdl_mat,
                                             synthesize_cdl_cir)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)

RTOL = 5e-5          # channels, relative to max|a| (tests/test_pallas.py:177)
FOV = [90, 90]


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


def _write(folder, **kw):
    from scenario_utils import write_synthetic_scenario
    return write_synthetic_scenario(folder, **kw)


@pytest.fixture(scope="module")
def scen(tmp_path_factory):
    """A 16-user, 6-path scenario (seed 11) and a 12-user, 4-path one
    (seed 12), written once; returns their folders."""
    root = tmp_path_factory.mktemp("integ")
    wide = str(root / "wide")
    narrow = str(root / "narrow")
    _write(wide, n_ue=16, max_paths=6, seed=11, grid=(4, 4))
    _write(narrow, n_ue=16, max_paths=4, seed=12, grid=(4, 4))
    return {"wide": wide, "narrow": narrow}


def _adapter(pkg):
    if pkg is dmt:
        return dmt.DeepMIMOSionnaAdapter
    return pkg.integrations.DeepMIMOSionnaAdapter


def _yields(adapter):
    outs = list(adapter())
    return (np.stack([a for a, _ in outs]), np.stack([t for _, t in outs]))


def _same_yields(got, want):
    (a, tau), (ja, jtau) = got, want
    assert a.dtype == np.complex64 and tau.dtype == np.float32
    assert a.shape == ja.shape and tau.shape == jtau.shape
    scale = float(np.abs(ja).max())
    assert scale > 0
    assert float(np.abs(a - ja).max()) <= RTOL * scale
    np.testing.assert_array_equal(tau, jtau)


def _load(pkg, folders, fov=None):
    """One dataset, or a MacroDataset of several, loaded by ``pkg``."""
    sets = [pkg.load(f) for f in folders]
    for ds in sets:
        if fov is not None:
            ds.apply_fov(bs_fov=fov)
    return sets[0] if len(sets) == 1 else pkg.MacroDataset(sets)


ADAPTER_CASES = {
    # name: (scenario keys, adapter kwargs)
    "one_bs": (("wide",), {}),
    "ue_rows": (("wide",), {"ue_idx": np.array([[0, 1], [2, 3], [9, 15]])}),
    "one_user": (("wide",), {"ue_idx": np.array([3])}),
    "two_bs_narrow_first": (("narrow", "wide"),
                            {"bs_idx": np.array([[0, 1]])}),
    "two_bs_rows": (("wide", "narrow"), {"bs_idx": np.array([[0], [1]]),
                                         "ue_idx": np.arange(5)}),
}


@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_adapter_matches_jax(dm, scen, case):
    keys, kw = ADAPTER_CASES[case]
    folders = [scen[k] for k in keys]
    got = _adapter(dmt)(_load(dmt, folders), **kw)
    want = _adapter(dm)(_load(dm, folders), **kw)
    for attr in ("num_rx_ant", "num_tx_ant", "num_paths", "num_rx",
                 "num_tx", "ch_shape", "t_shape"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert len(got) == len(want)
    _same_yields(_yields(got), _yields(want))
    if keys[0] == "narrow":
        # Sionna's num_paths is BS 0's width: the wider child is cut.
        assert got.num_paths == 4


@pytest.mark.parametrize("layout", ["delay", "paths"])
def test_adapter_v3_dicts_match_jax(dm, layout):
    rng = np.random.RandomState(3)
    n_ue, p = 5, 4
    bs = []
    for b in range(2):
        ch = (rng.normal(size=(n_ue, 1, 8, p)) +
              1j * rng.normal(size=(n_ue, 1, 8, p))).astype(np.complex64)
        tau = rng.uniform(1e-7, 1e-6, (n_ue, p))
        tau[:, -1] = np.nan
        user = {"channel": ch}
        if layout == "delay":
            user["delay"] = tau
        else:
            user["paths"] = [{"ToA": t} for t in tau]
        bs.append({"user": user})
    kw = {"bs_idx": np.array([[0, 1]]), "ue_idx": [0, 2, 4]}
    _same_yields(_yields(_adapter(dmt)(bs, **kw)),
                 _yields(_adapter(dm)(bs, **kw)))


def _column_delays(a, tau, a_ref, tau_ref):
    """For every user and non-empty column j of ``a`` (yields stacked, one
    TX and one RX): the raw path k whose no-FoV column of ``a_ref`` holds
    the same gains; returns (tau[j], tau_ref[k]) pairs as two arrays."""
    got, want = [], []
    for u in range(a.shape[0]):
        cols = a[u, 0, 0, 0, :, :, 0]
        ref = a_ref[u, 0, 0, 0, :, :, 0]
        for j in np.flatnonzero(np.abs(cols).max(0) > 0):
            k = int(np.argmin(np.abs(ref - cols[:, j:j + 1]).max(0)))
            assert np.abs(ref[:, k] - cols[:, j]).max() <= \
                RTOL * np.abs(ref).max()
            got.append(tau[u, 0, 0, j])
            want.append(tau_ref[u, 0, 0, k])
    return np.array(got), np.array(want)


def test_reference_fov_tau_is_misaligned(dm, scen):
    """The JAX adapter under an FoV: columns hold the packed kept paths,
    ``tau`` the raw delays, so at least one column's delay is another
    path's. Held as the reference's behaviour, not as right."""
    a, tau = _yields(_adapter(dm)(_load(dm, [scen["wide"]], fov=FOV)))
    a_ref, tau_ref = _yields(_adapter(dm)(_load(dm, [scen["wide"]])))
    got, want = _column_delays(a, tau, a_ref, tau_ref)
    assert np.sum(got != want) >= 1


def test_fov_tau_follows_its_column(dm, scen):
    """The port under the same FoV: each column's ``tau`` is the delay of
    the path in that column (the JAX adapter's no-FoV delay of that
    path), the empty columns 0, and the channels equal the JAX ones."""
    got_a, got_tau = _yields(_adapter(dmt)(
        _load(dmt, [scen["wide"]], fov=FOV)))
    ref_a, ref_tau = _yields(_adapter(dm)(_load(dm, [scen["wide"]])))
    got, want = _column_delays(got_a, got_tau, ref_a, ref_tau)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    empty = np.abs(got_a).max(axis=(1, 2, 3, 4, 6)) == 0     # [U, paths]
    assert empty.any()
    assert np.all(got_tau[:, 0, 0, :][empty] == 0)
    jax_a, _ = _yields(_adapter(dm)(_load(dm, [scen["wide"]], fov=FOV)))
    assert float(np.abs(got_a - jax_a).max()) <= \
        RTOL * float(np.abs(jax_a).max())


def test_compaction_order_matches_jax(dm):
    """The port's compaction (a stable sort and a gather) puts the slots
    in the JAX package's cumsum-rank order, ties included: kept slots in
    their order, then the dropped ones in theirs."""
    import jax.numpy as jnp
    from deepmimo_tpu.ops import channel as jch
    from deepmimo_tpu.ops.types import ChannelConfig as JConfig
    from deepmimo_tpu.ops.types import PathData as JPathData
    from deepmimo_tpu_torch.ops.channel import _compact_paths

    rng = np.random.RandomState(4)
    u, p = 64, 9
    valid = rng.rand(u, p) < 0.5
    valid[0] = True
    valid[1] = False
    arrs = {k: rng.uniform(-1, 1, (u, p)) for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")}
    arrs["delay"] = np.arange(u * p, dtype=np.float64).reshape(u, p)
    jp = JPathData(
        power_dbw=jnp.asarray(arrs["power"], jnp.float32),
        phase_deg=jnp.asarray(arrs["phase"], jnp.float32),
        delay_s=jnp.asarray(arrs["delay"], jnp.float32),
        aoa_az_deg=jnp.asarray(arrs["aoa_az"], jnp.float32),
        aoa_el_deg=jnp.asarray(arrs["aoa_el"], jnp.float32),
        aod_az_deg=jnp.asarray(arrs["aod_az"], jnp.float32),
        aod_el_deg=jnp.asarray(arrs["aod_el"], jnp.float32),
        valid=jnp.asarray(valid))
    ones = jnp.ones((u, p), jnp.float32)
    jpaths, jvalid, *_ = jch._compact_paths(
        JConfig(), jp, jnp.asarray(valid), ones, ones, ones, ones, ones)
    tp = dmt.PathData.from_numpy(
        np.where(valid, arrs["power"], np.nan), arrs["phase"],
        arrs["delay"], arrs["aoa_az"], arrs["aoa_el"], arrs["aod_az"],
        arrs["aod_el"], device="cpu")
    one = torch.ones(u, p)
    tpaths, tvalid, *_ = _compact_paths(tp, tp.valid, one, one, one, one,
                                        one)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(
        np.where(tvalid.numpy(), tpaths.delay_s.numpy(), -1),
        np.where(np.asarray(jvalid), np.asarray(jpaths.delay_s), -1))


# ----------------------------------------------------------------------------
# NR CDL export
# ----------------------------------------------------------------------------

CDL_CASES = {
    "defaults": {},
    "drawn_travel": {"velocity_kmh": (5.0, 30.0),
                     "travel_dir_deg": ((0.0, 360.0), (45.0, 135.0)),
                     "bs_orientation_deg": (30.0, 10.0), "polarization": 1},
    "fixed": {"velocity_kmh": 18.0, "travel_dir_deg": (45.0, 90.0),
              "nrb": 52, "scs_khz": 15},
}


def _same_user(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
            assert type(a[k]) is type(b[k]), k


@pytest.mark.parametrize("case", list(CDL_CASES))
def test_export_cdl_matches_jax(dm, scen, case):
    from deepmimo_tpu.integrations import CDLConfig as JCDLConfig
    from deepmimo_tpu.integrations import export_cdl as jexport_cdl
    got = export_cdl(dmt.load(scen["wide"]), CDLConfig(**CDL_CASES[case]),
                     np.random.RandomState(9))
    want = jexport_cdl(dm.load(scen["wide"]), JCDLConfig(**CDL_CASES[case]),
                       np.random.RandomState(9))
    assert len(got) == len(want) == 16
    assert any(u is not None for u in got)
    for a, b in zip(got, want):
        _same_user(a, b)


def test_cdl_numerology_matches_jax():
    from deepmimo_tpu.integrations import CDLConfig as JCDLConfig
    for nrb, scs in ((24, 30), (52, 15), (106, 30), (273, 30), (11, 120)):
        a, b = CDLConfig(nrb=nrb, scs_khz=scs), JCDLConfig(nrb=nrb,
                                                           scs_khz=scs)
        assert (a.sample_rate, a.slots_per_subframe, a.num_time_samples) \
            == (b.sample_rate, b.slots_per_subframe, b.num_time_samples)


def test_save_cdl_mat_matches_jax(dm, scen, tmp_path):
    from deepmimo_tpu.integrations import export_cdl as jexport_cdl
    from deepmimo_tpu.integrations import save_cdl_mat as jsave_cdl_mat
    cfg = CDLConfig(velocity_kmh=(5.0, 30.0))
    users = export_cdl(dmt.load(scen["wide"]), cfg)
    path = save_cdl_mat(users, str(tmp_path / "port.mat"))
    jpath = jsave_cdl_mat(jexport_cdl(dm.load(scen["wide"]), cfg),
                          str(tmp_path / "jax.mat"))
    got = scipy.io.loadmat(path, squeeze_me=True)["cdl_users"]
    want = scipy.io.loadmat(jpath, squeeze_me=True)["cdl_users"]
    assert got.shape == want.shape == (16,)
    def plain(x):
        """A loaded field without scipy's 0-d object wrappers."""
        x = np.asarray(x)
        return plain(x.item()) if x.dtype == object and x.ndim == 0 else x

    for a, b in zip(got, want):
        assert a.dtype.names == b.dtype.names
        for name in a.dtype.names:
            va, vb = plain(a[name]), plain(b[name])
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
    n_paths = [int(np.asarray(r["NumPaths"])) for r in got]
    assert n_paths == [0 if u is None else len(u["PathDelays"])
                       for u in users]


def test_synthesize_cdl_cir_matches_jax(dm, scen):
    from deepmimo_tpu.integrations import (
        synthesize_cdl_cir as jsynthesize_cdl_cir)
    users = [u for u in export_cdl(dmt.load(scen["wide"]), CDLConfig(
        velocity_kmh=(5.0, 30.0), travel_dir_deg=((0, 360), (30, 150))))
        if u is not None]
    t = np.linspace(0, 2e-3, 17)
    for user in users:
        got, want = synthesize_cdl_cir(user, t), jsynthesize_cdl_cir(user, t)
        assert got.shape == want.shape == (17, len(user["PathDelays"]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * float(
            np.abs(want).max()))
        np.testing.assert_allclose(np.abs(got[0]), 10 ** (np.asarray(
            user["AveragePathGains"]) / 20), rtol=1e-9)


def test_matlab_files_match_jax(dm):
    got = matlab_code_path()
    want = dm.integrations.matlab_code_path()
    m_files = sorted(f for f in os.listdir(got) if f.endswith(".m"))
    assert m_files == sorted(f for f in os.listdir(want) if f.endswith(".m"))
    assert len(m_files) == 8
    for name in m_files:
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(got, "README.md")) as f:
        readme = f.read()
    assert "deepmimo_tpu_torch.integrations.export_matlab" in readme
    assert "import deepmimo_tpu;" not in readme


def test_package_data_lists_the_matlab_files():
    """pyproject.toml ships the port's .m files and README."""
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    assert ('"deepmimo_tpu_torch.integrations" = ["matlab/*.m", '
            '"matlab/README.md"]') in text


# ----------------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------------

@pytest.mark.gpu
def test_adapter_on_card_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    folder = str(tmp_path / "card_scen")
    chip_smoke.write_scenario(dmt, folder, [chip_smoke._scenario_data(
        512, seed=13)], 512)
    outs = {}
    for dev in ("cpu", "cuda"):
        dmt.config.set("device", dev)
        ds = dmt.load(folder)
        ds.apply_fov(bs_fov=FOV)
        outs[dev] = _yields(dmt.DeepMIMOSionnaAdapter(ds))
    (a, tau), (ca, ctau) = outs["cuda"], outs["cpu"]
    assert float(np.abs(a - ca).max()) <= RTOL * float(np.abs(ca).max())
    np.testing.assert_array_equal(tau, ctau)
    shutil.rmtree(folder)
