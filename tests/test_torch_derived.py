"""PyTorch port vs the JAX package: the derived ``Dataset`` attributes.

Every key of the JAX ``Dataset`` registry
(``deepmimo_tpu/generator/dataset.py:755-781``) except ``channel``
resolves in the port and matches a JAX ``Dataset`` loaded from the same
synthetic scenario (``write_synthetic_scenario``): rotated and FoV angles,
the FoV mask, pathloss, LoS, path and interaction counts, interaction
strings and ints, distances, linear powers with and without pattern gains,
the array-response product, grid info; with ``apply_fov`` invalidating
its caches, ``subset``, the index helpers and the product's MemoryError.

Tolerances: arrays at the rtol of tests/test_reference_parity.py:232-235
(1e-5; distances 1e-6); masks, ints and strings exactly.
"""

import numpy as np
import pytest
import torch

import deepmimo_tpu as dm
import deepmimo_tpu_torch as dmt

from scenario_utils import write_synthetic_scenario

torch.set_num_threads(1)
RTOL = 1e-5
N_UE, GRID = 24, (6, 4)

KEYS = [k for k in dm.Dataset._computed_attributes
        if k not in ("channel", "fov")]
SETUPS = ("default", "fov", "rotated_dipole")


@pytest.fixture(autouse=True)
def port_on_cpu():
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("derived") / "synthetic_site")
    write_synthetic_scenario(folder, n_ue=N_UE, max_paths=6, seed=3,
                             grid=GRID)
    return folder


def _params(pkg):
    c = pkg.consts
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 2])
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_SHAPE] = np.array([2, 1])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([10, 20, -40])
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION] = np.array(
        [[0, 30], [-20, 20], [0, 360]])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_RAD_PAT] = "halfwave-dipole"
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_RAD_PAT] = "halfwave-dipole"
    return p


def _datasets(folder, setup):
    jds, tds = dm.load(folder), dmt.load(folder)
    for ds, pkg in ((jds, dm), (tds, dmt)):
        if setup in ("fov", "rotated_dipole"):
            ds.apply_fov(bs_fov=np.array([150, 120]),
                         ue_fov=np.array([300, 160]))
        if setup == "rotated_dipole":
            ds.set_channel_params(_params(pkg))
    return jds, tds


def _same(got, want, key=""):
    """Arrays at RTOL (NaN where JAX has NaN), masks, ints and strings
    exactly."""
    if want is None or isinstance(want, (int, np.integer)):
        assert got == want, key
        return
    if hasattr(want, "keys"):
        assert set(got.keys()) == set(want.keys()), key
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, key
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   equal_nan=True, err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("key", KEYS)
def test_registry_key_matches_jax(scenario, key, setup):
    jds, tds = _datasets(scenario, setup)
    assert key in dmt.Dataset._computed_attributes
    _same(tds[key], jds[key], key)
    _same(getattr(tds, key), getattr(jds, key), key)


def test_registry_and_aliases():
    assert set(dmt.Dataset._computed_attributes) == \
        set(dm.Dataset._computed_attributes)
    tds = dmt.Dataset({"rx_pos": np.zeros((3, 3)),
                       "tx_pos": np.ones((1, 3)),
                       "power": np.zeros((3, 2))})
    np.testing.assert_allclose(tds.dist, np.full(3, np.sqrt(3)))
    np.testing.assert_array_equal(tds.pwr_lin, np.ones((3, 2)))
    with pytest.raises(AttributeError):
        tds.not_a_key
    with pytest.raises(KeyError):
        tds["not_a_key"]


@pytest.mark.parametrize("setup", SETUPS)
def test_fov_dict_holds_the_fov_keys(scenario, setup):
    """``fov`` names the whole result of the FoV step: the port returns the
    dict (the JAX ``Dataset`` stores its keys and then raises for
    ``fov`` itself)."""
    jds, tds = _datasets(scenario, setup)
    fov = tds.fov
    assert set(fov) == {k for k in KEYS if "fov" in k}
    for k, v in fov.items():
        _same(v, jds[k], k)
        assert tds.get(k) is v                       # stored under its key
    with pytest.raises(AttributeError):
        jds.fov


@pytest.mark.parametrize("setup", SETUPS)
def test_orientations_match_jax(scenario, setup):
    jds, tds = _datasets(scenario, setup)
    for name in ("tx_ori", "bs_ori", "rx_ori", "ue_ori"):
        _same(getattr(tds, name), getattr(jds, name), name)


def test_dict_results_store_every_key(scenario):
    _, tds = _datasets(scenario, "default")
    assert "grid_spacing" not in tds.keys()
    _same(tds.grid_size, np.array(GRID))
    assert "grid_spacing" in tds.keys()
    assert {"_aod_el_rot", "_aod_az_rot", "_aoa_el_rot",
            "_aoa_az_rot"} - set(tds.keys())
    tds["_aoa_az_rot"]
    assert {"_aod_el_rot", "_aod_az_rot", "_aoa_el_rot",
            "_aoa_az_rot"} <= set(tds.keys())
    assert tds._is_valid_grid()


def test_apply_fov_invalidates_its_caches(scenario):
    jds, tds = _datasets(scenario, "default")
    before = {k: tds[k] for k in ("num_paths", "los", "_fov_mask")}
    assert before["_fov_mask"] is None
    for ds in (jds, tds):
        ds.apply_fov(bs_fov=np.array([90, 90]))
    for k in ("num_paths", "los", "_fov_mask", "_power_linear_ant_gain",
              "_aod_el_rot_fov"):
        _same(tds[k], jds[k], k)
    assert tds.num_paths.sum() < before["num_paths"].sum()
    for ds in (jds, tds):
        ds.apply_fov()                               # full sphere again
    _same(tds.num_paths, before["num_paths"])
    assert tds["_fov_mask"] is None


def test_rotation_change_invalidates_rotated_angles(scenario):
    jds, tds = _datasets(scenario, "default")
    first = tds["_aod_el_rot"].copy()
    for ds, pkg in ((jds, dm), (tds, dmt)):
        ds.set_channel_params(_params(pkg))
    assert "_aod_el_rot" not in tds.keys()
    _same(tds["_aod_el_rot"], jds["_aod_el_rot"])
    assert not np.allclose(tds["_aod_el_rot"], first, equal_nan=True)


def test_apply_fov_reaches_the_time_domain_render(scenario):
    """``apply_fov`` feeds the render's FoV and, in the time domain,
    compaction: each user's surviving paths first, then zeros."""
    jds, tds = _datasets(scenario, "default")
    for ds, pkg in ((jds, dm), (tds, dmt)):
        ds.apply_fov(bs_fov=np.array([120, 180]))
    jp, tp = dm.ChannelGenParameters(), dmt.ChannelGenParameters()
    jp["freq_domain"] = tp["freq_domain"] = 0
    want = jds.compute_channels(jp)
    got = tds.compute_channels(tp)
    assert got.shape == want.shape == (N_UE, 1, 8, 6)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-5 * np.abs(want).max())
    n = tds.num_paths
    for u in range(N_UE):
        assert np.all(got[u, ..., n[u]:] == 0)
    assert "channel" in tds.keys()
    tds.apply_fov()
    assert "channel" not in tds.keys()


@pytest.mark.parametrize("setup", SETUPS)
def test_subset_matches_jax(scenario, setup):
    """Per-user arrays indexed, shared parameters shared, caches left out.
    The subset keeps ``ch_params`` a ChannelGenParameters, so it derives
    rotated angles again; the JAX ``subset`` turns it into a plain dict,
    which has no ``resolve_ue_rotation``, so the JAX side is the full
    dataset's values at the indices (the BS side: a per-user UE rotation
    draws anew for the subset's users)."""
    jds, tds = _datasets(scenario, setup)
    idxs = np.array([0, 3, 5, 11, 17])
    for ds in (jds, tds):
        ds["los"], ds["pathloss"]                    # cached, then indexed
    jsub, tsub = jds.subset(idxs), tds.subset(idxs)
    assert isinstance(tsub, dmt.Dataset) and tsub.n_ue == len(idxs)
    # load attaches the scene (none written here) and the materials, and
    # subset shares them as the JAX package's does
    assert {"scene", "materials"} <= set(tds.keys()) & set(jds.keys())
    assert tds.scene is None and jds.scene is None
    assert isinstance(tds.materials, dmt.MaterialList)
    assert tds.materials.to_dict() == jds.materials.to_dict()
    assert set(tsub.keys()) == set(jsub.keys())
    for k in ("power", "rx_pos", "inter", "los", "pathloss", "inter_str",
              "distance"):
        _same(tsub[k], jsub[k], k)
    for k in ("_aod_az_rot_fov", "_aod_el_rot", "num_interactions"):
        _same(tsub[k], jds[k][idxs], k)
    assert isinstance(tsub.ch_params, dmt.ChannelGenParameters)
    from deepmimo_tpu_torch.generator.dataset import SHARED_PARAMS
    shared = [k for k in SHARED_PARAMS if k in tds.keys()]
    assert set(shared) == set(SHARED_PARAMS)
    assert all(tsub[k] is tds[k] for k in shared)
    assert all(jsub[k] is jds[k] for k in shared)


def test_index_helpers_match_jax(scenario):
    jds, tds = _datasets(scenario, "fov")
    _same(tds.get_active_idxs(), jds.get_active_idxs())
    for steps in ([1, 1], [2, 1], [2, 2], [3, 2]):
        _same(tds.get_uniform_idxs(steps), jds.get_uniform_idxs(steps))


def test_array_response_product_limit(scenario):
    _, tds = _datasets(scenario, "rotated_dipole")
    arp = tds.array_response_product
    assert arp.shape == (N_UE, 2, 8, 6) and arp.dtype == np.complex64
    assert np.all(arp[np.isnan(tds["_aod_el_rot_fov"])[:, None, None, :]
                      .repeat(2, 1).repeat(8, 2)] == 0)
    del tds["array_response_product"]
    dmt.config.set("max_array_product_bytes", arp.nbytes - 1)
    with pytest.raises(MemoryError, match="max_array_product_bytes"):
        tds.array_response_product
    dmt.config.set("max_array_product_bytes", arp.nbytes)
    dmt.config.set("user_block", 5)                  # 5 blocks, ragged
    np.testing.assert_array_equal(tds.array_response_product, arp)


@pytest.mark.parametrize("coherent", [True, False])
def test_pathloss_matches_jax(scenario, coherent):
    jds, tds = _datasets(scenario, "default")
    _same(tds.compute_pathloss(coherent), jds.compute_pathloss(coherent))
    assert tds["pathloss"] is not None
