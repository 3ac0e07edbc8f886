"""PyTorch port vs the JAX package: the slice end to end on the CPU.

``Dataset(dict).compute_channels`` (host and device results, ``out=``
reuse, streamed vs single dispatch), ``load``/``generate`` of an on-disk
scenario (also a dynamic one), ``to_config``.
Tolerance 5e-5 * max|H| (tests/test_pallas.py's fused-render bound).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import deepmimo_tpu as dm
import deepmimo_tpu_torch as dmt
from deepmimo_tpu.generator.dataset import \
    delay_clipping_report as jax_clipping_report
from deepmimo_tpu_torch.api import ApiError
from deepmimo_tpu_torch.generator.dataset import delay_clipping_report
from deepmimo_tpu_torch.ops.channel import unpack_planes_np

from oracle import make_synthetic_paths
from scenario_utils import write_synthetic_scenario

torch.set_num_threads(1)
RTOL = 5e-5
N_UE = 24


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port renders on the CPU here (its config default is "cuda")."""
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


def _data(seed=21, n_ue=N_UE, max_paths=12):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    return d


def _params(pkg, random_ue_rotation=False, **ofdm):
    c = pkg.consts
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([8, 8])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 15, -30])
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(64)
    for k, v in ofdm.items():
        p[c.PARAMSET_OFDM][k] = v
    if random_ue_rotation:
        p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION] = np.array(
            [[0, 30], [-20, 20], [0, 360]])
    return p


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_channels():
    """JAX results, computed once per module (interpret-mode kernel)."""
    out = {}
    for rot in (False, True):
        out[rot] = dm.Dataset(_data()).compute_channels(
            _params(dm, random_ue_rotation=rot))
    out["planes"] = np.asarray(dm.Dataset(_data()).compute_channels(
        _params(dm), to_device=True))
    return out


@pytest.mark.parametrize("random_ue_rotation", [False, True])
def test_compute_channels_matches_jax(jax_channels, random_ue_rotation):
    ds = dmt.Dataset(_data())
    h = ds.compute_channels(_params(dmt,
                                    random_ue_rotation=random_ue_rotation))
    assert isinstance(h, np.ndarray) and h.shape == (N_UE, 1, 64, 64)
    _close(h, jax_channels[random_ue_rotation])
    assert ds.channel is h and ds["ch"] is h          # cached + alias


def test_to_device_planes_match_jax(jax_channels):
    ds = dmt.Dataset(_data())
    h = ds.compute_channels(_params(dmt), to_device=True)
    assert isinstance(h, torch.Tensor) and h.device.type == "cpu"
    assert tuple(h.shape) == (N_UE, 1, 64, 128)
    _close(h.numpy(), jax_channels["planes"])
    assert "channel" not in ds.keys()                 # not cached


def test_out_reuse_overwrites_in_place_and_mismatch_is_ignored():
    ds = dmt.Dataset(_data())
    other = dmt.Dataset(_data(seed=22))
    params = _params(dmt)
    first = ds.compute_channels(params, to_device=True).clone()
    prev = other.compute_channels(params, to_device=True)
    h = ds.compute_channels(params, to_device=True, out=prev)
    assert h.data_ptr() == prev.data_ptr()            # previous overwritten
    assert torch.equal(h, first)
    wrong = torch.zeros(3, 1, 64, 128)
    h2 = ds.compute_channels(params, to_device=True, out=wrong)
    assert h2.data_ptr() != wrong.data_ptr() and torch.equal(h2, first)
    assert not wrong.any()


def _same_up_to_blocking(got, want):
    """On the CPU the plain version's batched product may round its float32
    sums differently for another batch size; the CUDA kernel renders each
    user alone, and chip_smoke.py checks exact equality on the card."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("random_ue_rotation", [False, True])
def test_streamed_blocks_equal_single_dispatch(random_ue_rotation):
    ds = dmt.Dataset(_data())
    params = _params(dmt, random_ue_rotation=random_ue_rotation)
    single = ds.compute_channels(params)
    dmt.config.set("max_device_output_bytes", 1)
    dmt.config.set("user_block", 7)                   # 4 blocks, ragged
    _same_up_to_blocking(ds.compute_channels(params), single)


def test_load_and_generate_match_jax(tmp_path):
    folder = str(tmp_path / "synthetic_city")
    write_synthetic_scenario(folder, n_ue=32, max_paths=8, grid=(8, 4))
    jds, tds = dm.load(folder), dmt.load(folder)
    assert isinstance(tds, dmt.Dataset)
    assert tds.n_ue == jds.n_ue == 32
    for key in ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
                "aod_el", "rx_pos", "tx_pos", "inter"):
        np.testing.assert_array_equal(tds[key], jds[key], key)
    assert tds["txrx"] == jds["txrx"] and tds["name"] == jds["name"]
    trimmed = dmt.load(folder, max_paths=3)
    assert trimmed["power"].shape == (32, 3)

    want = dm.generate(folder, ch_gen_params=_params(dm)).channel
    got = dmt.generate(folder, ch_gen_params=_params(dmt)).channel
    _close(got, want)
    # A missing folder is downloaded first; with the database unreachable
    # (a closed loopback port) the load raises ApiError, as the JAX one.
    dmt.config.set("api_endpoint", "http://127.0.0.1:1")
    with pytest.raises(ApiError):
        dmt.load(str(tmp_path / "missing"))
    assert not os.path.exists(tmp_path / "missing")


@pytest.mark.parametrize("kw", [
    dict(), dict(random_ue_rotation=True),
    dict(subcarriers=1024, bandwidth=50e6, rx_filter=0),
])
def test_to_config_matches_jax(kw):
    random = kw.pop("random_ue_rotation", False)
    jp = _params(dm, random_ue_rotation=random, **kw)
    tp = _params(dmt, random_ue_rotation=random, **kw)
    np.random.seed(1001)
    jrot = jp.resolve_ue_rotation(N_UE)
    np.random.seed(1001)
    trot = tp.resolve_ue_rotation(N_UE)
    np.testing.assert_array_equal(trot, jrot)
    jcfg, jbs, jue = jp.to_config(N_UE, bs_fov=(120, 90), ue_rotation=jrot)
    tcfg, tbs, tue = tp.to_config(N_UE, bs_fov=(120, 90), ue_rotation=trot)
    jfields = dataclasses.asdict(jcfg)
    for name, value in dataclasses.asdict(tcfg).items():
        assert value == jfields[name], name
    assert set(jfields) - set(dataclasses.asdict(tcfg)) == \
        {"kernel_no_pack", "kernel_pack_first"}
    for tpan, jpan in ((tbs, jbs), (tue, jue)):
        assert tpan.rotation_deg.device.type == "cpu"
        np.testing.assert_array_equal(tpan.rotation_deg.numpy(),
                                      np.asarray(jpan.rotation_deg))
        assert float(tpan.spacing) == float(jpan.spacing)


def test_delay_clipping_report_matches_jax(capsys):
    d = _data()
    for n_fft, bw in ((512, 10e6), (64, 10e6)):
        want = jax_clipping_report(d["delay"], d["power"], n_fft, bw)
        assert delay_clipping_report(d["delay"], d["power"], n_fft, bw) == \
            want
    ds = dmt.Dataset(d)
    ds.compute_channels(_params(dmt, subcarriers=64,
                                selected_subcarriers=np.arange(64)))
    assert ds["clipping_report"]["n_clipped_paths"] > 0
    assert "exceed the OFDM symbol duration" in capsys.readouterr().out


def test_out_of_slice_entry_points_raise(tmp_path):
    """The entry point this test once held to a NotImplementedError, a
    dynamic (two-scene) scenario without scene_i subfolders, now loads
    into a DynamicDataset whose snapshots (both from the root folder)
    match the JAX package's, arrays and channels."""
    from deepmimo_tpu.generator.core import DynamicDataset as JaxDynamic
    from deepmimo_tpu_torch.generator.core import DynamicDataset
    folder = str(tmp_path / "dynamic")
    write_synthetic_scenario(folder, n_ue=8, max_paths=4, grid=(4, 2))
    path = os.path.join(folder, "params.json")
    with open(path) as f:
        meta = json.load(f)
    meta["scene"]["num_scenes"] = 2
    with open(path, "w") as f:
        json.dump(meta, f)
    jds, tds = dm.load(folder), dmt.load(folder)
    assert isinstance(jds, JaxDynamic) and isinstance(tds, DynamicDataset)
    assert tds.n_snapshots == jds.n_snapshots == 2
    for t, j in zip(tds.datasets, jds.datasets):
        for key in ("power", "phase", "delay", "aoa_az", "rx_pos", "inter"):
            np.testing.assert_array_equal(t[key], np.asarray(j[key]))
    for t, j in zip(tds.compute_channels(_params(dmt)),
                    jds.compute_channels(_params(dm))):
        _close(t, j)


def test_unpack_gives_the_host_channel():
    ds = dmt.Dataset(_data())
    params = _params(dmt)
    planes = ds.compute_channels(params, to_device=True)
    cfg, _, _ = params.to_config(N_UE)
    np.testing.assert_array_equal(unpack_planes_np(planes.numpy(), cfg),
                                  ds.compute_channels(params))
