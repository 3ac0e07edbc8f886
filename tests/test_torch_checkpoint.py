"""Checkpoint/resume of the port's streamed render (``checkpoint_dir``).

With ``config['checkpoint_dir']`` set, a host result of
``Dataset.compute_channels`` streams over ``config['user_block']`` blocks,
single- and dual-polar; each rendered block is saved, and a later render
of the same inputs loads the blocks on disk and renders only the missing
ones. The store's fingerprint covers the data, so two datasets with the
same user count and configuration never share blocks (the JAX store hashes
only the configuration and the user count).

Resumed results equal the first run bit for bit; the first run equals the
uncheckpointed render and the JAX package's at 5e-5 * max|H|
(tests/test_pallas.py:177).

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_checkpoint.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import consts as c
from deepmimo_tpu_torch.generator import dataset as tdataset
from deepmimo_tpu_torch.generator.checkpoint import ChunkStore
from deepmimo_tpu_torch.ops.kernels import render as kr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import make_synthetic_paths  # noqa: E402

torch.set_num_threads(1)
RTOL = 5e-5
N_UE, BLOCK = 20, 8
POLS = ("VV", "VH", "HH", "HV")


@pytest.fixture(autouse=True)
def port_config():
    """The port on the CPU, 8-user blocks; the config restored after."""
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    dmt.config.set("user_block", BLOCK)
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


@pytest.fixture
def renders(monkeypatch):
    """Counts the block renders of the streamed paths (on the CPU no
    kernel counter moves)."""
    count = {"n": 0}
    for name in ("render_channels_planes", "render_channels_planes_polar"):
        real = getattr(tdataset, name)

        def counted(*a, _real=real, **kw):
            count["n"] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tdataset, name, counted)
    return count


def _data(seed=9, n_ue=N_UE, polar=False):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=6, seed=seed)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    if polar:
        rng = np.random.RandomState(seed + 3)
        nan = np.isnan(d["power"])
        for pol in POLS:
            for k, lo, hi in (("power", -130, -60), ("phase", -180, 180)):
                d[f"{k}_{pol.lower()}"] = np.where(
                    nan, np.nan, rng.uniform(lo, hi, nan.shape))
    return d


def _params(pkg, **kw):
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 2])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 15, -30])
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(16)
    for k, v in kw.items():
        p[k] = v
    return p


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _stores(root):
    return sorted(os.listdir(root))


def _render(d, ckpt, **kw):
    dmt.config.set("checkpoint_dir", ckpt)
    try:
        return dmt.Dataset(d).compute_channels(_params(dmt, **kw))
    finally:
        dmt.config.set("checkpoint_dir", None)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_resume_equals_first_run(tmp_path, renders, dtype):
    """The first run saves every block; with two blocks deleted, a fresh
    dataset renders exactly those two and returns the first run bit for
    bit (complex128 blocks keep their dtype)."""
    dmt.config.set("compute_dtype", dtype)
    ckpt = str(tmp_path / "ckpt")
    d = _data()
    plain = dmt.Dataset(d).compute_channels(_params(dmt))
    renders["n"] = 0
    first = _render(d, ckpt)
    assert renders["n"] == 3
    _close(first, plain, 1e-6 if dtype == "complex64" else 1e-12)
    (fp,) = _stores(ckpt)
    store = ChunkStore(ckpt, fp)
    assert store.blocks() == [0, 8, 16]
    for start in (0, 16):
        os.remove(store._block_path(start))
    renders["n"] = 0
    again = _render(d, ckpt)
    assert renders["n"] == 2 and store.blocks() == [0, 8, 16]
    assert again.dtype == first.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(again, first)
    renders["n"] = 0
    np.testing.assert_array_equal(_render(d, ckpt), first)
    assert renders["n"] == 0


def test_manifest_and_block_files(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _render(_data(), ckpt)
    (fp,) = _stores(ckpt)
    store = ChunkStore(ckpt, fp)
    import json
    with open(os.path.join(store.dir, "manifest.json")) as f:
        assert json.load(f) == {"n_ue": N_UE, "block": BLOCK}
    assert sorted(os.listdir(store.dir)) == [
        "block_000000000.npy", "block_000000008.npy", "block_000000016.npy",
        "manifest.json"]
    blk = store.load_block(16)
    assert blk.shape == (4, 1, 8, 16) and blk.dtype == np.complex64


def test_first_run_matches_jax(tmp_path):
    import deepmimo_tpu as dm
    ckpt = str(tmp_path / "ckpt")
    d = _data()
    want = dm.Dataset({k: np.asarray(v) for k, v in d.items()}
                      ).compute_channels(_params(dm))
    _close(_render(d, ckpt), want)
    _close(_render(d, ckpt), want)


def test_fingerprint_covers_the_data(tmp_path, renders):
    """Two datasets with the same user count and configuration get their
    own stores and their own channels; so do a change of the panel
    rotation and of the block size."""
    ckpt = str(tmp_path / "ckpt")
    a, b = _data(seed=9), _data(seed=50)
    ch_a, ch_b = _render(a, ckpt), _render(b, ckpt)
    assert len(_stores(ckpt)) == 2
    _close(ch_b, dmt.Dataset(b).compute_channels(_params(dmt)), 1e-6)
    assert not np.allclose(ch_a, ch_b)
    renders["n"] = 0
    rot = {c.PARAMSET_ANT_UE: {**_params(dmt)[c.PARAMSET_ANT_UE],
                               c.PARAMSET_ANT_ROTATION: np.array([0, 5, 0])}}
    _render(a, ckpt, **rot)
    assert renders["n"] == 3 and len(_stores(ckpt)) == 3
    dmt.config.set("user_block", 5)
    np.testing.assert_array_equal(_render(a, ckpt), ch_a)
    assert renders["n"] == 7 and len(_stores(ckpt)) == 4


def test_fingerprint_covers_polarization_matrices(tmp_path):
    d = _data(polar=True)
    fp = [ChunkStore.fingerprint("cfg", N_UE, BLOCK, [torch.as_tensor(x)])
          for x in (d["power_vv"], d["power_vh"])]
    assert fp[0] != fp[1]
    assert fp[0] == ChunkStore.fingerprint(
        "cfg", N_UE, BLOCK, [torch.as_tensor(d["power_vv"])])


def test_dual_polar_resume(tmp_path, renders):
    """Dual-polar host results stream with a checkpoint directory (even
    when they fit one launch), resume from the saved blocks, and equal
    the uncheckpointed render."""
    ckpt = str(tmp_path / "ckpt")
    d = _data(polar=True)
    params = _params(dmt, **{c.PARAMSET_POLAR_EN: 1})
    plain = dmt.Dataset(d).compute_channels(params)
    dmt.config.set("checkpoint_dir", ckpt)
    renders["n"] = 0
    first = dmt.Dataset(d).compute_channels(params)
    assert renders["n"] == 3
    (fp,) = _stores(ckpt)
    store = ChunkStore(ckpt, fp)
    assert store.blocks() == [0, 8, 16]
    assert store.load_block(8).shape == (4, 8, 1, 8, 16)
    os.remove(store._block_path(8))
    renders["n"] = 0
    again = dmt.Dataset(d).compute_channels(params)
    assert renders["n"] == 1
    for pol in POLS:
        np.testing.assert_array_equal(again[pol], first[pol])
        _close(first[pol], plain[pol], 1e-6)


def test_device_results_do_not_checkpoint(tmp_path, renders):
    ckpt = str(tmp_path / "ckpt")
    dmt.config.set("checkpoint_dir", ckpt)
    h = dmt.Dataset(_data()).compute_channels(_params(dmt), to_device=True)
    assert isinstance(h, torch.Tensor) and renders["n"] == 1
    assert not os.path.exists(ckpt)


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
@pytest.mark.parametrize("polar", [False, True])
def test_card_resume_renders_only_missing_blocks(cuda, tmp_path, polar):
    """On the card: one render launch per block rendered, two deleted
    blocks rendered again, the resumed result equal to the first bit for
    bit and to the single launch."""
    n = 1000
    dmt.config.set("user_block", 256)
    ckpt = str(tmp_path / "ckpt")
    d = _data(n_ue=n, polar=polar)
    params = _params(dmt, **({c.PARAMSET_POLAR_EN: 1} if polar else {}))
    single = dmt.Dataset(d).compute_channels(params)
    dmt.config.set("checkpoint_dir", ckpt)
    before = kr.LAUNCHES
    first = dmt.Dataset(d).compute_channels(params)
    assert kr.LAUNCHES == before + 4
    (fp,) = _stores(ckpt)
    store = ChunkStore(ckpt, fp)
    for start in (256, 768):
        os.remove(store._block_path(start))
    before = kr.LAUNCHES
    again = dmt.Dataset(d).compute_channels(params)
    assert kr.LAUNCHES == before + 2
    for key in (POLS if polar else [None]):
        a, b, s = ((x[key] if polar else x) for x in (again, first, single))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s)
