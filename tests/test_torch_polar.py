"""Dual-polar renders of the PyTorch port vs the JAX package.

All four polarizations ride the fused render's slot axis (one launch);
``render_channels_planes_polar`` (packed and stacked layouts) on one state
from ``state_from_numpy``, ``unpack_polar_planes_np``, dual-polar
``Dataset.compute_channels`` (fused branch, the per-polarization fallback,
the raw ``to_device`` layout, streamed == single, ``out=`` reuse) and
dual-polar ``compute_beam_gains`` (with ``out=`` honoured, which the JAX
package ignores). Polarization matrices arrive NaN-padded, as loaded.
Tolerance 5e-5 * max|H| on channels (tests/test_pallas.py), 3e-5 *
max|G| on beam gains against JAX's beam gains (tests/test_beamgain.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepmimo_tpu as dm
import deepmimo_tpu_torch as dmt
from deepmimo_tpu.ops import channel as jch
from deepmimo_tpu.ops import types as jtypes
from deepmimo_tpu_torch.generator import dataset as tdataset
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes

from oracle import make_synthetic_paths

torch.set_num_threads(1)
RTOL = 5e-5
BG_RTOL = 3e-5
POLS = ("VV", "VH", "HH", "HV")
N_UE = 20
MAX_PATHS = 6


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port renders on the CPU here (its config default is "cuda")."""
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


def _data(seed=3, n_ue=N_UE):
    """Synthetic paths plus four NaN-padded polarization matrices."""
    d = make_synthetic_paths(n_ue=n_ue, max_paths=MAX_PATHS, seed=seed)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    rng = np.random.RandomState(seed + 1)
    nan = np.isnan(d["power"])
    for pol in POLS:
        d[f"power_{pol.lower()}"] = np.float32(np.where(
            nan, np.nan, rng.uniform(-120, -70, nan.shape)))
        d[f"phase_{pol.lower()}"] = np.float32(np.where(
            nan, np.nan, rng.uniform(-180, 180, nan.shape)))
    return d


def _params(pkg, bs_shape=(4, 2), ue_shape=(1, 1), selected=np.arange(16),
            **kw):
    c = pkg.consts
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_POLAR_EN] = 1
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array(bs_shape)
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([10, 20, 30])
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_SHAPE] = np.array(ue_shape)
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = selected
    p[c.PARAMSET_NUM_PATHS] = MAX_PATHS
    for k, v in kw.items():
        p[k] = v
    return p


def _close(got, want, rtol=RTOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


# ----------------------------------------------------------------------------
# Channel level
# ----------------------------------------------------------------------------

def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _state(cfg_kw, seed=5):
    import jax.numpy as jnp

    d = _data(seed)
    jpaths = jtypes.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], dtype=jnp.float32)
    jbs = jtypes.AntennaPanel.make((5.0, -10.0, 20.0))
    jue = jtypes.AntennaPanel.make((0.0, 10.0, -5.0))
    kw = dict(bs_shape=(4, 2), subcarriers=512, num_paths=MAX_PATHS,
              selected_subcarriers=tuple(range(16)), backend="fused",
              planes_layout="packed")
    jcfg = jtypes.ChannelConfig(**{**kw, **cfg_kw})
    pol_p = np.stack([d[f"power_{p.lower()}"] for p in POLS])
    pol_ph = np.stack([d[f"phase_{p.lower()}"] for p in POLS])
    tstate = ttypes.state_from_numpy(_leaves(jpaths), _leaves(jbs),
                                     _leaves(jue), dataclasses.asdict(jcfg),
                                     device="cpu")
    return ((jpaths, jbs, jue, jcfg, jnp.asarray(pol_p),
             jnp.asarray(pol_ph)),
            (*tstate, torch.from_numpy(pol_p), torch.from_numpy(pol_ph)))


POLAR_STATES = {
    "packed": {},
    "stacked": dict(planes_layout="stacked"),
    "mimo_fov_dipole": dict(ue_shape=(2, 1), bs_fov=(120.0, 90.0),
                            bs_pattern="halfwave-dipole"),
}


@pytest.mark.parametrize("name", sorted(POLAR_STATES))
def test_render_channels_planes_polar_matches_jax(name):
    jstate, tstate = _state(POLAR_STATES[name])
    cfg = tstate[3]
    assert tch.polar_fused_eligible(cfg) == \
        jch.polar_fused_eligible(jstate[3])
    assert tch._packed_layout(cfg, 4) == \
        jch._polar_packed_layout(jstate[3])
    want = np.asarray(jch.render_channels_planes_polar(*jstate))
    got = tch.render_channels_planes_polar(*tstate)
    assert tuple(got.shape) == want.shape == tch.polar_out_shape(N_UE, cfg)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(
        tch.unpack_polar_planes_np(got.numpy(), cfg),
        jch.unpack_polar_planes_np(got.numpy(), jstate[3]))
    out = torch.full_like(got, float("nan"))
    assert tch.render_channels_planes_polar(*tstate, out=out) is not None
    assert torch.equal(out, got)


def test_render_beam_gains_polar_matches_jax():
    jstate, tstate = _state({})
    rng = np.random.RandomState(8)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 8))) / np.sqrt(8)
    wr, wi = np.float32(w.real), np.float32(w.imag)
    want = np.asarray(jch.render_beam_gains_polar(*jstate, wr, wi))
    got = tch.render_beam_gains_polar(*tstate, torch.from_numpy(wr),
                                      torch.from_numpy(wi))
    assert tuple(got.shape) == want.shape == (N_UE, 4, 4 * 16)
    _close(got.numpy(), want, BG_RTOL)


def test_polar_needs_a_fused_eligible_config():
    _, tstate = _state({})
    cfg = tstate[3].replace(selected_subcarriers=(0, 1, 3))
    assert not tch.polar_fused_eligible(cfg)
    with pytest.raises(ValueError, match="fused-eligible"):
        tch.render_channels_planes_polar(*tstate[:3], cfg, *tstate[4:])


# ----------------------------------------------------------------------------
# Dataset level
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_results():
    """JAX results, computed once per module (interpret-mode kernels)."""
    out = {}
    out["host"] = dm.Dataset(_data()).compute_channels(_params(dm))
    out["raw"] = np.asarray(dm.Dataset(_data()).compute_channels(
        _params(dm), to_device=True))
    mimo = dict(bs_shape=(2, 2), ue_shape=(2, 1))
    out["mimo"] = dm.Dataset(_data(9)).compute_channels(_params(dm, **mimo))
    return out


def test_dual_polar_channels_match_jax(jax_results):
    got = dmt.Dataset(_data()).compute_channels(_params(dmt))
    assert set(got) == set(POLS)
    for pol in POLS:
        assert got[pol].shape == (N_UE, 1, 8, 16)
        _close(got[pol], jax_results["host"][pol])
    mimo = dict(bs_shape=(2, 2), ue_shape=(2, 1))
    got = dmt.Dataset(_data(9)).compute_channels(_params(dmt, **mimo))
    for pol in POLS:
        assert got[pol].shape == (N_UE, 2, 4, 16)
        _close(got[pol], jax_results["mimo"][pol])


def test_dual_polar_fallback_matches_jax(jax_results, monkeypatch):
    monkeypatch.setattr(tdataset, "polar_fused_eligible",
                        lambda cfg, n_pol=4: False)
    ds = dmt.Dataset(_data())
    got = ds.compute_channels(_params(dmt))
    for pol in POLS:
        _close(got[pol], jax_results["host"][pol])
    with pytest.raises(ValueError, match="to_device"):
        ds.compute_channels(_params(dmt), to_device=True)


def test_dual_polar_device_layout_and_out_reuse(jax_results):
    ds = dmt.Dataset(_data())
    params = _params(dmt)
    h = ds.compute_channels(params, to_device=True)
    assert isinstance(h, torch.Tensor) and tuple(h.shape) == (N_UE, 1, 8,
                                                              2 * 4 * 16)
    _close(h.numpy(), jax_results["raw"])
    first, ptr = h.clone(), h.data_ptr()
    for _ in range(2):
        h = ds.compute_channels(params, to_device=True, out=h)
        assert h.data_ptr() == ptr and torch.equal(h, first)
    cfg, _, _ = params.to_config(N_UE)
    host = ds.compute_channels(params)
    unpacked = tch.unpack_polar_planes_np(first.numpy(), cfg)
    for i, pol in enumerate(POLS):
        np.testing.assert_array_equal(unpacked[i], host[pol])


def test_dual_polar_streamed_equals_single():
    ds = dmt.Dataset(_data(7))
    single = ds.compute_channels(_params(dmt))
    dmt.config.set("max_device_output_bytes", 1)
    dmt.config.set("user_block", 8)              # 20 users -> 3 blocks
    streamed = ds.compute_channels(_params(dmt))
    for pol in POLS:
        # The plain version's batched products may round differently per
        # batch size on the CPU; chip_smoke.py checks exact equality on
        # the card, where every user renders alone.
        np.testing.assert_allclose(streamed[pol], single[pol], rtol=0,
                                   atol=1e-6 * np.abs(single[pol]).max())


def test_dual_polar_beam_gains_match_jax_and_honour_out():
    rng = np.random.RandomState(8)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 8))) / np.sqrt(8)
    want = dm.Dataset(_data()).compute_beam_gains(_params(dm), codebook=w)
    ds = dmt.Dataset(_data())
    got = ds.compute_beam_gains(_params(dmt), codebook=w)
    assert set(got) == set(POLS)
    for pol in POLS:
        assert got[pol].shape == (N_UE, 1, 4, 16)
        _close(got[pol], want[pol], BG_RTOL)

    # the per-polarization fold of the port's own channels
    quad = ds.compute_channels(_params(dmt))
    for pol in POLS:
        fold = np.abs(np.einsum("bt,urtk->urbk", w.conj(), quad[pol])) ** 2
        np.testing.assert_allclose(got[pol], fold,
                                   atol=BG_RTOL * fold.max())

    raw = ds.compute_beam_gains(_params(dmt), codebook=w, to_device=True)
    assert tuple(raw.shape) == (N_UE, 4, 4 * 16)
    for i, pol in enumerate(POLS):
        np.testing.assert_array_equal(raw[:, :, i * 16:(i + 1) * 16].numpy(),
                                      got[pol][:, 0])
    ptr, first = raw.data_ptr(), raw.clone()
    again = ds.compute_beam_gains(_params(dmt), codebook=w, to_device=True,
                                  out=raw)
    assert again.data_ptr() == ptr and torch.equal(again, first)


def test_missing_polarization_matrices_raise():
    d = _data()
    for pol in ("hh", "hv"):
        del d[f"power_{pol}"]
    ds = dmt.Dataset(d)
    with pytest.raises(ValueError, match="per-polarization"):
        ds.compute_channels(_params(dmt))
    with pytest.raises(ValueError, match="per-polarization"):
        ds.compute_beam_gains(_params(dmt), codebook=np.ones((2, 8)))
