"""The forward variants of the PyTorch port vs the JAX package.

Several Doppler snapshots, the fused render's angle-space prologue (FoV
masks and antenna patterns), bfloat16 output and the ``matmul_dtype``
modes, through ``render_channels_planes``, ``render_channels_planes_polar``,
``render_beam_gains(_polar)``, ``render_channels`` and
``Dataset.compute_channels`` / ``compute_beam_gains``. Both packages take
the same numpy state on the CPU; the JAX fused backend runs its Pallas
kernels in interpret mode.

Tolerances, relative to max|H| (max|G| for beam gains):
- f32 modes (S > 1, angle space, "highest"): 5e-5 on channels and 3e-5
  on beam gains, the reference's own (tests/test_pallas.py:177,
  tests/test_beamgain.py);
- bf16 output: 2^-7 against the f32 planes of the same config and against
  JAX's bf16 planes (tests/test_pallas.py:536-537);
- one-pass bf16 products ("bfloat16", "default"): 1e-2. The JAX package
  has no bound for them: bf16 rounds each operand by up to 2^-9, so a term
  of the path sum by ~2^-8, and the TPU's one-pass render measured 2.9e-3
  against float64 (deepmimo_tpu/ops/pallas/render.py:213-215). In
  interpret mode JAX's "default" is f32, so there the port's one pass is
  held against f32 numbers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepmimo_tpu as dm
import deepmimo_tpu_torch as dmt
from deepmimo_tpu.ops import channel as jch
from deepmimo_tpu.ops import types as jtypes
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes

from oracle import make_synthetic_paths, oracle_channels

torch.set_num_threads(1)
RTOL = 5e-5
BG_RTOL = 3e-5
BF16_OUT_RTOL = 2 ** -7
BF16_MM_RTOL = 1e-2
U = 12
P = 10
POLS = ("VV", "VH", "HH", "HV")
BS_ROT, UE_ROT = (5.0, -10.0, 20.0), (0.0, 10.0, -5.0)

BASE = dict(bs_shape=(4, 4), ue_shape=(1, 1), subcarriers=512,
            selected_subcarriers=tuple(range(32)), bandwidth=10e6,
            num_paths=P, backend="fused", planes_layout="packed")
DOP2 = dict(enable_doppler=True, doppler_times=(0.0, 2e-3))
DOP3 = dict(enable_doppler=True, doppler_times=(0.0, 1e-3, 3e-3))
K16 = dict(selected_subcarriers=tuple(range(16)))
DIPOLES = dict(bs_pattern="halfwave-dipole", ue_pattern="halfwave-dipole")
CASES = {
    # S*K = 64: packed
    "doppler_s2_packed": DOP2,
    # S*K = 96 % 64 != 0: the packed opt-in falls back to stacked
    "doppler_s3_stacked": DOP3,
    "doppler_s2_mimo_stacked": dict(DOP2, ue_shape=(2, 1), bs_shape=(2, 2),
                                    planes_layout="stacked"),
    "xla_doppler_s2_packed": dict(DOP2, backend="xla"),
    "xla_doppler_s3_stacked": dict(DOP3, backend="xla", **K16),
    "fused_bs_fov": dict(bs_fov=(120.0, 90.0)),
    "fused_ue_fov_mimo": dict(ue_fov=(180.0, 120.0), ue_shape=(2, 1)),
    "fused_dipoles": DIPOLES,
    "fused_fov_dipoles_doppler": dict(DOP2, bs_fov=(120.0, 90.0), **DIPOLES),
    "bf16_out_packed": dict(out_dtype="bfloat16"),
    "bf16_out_stacked": dict(out_dtype="bfloat16", planes_layout="stacked"),
    "bf16_out_doppler_s3": dict(DOP3, out_dtype="bfloat16"),
    "xla_bf16_out_packed": dict(out_dtype="bfloat16", backend="xla"),
    "xla_bf16_out_stacked": dict(out_dtype="bfloat16", backend="xla",
                                 planes_layout="stacked"),
    "bf16_mm": dict(matmul_dtype="bfloat16"),
    "default_mm_stacked": dict(matmul_dtype="default",
                               planes_layout="stacked"),
    "highest_mm": dict(matmul_dtype="highest"),
    "xla_bf16_mm": dict(matmul_dtype="bfloat16", backend="xla"),
    "xla_default_mm": dict(matmul_dtype="default", backend="xla"),
    "serving_bf16_doppler": dict(DOP2, out_dtype="bfloat16",
                                 matmul_dtype="bfloat16"),
}


def _tol(kw):
    if kw.get("matmul_dtype") in ("bfloat16", "default"):
        return BF16_MM_RTOL
    if kw.get("out_dtype") == "bfloat16":
        return BF16_OUT_RTOL
    return RTOL


def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _data(seed, n_ue=U, max_paths=P):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed,
                             with_doppler=True)
    d.pop("n_valid")
    return d


def _state(kw, seed=31):
    """(JAX state, port state, numpy data) for ChannelConfig fields ``kw``
    over BASE."""
    d = _data(seed)
    jpaths = jtypes.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], doppler_vel=d["doppler_vel"],
        doppler_acc=d["doppler_acc"], dtype=jnp.float32)
    jbs = jtypes.AntennaPanel.make(BS_ROT)
    jue = jtypes.AntennaPanel.make(UE_ROT)
    jcfg = jtypes.ChannelConfig(**{**BASE, **kw})
    tstate = ttypes.state_from_numpy(_leaves(jpaths), _leaves(jbs),
                                     _leaves(jue), dataclasses.asdict(jcfg),
                                     device="cpu")
    return (jpaths, jbs, jue, jcfg), tstate, d


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32))


# ----------------------------------------------------------------------------
# render_channels_planes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_render_channels_planes_matches_jax(name):
    kw = CASES[name]
    jstate, (pd, bs, ue, cfg), _ = _state(kw)
    want = np.asarray(jch.render_channels_planes(*jstate))
    got = tch.render_channels_planes(pd, bs, ue, cfg)
    assert got.dtype == (torch.bfloat16 if cfg.out_dtype == "bfloat16"
                         else torch.float32)
    assert str(want.dtype) == cfg.out_dtype
    assert tuple(got.shape) == want.shape == tch.render_out_shape(U, cfg)
    scale = np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(kw) * scale)
    host = tch.unpack_planes_np(got, cfg)
    assert host.dtype == np.complex64
    np.testing.assert_array_equal(
        host, jch.unpack_planes_np(_np(got), jstate[3]))
    n_s = len(cfg.doppler_times) if cfg.enable_doppler else 1
    assert host.shape == (U, cfg.n_rx_ant, cfg.n_tx_ant,
                          cfg.n_sel_subcarriers) + ((n_s,) if n_s > 1
                                                    else ())
    if cfg.out_dtype == "bfloat16":     # against f32 planes of the config
        f32 = tch.render_channels_planes(pd, bs, ue,
                                         cfg.replace(out_dtype="float32"))
        np.testing.assert_allclose(
            _np(got), f32.numpy(),
            atol=BF16_OUT_RTOL * float(f32.abs().max()))


@pytest.mark.parametrize("name", ["doppler_s3_stacked",
                                  "doppler_s2_mimo_stacked",
                                  "fused_fov_dipoles_doppler",
                                  "fused_ue_fov_mimo"])
def test_render_matches_float64_oracle(name):
    """Each snapshot against tests/oracle.py's float64 channel at its
    time."""
    kw = CASES[name]
    _, (pd, bs, ue, cfg), d = _state(kw, seed=32)
    host = tch.unpack_planes_np(tch.render_channels_planes(pd, bs, ue, cfg),
                                cfg)
    times = cfg.doppler_times if cfg.enable_doppler else (None,)
    for i, t in enumerate(times):
        want = oracle_channels(
            d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
            d["aod_az"], d["aod_el"], bs_shape=cfg.bs_shape,
            ue_shape=cfg.ue_shape, bs_rotation=BS_ROT, ue_rotation=UE_ROT,
            n_fft=cfg.subcarriers,
            selected_subcarriers=cfg.selected_subcarriers,
            bandwidth=cfg.bandwidth, num_paths=P, bs_pattern=cfg.bs_pattern,
            ue_pattern=cfg.ue_pattern, bs_fov=cfg.bs_fov, ue_fov=cfg.ue_fov,
            **({} if t is None else dict(doppler_vel=d["doppler_vel"],
                                         doppler_acc=d["doppler_acc"],
                                         doppler_time=t)))
        got = host[..., i] if t is not None and len(times) > 1 else host
        np.testing.assert_allclose(got, want,
                                   atol=RTOL * np.abs(want).max())


def test_stacked_doppler_out_is_written_in_place():
    _, (pd, bs, ue, cfg), _ = _state(CASES["doppler_s3_stacked"])
    ref = tch.render_channels_planes(pd, bs, ue, cfg)
    out = torch.full_like(ref, float("nan"))
    assert tch.render_channels_planes(pd, bs, ue, cfg, out=out) is out
    assert torch.equal(out, ref)
    bf16 = cfg.replace(out_dtype="bfloat16", planes_layout="packed",
                       doppler_times=(0.0, 1e-3))
    out16 = torch.empty(tch.render_out_shape(U, bf16), dtype=torch.bfloat16)
    got = tch.render_channels_planes(pd, bs, ue, bf16, out=out16)
    assert got.data_ptr() == out16.data_ptr() and torch.equal(got, out16)
    with pytest.raises(ValueError, match="bfloat16"):
        tch.render_channels_planes(pd, bs, ue, bf16, out=out16.float())


# ----------------------------------------------------------------------------
# Dual-polar and beam gains
# ----------------------------------------------------------------------------

def _polar_state(kw, seed=41):
    jstate, tstate, d = _state(kw, seed)
    rng = np.random.RandomState(seed + 1)
    nan = np.isnan(d["power"])
    mats = [np.float32(np.where(nan, np.nan, rng.uniform(lo, hi, nan.shape)))
            for _ in POLS for lo, hi in ((-120, -70), (-180, 180))]
    pol_p, pol_ph = np.stack(mats[0::2]), np.stack(mats[1::2])
    return ((*jstate, jnp.asarray(pol_p), jnp.asarray(pol_ph)),
            (*tstate, torch.from_numpy(pol_p), torch.from_numpy(pol_ph)))


POLAR_CASES = {
    # 4 pols x 2 snapshots x 16 subcarriers = 128: packed
    "doppler_s2_packed": dict(DOP2, **K16),
    "doppler_s3_stacked": dict(DOP3, planes_layout="stacked", **K16),
    "bf16_out": dict(out_dtype="bfloat16", **K16),
    "bf16_mm_dipole_fov": dict(matmul_dtype="bfloat16", bs_fov=(150.0, 120.0),
                               bs_pattern="halfwave-dipole", **K16),
}


@pytest.mark.parametrize("name", sorted(POLAR_CASES))
def test_render_channels_planes_polar_matches_jax(name):
    kw = POLAR_CASES[name]
    jstate, tstate = _polar_state(kw)
    cfg = tstate[3]
    want = np.asarray(jch.render_channels_planes_polar(*jstate))
    got = tch.render_channels_planes_polar(*tstate)
    assert tuple(got.shape) == want.shape == tch.polar_out_shape(U, cfg)
    assert str(want.dtype) == cfg.out_dtype
    scale = np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(kw) * scale)
    host = tch.unpack_polar_planes_np(got, cfg)
    np.testing.assert_array_equal(
        host, jch.unpack_polar_planes_np(_np(got), jstate[3]))
    n_s = len(cfg.doppler_times) if cfg.enable_doppler else 1
    assert host.shape == (4, U, 1, 16, 16) + ((n_s,) if n_s > 1 else ())


BG_CASES = {
    "doppler_s2": DOP2,
    "doppler_s3_mimo": dict(DOP3, ue_shape=(2, 1), **K16),
    "fov_dipoles_doppler": dict(DOP2, bs_fov=(120.0, 90.0), **DIPOLES),
    "bf16_mm": dict(matmul_dtype="bfloat16"),
    "default_mm_doppler": dict(DOP2, matmul_dtype="default"),
    "highest_mm": dict(matmul_dtype="highest"),
    "xla_bf16_mm": dict(matmul_dtype="bfloat16", backend="xla"),
}


def _codebook(b=6, t=16, seed=9):
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, t))) / np.sqrt(t)
    return np.float32(w.real), np.float32(w.imag)


@pytest.mark.parametrize("name", sorted(BG_CASES))
def test_render_beam_gains_matches_jax(name):
    kw = BG_CASES[name]
    jstate, (pd, bs, ue, cfg), _ = _state(kw, seed=51)
    wr, wi = _codebook()
    want = np.asarray(jch.render_beam_gains(*jstate, wr, wi))
    got = tch.render_beam_gains(pd, bs, ue, cfg, torch.from_numpy(wr),
                                torch.from_numpy(wi))
    n_s = len(cfg.doppler_times) if cfg.enable_doppler else 1
    assert tuple(got.shape) == want.shape == \
        (U, cfg.n_rx_ant * 6, n_s * cfg.n_sel_subcarriers)
    tol = BG_RTOL if _tol(kw) == RTOL else BF16_MM_RTOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol * want.max())


@pytest.mark.parametrize("name", ["doppler_s2", "bf16_mm"])
def test_render_beam_gains_polar_matches_jax(name):
    kw = dict(POLAR_CASES["doppler_s2_packed"] if name == "doppler_s2"
              else dict(matmul_dtype="bfloat16", **K16))
    jstate, tstate = _polar_state(kw, seed=61)
    wr, wi = _codebook()
    want = np.asarray(jch.render_beam_gains_polar(*jstate, wr, wi))
    got = tch.render_beam_gains_polar(*tstate, torch.from_numpy(wr),
                                      torch.from_numpy(wi))
    n_s = 2 if name == "doppler_s2" else 1
    assert tuple(got.shape) == want.shape == (U, 6, 4 * n_s * 16)
    tol = BG_RTOL if _tol(kw) == RTOL else BF16_MM_RTOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol * want.max())


# ----------------------------------------------------------------------------
# The complex path, the eager products and unknown modes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mm", ["bfloat16", "default", "highest"])
def test_render_channels_modes_stay_f32(mm, backend):
    """render_channels takes every matmul_dtype and stays f32: the JAX
    path-sum kernel takes no mm_dtype, and on the CPU its XLA "default"
    and "highest" are f32. JAX's eager "bfloat16" rounds E and g, so that
    one case is held at the one-pass bound."""
    kw = dict(matmul_dtype=mm, backend=backend, **K16)
    jstate, (pd, bs, ue, cfg), _ = _state(kw, seed=71)
    want = np.asarray(jch.render_channels(*jstate))
    got = tch.render_channels(pd, bs, ue, cfg)
    f32 = tch.render_channels(pd, bs, ue, cfg.replace(matmul_dtype="float32"))
    assert torch.equal(got, f32)
    tol = BF16_MM_RTOL if (mm, backend) == ("bfloat16", "xla") else RTOL
    np.testing.assert_allclose(got.numpy(), want,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("mm", ["bfloat16", "default"])
def test_eager_planes_products_match_jax(mm):
    """_path_sum_planes_ri on the same planes: the port rounds E and g to
    bf16 and multiplies in f32, as JAX's einsum with bf16 operands and
    preferred_element_type=f32."""
    rng = np.random.RandomState(81)
    u, r, t, p, k = 5, 2, 8, 9, 12
    planes = [np.float32(rng.uniform(-1, 1, s)) for s in
              [(u, r, p)] * 2 + [(u, t, p)] * 2 + [(u, p, k)] * 2]
    jcfg = jtypes.ChannelConfig(matmul_dtype="bfloat16")
    j = [jnp.asarray(x) for x in planes]
    want = jch._path_sum_planes_ri(jcfg, (j[0], j[1]), (j[2], j[3]), j[4],
                                   j[5])
    tp = [torch.from_numpy(x) for x in planes]
    got = tch._path_sum_planes_ri((tp[0], tp[1]), (tp[2], tp[3]), tp[4],
                                  tp[5], mm)
    f32 = tch._path_sum_planes_ri((tp[0], tp[1]), (tp[2], tp[3]), tp[4],
                                  tp[5])
    for g, w, f in zip(got, want, f32):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        # bf16 operands, f32 products: the same numbers up to f32 sums
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-6 * np.abs(w).max())
        assert np.abs(g.numpy() - f.numpy()).max() > 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("entry", ["planes_fused", "planes_xla", "complex",
                                   "beam_gains", "polar", "out_dtype"])
def test_unknown_modes_raise_value_error(entry):
    kw = dict(matmul_dtype="tf32", **K16)
    if entry == "planes_xla":
        kw["backend"] = "xla"
    if entry == "out_dtype":
        kw = dict(out_dtype="float16")
    _, tstate = _polar_state(kw)
    pd, bs, ue, cfg = tstate[:4]
    with pytest.raises(ValueError, match="matmul_dtype|out_dtype"):
        if entry == "complex":
            tch.render_channels(pd, bs, ue, cfg)
        elif entry == "beam_gains":
            tch.render_beam_gains(pd, bs, ue, cfg,
                                  *map(torch.from_numpy, _codebook()))
        elif entry == "polar":
            tch.render_channels_planes_polar(*tstate)
        else:
            tch.render_channels_planes(pd, bs, ue, cfg)


# ----------------------------------------------------------------------------
# Dataset
# ----------------------------------------------------------------------------

@pytest.fixture
def port_on_cpu():
    """The port renders on the CPU here (its config default is "cuda")."""
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


def _ds_data(seed=91, n_ue=20, polar=False):
    d = _data(seed, n_ue=n_ue, max_paths=8)
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    if polar:
        rng = np.random.RandomState(seed + 1)
        nan = np.isnan(d["power"])
        for pol in POLS:
            for key, lo, hi in (("power", -120, -70), ("phase", -180, 180)):
                d[f"{key}_{pol.lower()}"] = np.float32(np.where(
                    nan, np.nan, rng.uniform(lo, hi, nan.shape)))
    return d


def _ds_params(pkg, times=(0.0, 2e-3), polar=False):
    c = pkg.consts
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 4])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 15, -30])
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(32)
    p[c.PARAMSET_NUM_PATHS] = 8
    p[c.PARAMSET_DOPPLER_EN] = 1
    p[c.PARAMSET_DOPPLER_TIMES] = np.array(times)
    if polar:
        p[c.PARAMSET_POLAR_EN] = 1
    return p


@pytest.mark.parametrize("times", [(0.0, 2e-3), (0.0, 1e-3, 3e-3)],
                         ids=["s2_packed", "s3_stacked"])
def test_compute_channels_doppler_matches_jax(port_on_cpu, times):
    """Host channels with the time axis last; S*K = 96 falls back to the
    stacked layout (the streamed blocks join the same)."""
    want = dm.Dataset(_ds_data()).compute_channels(_ds_params(dm, times))
    ds = dmt.Dataset(_ds_data())
    got = ds.compute_channels(_ds_params(dmt, times))
    assert got.shape == want.shape == (20, 1, 16, 32, len(times))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max())
    old = dmt.config.get("max_device_output_bytes")
    dmt.config.set("max_device_output_bytes", got.nbytes // 3)
    dmt.config.set("user_block", 7)
    try:
        streamed = ds.compute_channels(_ds_params(dmt, times))
    finally:
        dmt.config.set("max_device_output_bytes", old)
    np.testing.assert_array_equal(streamed, got)


def test_compute_channels_bf16_out_reuse_and_stream(port_on_cpu):
    """planes_out_dtype "bfloat16": bf16 planes on the device, reused in
    place through out=, complex64 on the host (from a single launch and
    from streamed blocks alike) within 2^-7 of the f32 channel."""
    want = dm.Dataset(_ds_data()).compute_channels(_ds_params(dm))
    dmt.config.set("planes_out_dtype", "bfloat16")
    ds = dmt.Dataset(_ds_data())
    params = _ds_params(dmt)
    h = ds.compute_channels(params, to_device=True)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (20, 1, 16, 128)
    ptr, first = h.data_ptr(), h.clone()
    h = ds.compute_channels(params, to_device=True, out=h)
    assert h.data_ptr() == ptr and torch.equal(h, first)
    f32_buf = torch.zeros(h.shape)       # another dtype: not reused
    h2 = ds.compute_channels(params, to_device=True, out=f32_buf)
    assert h2.dtype == torch.bfloat16 and not f32_buf.any()
    host = ds.compute_channels(params)
    assert host.dtype == np.complex64 and host.shape == want.shape
    np.testing.assert_allclose(host, want,
                               atol=BF16_OUT_RTOL * np.abs(want).max())
    dmt.config.set("max_device_output_bytes", h.numel())  # 2 bytes each
    dmt.config.set("user_block", 8)
    np.testing.assert_array_equal(ds.compute_channels(params), host)


def test_compute_beam_gains_doppler_matches_jax(port_on_cpu):
    w = np.exp(1j * np.random.RandomState(5).uniform(-np.pi, np.pi,
                                                     (4, 16))) / 4
    times = (0.0, 1e-3, 3e-3)
    want = dm.Dataset(_ds_data()).compute_beam_gains(
        _ds_params(dm, times), codebook=w)
    ds = dmt.Dataset(_ds_data())
    got = ds.compute_beam_gains(_ds_params(dmt, times), codebook=w)
    assert got.shape == want.shape == (20, 1, 4, 32, 3)
    np.testing.assert_allclose(got, want, atol=BG_RTOL * want.max())
    g = ds.compute_beam_gains(_ds_params(dmt, times), codebook=w,
                              to_device=True)
    assert tuple(g.shape) == (20, 4, 3 * 32)
    again = ds.compute_beam_gains(_ds_params(dmt, times), codebook=w,
                                  to_device=True, out=g)
    assert again.data_ptr() == g.data_ptr()


def test_dual_polar_doppler_dataset_matches_jax(port_on_cpu):
    """Dual-polar channels and beam gains with 2 snapshots, time axis last
    per polarization."""
    w = np.exp(1j * np.random.RandomState(6).uniform(-np.pi, np.pi,
                                                     (4, 16))) / 4
    jds = dm.Dataset(_ds_data(polar=True))
    ds = dmt.Dataset(_ds_data(polar=True))
    want = jds.compute_channels(_ds_params(dm, polar=True))
    got = ds.compute_channels(_ds_params(dmt, polar=True))
    want_g = jds.compute_beam_gains(_ds_params(dm, polar=True), codebook=w)
    got_g = ds.compute_beam_gains(_ds_params(dmt, polar=True), codebook=w)
    for pol in POLS:
        assert got[pol].shape == want[pol].shape == (20, 1, 16, 32, 2)
        np.testing.assert_allclose(got[pol], want[pol],
                                   atol=RTOL * np.abs(want[pol]).max())
        assert got_g[pol].shape == want_g[pol].shape == (20, 1, 4, 32, 2)
        np.testing.assert_allclose(got_g[pol], want_g[pol],
                                   atol=BG_RTOL * want_g[pol].max())
