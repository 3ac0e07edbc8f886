"""PyTorch port vs the JAX package: the non-fused channel paths.

The time domain (with path compaction), the sinc receive filter (DFT
matrix and full-band FFT, per-tap Doppler, over-FFT paths) and complex128,
through ``render_channels``, ``render_channels_planes``,
``render_channels_and_grads``, ``render_beam_gains`` and
``Dataset.compute_channels`` / ``compute_beam_gains``, from identical
numpy state on the CPU, compared as raw arrays. The JAX package sends
every one of these configurations to plain XLA ops, never to a Pallas
kernel, and the port keeps them eager.

Tolerances are the JAX tests' own: complex128 atol 1e-12 against JAX or
the float64 oracle (tests/test_renderer.py:44), 1e-10 with the filter
(:135); complex64 5e-5 * max|H| (tests/test_pallas.py:177); gradients
3e-4 * max|g| in complex64 and 1e-9 * max|g| in complex128.

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_nonfused.py``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes
from deepmimo_tpu_torch.ops.kernels import beamgain as kb
from deepmimo_tpu_torch.ops.kernels import pathsum as kp
from deepmimo_tpu_torch.ops.kernels import render as kr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import make_synthetic_paths, oracle_channels  # noqa: E402

torch.set_num_threads(1)
C64_RTOL = 5e-5
C128_ATOL = 1e-12
C128_LPF_ATOL = 1e-10
GRAD_RTOL = {"complex64": 3e-4, "complex128": 1e-9}
U = 8
P = 6
ANGLES = ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
          "aod_el")

BASE = dict(bs_shape=(2, 2), ue_shape=(1, 1), subcarriers=64,
            selected_subcarriers=(0, 3, 9), bandwidth=10e6, num_paths=P,
            carrier_freq=28e9)
CASES = {
    # time domain
    "td_siso": dict(bs_shape=(1, 1), freq_domain=False),
    "td_mimo": dict(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=False),
    "td_per_user_rotation": dict(freq_domain=False),
    "td_doppler_one": dict(freq_domain=False, enable_doppler=True,
                           doppler_times=(1e-3,)),
    "td_doppler_three": dict(freq_domain=False, enable_doppler=True,
                             doppler_times=(0.0, 1e-3, 2e-3)),
    "td_fov_auto": dict(freq_domain=False, ue_fov=(180.0, 90.0),
                        bs_fov=(240.0, 150.0)),
    "td_fov_never": dict(freq_domain=False, ue_fov=(180.0, 90.0),
                         compact_td_paths=False),
    "td_holes_compact_true": dict(freq_domain=False, compact_td_paths=True),
    "td_holes_auto": dict(freq_domain=False),
    # the sinc receive filter
    "lpf_selected": dict(rx_filter=True),
    "lpf_full_band": dict(rx_filter=True, subcarriers=32,
                          selected_subcarriers=tuple(range(32))),
    "lpf_doppler": dict(rx_filter=True, enable_doppler=True,
                        selected_subcarriers=(0, 5, 17),
                        doppler_times=(0.0, 1e-3, 2e-3)),
    "lpf_full_band_doppler": dict(rx_filter=True, subcarriers=16,
                                  selected_subcarriers=tuple(range(16)),
                                  enable_doppler=True,
                                  doppler_times=(5e-4,)),
    "lpf_over_fft": dict(rx_filter=True, selected_subcarriers=(0, 1)),
    "lpf_mimo_fov": dict(rx_filter=True, bs_shape=(4, 2), ue_shape=(2, 1),
                         bs_fov=(200.0, 120.0)),
    # complex128 in the frequency domain (complex64 is the planes path)
    "fd_fov_dipole": dict(selected_subcarriers=(0, 5, 20),
                          bs_fov=(120.0, 90.0),
                          bs_pattern="halfwave-dipole",
                          ue_pattern="halfwave-dipole"),
    "fd_doppler": dict(enable_doppler=True, doppler_times=(0.0, 2e-3)),
    "fd_mimo_per_user_rotation": dict(bs_shape=(4, 2), ue_shape=(2, 2),
                                      selected_subcarriers=tuple(
                                          range(0, 64, 8))),
    "fd_pallas_backend": dict(backend="pallas"),
}
DTYPES = {name: (("complex128",) if name.startswith("fd_") else
                 ("complex64", "complex128")) for name in CASES}
PARAMS = [(name, dt) for name in sorted(CASES) for dt in DTYPES[name]]
BS_ROT = (5.0, -10.0, 20.0)


def _jax():
    import jax.numpy as jnp
    from deepmimo_tpu.ops import channel as jch
    from deepmimo_tpu.ops import types as jtypes
    return jnp, jch, jtypes


def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _data(name, seed=31, n_ue=U):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=P, seed=seed,
                             with_doppler=True)
    if "holes" in name:                  # an interior invalid slot
        for key in ANGLES + ("doppler_vel", "doppler_acc"):
            d[key][:, 2] = np.nan
    if "over_fft" in name:               # past the symbol N * Ts = 6.4 us
        d["delay"][:, ::2] = 1e-3
    return d


def _ue_rot(name, seed=31, n_ue=U):
    if "per_user_rotation" in name:
        return np.random.RandomState(seed).uniform(-60, 60, (n_ue, 3))
    return (0.0, 10.0, -5.0)


def _state(name, dtype):
    """(JAX state, port state, data, ue rotation) of a case."""
    jnp, _, jtypes = _jax()
    jdt = jnp.float64 if dtype == "complex128" else jnp.float32
    d = _data(name)
    ue_rot = _ue_rot(name)
    jpaths = jtypes.PathData.from_numpy(
        *(d[k] for k in ANGLES), doppler_vel=d["doppler_vel"],
        doppler_acc=d["doppler_acc"], dtype=jdt)
    jbs = jtypes.AntennaPanel.make(BS_ROT, dtype=jdt)
    jue = jtypes.AntennaPanel.make(ue_rot, dtype=jdt)
    jcfg = jtypes.ChannelConfig(**{**BASE, **CASES[name], "dtype": dtype})
    tstate = ttypes.state_from_numpy(_leaves(jpaths), _leaves(jbs),
                                     _leaves(jue), dataclasses.asdict(jcfg),
                                     device="cpu")
    return (jpaths, jbs, jue, jcfg), tstate, d, ue_rot


def _close(got, want, dtype, lpf):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == "complex128":
        atol = C128_LPF_ATOL if lpf else C128_ATOL
    else:
        atol = C64_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _launches():
    return (kr.LAUNCHES, kp.LAUNCHES, kb.LAUNCHES)


@pytest.mark.parametrize("name,dtype", PARAMS)
def test_render_channels_matches_jax(name, dtype):
    _, jch, _ = _jax()
    jstate, tstate, _, _ = _state(name, dtype)
    cfg = tstate[3]
    assert not tch._kernel_config(cfg) or dtype == "complex64"
    before = _launches()
    got = tch.render_channels(*tstate)
    assert _launches() == before          # no kernel on these paths
    assert got.dtype == cfg.cdtype
    _close(got.numpy(), jch.render_channels(*jstate), dtype, cfg.rx_filter)


@pytest.mark.parametrize("name,dtype", PARAMS)
def test_render_channels_planes_matches_jax(name, dtype):
    _, jch, _ = _jax()
    jstate, (pd, bs, ue, cfg), _, _ = _state(name, dtype)
    before = _launches()
    got = tch.render_channels_planes(pd, bs, ue, cfg)
    assert _launches() == before
    assert got.dtype == tch.planes_dtype(cfg) == (
        torch.float64 if dtype == "complex128" else torch.float32)
    assert tuple(got.shape) == tch.render_out_shape(U, cfg, P)
    want = np.asarray(jch.render_channels_planes(*jstate))
    _close(got.numpy(), want, dtype, cfg.rx_filter)
    np.testing.assert_array_equal(tch.unpack_planes_np(got, cfg),
                                  jch.unpack_planes_np(got.numpy(),
                                                       jstate[3]))


ORACLE_CASES = ["td_siso", "td_mimo", "td_per_user_rotation",
                "td_doppler_three", "td_fov_auto", "td_holes_compact_true",
                "lpf_selected", "lpf_full_band", "lpf_doppler",
                "lpf_full_band_doppler", "lpf_over_fft", "lpf_mimo_fov",
                "fd_fov_dipole", "fd_doppler", "fd_mimo_per_user_rotation"]


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_complex128_matches_float64_oracle(name):
    """The oracle packs each user's surviving paths to the front of the
    time-domain path axis, as the compacted render does."""
    cfg = ttypes.ChannelConfig(**{**BASE, **CASES[name],
                                  "dtype": "complex128"})
    d = _data(name)
    ue_rot = _ue_rot(name)
    paths = dmt.PathData.from_numpy(*(d[k] for k in ANGLES),
                                    doppler_vel=d["doppler_vel"],
                                    doppler_acc=d["doppler_acc"],
                                    dtype=torch.float64, device="cpu")
    bs = dmt.AntennaPanel.make(BS_ROT, dtype=torch.float64, device="cpu")
    ue = dmt.AntennaPanel.make(ue_rot, dtype=torch.float64, device="cpu")
    h = tch.render_channels(paths, bs, ue, cfg).numpy()
    times = cfg.doppler_times if cfg.enable_doppler else (None,)
    hs = [h[..., i] for i in range(len(times))] if len(times) > 1 else [h]
    for got, t in zip(hs, times):
        want = oracle_channels(
            *(d[k] for k in ANGLES), bs_shape=cfg.bs_shape,
            ue_shape=cfg.ue_shape, bs_rotation=BS_ROT, ue_rotation=ue_rot,
            bs_pattern=cfg.bs_pattern, ue_pattern=cfg.ue_pattern,
            bs_fov=cfg.bs_fov, ue_fov=cfg.ue_fov,
            freq_domain=cfg.freq_domain, n_fft=cfg.subcarriers,
            selected_subcarriers=cfg.selected_subcarriers,
            bandwidth=cfg.bandwidth, rx_filter=cfg.rx_filter, num_paths=P,
            carrier_freq=cfg.carrier_freq,
            **(dict(doppler_vel=d["doppler_vel"],
                    doppler_acc=d["doppler_acc"], doppler_time=t)
               if cfg.enable_doppler else {}))
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=C128_LPF_ATOL if cfg.rx_filter else C128_ATOL)


def test_compaction_is_an_exact_stable_permutation():
    """Each output slot is one input value: the valid slots in their order,
    then the invalid ones, every per-path array (Doppler too) gathered by
    the same order."""
    d = _data("td_holes_compact_true")
    paths = dmt.PathData.from_numpy(*(d[k] for k in ANGLES),
                                    doppler_vel=d["doppler_vel"],
                                    doppler_acc=d["doppler_acc"],
                                    device="cpu")
    angles = [torch.randn(U, P) for _ in range(4)]
    powers = torch.rand(U, P)
    new, valid, pw, *new_angles = tch._compact_paths(paths, paths.valid,
                                                     powers, *angles)
    for u in range(U):
        v = paths.valid[u].numpy()
        order = np.concatenate([np.flatnonzero(v), np.flatnonzero(~v)])
        n = int(v.sum())
        assert valid[u, :n].all() and not valid[u, n:].any()
        for f in dataclasses.fields(paths):
            if f.name != "valid":
                assert torch.equal(getattr(new, f.name)[u],
                                   getattr(paths, f.name)[u, order])
        assert torch.equal(pw[u], powers[u, order])
        for a, b in zip(new_angles, angles):
            assert torch.equal(a[u], b[u, order])


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_compaction_gates(dtype):
    """"auto" compacts only with an active FoV; True always; False never.
    Without compaction the interior hole's slot stays zero."""
    _, tstate, _, _ = _state("td_holes_auto", dtype)
    pd, bs, ue, cfg = tstate
    for mode, fov, want in (("auto", None, False),
                            ("auto", (360.0, 180.0), False),
                            ("auto", (180.0, 90.0), True),
                            (True, None, True), (False, (180.0, 90.0), False)):
        assert tch._td_compact_active(
            cfg.replace(compact_td_paths=mode, ue_fov=fov)) == want
    h = tch.render_channels(pd, bs, ue, cfg).numpy()
    assert np.all(h[..., 2] == 0)
    hc = tch.render_channels(pd, bs, ue,
                             cfg.replace(compact_td_paths=True)).numpy()
    n = pd.valid.sum(1).numpy()
    for u in range(U):              # the CPU's vector and scalar sin/cos
        assert np.all(hc[u, ..., n[u]:] == 0)       # may differ by an ulp
        np.testing.assert_allclose(hc[u, ..., :n[u]],
                                   h[u][..., pd.valid[u].numpy()], rtol=0,
                                   atol=1e-6 * np.abs(h).max())


GRAD_PARAMS = [(n, dt) for n in ("td_fov_auto", "td_doppler_three",
                                  "td_holes_compact_true", "lpf_doppler",
                                  "lpf_full_band")
               for dt in ("complex64", "complex128")] + \
    [("fd_fov_dipole", "complex128"), ("fd_doppler", "complex128")]


def _uncompacted_cotangent(tstate, cot):
    """The cotangent of the uncompacted render that the compacted render's
    ``cot`` stands for: slot j < n_valid of a user goes back to the j-th
    valid slot; the other outputs are zero whatever the inputs."""
    pd, bs, ue, cfg = tstate
    valid = tch._angle_stage(cfg.replace(compact_td_paths=False),
                             pd.trim_paths(cfg.num_paths), bs,
                             ue)[1].numpy()
    full = np.zeros_like(cot)
    for u in range(valid.shape[0]):
        idx = np.flatnonzero(valid[u])
        full[u][..., idx] = cot[u][..., :len(idx)]
    return full


@pytest.mark.parametrize("name,dtype", GRAD_PARAMS)
def test_render_channels_and_grads_matches_jax(name, dtype):
    """A random complex cotangent (JAX's VJP with c is PyTorch's backward
    with c.conj()); every gradient leaf within GRAD_RTOL * max|g|.

    With compaction, JAX's gradient is NaN for every path of a user (its
    one-hot permutation product carries the 0 * inf of sqrt at an invalid
    slot's zero power into every slot). The port's gather keeps it at the
    invalid slot, where the validity mask drops it, so it is held against
    JAX's gradient of the uncompacted render with the cotangent moved back
    to the slots each output came from."""
    jnp, jch, _ = _jax()
    jstate, tstate, _, _ = _state(name, dtype)
    cfg = tstate[3]
    shape = tch.render_channels(*tstate).shape
    rng = np.random.RandomState(5)
    cot = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex128 if dtype == "complex128" else np.complex64)
    jcot = cot
    if not cfg.freq_domain and tch._td_compact_active(cfg):
        jcot = _uncompacted_cotangent(tstate, cot)
        jstate = jstate[:3] + (jstate[3].replace(compact_td_paths=False),)
    jh, jgrads = jch.render_channels_and_grads(*jstate, jnp.asarray(jcot))
    h, grads = tch.render_channels_and_grads(*tstate, torch.from_numpy(cot))
    if jcot is cot:
        _close(h.numpy(), jh, dtype, cfg.rx_filter)
    checked = 0
    for jg, g in zip(jgrads, grads):
        for f in dataclasses.fields(g):
            x = getattr(g, f.name)
            if f.name == "valid" or x is None:
                continue
            w = np.asarray(getattr(jg, f.name))
            assert x.shape == w.shape and x.dtype == tstate[3].rdtype
            assert np.isfinite(w).all() and torch.isfinite(x).all()
            np.testing.assert_allclose(
                x.numpy(), w, rtol=0,
                atol=GRAD_RTOL[dtype] * np.abs(w).max() + 1e-300)
            checked += 1
    assert checked == 13                 # 9 path leaves, 2 per panel


def test_packed_layout_of_the_complex_branch():
    """complex128 and the filter honour the packed plane layout that
    ``_packed_layout`` (the same answer as the JAX package's) announces,
    so ``unpack_planes_np`` reads them back (the JAX package stacks them
    instead, and its own unpack cannot read that at a packed-eligible
    config)."""
    _, jch, _ = _jax()
    for dtype, kw in (("complex128", {}), ("complex64",
                                           dict(rx_filter=True))):
        jstate, (pd, bs, ue, cfg), _, _ = _state("fd_doppler", dtype)
        sel = tuple(range(32))
        cfg = cfg.replace(planes_layout="packed", selected_subcarriers=sel,
                          **kw)
        jcfg = jstate[3].replace(planes_layout="packed",
                                 selected_subcarriers=sel, **kw)
        assert tch._packed_layout(cfg) == jch._packed_layout(jcfg) is True
        planes = tch.render_channels_planes(pd, bs, ue, cfg)
        assert tuple(planes.shape) == tch.render_out_shape(U, cfg) == \
            (U, 1, 4, 2 * 2 * 32)
        _close(tch.unpack_planes_np(planes, cfg),
               jch.render_channels(*jstate[:3], jcfg), dtype,
               cfg.rx_filter)


def test_out_reuse_and_shape_checks():
    _, (pd, bs, ue, cfg), _, _ = _state("td_doppler_three", "complex128")
    ref = tch.render_channels_planes(pd, bs, ue, cfg)
    assert tuple(ref.shape) == (2, U, 1, 4, P, 3)
    out = torch.full_like(ref, float("nan"))
    got = tch.render_channels_planes(pd, bs, ue, cfg, out=out)
    assert got is out and torch.equal(out, ref)
    with pytest.raises(ValueError):
        tch.render_channels_planes(pd, bs, ue, cfg, out=out.float())
    with pytest.raises(ValueError, match="max_paths"):
        tch.render_out_shape(U, cfg)
    assert tch.render_out_shape(U, cfg.replace(num_paths=4), P)[4] == 4
    with pytest.raises(ValueError, match="out_dtype"):
        tch.render_channels_planes(pd, bs, ue, cfg.replace(out_dtype="f16"))
    with pytest.raises(ValueError, match="matmul_dtype"):
        tch.render_channels(pd, bs, ue, cfg.replace(matmul_dtype="tf32"))


# ----------------------------------------------------------------------------
# Beam gains
# ----------------------------------------------------------------------------

def _codebook(n_beams, n_tx, seed=4):
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (n_beams, n_tx)))
    return w / np.sqrt(n_tx)


@pytest.mark.parametrize("name", ["fd_doppler", "fd_fov_dipole",
                                  "fd_mimo_per_user_rotation"])
def test_complex128_beam_gains_match_jax(name, monkeypatch):
    """Float64 through the beam-gain kernel's wrapper, as the JAX package
    sends complex128 to its beam-gain kernel: with the card route forced,
    the wrapper gets float64 inputs at full grade (its float64
    instantiation on the card; the plain version on these CPU tensors, so
    no launch); |conj(W) H|^2 of the float64 oracle within 1e-9 * max|G|.
    JAX's ``render_beam_gains`` does not run in float64 at complex128:
    with a fused backend its Pallas kernel returns float32 (bf16 products
    here), and its plain version ("xla") lands ~1e-7 * max|G| off the
    oracle; it is held at 1e-5 * max|G| against that plain version."""
    jnp, jch, _ = _jax()
    jstate, (pd, bs, ue, cfg), d, ue_rot = _state(name, "complex128")
    kw = dict(backend="fused", matmul_dtype="bfloat16",
              selected_subcarriers=tuple(range(0, 16, 2)))
    cfg = cfg.replace(**kw)
    jcfg = jstate[3].replace(**{**kw, "backend": "xla",
                                "matmul_dtype": "float32"})
    w = _codebook(5, cfg.n_tx_ant)
    monkeypatch.setattr(tch, "_on_card", lambda dev: True)
    calls = []
    real = kb.fused_beam_gain
    monkeypatch.setattr(kb, "fused_beam_gain", lambda *a, **k: (
        calls.append((a[0].dtype, k["mm_dtype"])), real(*a, **k))[1])
    before = _launches()
    got = tch.render_beam_gains(pd, bs, ue, cfg,
                                torch.from_numpy(w.real.copy()),
                                torch.from_numpy(w.imag.copy()))
    assert _launches() == before and got.dtype == torch.float64
    assert calls == [(torch.float64, "float32")]
    n_s = len(cfg.doppler_times) if cfg.enable_doppler else 1
    for i, t in enumerate(cfg.doppler_times if n_s > 1 else (None,)):
        h = oracle_channels(
            *(d[k] for k in ANGLES), bs_shape=cfg.bs_shape,
            ue_shape=cfg.ue_shape, bs_rotation=BS_ROT, ue_rotation=ue_rot,
            bs_pattern=cfg.bs_pattern, ue_pattern=cfg.ue_pattern,
            bs_fov=cfg.bs_fov, n_fft=cfg.subcarriers,
            selected_subcarriers=cfg.selected_subcarriers,
            bandwidth=cfg.bandwidth, num_paths=P,
            carrier_freq=cfg.carrier_freq,
            **(dict(doppler_vel=d["doppler_vel"],
                    doppler_acc=d["doppler_acc"], doppler_time=t)
               if n_s > 1 else {}))
        want = (np.abs(np.einsum("bt,urtk->urbk", w.conj(), h)) ** 2
                ).reshape(U, -1, len(cfg.selected_subcarriers))
        k = want.shape[-1]
        np.testing.assert_allclose(got.numpy()[..., i * k:(i + 1) * k],
                                   want, rtol=0, atol=1e-9 * want.max())
    jg = np.asarray(jch.render_beam_gains(
        *jstate[:3], jcfg, jnp.asarray(w.real), jnp.asarray(w.imag)))
    assert jg.shape == tuple(got.shape)
    np.testing.assert_allclose(got.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


def test_beam_gains_still_refuse_the_receive_filter():
    _, (pd, bs, ue, cfg), _, _ = _state("lpf_selected", "complex128")
    cfg = cfg.replace(selected_subcarriers=(0, 1, 2))
    w = _codebook(3, cfg.n_tx_ant)
    with pytest.raises(ValueError, match="rx_filter"):
        tch.render_beam_gains(pd, bs, ue, cfg, w.real, w.imag)


# ----------------------------------------------------------------------------
# Dataset.compute_channels / compute_beam_gains
# ----------------------------------------------------------------------------

@pytest.fixture
def port_on_cpu():
    """The port renders on the CPU here (its config default is "cuda");
    the JAX package's compute_dtype is restored too."""
    import deepmimo_tpu as dm
    old = dict(dmt.config.items())
    old_dm = {k: dm.config.get(k) for k in ("compute_dtype",
                                            "planes_layout")}
    dmt.config.set("device", "cpu")
    yield dm
    for k, v in old.items():
        dmt.config.set(k, v)
    for k, v in old_dm.items():
        dm.config.set(k, v)


N_UE = 24


def _ds_data(seed=41, n_ue=N_UE, max_paths=8, polar=False):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    if polar:
        rng = np.random.RandomState(seed + 1)
        nan = np.isnan(d["power"])
        for pol in ("vv", "vh", "hh", "hv"):
            d[f"power_{pol}"] = np.where(nan, np.nan,
                                         rng.uniform(-130, -60, nan.shape))
            d[f"phase_{pol}"] = np.where(nan, np.nan,
                                         rng.uniform(-180, 180, nan.shape))
    return d


def _params(pkg, freq_domain=1, **ofdm):
    c = pkg.consts
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 2])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 15, -30])
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION] = np.array(
        [[0, 30], [-20, 20], [0, 360]])
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 64
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(16)
    p[c.PARAMSET_FD_CH] = freq_domain
    for k, v in ofdm.items():
        p[c.PARAMSET_OFDM][k] = v
    return p


DS_CASES = {
    "time_domain": dict(freq_domain=0),
    "time_domain_fov": dict(freq_domain=0),
    "rx_filter": dict(rx_filter=1),
    "rx_filter_full_band": dict(rx_filter=1, selected_subcarriers=64),
    "frequency_domain": {},
}
DS_PARAMS = [(n, dt) for n in sorted(DS_CASES)
             for dt in ("complex64", "complex128")
             if not (n == "frequency_domain" and dt == "complex64")]


def _ds_params(pkg, name):
    kw = dict(DS_CASES[name])
    if kw.get("selected_subcarriers"):
        kw[pkg.consts.PARAMSET_OFDM_SC_SAMP] = np.arange(
            kw.pop("selected_subcarriers"))
    return _params(pkg, **kw)


@pytest.mark.parametrize("name,dtype", DS_PARAMS)
def test_compute_channels_matches_jax(port_on_cpu, name, dtype):
    """A fresh JAX Dataset per dtype: the JAX package caches one PathData
    whatever the dtype."""
    dm = port_on_cpu
    dm.config.set("compute_dtype", dtype)
    dmt.config.set("compute_dtype", dtype)
    # The JAX Dataset cannot unpack the filter's or complex128's planes at
    # a packed-eligible selection (64 subcarriers): it renders them stacked.
    dm.config.set("planes_layout", "stacked")
    jds, tds = dm.Dataset(_ds_data()), dmt.Dataset(_ds_data())
    if name.endswith("_fov"):
        for ds in (jds, tds):
            ds.apply_fov(bs_fov=np.array([120, 180]))
    want = jds.compute_channels(_ds_params(dm, name))
    got = tds.compute_channels(_ds_params(dmt, name))
    _close(got, want, dtype, "rx_filter" in name)
    assert tds.channel is got
    if name.startswith("time_domain"):
        assert got.shape == (N_UE, 1, 8, 8)


def test_time_domain_fov_front_packs_valid_paths(port_on_cpu):
    dmt.config.set("compute_dtype", "complex128")
    d = _ds_data()
    ds = dmt.Dataset(d)
    ds.apply_fov(bs_fov=np.array([120, 180]))
    h = ds.compute_channels(_params(dmt, freq_domain=0))
    n = ds.num_paths
    assert n.sum() < (~np.isnan(d["power"])).sum()
    for u in range(N_UE):
        assert np.all(h[u, ..., n[u]:] == 0)
        assert np.all(np.abs(h[u, ..., :n[u]]) > 0)


@pytest.mark.parametrize("name,dtype", [("time_domain", "complex128"),
                                        ("rx_filter", "complex64"),
                                        ("frequency_domain", "complex128")])
def test_out_reuse_and_streamed_blocks(port_on_cpu, name, dtype):
    dmt.config.set("compute_dtype", dtype)
    ds, other = dmt.Dataset(_ds_data()), dmt.Dataset(_ds_data(seed=42))
    params = _ds_params(dmt, name)
    first = ds.compute_channels(params, to_device=True).clone()
    assert first.dtype == (torch.float64 if dtype == "complex128"
                           else torch.float32)
    prev = other.compute_channels(params, to_device=True)
    h = ds.compute_channels(params, to_device=True, out=prev)
    assert h.data_ptr() == prev.data_ptr() and torch.equal(h, first)
    single = ds.compute_channels(params)
    dmt.config.set("max_device_output_bytes", 1)
    dmt.config.set("user_block", 7)                   # 4 blocks, ragged
    streamed = ds.compute_channels(params)
    assert streamed.dtype == single.dtype
    # The CPU's vector and scalar paths, and its batched products, may
    # round another batch size differently; on the card the time domain is
    # exact (test_card_time_domain_dataset_streamed_equals_single).
    np.testing.assert_allclose(streamed, single, rtol=0,
                               atol=1e-6 * np.abs(single).max())


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_dual_polar_time_domain_matches_jax(port_on_cpu, dtype):
    dm = port_on_cpu
    dm.config.set("compute_dtype", dtype)
    dmt.config.set("compute_dtype", dtype)
    jds = dm.Dataset(_ds_data(polar=True))
    tds = dmt.Dataset(_ds_data(polar=True))
    jp, tp = _params(dm, freq_domain=0), _params(dmt, freq_domain=0)
    for p, pkg in ((jp, dm), (tp, dmt)):
        p[pkg.consts.PARAMSET_POLAR_EN] = 1
    want = jds.compute_channels(jp)
    got = tds.compute_channels(tp)
    assert set(got) == set(want) == {"VV", "VH", "HH", "HV"}
    for pol in want:
        _close(got[pol], want[pol], dtype, False)
    with pytest.raises(ValueError, match="to_device"):
        tds.compute_channels(tp, to_device=True)


def test_complex128_compute_beam_gains_matches_oracle(port_on_cpu):
    """|conj(W) H|^2 of the float64 oracle's channels at 1e-9 * max|G|,
    from a float64 codebook (the JAX Dataset rounds the codebook to
    float32 first)."""
    dmt.config.set("compute_dtype", "complex128")
    d = _ds_data()
    ds = dmt.Dataset(d)
    params = _params(dmt)
    c = dmt.consts
    params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION] = np.array(
        [0, 10, -5])
    w = _codebook(6, 8, seed=9)
    g = ds.compute_beam_gains(params, codebook=w)
    assert g.dtype == np.float64 and g.shape == (N_UE, 1, 6, 16)
    h = oracle_channels(*(d[k] for k in ANGLES), bs_shape=(4, 2),
                        bs_rotation=(0, 15, -30), ue_rotation=(0, 10, -5),
                        n_fft=64, selected_subcarriers=tuple(range(16)),
                        num_paths=8)
    want = np.abs(np.einsum("bt,urtk->urbk", w.conj(), h)) ** 2
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-9 * want.max())
    dev = ds.compute_beam_gains(params, codebook=w, to_device=True)
    again = ds.compute_beam_gains(params, codebook=w, to_device=True,
                                  out=dev)
    assert again.data_ptr() == dev.data_ptr() and again.dtype == \
        torch.float64


# ----------------------------------------------------------------------------
# On the card (skipped without one)
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


CARD_CASES = ["td_fov_auto", "td_doppler_three", "lpf_selected",
              "lpf_full_band_doppler", "fd_fov_dipole"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("name", CARD_CASES)
def test_card_render_matches_float64_oracle(cuda, name, dtype):
    """The eager paths on the card: planes against the float64 oracle on
    300 users, and no kernel launched."""
    n = 300
    cfg = ttypes.ChannelConfig(**{**BASE, **CASES[name], "dtype": dtype,
                                  "backend": "fused"})
    d = _data(name, n_ue=n)
    rd = torch.float64 if dtype == "complex128" else torch.float32
    paths = dmt.PathData.from_numpy(*(d[k] for k in ANGLES),
                                    doppler_vel=d["doppler_vel"],
                                    doppler_acc=d["doppler_acc"],
                                    dtype=rd, device=cuda)
    bs = dmt.AntennaPanel.make(BS_ROT, dtype=rd, device=cuda)
    ue = dmt.AntennaPanel.make(_ue_rot(name), dtype=rd, device=cuda)
    before = _launches()
    planes = tch.render_channels_planes(paths, bs, ue, cfg)
    torch.cuda.synchronize()
    assert _launches() == before and planes.device.type == "cuda"
    h = tch.unpack_planes_np(planes, cfg)
    times = cfg.doppler_times if cfg.enable_doppler else (None,)
    for i, t in enumerate(times):
        want = oracle_channels(
            *(d[k] for k in ANGLES), bs_shape=cfg.bs_shape,
            ue_shape=cfg.ue_shape, bs_rotation=BS_ROT,
            ue_rotation=_ue_rot(name), bs_pattern=cfg.bs_pattern,
            ue_pattern=cfg.ue_pattern, bs_fov=cfg.bs_fov, ue_fov=cfg.ue_fov,
            freq_domain=cfg.freq_domain, n_fft=cfg.subcarriers,
            selected_subcarriers=cfg.selected_subcarriers,
            bandwidth=cfg.bandwidth, rx_filter=cfg.rx_filter, num_paths=P,
            carrier_freq=cfg.carrier_freq,
            **(dict(doppler_vel=d["doppler_vel"],
                    doppler_acc=d["doppler_acc"], doppler_time=t)
               if cfg.enable_doppler else {}))
        got = h[..., i] if len(times) > 1 else h
        tol = (C64_RTOL * np.abs(want).max() if dtype == "complex64" else
               (C128_LPF_ATOL if cfg.rx_filter else C128_ATOL))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_card_time_domain_dataset_streamed_equals_single(cuda):
    """compute_channels on the card: time-domain planes to the host,
    streamed over ragged blocks equal to one launch bit for bit."""
    old = dict(dmt.config.items())
    try:
        dmt.config.set("device", "cuda")
        ds = dmt.Dataset(_ds_data(n_ue=1000))
        ds.apply_fov(bs_fov=np.array([120, 180]))
        params = _params(dmt, freq_domain=0)
        single = ds.compute_channels(params)
        dmt.config.set("max_device_output_bytes", 1)
        dmt.config.set("user_block", 300)
        np.testing.assert_array_equal(ds.compute_channels(params), single)
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)


@pytest.mark.gpu
def test_card_complex128_beam_gains_launch_the_float64_kernel(cuda):
    """complex128 compute_beam_gains on the card: one launch of the
    beam-gain kernel's float64 instantiation per call, no other kernel,
    |conj(W) H|^2 of the float64 oracle within 1e-9 * max|G|."""
    old = dict(dmt.config.items())
    try:
        dmt.config.set("device", "cuda")
        dmt.config.set("compute_dtype", "complex128")
        d = _ds_data(n_ue=1000)
        ds = dmt.Dataset(d)
        params = _params(dmt)
        c = dmt.consts
        params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION] = np.array(
            [0, 10, -5])
        w = _codebook(6, 8, seed=9)
        kb.MODE_LAUNCHES.clear()
        before = _launches()
        g = ds.compute_beam_gains(params, codebook=w, to_device=True)
        torch.cuda.synchronize()
        assert g.dtype == torch.float64 and g.device.type == "cuda"
        assert dict(kb.MODE_LAUNCHES) == {"f64": 1}
        assert _launches()[:2] == before[:2]
        h = oracle_channels(*(d[k] for k in ANGLES), bs_shape=(4, 2),
                            bs_rotation=(0, 15, -30),
                            ue_rotation=(0, 10, -5), n_fft=64,
                            selected_subcarriers=tuple(range(16)),
                            num_paths=8)
        want = np.abs(np.einsum("bt,urtk->urbk", w.conj(), h)) ** 2
        np.testing.assert_allclose(g.cpu().numpy().reshape(want.shape),
                                   want, rtol=0, atol=1e-9 * want.max())
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
