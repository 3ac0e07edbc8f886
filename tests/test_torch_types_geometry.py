"""PyTorch port vs the JAX package: data types, geometry, patterns.

Same numpy inputs (cast to float32) through both packages on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimo_tpu.ops import geometry as jgeo
from deepmimo_tpu.ops import patterns as jpat
from deepmimo_tpu.ops import types as jtypes
from deepmimo_tpu_torch.ops import geometry as tgeo
from deepmimo_tpu_torch.ops import patterns as tpat
from deepmimo_tpu_torch.ops import types as ttypes

from oracle import make_synthetic_paths

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32

ROTATIONS = {
    "none": np.zeros(3, F32),
    "global": np.array([10.0, -20.0, 35.0], F32),
    "per_user": np.random.RandomState(5).uniform(-90, 90, (16, 3)).astype(F32),
}


def _angles(u=16, p=9, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 180, (u, p)).astype(F32),
            rng.uniform(-180, 180, (u, p)).astype(F32))


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("rot", sorted(ROTATIONS))
def test_rotate_unit_vec_matches_jax(rot):
    el, az = _angles()
    (jr, je, ja), (tr, te, ta) = _pair(ROTATIONS[rot], el, az)
    want = jgeo.rotate_unit_vec(jr, je, ja)
    got = tgeo.rotate_unit_vec(tr, te, ta)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)


def test_rotate_unit_vec_flat_views_match_2d():
    el, az = _angles()
    rot = torch.from_numpy(ROTATIONS["global"])
    flat = tgeo.rotate_unit_vec(rot, torch.from_numpy(el).reshape(-1),
                                torch.from_numpy(az).reshape(-1))
    full = tgeo.rotate_unit_vec(rot, torch.from_numpy(el),
                                torch.from_numpy(az))
    for a, b in zip(flat, full):
        assert torch.equal(a.reshape(-1), b.reshape(-1))


@pytest.mark.parametrize("rot", sorted(ROTATIONS))
def test_rotate_angles_matches_jax(rot):
    el, az = _angles(seed=1)
    (jr, je, ja), (tr, te, ta) = _pair(ROTATIONS[rot], el, az)
    jt, jp = jgeo.rotate_angles(jr, je, ja)
    tt, tp = tgeo.rotate_angles(tr, te, ta)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-5)
    # phi wraps at +-pi: compare on the circle
    dphi = np.angle(np.exp(1j * (tp.numpy().astype(np.float64) -
                                 np.asarray(jp, np.float64))))
    np.testing.assert_allclose(dphi, 0.0, atol=2e-5)


def test_safe_arccos_gradient_bounded_like_jax():
    x = np.array([-1.2, -1.0, -1 + 1e-9, -0.999999, -0.5, 0.0, 0.5,
                  0.999999, 1 - 1e-9, 1.0, 1.2], F32)
    want = np.asarray(jax.vmap(jax.grad(jgeo.safe_arccos))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    val = tgeo.safe_arccos(xt)
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy(),
                               np.asarray(jgeo.safe_arccos(jnp.asarray(x))),
                               atol=1e-6)
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5)


def test_rotate_angles_gradient_at_pole_matches_jax():
    """theta' = arccos(z') with z' -> 1 at the zenith: the bounded
    gradient keeps d theta'/d el finite and equal to the JAX one."""
    el = np.array([[0.0, 1e-3, 30.0, 180.0]], F32)
    az = np.array([[0.0, 45.0, 90.0, -30.0]], F32)
    rot = np.zeros(3, F32)

    def jloss(e):
        t, p = jgeo.rotate_angles(jnp.asarray(rot), e, jnp.asarray(az))
        return jnp.sum(t)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(el)))
    et = torch.from_numpy(el).requires_grad_(True)
    t, _ = tgeo.rotate_angles(torch.from_numpy(rot), et, torch.from_numpy(az))
    t.sum().backward()
    assert np.isfinite(et.grad.numpy()).all()
    np.testing.assert_allclose(et.grad.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (8, 8)])
def test_array_response_planes_matches_jax(shape):
    rng = np.random.RandomState(2)
    theta = rng.uniform(0, np.pi, (12, 7)).astype(F32)
    phi = rng.uniform(-np.pi, np.pi, (12, 7)).astype(F32)
    valid = rng.rand(12, 7) > 0.3
    want = jgeo.array_response_planes(shape, jnp.float32(0.5),
                                      jnp.asarray(theta), jnp.asarray(phi),
                                      jnp.asarray(valid))
    got = tgeo.array_response_planes(shape, torch.tensor(0.5),
                                     torch.from_numpy(theta),
                                     torch.from_numpy(phi),
                                     torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (12, shape[0] * shape[1], 7)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_ant_indices_and_full_fov_match_jax():
    for shape in [(1, 1), (4, 2), (3, 5)]:
        np.testing.assert_array_equal(tgeo.ant_indices(shape),
                                      jgeo.ant_indices(shape))
    for fov in [(360, 180), (120, 90), (360, 90)]:
        assert tgeo.is_full_fov(fov) == jgeo.is_full_fov(fov)


@pytest.mark.parametrize("fov", [(120.0, 90.0), (60.0, 180.0)])
def test_apply_fov_matches_jax(fov):
    rng = np.random.RandomState(3)
    theta = rng.uniform(0, np.pi, (20, 6)).astype(F32)
    phi = rng.uniform(-np.pi, np.pi, (20, 6)).astype(F32)
    want = np.asarray(jgeo.apply_fov(fov, jnp.asarray(theta),
                                     jnp.asarray(phi)))
    got = tgeo.apply_fov(fov, torch.from_numpy(theta), torch.from_numpy(phi))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["isotropic", "halfwave-dipole"])
def test_pattern_gain_matches_jax(name):
    theta = np.concatenate([np.linspace(0, np.pi, 33),
                            [np.float32(np.pi)]]).astype(F32)
    phi = np.zeros_like(theta)
    want = np.asarray(jpat.pattern_gain(name, jnp.asarray(theta),
                                        jnp.asarray(phi)))
    got = tpat.pattern_gain(name, torch.from_numpy(theta),
                            torch.from_numpy(phi))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tpat.pattern_gain("cardioid", torch.from_numpy(theta),
                          torch.from_numpy(phi))


def _path_data_pair(with_doppler):
    d = make_synthetic_paths(n_ue=10, max_paths=6, seed=4,
                             with_doppler=with_doppler)
    kw = {k: d[k] for k in ("power", "phase", "delay", "aoa_az", "aoa_el",
                            "aod_az", "aod_el")}
    if with_doppler:
        kw.update(doppler_vel=d["doppler_vel"], doppler_acc=d["doppler_acc"])
    return (jtypes.PathData.from_numpy(**kw, dtype=jnp.float32),
            ttypes.PathData.from_numpy(**kw, device="cpu"))


@pytest.mark.parametrize("with_doppler", [False, True])
def test_path_data_from_numpy_matches_jax(with_doppler):
    jp, tp = _path_data_pair(with_doppler)
    assert (tp.n_ue, tp.max_paths) == (jp.n_ue, jp.max_paths)
    for f in dataclasses.fields(jtypes.PathData):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if a is None:
            assert b is None, f.name
            continue
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), f.name)
    tr = tp.trim_paths(4).slice_users(2, 5)
    assert tuple(tr.delay_s.shape) == (5, 4)
    np.testing.assert_array_equal(tr.delay_s.numpy(),
                                  np.asarray(jp.delay_s)[2:7, :4])


def test_state_from_numpy_rebuilds_jax_state():
    """The parity tests' bridge: JAX objects -> numpy leaves + asdict ->
    identical port state."""
    jp, _ = _path_data_pair(True)
    jbs = jtypes.AntennaPanel.make((5.0, 0.0, 20.0))
    jue = jtypes.AntennaPanel.make(np.ones((10, 3)) * 7.0)
    jcfg = jtypes.ChannelConfig(bs_shape=(4, 2), ue_shape=(2, 1),
                                selected_subcarriers=tuple(range(8)),
                                planes_layout="packed", backend="fused")
    leaves = lambda obj: {f.name: None if getattr(obj, f.name) is None
                          else np.asarray(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)}
    pd, bs, ue, cfg = ttypes.state_from_numpy(
        leaves(jp), leaves(jbs), leaves(jue), dataclasses.asdict(jcfg),
        device="cpu")
    for name, arr in leaves(jp).items():
        got = getattr(pd, name)
        assert (got is None) == (arr is None)
        if arr is not None:
            np.testing.assert_array_equal(got.numpy(), arr)
    assert pd.valid.dtype == torch.bool
    np.testing.assert_array_equal(ue.rotation_deg.numpy(),
                                  np.asarray(jue.rotation_deg))
    assert float(bs.spacing) == float(jbs.spacing)
    jfields = dataclasses.asdict(jcfg)
    for name, value in dataclasses.asdict(cfg).items():
        assert value == jfields[name], name
    assert hash(cfg) == hash(ttypes.ChannelConfig(**dataclasses.asdict(cfg)))


def test_channel_config_dtypes_and_defaults():
    cfg = ttypes.ChannelConfig()
    assert (cfg.cdtype, cfg.rdtype) == (torch.complex64, torch.float32)
    wide = cfg.replace(dtype="complex128")
    assert (wide.cdtype, wide.rdtype) == (torch.complex128, torch.float64)
    jdef = dataclasses.asdict(jtypes.ChannelConfig())
    for name, value in dataclasses.asdict(cfg).items():
        assert value == jdef[name], name
    panel = ttypes.AntennaPanel.make((1.0, 2.0, 3.0), 0.25, device="cpu")
    assert panel.rotation_deg.dtype == torch.float32
    assert float(panel.spacing) == 0.25


def test_import_leaves_out_jax():
    """``import deepmimo_tpu_torch`` and its calibration package import
    neither jax nor the JAX package (checked in a fresh interpreter)."""
    code = ("import sys, deepmimo_tpu_torch, deepmimo_tpu_torch.ops.channel, "
            "deepmimo_tpu_torch.parallel, "
            "deepmimo_tpu_torch.ops.kernels.pathsum;"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'deepmimo_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'deepmimo_tpu.'))];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
