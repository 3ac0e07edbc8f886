"""PyTorch port vs the JAX package: ``render_channels``,
``render_channels_and_grads`` and the calibration training step.

Both packages start from identical state (the JAX objects' numpy leaves
through ``state_from_numpy`` / ``calib_params_from_numpy``) on the CPU, on
the config of tests/test_sharding.py:30-32; the JAX Pallas kernels run in
interpret mode. Tolerances: channels 5e-5 * max|H| (tests/test_pallas.py:
177), losses rtol 1e-5, every gradient leaf 3e-4 * max|g|
(tests/test_pallas.py:238-239), the planes-vs-complex loss rtol 1e-4
(tests/test_sharding.py:127).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimo_tpu.ops import channel as jch
from deepmimo_tpu.ops import types as jtypes
from deepmimo_tpu.parallel import sharded as jsh
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes
from deepmimo_tpu_torch.parallel import sharded as tsh

from oracle import make_synthetic_paths

torch.set_num_threads(1)
HTOL = 5e-5
GTOL = 3e-4
U = 16
CFG = dict(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
           subcarriers=64, selected_subcarriers=tuple(range(8)),
           num_paths=6, dtype="complex64")


def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _state(seed=50, bs_rot=(5.0, 5.0, 5.0), doppler=False, **kw):
    d = make_synthetic_paths(n_ue=U, max_paths=6, seed=seed,
                             with_doppler=doppler)
    extra = dict(doppler_vel=d["doppler_vel"],
                 doppler_acc=d["doppler_acc"]) if doppler else {}
    jpaths = jtypes.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], dtype=jnp.float32, **extra)
    jbs, jue = jtypes.AntennaPanel.make(bs_rot), jtypes.AntennaPanel.make()
    jcfg = jtypes.ChannelConfig(**{**CFG, **kw})
    tstate = ttypes.state_from_numpy(_leaves(jpaths), _leaves(jbs),
                                     _leaves(jue), dataclasses.asdict(jcfg),
                                     device="cpu")
    return (jpaths, jbs, jue, jcfg), tstate


def _port_params(jparams):
    d = {k: np.asarray(v) for k, v in jparams._asdict().items()
         if k not in ("bs", "ue")}
    d.update(bs=_leaves(jparams.bs), ue=_leaves(jparams.ue))
    return ttypes.calib_params_from_numpy(d, device="cpu")


def _jax_leaves(p):
    return [p.bs.rotation_deg, p.bs.spacing, p.ue.rotation_deg,
            p.ue.spacing, p.d_power_dbw, p.d_phase_deg, p.d_delay_ns,
            p.d_angles_deg]


def _close_leaves(got, want, tol=GTOL):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * np.abs(w).max() + 1e-30)


RENDER_CASES = {
    "xla": {},
    "pallas": dict(backend="pallas"),
    "pallas_non_arithmetic": dict(backend="pallas",
                                  selected_subcarriers=(0, 1, 3, 7, 20)),
    "doppler_three_snapshots": dict(enable_doppler=True,
                                    doppler_times=(0.0, 1e-3, 2e-3)),
    "pallas_doppler_two_snapshots": dict(backend="pallas",
                                         enable_doppler=True,
                                         doppler_times=(0.0, 5e-4)),
    "fov_dipole": dict(bs_pattern="halfwave-dipole",
                       bs_fov=(200.0, 160.0)),
}


@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_render_channels_matches_jax(name):
    jstate, tstate = _state(doppler="doppler" in name, **RENDER_CASES[name])
    want = np.asarray(jch.render_channels(*jstate))
    got = tch.render_channels(*tstate)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=HTOL * np.abs(want).max())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("cot", ["ones", "complex"])
def test_render_channels_and_grads_matches_jax(backend, cot):
    """JAX's VJP with cotangent c is PyTorch's backward with c.conj(): a
    complex cotangent tells the two conventions apart."""
    jstate, tstate = _state(seed=51, backend=backend)
    cotangent = None
    if cot == "complex":
        rng = np.random.RandomState(2)
        shape = (U, 2, 8, 8)
        cotangent = (rng.normal(size=shape) +
                     1j * rng.normal(size=shape)).astype(np.complex64)
    jh, jgrads = jch.render_channels_and_grads(
        *jstate, None if cotangent is None else jnp.asarray(cotangent))
    h, grads = tch.render_channels_and_grads(
        *tstate, None if cotangent is None else torch.from_numpy(cotangent))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                               atol=HTOL * np.abs(np.asarray(jh)).max())
    for jg, g in zip(jgrads, grads):
        for f in dataclasses.fields(g):
            if f.name == "valid" or getattr(g, f.name) is None:
                continue
            _close_leaves([getattr(g, f.name)], [getattr(jg, f.name)])


def _calib(loss, seed=52, **kw):
    """JAX and port states for a calibration test: start at BS rotation
    (0, 0, 0), target rendered at (0, 0, 10) (test_sharding.py:109-137)."""
    planes = loss == "planes"
    kw = {**kw, **(dict(backend="fused") if planes else {})}
    jstate, tstate = _state(seed=seed, bs_rot=(0.0, 0.0, 0.0), **kw)
    jpaths, jbs, jue, jcfg = jstate
    jrot = jtypes.AntennaPanel.make((0.0, 0.0, 10.0))
    render = jch.render_channels_planes if planes else jch.render_channels
    jtarget = render(jpaths, jrot, jue, jcfg)
    jparams = jsh.init_calib_params(jpaths, jbs, jue)
    paths, bs, ue, cfg = tstate
    target = torch.from_numpy(np.array(jtarget))
    params = _port_params(jparams)
    return (jparams, jpaths, jtarget, jcfg), (params, paths, target, cfg)


LOSSES = {"complex_xla": ("complex", {}),
          "complex_pallas": ("complex", dict(backend="pallas")),
          "planes": ("planes", {})}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_calib_loss_and_gradients_match_jax(name):
    kind, kw = LOSSES[name]
    jargs, targs = _calib(kind, **kw)
    jfn = jsh.calib_loss_planes if kind == "planes" else jsh.calib_loss
    tfn = tsh.calib_loss_planes if kind == "planes" else tsh.calib_loss
    jloss, jgrads = jax.value_and_grad(jfn)(*jargs)
    loss, grads = tsh.calib_value_and_grad(tfn, *targs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(tfn(*targs)) == float(loss)
    _close_leaves(grads.leaves(), _jax_leaves(jgrads))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_training_step_matches_jax(name):
    kind, kw = LOSSES[name]
    jargs, targs = _calib(kind, seed=53, **kw)
    jstep = jsh.training_step_planes if kind == "planes" else \
        jsh.training_step
    tstep = tsh.training_step_planes if kind == "planes" else \
        tsh.training_step
    jnew, jloss = jstep(*jargs, lr=3e-3)
    new, loss = tstep(*targs, lr=3e-3)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # p - lr * g: the step moves each leaf by 3e-3 * grad; compare the
    # moves at the gradient tolerance.
    old = targs[0].leaves()
    _close_leaves([n - o for n, o in zip(new.leaves(), old)],
                  [np.asarray(n) - np.asarray(o) for n, o in
                   zip(_jax_leaves(jnew), _jax_leaves(jargs[0]))])


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_ten_steps_decrease_the_loss(name):
    kind, kw = LOSSES[name]
    _, (params, paths, target, cfg) = _calib(kind, seed=54, **kw)
    step = tsh.training_step_planes if kind == "planes" else \
        tsh.training_step
    losses = []
    for _ in range(10):
        params, loss = step(params, paths, target, cfg, lr=3e-3)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert not any(x.requires_grad for x in params.leaves())


def test_planes_loss_matches_complex_loss():
    (_, (params, paths, target_p, cfg_p)) = _calib("planes", seed=55)
    (_, (_, _, target_c, cfg_c)) = _calib("complex", seed=55)
    np.testing.assert_allclose(
        float(tsh.calib_loss_planes(params, paths, target_p, cfg_p)),
        float(tsh.calib_loss(params, paths, target_c, cfg_c)), rtol=1e-4)


def test_calib_params_from_numpy_round_trip():
    jargs, (params, paths, _, _) = _calib("complex")
    assert isinstance(params, tsh.CalibParams)
    for got, want in zip(params.leaves(), _jax_leaves(jargs[0])):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    init = tsh.init_calib_params(paths, params.bs, params.ue)
    assert tuple(init.d_angles_deg.shape) == (U, 6, 4)
