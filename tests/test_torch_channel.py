"""PyTorch port vs the JAX package: ``render_channels_planes``.

Both packages render from identical state (the JAX objects' numpy leaves
through ``state_from_numpy``) on the CPU; the JAX fused backend runs its
Pallas kernel in interpret mode. Tolerance 5e-5 * max|H|, as the JAX
package's own fused-vs-xla test (tests/test_pallas.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimo_tpu.ops import channel as jch
from deepmimo_tpu.ops import types as jtypes
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes

from oracle import make_synthetic_paths, oracle_channels

torch.set_num_threads(1)
RTOL = 5e-5
U = 16

BASE = dict(bs_shape=(8, 8), ue_shape=(1, 1), subcarriers=512,
            selected_subcarriers=tuple(range(64)), bandwidth=10e6,
            num_paths=25, backend="fused", planes_layout="packed")
CASES = {
    "headline": {},
    "mimo_stacked": dict(bs_shape=(4, 2), ue_shape=(2, 2),
                         selected_subcarriers=tuple(range(16))),
    "stride4": dict(bs_shape=(4, 4),
                    selected_subcarriers=tuple(range(1, 65, 4))),
    "single_subcarrier": dict(bs_shape=(4, 2), selected_subcarriers=(5,)),
    "per_user_rotation": dict(bs_shape=(4, 4)),
    "doppler_one_snapshot": dict(bs_shape=(2, 2), enable_doppler=True,
                                 doppler_times=(1e-3,)),
    "fewer_paths": dict(bs_shape=(2, 4), num_paths=7),
    "xla_backend": dict(bs_shape=(4, 2), backend="xla",
                        selected_subcarriers=tuple(range(16))),
    "xla_doppler_one_snapshot": dict(bs_shape=(2, 2), backend="xla",
                                     enable_doppler=True,
                                     doppler_times=(1e-3,)),
    "xla_fov_dipole": dict(bs_shape=(4, 2), backend="xla",
                           bs_pattern="halfwave-dipole",
                           ue_pattern="halfwave-dipole",
                           bs_fov=(120.0, 90.0)),
    "non_arithmetic": dict(bs_shape=(4, 2),
                           selected_subcarriers=(0, 1, 3, 7)),
}


def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _state(name, seed=11):
    kw = {**BASE, **CASES[name]}
    d = make_synthetic_paths(n_ue=U, max_paths=25, seed=seed,
                             with_doppler=True)
    jpaths = jtypes.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], doppler_vel=d["doppler_vel"],
        doppler_acc=d["doppler_acc"], dtype=jnp.float32)
    ue_rot = (np.random.RandomState(seed).uniform(-60, 60, (U, 3))
              if name == "per_user_rotation" else (0.0, 10.0, -5.0))
    jbs = jtypes.AntennaPanel.make((5.0, -10.0, 20.0))
    jue = jtypes.AntennaPanel.make(ue_rot)
    jcfg = jtypes.ChannelConfig(**kw)
    tstate = ttypes.state_from_numpy(_leaves(jpaths), _leaves(jbs),
                                     _leaves(jue), dataclasses.asdict(jcfg),
                                     device="cpu")
    return (jpaths, jbs, jue, jcfg), tstate, d, ue_rot


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_channels_planes_matches_jax(name):
    jstate, (pd, bs, ue, cfg), _, _ = _state(name)
    assert tch._fused_render_eligible(cfg) == \
        jch._fused_render_eligible(jstate[3])
    want = np.asarray(jch.render_channels_planes(*jstate))
    got = tch.render_channels_planes(pd, bs, ue, cfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == \
        tch.render_out_shape(U, cfg)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_array_equal(tch.unpack_planes_np(got.numpy(), cfg),
                                  jch.unpack_planes_np(got.numpy(),
                                                       jstate[3]))


@pytest.mark.parametrize("name", ["headline", "mimo_stacked"])
def test_render_matches_float64_oracle(name):
    _, (pd, bs, ue, cfg), d, ue_rot = _state(name, seed=12)
    h = tch.unpack_planes_np(
        tch.render_channels_planes(pd, bs, ue, cfg).numpy(), cfg)
    want = oracle_channels(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], bs_shape=cfg.bs_shape,
        ue_shape=cfg.ue_shape, bs_rotation=(5.0, -10.0, 20.0),
        ue_rotation=ue_rot, n_fft=cfg.subcarriers,
        selected_subcarriers=cfg.selected_subcarriers,
        bandwidth=cfg.bandwidth, num_paths=cfg.num_paths)
    np.testing.assert_allclose(h, want, atol=RTOL * np.abs(want).max())


def test_out_is_written_in_place():
    _, (pd, bs, ue, cfg), _, _ = _state("headline")
    ref = tch.render_channels_planes(pd, bs, ue, cfg)
    out = torch.full_like(ref, float("nan"))
    got = tch.render_channels_planes(pd, bs, ue, cfg, out=out)
    assert got.data_ptr() == out.data_ptr() and torch.equal(out, ref)
    xla = cfg.replace(backend="xla")
    got = tch.render_channels_planes(pd, bs, ue, xla, out=out)
    assert got is out
    with pytest.raises(ValueError):
        tch.render_channels_planes(pd, bs, ue, cfg, out=out[:-1])


@pytest.mark.parametrize("kw", [
    dict(), dict(ue_shape=(2, 2), bs_shape=(4, 2)),
    dict(selected_subcarriers=(0, 2, 3)), dict(freq_domain=False),
    dict(rx_filter=True), dict(dtype="complex128"),
    dict(selected_subcarriers=tuple(range(0, 128, 2))),
], ids=["headline", "mimo", "non_arithmetic", "time_domain", "rx_filter",
        "complex128", "stride2"])
def test_fused_eligibility_matches_jax(kw):
    jcfg = jtypes.ChannelConfig(**{**BASE, **kw})
    cfg = ttypes.ChannelConfig(**{**BASE, **kw})
    assert tch._fused_render_eligible(cfg) == \
        jch._fused_render_eligible(jcfg)
    assert tch._k_progression(cfg) == jch._k_progression(jcfg)
    assert tch._packed_layout(cfg) == jch._packed_layout(jcfg)
