"""Multi-device layer of the PyTorch port (``deepmimo_tpu_torch.parallel``)
in one process: meshes, the sharded renders and beam gains, the sharded
training step and the loader, on a one-rank gloo mesh, against the port's
unsharded calls and the JAX package's sharded calls on conftest's 8-device
CPU mesh. Multi-rank meshes are in tests/test_torch_multiprocess.py.

Every test that makes a mesh takes it from a fixture that destroys the
process group at teardown (``make_mesh`` starts a group when none exists).
Both packages start from the same numpy state. Tolerances: the port's
sharded call vs its unsharded call 1e-6 (tests/test_sharding.py); vs JAX
5e-5 * max|H| (tests/test_pallas.py:177), beam gains 1e-4 * max|G|; the
loss rtol 1e-5 and the updated rotation rtol 1e-4 (tests/test_sharding.py:
88-91).

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_parallel.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import parallel as par
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes
from deepmimo_tpu_torch.parallel import mesh as tmesh
from deepmimo_tpu_torch.parallel import sharded as tsh

from oracle import make_synthetic_paths

torch.set_num_threads(1)
U, P = 16, 6
HTOL = 5e-5
BGTOL = 1e-4
CFG = dict(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
           subcarriers=64, selected_subcarriers=tuple(range(8)),
           num_paths=P, dtype="complex64")

RENDER_CASES = {
    "xla": {},
    "pallas": dict(backend="pallas"),
    "pallas_non_arithmetic": dict(backend="pallas",
                                  selected_subcarriers=(0, 1, 3, 7, 20)),
    "doppler_two_snapshots": dict(enable_doppler=True,
                                  doppler_times=(0.0, 1e-3)),
    "time_domain": dict(freq_domain=False),
    "rx_filter": dict(rx_filter=True),
}


def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _state(seed=50, bs_rot=(10.0, 0.0, 30.0), doppler=False, **kw):
    """(JAX PathData, bs, ue, cfg) and the port's, from one numpy state."""
    import jax.numpy as jnp
    from deepmimo_tpu.ops import types as jtypes
    d = make_synthetic_paths(n_ue=U, max_paths=P, seed=seed,
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


def _jax_mesh():
    from deepmimo_tpu.parallel import make_mesh
    return make_mesh()


def _pols(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-120, -70, (4, U, P)).astype(np.float32),
            rng.uniform(-180, 180, (4, U, P)).astype(np.float32))


def _codebook(t, seed=6, n_beams=4):
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (n_beams, t))) / np.sqrt(t)
    return np.real(w).astype(np.float32), np.imag(w).astype(np.float32)


@pytest.fixture
def mesh():
    """A one-rank gloo mesh; the process group is destroyed after."""
    old = dmt.config.get("device")
    dmt.config.set("device", "cpu")
    assert not dist.is_initialized()
    try:
        yield par.make_mesh()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        dmt.config.set("device", old)


def _check_sharded(out, ref, users_dim=0):
    """A DTensor in the channel layout whose global value is ``ref`` to
    1e-6, its local block this rank's (all) users."""
    assert isinstance(out, tmesh.DTensor)
    assert tuple(out.placements) == (tmesh.Shard(users_dim),
                                     tmesh.Shard(ref.ndim - 1))
    full = out.full_tensor()
    assert full.shape == ref.shape and full.dtype == ref.dtype
    np.testing.assert_allclose(full.numpy(), ref.numpy(), atol=1e-6)
    assert out.to_local().shape[users_dim] == U
    return full


# ---------------------------------------------------------------- meshes

def test_exports_the_jax_names():
    from deepmimo_tpu import parallel as jpar
    assert set(jpar.__all__) <= set(par.__all__)
    for name in par.__all__:
        assert callable(getattr(par, name)), name


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX or the JAX
    package (the card's machine has neither)."""
    import ast
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(root, "deepmimo_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "deepmimo_tpu"), \
                    (path, mod)


@pytest.mark.parametrize("n, tile", [(8, 1), (8, 2), (8, 4), (6, 3), (1, 1),
                                     (4, 4)])
def test_default_mesh_shape_matches_jax(n, tile):
    from deepmimo_tpu.parallel import mesh as jmesh
    assert tmesh.default_mesh_shape(n, tile) == \
        jmesh.default_mesh_shape(n, tile)


def test_default_mesh_shape_raises_as_jax():
    from deepmimo_tpu.parallel import mesh as jmesh
    for fn in (tmesh.default_mesh_shape, jmesh.default_mesh_shape):
        with pytest.raises(ValueError, match="tile=3 must divide"):
            fn(8, 3)


def test_make_mesh_starts_a_one_rank_group(mesh):
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert mesh.device_type == "cpu"
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == (tmesh.USERS_AXIS, tmesh.TILE_AXIS)
    assert (dmt.config.get("mesh_axis_users"),
            dmt.config.get("mesh_axis_tile")) == ("users", "tile")
    # A second mesh uses the group that exists.
    again = par.make_mesh()
    assert tuple(again.shape) == (1, 1) and dist.get_world_size() == 1
    with pytest.raises(ValueError, match="tile=2 must divide"):
        par.make_mesh(tile=2)


def test_make_mesh_starts_the_group_from_torchrun_env(monkeypatch):
    """Under ``torchrun`` (RANK, WORLD_SIZE, MASTER_ADDR/PORT set) the
    group starts from the environment."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    old = dmt.config.get("device")
    dmt.config.set("device", "cpu")
    assert not dist.is_initialized()
    try:
        m = par.make_mesh()
        assert dist.get_world_size() == 1 and tuple(m.shape) == (1, 1)
        assert not isinstance(dist.distributed_c10d._get_default_store(),
                              dist.HashStore)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        dmt.config.set("device", old)


def test_shardings_are_the_jax_specs(mesh):
    sh, rp = tmesh.Shard, tmesh.Replicate
    assert tmesh.user_sharding(mesh) == (sh(0), rp())
    assert tmesh.replicated(mesh) == (rp(), rp())
    assert tmesh.channel_sharding(mesh) == (sh(0), sh(3))
    assert tmesh.channel_sharding(mesh, 5) == (sh(0), sh(4))


def test_shard_paths(mesh):
    _, (paths, _, _, _) = _state()
    sp = par.shard_paths(paths, mesh)
    for f in dataclasses.fields(sp):
        x, want = getattr(sp, f.name), getattr(paths, f.name)
        if want is None:
            assert x is None
            continue
        assert isinstance(x, tmesh.DTensor)
        assert tuple(x.placements) == tmesh.user_sharding(mesh)
        assert torch.equal(x.full_tensor(), want)
    # Idempotent: a sharded PathData shards to itself.
    again = par.shard_paths(sp, mesh)
    assert torch.equal(again.power_dbw.to_local(), paths.power_dbw)


def test_users_must_divide_the_users_axis(mesh, monkeypatch):
    _, (paths, bs, ue, cfg) = _state()
    monkeypatch.setattr(type(mesh), "size",
                        lambda self, dim=None: 3 if dim == 0 else 1)
    with pytest.raises(ValueError, match="16 users do not divide"):
        par.render_channels_sharded(paths, bs, ue, cfg, mesh)


# ---------------------------------------------------------- sharded renders

@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_render_channels_sharded(mesh, name):
    from deepmimo_tpu.parallel import render_channels_sharded as jrender
    doppler = "doppler" in name
    jstate, tstate = _state(doppler=doppler, **RENDER_CASES[name])
    ref = tch.render_channels(*tstate)
    out = par.render_channels_sharded(*tstate, mesh)
    full = _check_sharded(out, ref)
    want = np.asarray(jrender(*jstate, _jax_mesh()))
    np.testing.assert_allclose(full.numpy(), want,
                               atol=HTOL * np.abs(want).max())


@pytest.mark.parametrize("layout", ["stacked", "packed"])
def test_render_polar_sharded(mesh, layout):
    from deepmimo_tpu.parallel import render_polar_sharded as jpolar
    kw = dict(planes_layout=layout, selected_subcarriers=tuple(range(16)))
    jstate, tstate = _state(**kw)
    pol_p, pol_ph = _pols()
    ref = tch.render_channels_planes_polar(
        *tstate, torch.from_numpy(pol_p), torch.from_numpy(pol_ph))
    out = par.render_polar_sharded(*tstate, pol_p, pol_ph, mesh)
    users_dim = 0 if layout == "packed" else 1
    assert ref.ndim == (4 if layout == "packed" else 7)
    full = _check_sharded(out, ref, users_dim)
    want = np.asarray(jpolar(*jstate, pol_p, pol_ph, _jax_mesh()))
    np.testing.assert_allclose(full.numpy(), want,
                               atol=HTOL * np.abs(want).max())


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_render_beam_gains_sharded(mesh, backend):
    from deepmimo_tpu.parallel import render_beam_gains_sharded as jbg
    jstate, tstate = _state()
    tstate = (*tstate[:3], tstate[3].replace(backend=backend))
    wr, wi = _codebook(8)
    ref = tch.render_beam_gains(*tstate, wr, wi)
    out = par.render_beam_gains_sharded(*tstate, wr, wi, mesh)
    full = _check_sharded(out, ref)
    want = np.asarray(jbg(*jstate, wr, wi, _jax_mesh()))
    np.testing.assert_allclose(full.numpy(), want, atol=BGTOL * want.max())


def test_render_beam_gains_polar_sharded(mesh):
    from deepmimo_tpu.parallel import render_beam_gains_polar_sharded as jbg
    jstate, tstate = _state()
    pol_p, pol_ph = _pols(8)
    wr, wi = _codebook(8, seed=9)
    ref = tch.render_beam_gains_polar(
        *tstate, torch.from_numpy(pol_p), torch.from_numpy(pol_ph), wr, wi)
    out = par.render_beam_gains_polar_sharded(*tstate, pol_p, pol_ph, wr,
                                              wi, mesh)
    full = _check_sharded(out, ref)
    want = np.asarray(jbg(*jstate, pol_p, pol_ph, wr, wi, _jax_mesh()))
    np.testing.assert_allclose(full.numpy(), want, atol=BGTOL * want.max())


# ------------------------------------------------------------ training step

def _port_params(jparams):
    d = {k: np.asarray(v) for k, v in jparams._asdict().items()
         if k not in ("bs", "ue")}
    d.update(bs=_leaves(jparams.bs), ue=_leaves(jparams.ue))
    return ttypes.calib_params_from_numpy(d, device="cpu")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_training_step(mesh, backend):
    """The sharded step's loss and update against the port's
    ``training_step`` and JAX's ``make_sharded_training_step`` (the
    test_sharding.py:67-91 recipe: target from a BS rotated to (7, 5, 5),
    calibration from (5, 5, 5), lr 1e-2)."""
    from deepmimo_tpu.ops.channel import render_channels as jrender
    from deepmimo_tpu.ops.types import AntennaPanel as JPanel
    from deepmimo_tpu.parallel import sharded as jsh
    jstate, (paths, bs, ue, cfg) = _state(bs_rot=(5.0, 5.0, 5.0),
                                          backend=backend)
    jpaths, jbs, jue, jcfg = jstate
    jtarget = jrender(jpaths, JPanel.make((7, 5, 5)), jue, jcfg)
    jparams = jsh.init_calib_params(jpaths, jbs, jue)
    target = torch.from_numpy(np.array(jtarget))
    params = _port_params(jparams)

    step, place = par.make_sharded_training_step(mesh, cfg, lr=1e-2)
    s_params, s_paths, s_target = place(params, paths, target)
    assert tuple(s_target.placements) == tmesh.channel_sharding(mesh)
    new, loss = step(s_params, s_paths, s_target)
    ref_new, ref_loss = tsh.training_step(params, paths, target, cfg,
                                          lr=1e-2)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for got, want in zip(new.leaves(), ref_new.leaves()):
        assert isinstance(got, tmesh.DTensor)
        np.testing.assert_allclose(got.full_tensor().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6)

    jstep, jplace = jsh.make_sharded_training_step(_jax_mesh(), jcfg,
                                                   lr=1e-2)
    jnew, jloss = jstep(*jplace(jparams, jpaths, jtarget))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(
        new.bs.rotation_deg.full_tensor().numpy(),
        np.asarray(jnew.bs.rotation_deg), rtol=1e-4, atol=1e-6)


def test_sharded_training_step_loss_decreases(mesh):
    _, (paths, bs, ue, cfg) = _state(seed=51, bs_rot=(0.0, 0.0, 0.0))
    target = tch.render_channels(
        paths, dmt.AntennaPanel.make((0, 0, 10), device="cpu"), ue, cfg)
    step, place = par.make_sharded_training_step(mesh, cfg, lr=3e-3)
    params, s_paths, s_target = place(
        tsh.init_calib_params(paths, bs, ue), paths, target)
    losses = []
    for _ in range(10):
        params, loss = step(params, s_paths, s_target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("n_ue, index, count", [
    (16, 0, 4), (16, 3, 4), (10, 3, 4), (5, 3, 4), (7, 1, 1), (100, 2, 3)])
def test_host_user_range_matches_jax(n_ue, index, count):
    from deepmimo_tpu.parallel import host_user_range as jrange
    assert par.host_user_range(n_ue, index, count) == \
        jrange(n_ue, index, count)


def test_host_user_range_defaults(mesh):
    assert par.host_user_range(16) == (0, 16)
    dist.destroy_process_group()
    assert par.host_user_range(16) == (0, 16)        # no group: (0, 1)


def _datasets(doppler=True):
    """The same in-memory scenario as a JAX and a port Dataset."""
    import deepmimo_tpu as dm
    d = make_synthetic_paths(n_ue=U, max_paths=4, seed=21,
                             with_doppler=doppler)
    keys = ["power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
            "aod_el"] + (["doppler_vel", "doppler_acc"] if doppler else [])
    data = {k: np.asarray(d[k], np.float32) for k in keys}
    data.update(rx_pos=np.zeros((U, 3), np.float32),
                tx_pos=np.zeros((1, 3), np.float32))
    return dm.Dataset(dict(data)), dmt.Dataset(dict(data))


def test_load_paths_sharded_single_process(mesh):
    from deepmimo_tpu.parallel import load_paths_sharded as jload
    jds, ds = _datasets()
    pd = par.load_paths_sharded(ds, mesh, num_paths=3)
    want = jload(jds, _jax_mesh(), num_paths=3)
    for f in dataclasses.fields(pd):
        x, w = getattr(pd, f.name), getattr(want, f.name)
        assert isinstance(x, tmesh.DTensor), f.name
        assert tuple(x.placements) == tmesh.user_sharding(mesh)
        assert x.shape == (U, 3) and x.to_local().shape == (U, 3)
        np.testing.assert_array_equal(x.full_tensor().numpy(),
                                      np.asarray(w))
    # The sharded render of the loaded paths equals the unsharded one.
    _, (_, bs, ue, cfg) = _state()
    cfg = cfg.replace(num_paths=3)
    local = pd._map(lambda x: x.to_local())
    np.testing.assert_allclose(
        par.render_channels_sharded(pd, bs, ue, cfg, mesh).full_tensor(),
        tch.render_channels(local, bs, ue, cfg), atol=1e-6)


# -------------------------------------------------------------------- card

@pytest.fixture
def cuda_mesh():
    """A one-rank NCCL mesh on the card; the group is destroyed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = dmt.config.get("device")
    dmt.config.set("device", "cuda")
    try:
        m = par.make_mesh()
        assert dist.get_backend() == "nccl" and m.device_type == "cuda"
        yield m
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        dmt.config.set("device", old)


def _card_state(n_ue=4096, seed=52):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=P, seed=seed)
    paths = dmt.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], device="cuda")
    cfg = dmt.ChannelConfig(**{**CFG, "bs_shape": (8, 8),
                               "selected_subcarriers": tuple(range(64)),
                               "subcarriers": 512})
    return (paths, dmt.AntennaPanel.make((10, 0, 30), device="cuda"),
            dmt.AntennaPanel.make(device="cuda"), cfg)


@pytest.mark.gpu
def test_cuda_sharded_render_equals_unsharded(cuda_mesh):
    from deepmimo_tpu_torch.ops.kernels import pathsum as kp
    paths, bs, ue, cfg = _card_state()
    cfg = cfg.replace(backend="pallas")
    ref = tch.render_channels(paths, bs, ue, cfg)
    before = kp.LAUNCHES
    out = par.render_channels_sharded(paths, bs, ue, cfg, cuda_mesh)
    assert kp.LAUNCHES == before + 1
    assert out.device_mesh.device_type == "cuda"
    assert torch.equal(out.full_tensor(), ref)


@pytest.mark.gpu
def test_cuda_sharded_beam_gains_equal_unsharded(cuda_mesh):
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    paths, bs, ue, cfg = _card_state()
    cfg = cfg.replace(backend="fused")
    wr, wi = (torch.from_numpy(x).cuda() for x in _codebook(64, n_beams=16))
    ref = tch.render_beam_gains(paths, bs, ue, cfg, wr, wi)
    before = kb.LAUNCHES
    out = par.render_beam_gains_sharded(paths, bs, ue, cfg, wr, wi,
                                        cuda_mesh)
    assert kb.LAUNCHES == before + 1
    assert torch.equal(out.full_tensor(), ref)
    pol_p, pol_ph = (np.repeat(x, 256, axis=1) for x in _pols())
    pp, pph = (torch.from_numpy(x).cuda() for x in (pol_p, pol_ph))
    ref = tch.render_beam_gains_polar(paths, bs, ue, cfg, pp, pph, wr, wi)
    out = par.render_beam_gains_polar_sharded(paths, bs, ue, cfg, pol_p,
                                              pol_ph, wr, wi, cuda_mesh)
    assert kb.LAUNCHES == before + 3         # the unsharded call's too
    assert torch.equal(out.full_tensor(), ref)
