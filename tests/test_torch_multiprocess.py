"""Multi-rank runs of the PyTorch port's parallel layer on gloo.

Each run spawns fresh interpreters, one rank each (``torch.distributed``
with gloo on the CPU, a free port, one thread per rank), as
tests/test_multiprocess_loader.py spawns JAX processes. The workers import
only torch, numpy and the port (and ``tests/oracle.py`` for the inputs)
and write their arrays to an ``.npz`` file per rank; the JAX side runs in
this process on conftest's 8-device CPU mesh. Every worker has 240 s, and
all are killed when one overruns.

- 4 ranks on a (4, 1) and a (2, 2) mesh: every sharded entry point,
  gathered with ``.full_tensor()``, against the JAX package's sharded call
  (5e-5 * max|H|, beam gains 1e-4 * max|G|); each rank's ``.to_local()``
  holds 16 // users rows and its tile block of the last axis; the sharded
  training step's loss within 1e-5 and its updated BS rotation within
  rtol 1e-4 of JAX's.
- 2 ranks: ``load_paths_sharded`` of a Doppler scenario. Each rank holds
  only its rows, the gathered arrays equal the data, and ``doppler_vel``
  and ``doppler_acc`` are kept; beside it, the JAX package's multi-process
  branch drops them.
- ``dryrun_multichip(4, device="cpu")``.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from oracle import make_synthetic_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
U, P = 16, 6
HTOL = 5e-5
BGTOL = 1e-4
CFG = dict(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
           subcarriers=64, selected_subcarriers=tuple(range(8)),
           num_paths=P, dtype="complex64")
# name: (entry point, ChannelConfig overrides, Doppler data)
ENTRIES = {
    "render": ("channels", {}, False),
    "render_pallas": ("channels", dict(backend="pallas"), False),
    "render_doppler": ("channels", dict(enable_doppler=True,
                                        doppler_times=(0.0, 1e-3)), True),
    "render_time_domain": ("channels", dict(freq_domain=False), False),
    "polar_packed": ("polar", dict(planes_layout="packed",
                                   selected_subcarriers=tuple(range(16))),
                     False),
    "polar_stacked": ("polar", {}, False),
    "beam_gains": ("beam_gains", {}, False),
    "beam_gains_polar": ("beam_gains_polar", {}, False),
}
MESHES = {"4x1": 1, "2x2": 2}            # name: tile

WORKER = r"""
import sys
rank, world, port, repo, out, mode, tile = sys.argv[1:]
rank, world, tile = int(rank), int(world), int(tile)
sys.path[:0] = [repo, repo + "/tests"]
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch import parallel as par
import test_torch_multiprocess as spec

dmt.config.set("device", "cpu")
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = par.make_mesh(tile=tile)
arrays = spec.run_entries(mesh) if mode == "entries" else \
    spec.run_loader(mesh)
np.savez(f"{out}/rank{rank}.npz", **arrays)
dist.destroy_process_group()
print(f"WORKER_{rank}_OK", flush=True)
"""


def _inputs(doppler=False, seed=50):
    d = make_synthetic_paths(n_ue=U, max_paths=P, seed=seed,
                             with_doppler=doppler)
    keys = ["power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
            "aod_el"]
    if doppler:
        keys += ["doppler_vel", "doppler_acc"]
    return {k: np.asarray(d[k], np.float32) for k in keys}


def _pols(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-120, -70, (4, U, P)).astype(np.float32),
            rng.uniform(-180, 180, (4, U, P)).astype(np.float32))


def _codebook(t=8, seed=6):
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, t))) / np.sqrt(t)
    return np.real(w).astype(np.float32), np.imag(w).astype(np.float32)


def _call(pkg, entry, state, mesh):
    """The sharded entry point ``entry`` of ``pkg`` (the JAX or the port's
    ``parallel``) on ``state`` = (paths, bs, ue, cfg)."""
    pol_p, pol_ph = _pols()
    wr, wi = _codebook()
    if entry == "channels":
        return pkg.render_channels_sharded(*state, mesh)
    if entry == "polar":
        return pkg.render_polar_sharded(*state, pol_p, pol_ph, mesh)
    if entry == "beam_gains":
        return pkg.render_beam_gains_sharded(*state, wr, wi, mesh)
    return pkg.render_beam_gains_polar_sharded(*state, pol_p, pol_ph, wr,
                                               wi, mesh)


def _step_targets(paths_cls, panel_cls, render, inputs, cfg, device):
    """(paths, bs, ue, target): the test_sharding.py:67-91 recipe."""
    kw = {} if device is None else {"device": device}
    paths = paths_cls.from_numpy(*(inputs[k] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
        "aod_el")), **kw)
    bs, ue = panel_cls.make((5, 5, 5), **kw), panel_cls.make(**kw)
    return paths, bs, ue, render(paths, panel_cls.make((7, 5, 5), **kw),
                                 ue, cfg)


def run_entries(mesh):
    """Worker side: every entry of ENTRIES and one training step on
    ``mesh``; the gathered arrays and this rank's local shapes."""
    import deepmimo_tpu_torch as dmt
    from deepmimo_tpu_torch import parallel as par
    from deepmimo_tpu_torch.ops.channel import render_channels
    out = {}
    for name, (entry, kw, doppler) in ENTRIES.items():
        d = _inputs(doppler)
        paths = dmt.PathData.from_numpy(*(d[k] for k in (
            "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
            "aod_el")), doppler_vel=d.get("doppler_vel"),
            doppler_acc=d.get("doppler_acc"))
        state = (paths, dmt.AntennaPanel.make((10, 0, 30)),
                 dmt.AntennaPanel.make(), dmt.ChannelConfig(**{**CFG, **kw}))
        res = _call(par, entry, state, mesh)
        out[name] = res.full_tensor().numpy()
        out[name + "_local"] = np.array(res.to_local().shape)
    cfg = dmt.ChannelConfig(**CFG)
    paths, bs, ue, target = _step_targets(dmt.PathData, dmt.AntennaPanel,
                                          render_channels, _inputs(seed=51),
                                          cfg, None)
    step, place = par.make_sharded_training_step(mesh, cfg, lr=1e-2)
    new, loss = step(*place(par.init_calib_params(paths, bs, ue), paths,
                            target))
    out["step_loss"] = np.array(float(loss))
    out["step_bs_rotation"] = new.bs.rotation_deg.full_tensor().numpy()
    return out


def run_loader(mesh):
    """Worker side: ``load_paths_sharded`` of a Doppler scenario; each
    leaf's local rows and the gathered arrays."""
    import deepmimo_tpu_torch as dmt
    from deepmimo_tpu_torch import parallel as par
    data = _inputs(doppler=True, seed=3)
    data.update(rx_pos=np.zeros((U, 3), np.float32),
                tx_pos=np.zeros((1, 3), np.float32))
    pd = par.load_paths_sharded(dmt.Dataset(data), mesh)
    out = {}
    for f in dataclasses.fields(pd):
        x = getattr(pd, f.name)
        out[f.name + "_local"] = x.to_local().numpy()
        out[f.name] = x.full_tensor().numpy()
    return out


def _spawn(tmp_path, world, mode, tile=1):
    """``world`` worker ranks in ``mode``; their arrays by rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "WORLD_SIZE", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(port), REPO,
         str(tmp_path), mode, str(tile)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for r in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a gloo worker timed out")
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"WORKER_{r}_OK" in out, out
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=sorted(MESHES))
def entries(request, tmp_path_factory):
    """(mesh name, tile, the 4 ranks' arrays) of one run per mesh."""
    tile = MESHES[request.param]
    ranks = _spawn(tmp_path_factory.mktemp(request.param), 4, "entries",
                   tile)
    return request.param, tile, ranks


def _jax_state(kw, doppler):
    import jax.numpy as jnp
    from deepmimo_tpu.ops import types as jtypes
    d = _inputs(doppler)
    paths = jtypes.PathData.from_numpy(
        *(d[k] for k in ("power", "phase", "delay", "aoa_az", "aoa_el",
                         "aod_az", "aod_el")),
        doppler_vel=d.get("doppler_vel"), doppler_acc=d.get("doppler_acc"),
        dtype=jnp.float32)
    return (paths, jtypes.AntennaPanel.make((10, 0, 30)),
            jtypes.AntennaPanel.make(), jtypes.ChannelConfig(**{**CFG, **kw}))


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_sharded_entry_matches_jax(entries, name):
    from deepmimo_tpu import parallel as jpar
    _, tile, ranks = entries
    entry, kw, doppler = ENTRIES[name]
    want = np.asarray(_call(jpar, entry, _jax_state(kw, doppler),
                            jpar.make_mesh()))
    tol = (BGTOL if entry.startswith("beam") else HTOL) * \
        np.abs(want).max()
    users = 4 // tile
    users_dim = 1 if want.ndim == 7 else 0
    n_last = want.shape[-1]
    per = -(-n_last // tile)
    for r, arrays in enumerate(ranks):
        got = arrays[name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=tol)
        local = tuple(arrays[name + "_local"])
        a = min((r % tile) * per, n_last)
        assert local[users_dim] == U // users
        assert local[-1] == min(a + per, n_last) - a
        assert local[:users_dim] + local[users_dim + 1:-1] == \
            want.shape[:users_dim] + want.shape[users_dim + 1:-1]


def test_sharded_training_step_matches_jax(entries):
    from deepmimo_tpu.ops.channel import render_channels
    from deepmimo_tpu.ops.types import AntennaPanel, PathData
    from deepmimo_tpu.parallel import make_mesh
    from deepmimo_tpu.parallel import sharded as jsh
    _, _, ranks = entries
    cfg = jsh.ChannelConfig(**CFG)
    paths, bs, ue, target = _step_targets(PathData, AntennaPanel,
                                          render_channels,
                                          _inputs(seed=51), cfg, None)
    step, place = jsh.make_sharded_training_step(make_mesh(), cfg, lr=1e-2)
    new, loss = step(*place(jsh.init_calib_params(paths, bs, ue), paths,
                            target))
    for arrays in ranks:
        np.testing.assert_allclose(float(arrays["step_loss"]), float(loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(arrays["step_bs_rotation"],
                                   np.asarray(new.bs.rotation_deg),
                                   rtol=1e-4, atol=1e-6)


def test_two_rank_loader_keeps_doppler(tmp_path):
    ranks = _spawn(tmp_path, 2, "loader")
    data = _inputs(doppler=True, seed=3)
    valid = ~np.isnan(data["power"])
    for name, key in (("power_dbw", "power"), ("doppler_vel", "doppler_vel"),
                      ("doppler_acc", "doppler_acc"), ("aod_el_deg",
                                                       "aod_el")):
        want = np.where(valid, np.nan_to_num(data[key]), 0.0)
        for r, arrays in enumerate(ranks):
            np.testing.assert_allclose(arrays[name + "_local"],
                                       want[8 * r:8 * (r + 1)], atol=1e-6)
            np.testing.assert_allclose(arrays[name], want, atol=1e-6)
    for r, arrays in enumerate(ranks):
        np.testing.assert_array_equal(arrays["valid_local"],
                                      valid[8 * r:8 * (r + 1)])


def test_reference_multiprocess_loader_drops_doppler(monkeypatch):
    """The JAX package's multi-process branch builds its local PathData
    without the Doppler rows (deepmimo_tpu/parallel/multihost.py:64-71,
    against :47-55): with two processes faked, ``doppler_vel`` and
    ``doppler_acc`` come back None, where the port keeps them."""
    import jax
    import deepmimo_tpu as dm
    from deepmimo_tpu.parallel import make_mesh
    from deepmimo_tpu.parallel import multihost as jmh
    data = _inputs(doppler=True, seed=3)
    data.update(rx_pos=np.zeros((U, 3), np.float32),
                tx_pos=np.zeros((1, 3), np.float32))
    assert jmh.load_paths_sharded(dm.Dataset(dict(data)),
                                  make_mesh()).doppler_vel is not None
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, local, shape: local)
    pd = jmh.load_paths_sharded(dm.Dataset(dict(data)), make_mesh())
    assert pd.power_dbw.shape == (U // 2, P)      # process 0's rows only
    assert pd.doppler_vel is None and pd.doppler_acc is None


def test_dryrun_multichip_four_gloo_ranks(capsys):
    from deepmimo_tpu_torch.parallel.dryrun import dryrun_multichip
    res = dryrun_multichip(4, device="cpu")
    assert res["mesh"] == {"users": 2, "tile": 2}
    line = capsys.readouterr().out
    assert "dryrun_multichip ok: 4 devices, mesh {'users': 2, 'tile': 2}" \
        in line
    assert "beam_gains_fused" in line and np.isfinite(res["loss"])
