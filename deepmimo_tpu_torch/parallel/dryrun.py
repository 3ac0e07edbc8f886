"""Multi-device dry run: the sharded paths on n ranks against one device.

Counterpart of ``dryrun_multichip`` in the JAX repository's
``__graft_entry__.py``: one sharded training step and four sharded renders
(dual-polar, Doppler snapshots, streamed user chunks, fused beam gains)
on an n-rank (users, tile) mesh, each held against its single-device run.
Every rank is a spawned process of its own, one device each: gloo ranks on
the CPU, NCCL ranks on n CUDA cards.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

TIMEOUT_S = 240          # seconds each rank may take before all are killed

PATHS = ("training_step, dual_polar_fused, doppler_snapshots, "
         "streamed_chunks, beam_gains_fused")


def _tiny_inputs(n_ue=64, max_paths=8, seed=0, doppler=False):
    """NaN-padded random paths and two panels (the JAX dry run's recipe)."""
    from ..ops.types import AntennaPanel, PathData

    rng = np.random.RandomState(seed)

    def mat(lo, hi):
        return rng.uniform(lo, hi, (n_ue, max_paths))

    power = mat(-130, -60)
    power[:, max_paths // 2:] = np.nan  # some padded slots
    paths = PathData.from_numpy(
        power=power, phase=mat(-180, 180), delay=mat(1e-7, 2e-6),
        aoa_az=mat(-180, 180), aoa_el=mat(0, 180),
        aod_az=mat(-180, 180), aod_el=mat(0, 180),
        doppler_vel=mat(-30, 30) if doppler else None,
        doppler_acc=mat(-2, 2) if doppler else None)
    bs = AntennaPanel.make((10.0, 0.0, 30.0), 0.5)
    ue = AntennaPanel.make((0.0, 0.0, 0.0), 0.5)
    return paths, bs, ue


def _close(what: str, got: torch.Tensor, want: torch.Tensor,
           atol: float) -> None:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got - want).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: sharded vs single device "
                             f"max_abs_err {err:.3e} > {atol:.3e}")


def run(n_devices: int) -> dict:
    """The five paths on an ``n_devices``-rank mesh of the default process
    group (tile 2 when the count is even and above 1), each against its
    single-device run: the loss to 1e-5 relative, renders to 1e-6
    (beam gains 1e-6 of their largest value). Returns the loss and the
    mesh's shape."""
    from ..ops.channel import (render_beam_gains, render_channels,
                               render_channels_planes_polar)
    from ..ops.types import ChannelConfig
    from .mesh import make_mesh
    from .sharded import (init_calib_params, make_sharded_training_step,
                          render_beam_gains_sharded, render_channels_sharded,
                          render_polar_sharded, training_step)

    tile = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(tile=tile)
    n_ue = 8 * n_devices
    n_sc = 8 * tile
    cfg = ChannelConfig(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
                        subcarriers=64,
                        selected_subcarriers=tuple(range(n_sc)),
                        num_paths=4, dtype="complex64")

    paths, bs, ue = _tiny_inputs(n_ue=n_ue, max_paths=4)
    params = init_calib_params(paths, bs, ue)
    target = render_channels(paths, bs, ue, cfg)
    # A perturbed start, so the loss and its gradients (the all-reduced
    # panel gradients too) are not trivial.
    params = params.__class__.from_leaves(
        params.leaves()[:4] + [params.d_power_dbw + 1.0,
                               params.d_phase_deg + 7.5,
                               params.d_delay_ns, params.d_angles_deg])

    step, place = make_sharded_training_step(mesh, cfg, lr=1e-3)
    _, loss = step(*place(params, paths, target))
    loss_val = float(loss)
    if not np.isfinite(loss_val):
        raise AssertionError(f"non-finite loss: {loss_val}")
    _, loss_1 = training_step(params, paths, target, cfg, lr=1e-3)
    loss_1 = float(loss_1)
    if not abs(loss_val - loss_1) <= 1e-5 * max(abs(loss_1), 1e-12):
        raise AssertionError(f"sharded loss {loss_val} != single-device "
                             f"loss {loss_1}")

    # 1. Dual-polar: all four polarizations in one fused launch per rank.
    rng = np.random.RandomState(3)
    pol_p = rng.uniform(-120, -70, (4, n_ue, 4)).astype(np.float32)
    pol_ph = rng.uniform(-180, 180, (4, n_ue, 4)).astype(np.float32)
    dev = paths.valid.device
    ref = render_channels_planes_polar(
        paths, bs, ue, cfg, torch.as_tensor(pol_p, device=dev),
        torch.as_tensor(pol_ph, device=dev))
    out = render_polar_sharded(paths, bs, ue, cfg, pol_p, pol_ph, mesh)
    _close("dual_polar_fused", out.full_tensor(), ref, 1e-6)

    # 2. Doppler: 2 snapshots; with tile 2 each tile rank renders one.
    dop_cfg = cfg.replace(enable_doppler=True, doppler_times=(0.0, 1e-3))
    dpaths, _, _ = _tiny_inputs(n_ue=n_ue, max_paths=4, doppler=True)
    ref = render_channels(dpaths, bs, ue, dop_cfg)
    out = render_channels_sharded(dpaths, bs, ue, dop_cfg, mesh)
    _close("doppler_snapshots", out.full_tensor(), ref, 1e-6)

    # 3. Streamed chunks: user chunks rendered back to back on the mesh
    #    and joined == the one-shot sharded render.
    full = render_channels_sharded(paths, bs, ue, cfg, mesh).full_tensor()
    chunk = n_ue // 2
    parts = [render_channels_sharded(paths.slice_users(s, chunk), bs, ue,
                                     cfg, mesh).full_tensor()
             for s in range(0, n_ue, chunk)]
    _close("streamed_chunks", torch.cat(parts), full, 1e-6)

    # 4. Fused beam gains (codebook folded into the path sum, no H).
    t_ant = cfg.n_tx_ant
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, t_ant))) / np.sqrt(t_ant)
    wr = torch.as_tensor(np.real(w), dtype=torch.float32, device=dev)
    wi = torch.as_tensor(np.imag(w), dtype=torch.float32, device=dev)
    ref = render_beam_gains(paths, bs, ue, cfg, wr, wi)
    out = render_beam_gains_sharded(paths, bs, ue, cfg, wr, wi, mesh)
    _close("beam_gains_fused", out.full_tensor(), ref,
           1e-6 * max(float(ref.max()), 1e-30))
    return {"loss": loss_val,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}


def _rank(rank: int, n: int, port: int, device_type: str,
          results) -> None:
    """One spawned rank: its process group, then :func:`run`; puts
    ``(rank, result, None)`` or ``(rank, None, traceback)``."""
    import torch.distributed as dist
    from ..config import config
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            config.set("device", f"cuda:{rank}")
        else:
            config.set("device", "cpu")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n,
            timeout=timedelta(seconds=TIMEOUT_S))
        try:
            results.put((rank, run(n), None))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, None, traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded training step and four sharded renders on an
    ``n_devices``-rank mesh, each against its single-device run; prints
    ``dryrun_multichip ok: ...`` and returns rank 0's result.

    ``device`` ("cuda" or "cpu"; default ``config['device']``) picks the
    ranks: n gloo processes on the CPU, or n NCCL processes on CUDA cards
    0..n-1, which must exist (RuntimeError otherwise; there is no fallback
    to the CPU). Each rank is a fresh spawned interpreter; every rank is
    killed when one fails or none finishes within ``TIMEOUT_S``.
    """
    from ..config import config
    dev = torch.device(device if device is not None
                       else config.get("device"))
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > have:
            raise RuntimeError(f"dryrun_multichip needs {n_devices} CUDA "
                               f"devices, have {have}")
    elif dev.type != "cpu":
        raise ValueError(f"dryrun_multichip runs on 'cuda' or 'cpu', not "
                         f"{dev.type!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, n_devices, port, dev.type,
                                              results))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + TIMEOUT_S
    try:
        while len(got) < n_devices:
            try:
                rank, out, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"dryrun_multichip: ranks exited {dead} or timed "
                        f"out after {TIMEOUT_S} s with {len(got)} of "
                        f"{n_devices} results")
                continue
            if err is not None:
                raise RuntimeError(f"dryrun_multichip rank {rank} "
                                   f"failed:\n{err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    res = got[0]
    print(f"dryrun_multichip ok: {n_devices} devices, mesh {res['mesh']}, "
          f"loss={res['loss']:.3e}, paths=[{PATHS}]", flush=True)
    return res

