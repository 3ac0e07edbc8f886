"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. Card and toolchain: ``nvidia-smi`` name and power limit, torch/CUDA.
2. Build: compiles every kernel (``render_fwd``, ``render_bwd``,
   ``pathsum``) from ``csrc/`` with nvcc for sm_90a, one nvcc per source,
   all started together, and prints the ptxas report.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main paths' shapes (``KERNEL_CASES``), with CUDA-event
   times of both at the headline width: the forward render and the path
   sum within 3e-5 * max|H|, the render's backward within 3e-4 * max|g|
   for each of its 7 gradients.
4. Serving path: four 131,072-user x 25-path datasets (synthetic, seed 7)
   through ``Dataset.compute_channels(params, to_device=True, out=prev)``
   — one kernel launch per call — checked for shape and finiteness and on
   64 users per dataset against the float64 oracle ``tests/oracle.py``;
   then a timed sweep.
5. Streamed path: ``to_device=False`` over 3 user blocks must equal the
   single-dispatch result exactly.
6. Training path: the calibration step ``training_step_planes`` with the
   fused backend at the headline width (BS rotated 10 degrees in the
   target, calibration from 0): the first step's gradients of every
   ``CalibParams`` leaf on 4,096 users against the plain versions
   (3e-4 * max|g|); 5 steps at lr 3e-3 with a finite, decreasing loss and
   exactly one forward and one backward launch per step; ms per step,
   peak device memory and the step's split.
7. The ``pallas`` trainer: ``training_step`` at the same width, one
   path-sum launch per step, first loss equal to the planes loss at rtol
   1e-4.

The line before the last is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits non-zero before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CHUNK = 131_072          # users per dataset (asu_campus scale, 411 x 321)
N_DATASETS = 4
MAX_PATHS = 25
BS_SHAPE = (8, 8)
UE_SHAPE = (1, 1)
N_FFT = 512
N_SC = 64
BANDWIDTH = 10e6
KERNEL_RTOL = 3e-5       # kernel vs plain, relative to max|H|
GRAD_RTOL = 3e-4         # backward kernel vs plain, relative to max|g|
KERNELS = ("render_fwd", "render_bwd", "pathsum")
TRAIN_STEPS = 5
PALLAS_STEPS = 3
LR = 3e-3
GRAD_USERS = 4096        # users of the kernel-vs-plain gradient check
DEV = "cuda"
ORACLE_RTOL = 5e-5       # main path vs float64 oracle, relative to max|H|
N_ORACLE = 64            # users per dataset checked against the oracle


def log(msg):
    print(msg, flush=True)


def make_data(n_ue, max_paths, seed=7):
    """NaN-padded synthetic path matrices (the headline benchmark recipe)."""
    rng = np.random.RandomState(seed)
    n_valid = rng.randint(1, max_paths + 1, size=n_ue)
    mask = np.arange(max_paths)[None, :] < n_valid[:, None]

    def mat(lo, hi):
        a = rng.uniform(lo, hi, (n_ue, max_paths)).astype(np.float32)
        return np.where(mask, a, np.nan).astype(np.float32)

    return {
        "power": mat(-130, -60), "phase": mat(-180, 180),
        "delay": mat(1e-7, 4e-6),
        "aoa_az": mat(-180, 180), "aoa_el": mat(0, 180),
        "aod_az": mat(-180, 180), "aod_el": mat(0, 180),
    }


def make_params(dmt):
    c = dmt.consts
    params = dmt.ChannelGenParameters()
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array(BS_SHAPE)
    params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_SHAPE] = np.array(UE_SHAPE)
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = N_FFT
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(N_SC)
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_BANDWIDTH] = BANDWIDTH
    params[c.PARAMSET_NUM_PATHS] = MAX_PATHS
    return params


def event_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} python {sys.version.split()[0]}")


def phase_build():
    from deepmimo_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_build.build, KERNELS))
    log(f"[build] {len(KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, lib in zip(KERNELS, libs):
        log(f"[build] {name} -> {os.path.relpath(lib, HERE)}")
        for line in _build.build_log(name).splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                log(f"[build] {name}: {line.strip()}")


def _render_inputs(torch, u, p, n_s, n_sa, seed):
    """Per-path kernel inputs at realistic ranges; invalid paths zeroed."""
    rng = np.random.RandomState(seed)
    valid = (np.arange(p)[None, :] <
             rng.randint(1, p + 1, size=(u, 1))).astype(np.float32)

    def mk(lo, hi, reps=1):
        x = rng.uniform(lo, hi, (u, reps * p)).astype(np.float32)
        return x * np.tile(valid, (1, reps))

    arrs = [mk(-math.pi, math.pi) for _ in range(4)]        # gry..gtz
    arrs += [mk(0, 1e-4, n_sa), mk(-math.pi, math.pi, n_s),  # amp, psi
             mk(0, 2 * math.pi * 40 / N_FFT)]                # omega
    return [torch.from_numpy(a).to(DEV) for a in arrs]


KERNEL_CASES = [
    # name, U, P, rx_shape, tx_shape, K, S, per-slot amp, packed
    ("headline", CHUNK, MAX_PATHS, UE_SHAPE, BS_SHAPE, N_SC, 1, False, True),
    ("ragged_mimo", 4099, MAX_PATHS, (2, 2), (4, 2), N_SC, 1, False, True),
    ("stacked_k16", 4096, MAX_PATHS, UE_SHAPE, BS_SHAPE, 16, 1, False,
     False),
    ("two_slots", 4096, MAX_PATHS, UE_SHAPE, BS_SHAPE, N_SC, 2, True, True),
]


def phase_kernels(torch):
    from deepmimo_tpu_torch.ops.kernels import render as kr
    headline = None
    for name, u, p, rx, tx, k, s, per_slot, packed in KERNEL_CASES:
        args = _render_inputs(torch, u, p, s, s if per_slot else 1,
                              seed=len(name))
        h = kr.fused_render(*args, rx, tx, k, packed)
        ref = kr.fused_render_reference(*args, rx, tx, k, packed)
        torch.cuda.synchronize()
        err = float((h - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"[kernel] fused_render {name}: U={u} P={p} rx={rx} tx={tx} "
            f"K={k} S={s} packed={packed} out={tuple(h.shape)} "
            f"max_abs_err={err:.3e} max|H|={scale:.3e} "
            f"rel={err / scale:.3e} (limit {KERNEL_RTOL:g})")
        if not (math.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(f"fused_render {name}: kernel disagrees "
                                 f"with its plain version")
        if name == "headline":
            out = torch.empty_like(h)
            ms = event_ms(torch, lambda: kr.fused_render(
                *args, rx, tx, k, packed, out=out), reps=20)
            plain_ms = event_ms(torch, lambda: kr.fused_render_reference(
                *args, rx, tx, k, packed), reps=3)
            gbps = h.numel() * 4 / (ms * 1e-3) / 1e9
            log(f"[kernel] fused_render headline: kernel {ms:.4f} ms "
                f"({gbps:.1f} GB/s of H written), plain {plain_ms:.4f} ms")
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del h, ref, args
        torch.cuda.empty_cache()
    return headline


def _cuda_rand(torch, shape, gen, lo=-1.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=DEV) * (hi - lo) + lo


def largest_fitting_ms(torch, make_fn, u_max, reps):
    """CUDA-event time of ``make_fn(u)()`` at the largest user count from
    ``u_max`` down (halving) whose plain version fits in device memory."""
    u = u_max
    while True:
        try:
            return event_ms(torch, make_fn(u), reps), u
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if u <= 1024:
                raise
            u //= 2


def phase_bwd_kernels(torch):
    """The render's backward kernel vs its plain version (the VJP of the
    plain forward) at every KERNEL_CASES shape."""
    from deepmimo_tpu_torch.ops.kernels import render as kr
    headline = None
    for name, u, p, rx, tx, k, s, per_slot, packed in KERNEL_CASES:
        args = _render_inputs(torch, u, p, s, s if per_slot else 1,
                              seed=len(name) + 100)
        q = rx[0] * rx[1] * tx[0] * tx[1]
        gen = torch.Generator(device=DEV).manual_seed(len(name))
        ct = _cuda_rand(torch, (u, q, 2 * s * k) if packed
                        else (2, u, q, s * k), gen)
        got = kr.fused_render_bwd(*args, ct, rx, tx, k, packed)
        want = kr.fused_render_bwd_reference(*args, ct, rx, tx, k, packed)
        torch.cuda.synchronize()
        errs, worst = [], 0.0
        for gname, g, w in zip(("gry", "grz", "gty", "gtz", "amp", "psi",
                                "omega"), got, want):
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            rel = err / scale if scale > 0 else err
            errs.append(f"{gname} {rel:.2e}")
            worst = max(worst, err)
            if not (math.isfinite(err) and err <= GRAD_RTOL * scale + 1e-30):
                raise AssertionError(f"fused_render_bwd {name}: d{gname} "
                                     f"disagrees with its plain version "
                                     f"(err {err:.3e}, max|g| {scale:.3e})")
        log(f"[kernel] fused_render_bwd {name}: U={u} P={p} rx={rx} tx={tx} "
            f"K={k} S={s} packed={packed} rel err per grad: "
            f"{', '.join(errs)} (limit {GRAD_RTOL:g})")
        del got, want
        if name == "headline":
            ms = event_ms(torch, lambda: kr.fused_render_bwd(
                *args, ct, rx, tx, k, packed), reps=20)
            plain_ms, plain_u = largest_fitting_ms(
                torch, lambda n: lambda: kr.fused_render_bwd_reference(
                    *[a[:n] for a in args], ct[:n], rx, tx, k, packed),
                u, reps=3)
            gbps = ct.numel() * 4 / (ms * 1e-3) / 1e9
            log(f"[kernel] fused_render_bwd headline: kernel {ms:.4f} ms "
                f"({gbps:.1f} GB/s of ct read), plain {plain_ms:.4f} ms at "
                f"{plain_u} users")
            headline = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                            plain_users=plain_u)
        del args, ct
        torch.cuda.empty_cache()
    return headline


def _pathsum_inputs(torch, u, p, r, t, k_sel, seed):
    """Array-response planes and per-path scalars at realistic ranges;
    invalid paths zeroed. Made on the card from a seeded generator."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    valid = (torch.arange(p, device=DEV)[None, :] <
             torch.randint(1, p + 1, (u, 1), generator=gen,
                           device=DEV)).float()

    def planes(n):
        ph = _cuda_rand(torch, (u, n, p), gen, -math.pi, math.pi)
        return torch.cos(ph) * valid[:, None], torch.sin(ph) * valid[:, None]

    return [*planes(r), *planes(t),
            _cuda_rand(torch, (u, p), gen, 0, 1e-4) * valid,
            _cuda_rand(torch, (u, p), gen, -math.pi, math.pi) * valid,
            _cuda_rand(torch, (u, p), gen, 0, 2 * math.pi * 40 / N_FFT)
            * valid,
            torch.as_tensor(k_sel, dtype=torch.float32, device=DEV)]


def phase_pathsum_kernels(torch):
    """The path-sum kernel vs its plain version at the KERNEL_CASES shapes
    (R*T antennas, S*K subcarriers); the two-slot case selects a
    non-arithmetic set of subcarriers."""
    from deepmimo_tpu_torch.ops.kernels import pathsum as kp
    headline = None
    for name, u, p, rx, tx, k, s, per_slot, _ in KERNEL_CASES:
        r, t = rx[0] * rx[1], tx[0] * tx[1]
        if per_slot:
            rng = np.random.RandomState(5)
            k_sel = np.sort(rng.choice(N_FFT, s * k, replace=False))
        else:
            k_sel = np.arange(s * k)
        args = _pathsum_inputs(torch, u, p, r, t, k_sel, seed=len(name))
        got = kp.fused_path_sum(*args)
        want = kp.fused_path_sum_reference(*args)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        log(f"[kernel] fused_path_sum {name}: U={u} P={p} R={r} T={t} "
            f"K={len(k_sel)} arithmetic={not per_slot} "
            f"max_abs_err={err:.3e} max|H|={scale:.3e} "
            f"rel={err / scale:.3e} (limit {KERNEL_RTOL:g})")
        if not (math.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(f"fused_path_sum {name}: kernel disagrees "
                                 f"with its plain version")
        del got, want
        if name == "headline":
            ms = event_ms(torch, lambda: kp.fused_path_sum(*args), reps=20)
            plain_ms = event_ms(
                torch, lambda: kp.fused_path_sum_reference(*args), reps=3)
            log(f"[kernel] fused_path_sum headline: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del args
        torch.cuda.empty_cache()
    return headline


def phase_main(torch, dmt):
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.ops.kernels import render as kr
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from oracle import oracle_channels

    t0 = time.perf_counter()
    data = make_data(CHUNK * N_DATASETS, MAX_PATHS, seed=7)
    datasets = []
    for i in range(N_DATASETS):
        d = {key: v[i * CHUNK:(i + 1) * CHUNK] for key, v in data.items()}
        d["rx_pos"] = np.zeros((CHUNK, 3), np.float32)
        d["tx_pos"] = np.zeros((1, 3), np.float32)
        datasets.append(dmt.Dataset(d))
    params = make_params(dmt)
    cfg, _, _ = params.to_config(CHUNK)
    log(f"[main] {N_DATASETS} datasets of {CHUNK} users x {MAX_PATHS} paths "
        f"built in {time.perf_counter() - t0:.1f} s")

    # The main path, counted: one kernel launch per compute_channels call.
    expected = (CHUNK, UE_SHAPE[0] * UE_SHAPE[1],
                BS_SHAPE[0] * BS_SHAPE[1], 2 * N_SC)
    kr.LAUNCHES = 0
    h = None
    for i, ds in enumerate(datasets):
        prev = h
        h = ds.compute_channels(params, to_device=True, out=prev)
        if tuple(h.shape) != expected or h.dtype != torch.float32:
            raise AssertionError(f"dataset {i}: output {tuple(h.shape)} "
                                 f"{h.dtype}, expected {expected} float32")
        if prev is not None and h.data_ptr() != prev.data_ptr():
            raise AssertionError(f"dataset {i}: out= buffer not reused")
        if not bool(torch.isfinite(h).all()):
            raise AssertionError(f"dataset {i}: non-finite channels")
        got = unpack_planes_np(h[:N_ORACLE].cpu().numpy(), cfg)
        sub = {key: data[key][i * CHUNK:i * CHUNK + N_ORACLE]
               for key in data}
        want = oracle_channels(
            sub["power"], sub["phase"], sub["delay"], sub["aoa_az"],
            sub["aoa_el"], sub["aod_az"], sub["aod_el"], bs_shape=BS_SHAPE,
            ue_shape=UE_SHAPE, n_fft=N_FFT,
            selected_subcarriers=tuple(range(N_SC)), bandwidth=BANDWIDTH,
            num_paths=MAX_PATHS)
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        log(f"[main] dataset {i}: {tuple(h.shape)} finite; oracle "
            f"{N_ORACLE} users max_abs_err={err:.3e} max|H|={scale:.3e} "
            f"rel={err / scale:.3e} (limit {ORACLE_RTOL:g})")
        if not err <= ORACLE_RTOL * scale:
            raise AssertionError(f"dataset {i}: disagrees with the oracle")
    launches = kr.LAUNCHES
    if launches != N_DATASETS:
        raise AssertionError(f"fused_render launched {launches} times for "
                             f"{N_DATASETS} compute_channels calls")
    log(f"[main] fused_render launches in the main path: {launches}")

    reps = 5
    sweep = lambda: [ds.compute_channels(params, to_device=True, out=h)
                     for ds in datasets]
    sweep()                                     # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        sweep()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (reps * N_DATASETS)
    ms = start.elapsed_time(end) / (reps * N_DATASETS)
    log(f"[main] sweep of {reps} x {N_DATASETS} datasets: {ms:.4f} ms per "
        f"{CHUNK}-user dataset (CUDA events), {CHUNK / ms * 1e3:.1f} "
        f"users/s; host wall {wall:.4f} ms per dataset")
    return datasets, params, launches


def phase_streamed(torch, dmt, datasets, params):
    from deepmimo_tpu_torch.ops.kernels import render as kr
    ds = datasets[0]
    single = ds.compute_channels(params)
    out_bytes = single.size * 8                 # packed float32 planes
    old = {k: dmt.config.get(k)
           for k in ("max_device_output_bytes", "user_block")}
    block = -(-CHUNK // 3)
    dmt.config.set("max_device_output_bytes", out_bytes - 1)
    dmt.config.set("user_block", block)
    try:
        before = kr.LAUNCHES
        streamed = ds.compute_channels(params)
        blocks = kr.LAUNCHES - before
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
    if blocks != 3:
        raise AssertionError(f"streamed path rendered {blocks} blocks, "
                             f"expected 3")
    if single.shape != streamed.shape or not np.array_equal(single,
                                                            streamed):
        raise AssertionError("streamed result differs from single dispatch")
    log(f"[streamed] {blocks} blocks of <= {block} users: {streamed.shape} "
        f"{streamed.dtype} equals the single dispatch exactly")


def _train_config(dmt, backend):
    return dmt.ChannelConfig(
        bs_shape=BS_SHAPE, ue_shape=UE_SHAPE, subcarriers=N_FFT,
        selected_subcarriers=tuple(range(N_SC)), bandwidth=BANDWIDTH,
        num_paths=MAX_PATHS, backend=backend, planes_layout="packed")


def _to_cpu_params(sh, params):
    return sh.CalibParams.from_leaves([x.cpu() for x in params.leaves()])


def _launch_counts():
    from deepmimo_tpu_torch.ops.kernels import pathsum as kp
    from deepmimo_tpu_torch.ops.kernels import render as kr
    return kr.LAUNCHES, kr.BWD_LAUNCHES, kp.LAUNCHES


def run_steps(torch, step, params, n, per_step):
    """``n`` calls ``params, loss = step(params)``, each timed with CUDA
    events; fails unless every step launches exactly ``per_step``
    (forward render, backward render, path sum) kernels. Returns the
    losses, the ms per step and the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(n):
        before = _launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, loss = step(params)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        made = tuple(a - b for a, b in zip(_launch_counts(), before))
        if made != per_step:
            raise AssertionError(f"step {i}: launches (fwd, bwd, path sum) "
                                 f"{made}, expected {per_step}")
    return losses, step_ms, torch.cuda.max_memory_allocated()


def phase_train(torch, dmt, fwd_ms, bwd_ms):
    """The calibration step on the planes path: fused fwd + bwd kernels."""
    from deepmimo_tpu_torch.ops.channel import render_channels_planes
    from deepmimo_tpu_torch.ops.kernels import render as kr
    from deepmimo_tpu_torch.parallel import sharded as sh

    d = make_data(CHUNK, MAX_PATHS, seed=11)
    paths = dmt.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], device=DEV)
    ue = dmt.AntennaPanel.make(device=DEV)
    bs0 = dmt.AntennaPanel.make((0.0, 0.0, 0.0), device=DEV)
    cfg = _train_config(dmt, "fused")
    with torch.no_grad():
        target = render_channels_planes(
            paths, dmt.AntennaPanel.make((0.0, 0.0, 10.0), device=DEV),
            ue, cfg)
    params = sh.init_calib_params(paths, bs0, ue)

    # First step's gradients on a slice: kernels (card) vs plain (CPU).
    sub = paths.slice_users(0, GRAD_USERS)
    p_sub = sh.init_calib_params(sub, bs0, ue)
    t_sub = target[:GRAD_USERS]
    loss_k, g_k = sh.calib_value_and_grad(sh.calib_loss_planes, p_sub, sub,
                                          t_sub, cfg)
    loss_p, g_p = sh.calib_value_and_grad(
        sh.calib_loss_planes, _to_cpu_params(sh, p_sub),
        sub._map(lambda x: x.cpu()), t_sub.cpu(), cfg)
    names = ("bs.rotation_deg", "bs.spacing", "ue.rotation_deg",
             "ue.spacing", "d_power_dbw", "d_phase_deg", "d_delay_ns",
             "d_angles_deg")
    rels = []
    for name, a, b in zip(names, g_k.leaves(), g_p.leaves()):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        rels.append(f"{name} {err / scale if scale else err:.2e}")
        if not (math.isfinite(err) and err <= GRAD_RTOL * scale + 1e-30):
            raise AssertionError(f"training gradient {name}: kernels "
                                 f"{err:.3e} off the plain versions "
                                 f"(max|g| {scale:.3e})")
    log(f"[train] {GRAD_USERS}-user gradients, kernels vs plain, rel err "
        f"per leaf: {', '.join(rels)} (limit {GRAD_RTOL:g}); loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f}")
    del g_k, g_p, t_sub, sub, p_sub

    # The training path, counted: one forward + one backward per step.
    kr.LAUNCHES = kr.BWD_LAUNCHES = 0
    losses, step_ms, peak = run_steps(
        torch, lambda p: sh.training_step_planes(p, paths, target, cfg,
                                                 lr=LR),
        params, TRAIN_STEPS, per_step=(1, 1, 0))
    launches = (kr.LAUNCHES, kr.BWD_LAUNCHES)
    log(f"[train] {TRAIN_STEPS} training_step_planes steps, {CHUNK} users, "
        f"lr {LR}: losses {['%.7f' % x for x in losses]}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError("training loss not finite and decreasing")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"[train] ms per step (CUDA events): "
        f"{', '.join('%.4f' % x for x in step_ms)}; median of steps 2-"
        f"{TRAIN_STEPS} {steady:.4f} ms = fwd kernel {fwd_ms:.4f} + bwd "
        f"kernel {bwd_ms:.4f} + rest {steady - fwd_ms - bwd_ms:.4f} "
        f"(kernel times from phase 3); peak device memory "
        f"{peak / 2**30:.3f} GiB; launches fwd {launches[0]}, "
        f"bwd {launches[1]}")
    first_loss = losses[0]
    del target
    torch.cuda.empty_cache()
    return paths, launches, first_loss


def phase_train_pallas(torch, dmt, paths, planes_loss):
    """training_step with backend "pallas": the path-sum kernel."""
    from deepmimo_tpu_torch.ops.channel import render_channels
    from deepmimo_tpu_torch.ops.kernels import pathsum as kp
    from deepmimo_tpu_torch.ops.kernels import render as kr
    from deepmimo_tpu_torch.parallel import sharded as sh

    cfg = _train_config(dmt, "pallas")
    ue = dmt.AntennaPanel.make(device=DEV)
    with torch.no_grad():
        target = render_channels(
            paths, dmt.AntennaPanel.make((0.0, 0.0, 10.0), device=DEV),
            ue, cfg)
    params = sh.init_calib_params(
        paths, dmt.AntennaPanel.make((0.0, 0.0, 0.0), device=DEV), ue)
    kp.LAUNCHES = 0
    losses, step_ms, peak = run_steps(
        torch, lambda p: sh.training_step(p, paths, target, cfg, lr=LR),
        params, PALLAS_STEPS, per_step=(0, 0, 1))
    rel = abs(losses[0] - planes_loss) / abs(planes_loss)
    log(f"[train-pallas] {PALLAS_STEPS} training_step steps: losses "
        f"{['%.7f' % x for x in losses]}; first loss vs planes "
        f"{planes_loss:.7f}: rel {rel:.2e} (limit 1e-4); ms per step "
        f"{', '.join('%.4f' % x for x in step_ms)}; peak device memory "
        f"{peak / 2**30:.3f} GiB; path-sum launches {kp.LAUNCHES}")
    if not (all(math.isfinite(x) for x in losses) and rel <= 1e-4):
        raise AssertionError("pallas trainer loss differs from the planes "
                             "loss")
    return kp.LAUNCHES


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import deepmimo_tpu_torch as dmt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card(torch)
    phase_build()
    fwd = phase_kernels(torch)
    bwd = phase_bwd_kernels(torch)
    psum = phase_pathsum_kernels(torch)
    datasets, params, serve_launches = phase_main(torch, dmt)
    phase_streamed(torch, dmt, datasets, params)
    del datasets
    torch.cuda.empty_cache()
    paths, (train_fwd, train_bwd), planes_loss = phase_train(
        torch, dmt, fwd["ms"], bwd["ms"])
    pallas_launches = phase_train_pallas(torch, dmt, paths, planes_loss)
    log(f"[launches] fused_render: serving {serve_launches} + training "
        f"{train_fwd}; fused_render_bwd: training {train_bwd}; "
        f"fused_path_sum: pallas training {pallas_launches}")
    src = "deepmimo_tpu_torch/csrc/"
    kernels = [
        {"name": "fused_render", "route": "cuda",
         "source": src + "render_fwd.cu",
         "replaces": "deepmimo_tpu/ops/pallas/render.py:432",
         "launches": serve_launches + train_fwd,
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "plain_ms": fwd["plain_ms"]},
        {"name": "fused_render_bwd", "route": "cuda",
         "source": src + "render_bwd.cu",
         "replaces": "deepmimo_tpu/ops/pallas/render.py:659",
         "launches": train_bwd, "max_abs_err": bwd["max_abs_err"],
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"]},
        {"name": "fused_path_sum", "route": "cuda",
         "source": src + "pathsum.cu",
         "replaces": "deepmimo_tpu/ops/pallas/pathsum.py:66",
         "launches": pallas_launches, "max_abs_err": psum["max_abs_err"],
         "ms": psum["ms"], "plain_ms": psum["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
