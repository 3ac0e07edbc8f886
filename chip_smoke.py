"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. Card and toolchain: ``nvidia-smi`` name and power limit, torch/CUDA.
2. Build: compiles every kernel (``render_fwd``, ``render_bwd``,
   ``pathsum``, ``beamgain``) from ``csrc/`` with nvcc for sm_90a, one
   nvcc per source, all started together, and prints the ptxas report.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main paths' shapes (``KERNEL_CASES``, ``BG_CASES``), with
   CUDA-event times of both at the headline width: the forward render and
   the path sum within 3e-5 * max|H| (also at ``PS_WIDE_CASES``, past the
   old kernel's shared memory: a 16 x 16 BS at 1,024 subcarriers, and 300
   paths), the render's backward within
   3e-4 * max|g| for each of its 7 gradients, the beam-gain kernel within
   3e-5 * max|G| at 6 shapes, from 5 users to 131,072 and up to 100 paths,
   256 subcarriers and 64 beams of a 16 x 16 panel (and, for context, the
   forward render plus an einsum fold at the headline width). The path
   sum's yardstick is timed beside it: one complex64 ``torch.einsum`` over
   the same planes with g given (its ``library_ms``). Every mode is held
   against its plain version in the same mode at every case, and timed
   at the headline: the forward with bf16 output (2^-7 * max|H|), one-pass
   bf16 products (1e-2 * max|H|) and both; the backward and the beam gain
   with one-pass bf16 products (1e-2 * max|g|, max|G|); the beam gain's
   float64 instantiation (complex128 configs) within 1e-9 * max|G| at
   every case whose codebook fits its shared memory.
4. Serving path: four 131,072-user x 25-path datasets (synthetic, seed 7)
   through ``Dataset.compute_channels(params, to_device=True, out=prev)``
   — one kernel launch per call — checked for shape and finiteness and on
   64 users per dataset against the float64 oracle ``tests/oracle.py``;
   then a timed sweep and a ``torch.profiler`` breakdown (device window,
   busy and idle share, largest kernels), as in phases 5b, 5c and 5f.
5. Streamed path: ``to_device=False`` over 3 user blocks must equal the
   single-dispatch result exactly.
5b. Beam-gain serving: ``Dataset.compute_beam_gains(params, codebook=W,
   to_device=True, out=prev)`` on the same four datasets with a 16-beam
   codebook — one beam-gain launch and no render launch per call — on 64
   users per dataset against |conj(W) . H| ** 2 from the float64 oracle
   (1e-4 * max|G|); then a timed sweep.
5c. bf16 serving on the four datasets, counted by kernel mode:
   ``compute_channels`` with ``planes_out_dtype`` "bfloat16" (f32
   products, then bf16 products) and ``compute_beam_gains`` with bf16
   products, each against the oracle (2^-7, 1e-2) and timed as phase 4.
5d. Angle space: the four datasets with a half-wave dipole BS pattern
   through ``compute_channels`` and an ops-level ``render_channels_planes``
   with bs_fov=(120, 180), both through the fused render, against the
   oracle; ms per call.
5e. Doppler: one 131,072-user dataset with radial velocities and
   accelerations at 4 snapshots, ``compute_channels`` (17.2 GB, one
   launch with 4 slots) and ``compute_beam_gains``, each snapshot against
   the oracle; ms per call.
5f. Dual-polar: a 131,072-user dataset with four NaN-padded polarization
   matrices; ``compute_channels(..., to_device=True, out=prev)`` in one
   render launch with 4 slots, 64 users per polarization against the
   oracle (5e-5 * max|H|); dual-polar ``compute_beam_gains`` in one
   beam-gain launch, equal to the per-polarization fold of those channels
   (3e-5 * max|G|); the streamed dual-polar render of a 16,384-user slice
   over 3 blocks equal to its single launch bit for bit.
5g. Non-fused paths: the headline data (seed 7) through
   ``Dataset.compute_channels(params, to_device=True)`` in the settings
   the JAX package renders with plain XLA ops, which stay eager here:
   the time domain (f32 planes [2, U, 1, 64, 25]), the time domain after
   ``ds.apply_fov(bs_fov=[120, 180])`` ("auto" compaction, valid paths
   front-packed), the sinc receive filter at 64 of 512 subcarriers (DFT
   matrix) and at the full band (FFT, 16,384 users), and complex128
   (float64 planes). Each is held against the float64 oracle on 64 users
   (5e-5 * max|H|; complex128 1e-9), timed with CUDA events over 3 calls
   after a warm call, with its peak device memory after a reset, a
   ``torch.profiler`` breakdown, and no fused-kernel launch; the time
   domain streamed over 3 blocks of a 16,384-user slice equals its single
   launch bit for bit. Then complex128 ``compute_beam_gains`` (131,072
   users, a 16-beam codebook, float64 [U, 16, 64]): one launch per call
   of the beam-gain kernel's float64 instantiation, as the JAX package
   sends complex128 to its beam-gain kernel, and no other kernel; the
   oracle at 1e-9 * max|G|, timed and profiled the same way.
5h. Scenarios from disk, at the headline width, each folder written by
   the port's own writers (``save_mat``, ``save_dict_as_json``,
   ``Scene.export_data``, ``export_matlab``) into a temporary directory
   removed at the end, with the host seconds of every write and load, the
   CUDA-event ms of every render and the peak device memory: (a) one TX
   set of 4 points x 32,768 users (seed 12) loads into a ``MacroDataset``;
   ``compute_channels_batched(to_device=True)`` is one render launch into
   [131072, 1, 64, 128], each child against the oracle and against its
   own ``compute_channels`` (3e-5 * max|H|), and
   ``compute_beam_gains_batched`` one beam-gain launch (phase 5b's
   codebook), both routes timed; after ``append`` of a fifth child the
   batched render has its users and its own render's values; (b) a
   dynamic scenario of 3 x 131,072-user snapshots (seeds 13-15) with a
   scene of 300 box buildings and 3 materials loads into a
   ``DynamicDataset``, one render launch per snapshot against the oracle;
   (c) legacy v3 folders: single-pol with Doppler rows (131,072 users in
   8 chunks at 30 dBm: the loaded matrices equal the written ones, one
   launch, the oracle), dual-polar (16,384 users, one launch with 4
   slots, each polarization against the oracle) and two BS (a
   ``MacroDataset``; exported by worker processes while (b) runs);
   (d) checkpoint/resume: child 0 of (a) streamed in
   4 blocks of 8,192 into ``checkpoint_dir``, 2 block files deleted, the
   resume equal to the first run bit for bit with 2 launches; child 1
   (same user count and configuration) gets its own store and equals its
   uncheckpointed render; the same resume for the dual-polar folder in
   blocks of 4,096.
5i. The public surface, at the headline width, on a 131,072-user dataset
   (seed 16) with users on a 256 x 512 grid: (a) ``LinearPath`` across
   the grid in 256 steps and ``get_idxs_with_limits`` (a 64 x 128 box,
   8,192 users), each ``subset`` rendered in one launch and held against
   the float64 oracle (every user of the path; every 128th of the box);
   (b) 16 beams of ``steering_vec`` as the codebook of
   ``compute_beam_gains``: one beam-gain launch, 64 users against
   |conj(W) . H| ** 2 of the oracle (1e-4 * max|G|), CUDA-event ms;
   (c) 5 serving calls, each in a ``StageTimer`` stage and an
   ``annotate("dm.serve")`` range: each stage at least 0.95 x the call's
   CUDA-event time (the stage waits for the device); one call under
   ``xla_trace`` whose written trace must hold a render-kernel event and
   the ``dm.serve`` range; ``renderer_roofline``'s memory bound equal to
   ``kernel_bounds()``'s for the render (1e-9 relative), its users/s
   beside the measured; (d) a 16,384-user scenario written with the port's
   writers, its ``summary``, ``upload`` to a loopback mock of the scenario
   database (``tests/mock_db_server.py``), the folder deleted, ``load``
   downloading and loading it, one render launch against the oracle; host
   seconds of the zip, upload, download and loads.
5j. Converted scenarios, at the headline width: one set of 131,072 users
   (a 256 x 512 grid) x 25 paths (seed 20; line of sight and chains of 1
   or 2 reflections) written as a Wireless InSite project (.setup from the
   port's token writer, project .xml, .city, a ~410 MB .paths.p2m printed
   with ``%.17g`` by 4 worker processes while the Sionna conversion runs,
   and the .pl.p2m) and as a Sionna RT export (six pickles); ``convert``
   of each, InSite through the native p2m parser (built with g++ into
   ``build/native/``; its parse count must rise); a 16,384-user file parsed
   by the native and the Python parser, bit for bit; the two scenarios'
   path matrices equal bit for bit; ``load`` of each, ``compute_channels``
   in one render launch each, 64 users against the oracle (5e-5 x
   max|H|), the two channels equal; beam gains of the Sionna scenario in
   one beam-gain launch against the oracle (1e-4 x max|G|); the batch CLI
   (``convert_folder_loop``) over a 4,096-user InSite run, a Sionna run
   and an unclaimed folder (2 converted, 1 error, the error log), its
   ``--retry`` reading the log, ``copy_source`` writing
   ``rt_source.zip``; where pandas and pyarrow are installed, an AODT
   export of 1,024 users converted and rendered in one launch against the
   oracle (else its ``convert`` must raise ImportError). Host seconds of
   every write, conversion, parse (the whole file's native parse alone
   too), load and the zip; CUDA-event ms and a ``torch.profiler``
   breakdown of each render; the peak device memory.
5k. The scenario factory, at the headline width: (a) ``csv_gen_cli`` on a
   three-city CSV it writes (one city under the population floor), the
   two rows read back by ``read_pipeline_csv``, row 0's box set so that
   ``gen_rx_grid`` at 2 m places 256 x 512 = 131,072 users,
   ``gen_tx_pos`` the BS; (b) ``write_insite_project`` for that placement
   (one inferred grid set) read back by the port's InSite parsers, the
   Blender OSM script compiled; (c) a Sionna export of phase 5j's path
   generator (seed 24) at those positions standing in for the ray
   tracers, the row's ``scene`` and ``raytrace`` stages marked done;
   (d) ``run_pipeline`` with an upload key against the loopback mock of
   the database: row 0 converts and uploads, row 1 fails at
   ``fetch_osm_scene`` (no Blender) and is marked ``error``; (e) the
   scenario loaded back by download, ``compute_channels`` in one render
   launch and ``compute_beam_gains`` (phase 5b's codebook) in one
   beam-gain launch against the oracle; (f) ``DeepMIMOSionnaAdapter`` over
   every user on the time-domain channels (eager, no fused launch), users
   per second and memory, 64 yields against the time-domain oracle, and
   again after ``apply_fov(bs_fov=(120, 180))`` with every kept column's
   ``tau`` its own path's delay; (g) ``export_cdl`` of every user,
   ``save_cdl_mat`` of 16,384 read back, ``synthesize_cdl_cir`` of 4;
   (h) ``stats_cli --json``. Host seconds of each step; everything in a
   temporary directory removed at the end.
6. Training path: the calibration step ``training_step_planes`` with the
   fused backend at the headline width (BS rotated 10 degrees in the
   target, calibration from 0): the first step's gradients of every
   ``CalibParams`` leaf on 4,096 users against the plain versions
   (3e-4 * max|g|); 5 steps at lr 3e-3 with a finite, decreasing loss and
   exactly one forward and one backward launch per step; ms per step,
   peak device memory, the step's split and a ``torch.profiler``
   breakdown of one step.
6b. The planes step with ``matmul_dtype`` "bfloat16": 3 steps, one
   forward and one backward launch per step in their one-pass modes, the
   first step's gradients against the plain versions in that mode
   (1e-2 * max|g|), the first loss within 1e-2 of the f32 one.
7. The ``pallas`` trainer: ``training_step`` at the same width, one
   path-sum launch per step, first loss equal to the planes loss at rtol
   1e-4.

The line before the last is a JSON object describing every kernel in each
of its modes (``fused_render[bf16_out]``, ...; each launched on a main
path, counted by mode), with ``bound_ms``: the larger of its bytes (each
input read once, each output written once) over 3.35 TB/s and its flops
at f32 grade on the tensor cores (3 TF32 passes at 495 TFLOP/s), or for
one-pass bf16 products at 989 TFLOP/s, or the float64 beam gain's
flops at the FP64 tensor-core rate of 67 TFLOP/s, at the headline shapes
of this run; a ``[bounds]`` line beside it gives the SIMT figure (FP32 at
67 TFLOP/s, FP64 at 34) too.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card
the script exits non-zero before printing any result.
"""

import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
KERNELS = ("render_fwd", "render_bwd", "pathsum", "beamgain")
TRAIN_STEPS = 5
PALLAS_STEPS = 3
LR = 3e-3
GRAD_USERS = 4096        # users of the kernel-vs-plain gradient check
DEV = "cuda"
ORACLE_RTOL = 5e-5       # main path vs float64 oracle, relative to max|H|
N_ORACLE = 64            # users per dataset checked against the oracle
BG_BEAMS = 16            # codebook beams of the beam-gain paths
BG_RTOL = 3e-5           # beam-gain kernel vs plain, relative to max|G|
BG_ORACLE_RTOL = 1e-4    # beam gains vs the float64 oracle, rel. max|G|
POLAR_STREAM_USERS = 16_384
C128_RTOL = 1e-9             # complex128 vs the float64 oracle, rel. max
FULL_BAND_USERS = 16_384     # the full-band filter's H is 34 GB at CHUNK
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, HBM3 peak
FP32_FLOPS_PER_S = 67e12     # H100 SXM, FP32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12    # H100 SXM, dense TF32 on the tensor cores
FP64_TC_FLOPS_PER_S = 67e12  # H100 SXM, FP64 on the tensor cores
FP64_FLOPS_PER_S = 34e12     # H100 SXM, FP64 outside the tensor cores
TF32_PASSES = 3              # f32 grade: hi*hi + hi*lo + lo*hi
BF16_FLOPS_PER_S = 989e12    # H100 SXM, dense bf16 on the tensor cores
# Modes with bf16 in them (tests/test_torch_render.py states the reasons):
BF16_OUT_RTOL = 2 ** -7      # bf16 output vs f32, relative to max|H|
BF16_MM_RTOL = 1e-2          # one-pass bf16 products, rel. max|H|, |G|, |g|
DOPPLER_TIMES = (0.0, 1e-3, 2e-3, 3e-3)     # snapshots of the Doppler cell
BF16_STEPS = 3               # training_step_planes steps in bf16 products
# Forward modes held against their plain versions: mm_dtype, out_dtype,
# tolerance relative to max|H|.
FWD_MODES = [("float32", "float32", KERNEL_RTOL),
             ("float32", "bfloat16", BF16_OUT_RTOL),
             ("bfloat16", "float32", BF16_MM_RTOL),
             ("bfloat16", "bfloat16", BF16_MM_RTOL)]
# Backward and beam-gain modes (their outputs are float32).
MM_MODES = ("float32", "bfloat16")
# Beam-gain modes: mm_dtype and the inputs' dtype (float64: complex128
# configs), and each mode's tolerance against its plain version, relative
# to max|G|.
BG_MODES = (("float32", "float32"), ("bfloat16", "float32"),
            ("float32", "float64"))
BG_TOL = {"f32": BG_RTOL, "bf16_mm": BF16_MM_RTOL, "f64": C128_RTOL}


def log(msg):
    print(msg, flush=True)


def entry(name, key):
    """A kernel's entry in the kernels line: ``name``, or ``name[mode]`` for
    a mode other than f32 (``render.mode_key``)."""
    return name if key == "f32" else f"{name}[{key}]"


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


def timed_sweep(torch, calls, reps=5):
    """(CUDA-event ms, host ms) per call over ``reps`` sweeps of the
    functions ``calls``, after one warm sweep."""
    def sweep():
        for call in calls:
            call()
    sweep()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        sweep()
    end.record()
    end.synchronize()
    n = reps * len(calls)
    return start.elapsed_time(end) / n, (time.perf_counter() - t0) * 1e3 / n


def event_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm run."""
    return timed_sweep(torch, [fn], reps)[0]


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
    # Q = 15, S*K = 51, P = 37: off every tile size and the k-step
    ("odd_panel", 4099, 37, (1, 1), (3, 5), 17, 3, True, False),
]


def phase_kernels(torch):
    """The forward kernel in each of FWD_MODES against its plain version in
    the same mode at every KERNEL_CASES shape; at the headline, times of
    both. Returns the headline's metrics by mode."""
    from deepmimo_tpu_torch.ops.kernels import render as kr
    headline = {}
    for name, u, p, rx, tx, k, s, per_slot, packed in KERNEL_CASES:
        args = _render_inputs(torch, u, p, s, s if per_slot else 1,
                              seed=len(name))
        for mm, out_dtype, tol in FWD_MODES:
            key = kr.mode_key(mm, out_dtype)
            h = kr.fused_render(*args, rx, tx, k, packed, mm_dtype=mm,
                                out_dtype=out_dtype)
            ref = kr.fused_render_reference(*args, rx, tx, k, packed, mm)
            torch.cuda.synchronize()
            err = float((h.float() - ref).abs().max())
            scale = float(ref.abs().max())
            log(f"[kernel] {entry('fused_render', key)} {name}: U={u} P={p} "
                f"rx={rx} tx={tx} K={k} S={s} packed={packed} "
                f"out={tuple(h.shape)} {h.dtype} max_abs_err={err:.3e} "
                f"max|H|={scale:.3e} rel={err / scale:.3e} (limit {tol:g})")
            if not (math.isfinite(err) and err <= tol * scale):
                raise AssertionError(f"fused_render {name} {key}: kernel "
                                     f"disagrees with its plain version")
            if name == "headline":
                out = torch.empty_like(h)
                ms = event_ms(torch, lambda: kr.fused_render(
                    *args, rx, tx, k, packed, out=out, mm_dtype=mm,
                    out_dtype=out_dtype), reps=20)
                plain_ms = event_ms(torch, lambda: kr.fused_render_reference(
                    *args, rx, tx, k, packed, mm).to(h.dtype), reps=3)
                gbps = h.numel() * h.element_size() / (ms * 1e-3) / 1e9
                log(f"[kernel] {entry('fused_render', key)} headline: kernel "
                    f"{ms:.4f} ms ({gbps:.1f} GB/s of H written), plain "
                    f"{plain_ms:.4f} ms")
                headline[key] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms)
                del out
            del h, ref
        del args
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
    """The render's backward kernel in each of MM_MODES vs its plain
    version in the same mode at every KERNEL_CASES shape. Returns the
    headline's metrics by mode."""
    from deepmimo_tpu_torch.ops.kernels import render as kr
    headline = {}
    for name, u, p, rx, tx, k, s, per_slot, packed in KERNEL_CASES:
        args = _render_inputs(torch, u, p, s, s if per_slot else 1,
                              seed=len(name) + 100)
        q = rx[0] * rx[1] * tx[0] * tx[1]
        gen = torch.Generator(device=DEV).manual_seed(len(name))
        ct = _cuda_rand(torch, (u, q, 2 * s * k) if packed
                        else (2, u, q, s * k), gen)
        for mm in MM_MODES:
            key = kr.mode_key(mm)
            tol = GRAD_RTOL if key == "f32" else BF16_MM_RTOL
            got = kr.fused_render_bwd(*args, ct, rx, tx, k, packed, mm)
            want = kr.fused_render_bwd_reference(*args, ct, rx, tx, k,
                                                 packed, mm)
            torch.cuda.synchronize()
            errs, worst = [], 0.0
            for gname, g, w in zip(("gry", "grz", "gty", "gtz", "amp", "psi",
                                    "omega"), got, want):
                err = float((g - w).abs().max())
                scale = float(w.abs().max())
                rel = err / scale if scale > 0 else err
                errs.append(f"{gname} {rel:.2e}")
                worst = max(worst, err)
                if not (math.isfinite(err) and err <= tol * scale + 1e-30):
                    raise AssertionError(
                        f"fused_render_bwd {name} {key}: d{gname} disagrees "
                        f"with its plain version (err {err:.3e}, max|g| "
                        f"{scale:.3e})")
            log(f"[kernel] {entry('fused_render_bwd', key)} {name}: U={u} "
                f"P={p} rx={rx} tx={tx} K={k} S={s} packed={packed} rel err "
                f"per grad: {', '.join(errs)} (limit {tol:g})")
            del got, want
            if name == "headline":
                ms = event_ms(torch, lambda: kr.fused_render_bwd(
                    *args, ct, rx, tx, k, packed, mm), reps=20)
                plain_ms, plain_u = largest_fitting_ms(
                    torch, lambda n: lambda: kr.fused_render_bwd_reference(
                        *[a[:n] for a in args], ct[:n], rx, tx, k, packed,
                        mm), u, reps=3)
                gbps = ct.numel() * 4 / (ms * 1e-3) / 1e9
                log(f"[kernel] {entry('fused_render_bwd', key)} headline: "
                    f"kernel {ms:.4f} ms ({gbps:.1f} GB/s of ct read), plain "
                    f"{plain_ms:.4f} ms at {plain_u} users")
                headline[key] = dict(max_abs_err=worst, ms=ms,
                                     plain_ms=plain_ms, plain_users=plain_u)
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


# Path-sum shapes past the shared memory of a kernel that staged E and g of
# all P paths of a user at once (8 P (Q + K) bytes > 232,448): a 16 x 16 BS
# at 1,024 non-arithmetic subcarriers of 2,048, and 300 paths at the
# headline panel. name, U, P, rx_shape, tx_shape, K, non-arithmetic
PS_WIDE_CASES = [
    ("wide_bs", 2048, MAX_PATHS, UE_SHAPE, (16, 16), 1024, True),
    ("many_paths", 4096, 300, UE_SHAPE, BS_SHAPE, N_SC, False),
]


def einsum_yardstick(torch, args, want):
    """The library call that computes the path sum: one complex64
    ``torch.einsum("urp,utp,upk->urtk", arx, atx, g)`` with g formed
    before the timed window (so it leaves out g's trig). Returns its
    CUDA-event ms and its max abs deviation from the plain version."""
    arx_r, arx_i, atx_r, atx_i, amp, psi, omega, k_sel = args
    arx = torch.complex(arx_r, arx_i)
    atx = torch.complex(atx_r, atx_i)
    ph = psi[..., None] - omega[..., None] * k_sel
    g = torch.complex(amp[..., None] * torch.cos(ph),
                      amp[..., None] * torch.sin(ph))
    del ph

    def call():
        return torch.einsum("urp,utp,upk->urtk", arx, atx, g)

    h = call().reshape(want[0].shape)
    err = max(float((h.real - want[0]).abs().max()),
              float((h.imag - want[1]).abs().max()))
    del h
    return event_ms(torch, call, reps=5), err


def phase_pathsum_kernels(torch):
    """The path-sum kernel vs its plain version at the KERNEL_CASES shapes
    (R*T antennas, S*K subcarriers; the two-slot case selects a
    non-arithmetic set of subcarriers) and at PS_WIDE_CASES; at the
    headline also the einsum yardstick."""
    from deepmimo_tpu_torch.ops.kernels import pathsum as kp
    cases = [(name, u, p, rx, tx, s * k, per_slot)
             for name, u, p, rx, tx, k, s, per_slot, _ in KERNEL_CASES]
    headline = None
    for name, u, p, rx, tx, k, non_ap in cases + PS_WIDE_CASES:
        r, t = rx[0] * rx[1], tx[0] * tx[1]
        if non_ap:
            rng = np.random.RandomState(5)
            n_fft = N_FFT if k <= N_FFT // 2 else 2 * k
            k_sel = np.sort(rng.choice(n_fft, k, replace=False))
        else:
            k_sel = np.arange(k)
        args = _pathsum_inputs(torch, u, p, r, t, k_sel, seed=len(name))
        got = kp.fused_path_sum(*args)
        want = kp.fused_path_sum_reference(*args)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        log(f"[kernel] fused_path_sum {name}: U={u} P={p} R={r} T={t} "
            f"K={len(k_sel)} arithmetic={not non_ap} "
            f"8P(Q+K)={8 * p * (r * t + len(k_sel))} "
            f"max_abs_err={err:.3e} max|H|={scale:.3e} "
            f"rel={err / scale:.3e} (limit {KERNEL_RTOL:g})")
        if not (math.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(f"fused_path_sum {name}: kernel disagrees "
                                 f"with its plain version")
        del got
        if name == "headline":
            ms = event_ms(torch, lambda: kp.fused_path_sum(*args), reps=20)
            plain_ms = event_ms(
                torch, lambda: kp.fused_path_sum_reference(*args), reps=3)
            lib_ms, lib_err = einsum_yardstick(torch, args, want)
            log(f"[kernel] fused_path_sum headline: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms; einsum yardstick (complex64, g "
                f"given) {lib_ms:.4f} ms, max_abs_err vs plain "
                f"{lib_err:.3e}")
            if not lib_err <= KERNEL_RTOL * scale:
                raise AssertionError("the einsum yardstick computes another "
                                     "function")
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms)
        del args, want
        torch.cuda.empty_cache()
    return headline


def codebook(n_beams, n_tx, seed):
    """Random-phase codebook / sqrt(T) (1/8 at T = 64, the recipe of
    benchmarks/run_beamgain_bench.py); complex128 [B, T]."""
    rng = np.random.RandomState(seed)
    return np.exp(1j * rng.uniform(-np.pi, np.pi, (n_beams, n_tx))) / \
        math.sqrt(n_tx)


def _planes_on_card(torch, w):
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(DEV)
            for x in (w.real, w.imag)]


BG_CASES = [
    # name, U, rx_shape, tx_shape, B, K, P, S, n_sa
    ("headline", CHUNK, UE_SHAPE, BS_SHAPE, BG_BEAMS, N_SC, MAX_PATHS, 1, 1),
    ("multi_rx", 4099, (2, 1), (4, 2), 8, 16, MAX_PATHS, 1, 1),
    ("polar_slots", 4096, UE_SHAPE, BS_SHAPE, BG_BEAMS, N_SC, MAX_PATHS, 4,
     4),
    ("ragged_large", 4099, (2, 2), (4, 4), 5, 17, 100, 3, 1),
    # the largest P the one-block-per-user kernel took at this shape
    ("wide", 4099, (1, 1), (16, 16), 64, 256, 39, 1, 1),
    # fewer users than the grid has warps
    ("few_users", 5, UE_SHAPE, BS_SHAPE, BG_BEAMS, N_SC, MAX_PATHS, 4, 4),
]


def phase_bg_kernels(torch):
    """The beam-gain kernel vs its plain version at the BG_CASES shapes."""
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    from deepmimo_tpu_torch.ops.kernels import render as kr
    headline = {}
    for name, u, rx, tx, b, k, p, s, n_sa in BG_CASES:
        args32 = _render_inputs(torch, u, p, s, n_sa, seed=len(name) + 200)
        t = tx[0] * tx[1]
        w32 = _planes_on_card(torch, codebook(b, t, seed=len(name)))
        for mm, dtype_name in BG_MODES:
            dtype = getattr(torch, dtype_name)
            key = kb.beam_gain_mode(mm, dtype)
            if not kb.beam_gain_fits(rx, tx, b, p, k, key == "f64"):
                log(f"[kernel] {entry('fused_beam_gain', key)} {name}: "
                    f"T*B = {t * b} past the float64 shared memory; the "
                    f"card refuses it")
                continue
            tol = BG_TOL[key]
            args = [x.to(dtype) for x in args32]
            wr, wi = (x.to(dtype) for x in w32)
            got = kb.fused_beam_gain(*args, wr, wi, rx, tx, k, mm_dtype=mm)
            want = kb.beam_gain_reference(*args, wr, wi, rx, tx, k, mm)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.max())
            log(f"[kernel] {entry('fused_beam_gain', key)} {name}: U={u} "
                f"P={p} rx={rx} tx={tx} B={b} K={k} S={s} n_sa={n_sa} "
                f"out={tuple(got.shape)} max_abs_err={err:.3e} "
                f"max|G|={scale:.3e} rel={err / scale:.3e} (limit {tol:g})")
            if not (math.isfinite(err) and err <= tol * scale):
                raise AssertionError(f"fused_beam_gain {name} {key}: kernel "
                                     f"disagrees with its plain version")
            del want
            if name == "headline":
                ms = event_ms(torch, lambda: kb.fused_beam_gain(
                    *args, wr, wi, rx, tx, k, out=got, mm_dtype=mm), reps=20)
                plain_ms = event_ms(torch, lambda: kb.beam_gain_reference(
                    *args, wr, wi, rx, tx, k, mm), reps=3)
                log(f"[kernel] {entry('fused_beam_gain', key)} headline: "
                    f"kernel {ms:.4f} ms ({u / ms * 1e3:.1f} users/s), "
                    f"plain {plain_ms:.4f} ms")
                headline[key] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms)
                if key == "f32":
                    h = torch.empty((2, u, t, k), device=DEV)
                    pair_ms = event_ms(torch, lambda: kb.codebook_gain(
                        wr, wi, *kr.fused_render(*args, rx, tx, k, False,
                                                 out=h)), reps=3)
                    log(f"[kernel] for context, forward render kernel + "
                        f"einsum fold {pair_ms:.4f} ms")
                    del h
            del got, args
        del args32
        torch.cuda.empty_cache()
    return headline


def phase_main(torch, dmt):
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.ops.kernels import render as kr

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
        want = _oracle(ds, N_ORACLE, ds["power"], ds["phase"])
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

    calls = [lambda ds=ds: ds.compute_channels(params, to_device=True, out=h)
             for ds in datasets]
    ms, wall = timed_sweep(torch, calls)
    log(f"[main] sweep of 5 x {N_DATASETS} datasets: {ms:.4f} ms per "
        f"{CHUNK}-user dataset (CUDA events), {CHUNK / ms * 1e3:.1f} "
        f"users/s; host wall {wall:.4f} ms per dataset")
    profile_cell(torch, "serving", calls)
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


def _oracle(ds, n, power, phase, **kw):
    """float64 oracle channels of the first ``n`` users of ``ds``, fed the
    given power and phase matrices (``kw``: the oracle's pattern, FoV and
    Doppler arguments; Doppler arrays are cut to ``n`` users here)."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from oracle import oracle_channels
    for key in ("doppler_vel", "doppler_acc"):
        if key in kw:
            kw[key] = kw[key][:n]
    args = dict(bs_shape=BS_SHAPE, ue_shape=UE_SHAPE, n_fft=N_FFT,
                selected_subcarriers=tuple(range(N_SC)), bandwidth=BANDWIDTH,
                num_paths=MAX_PATHS)
    args.update(kw)
    return oracle_channels(
        power[:n], phase[:n], *(ds[key][:n] for key in (
            "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")), **args)


def _check_oracle(tag, what, got, want, tol):
    """Fail unless ``got`` is within ``tol`` * max|want| of the oracle's
    ``want``; logs the error under ``[tag] what``."""
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    log(f"[{tag}] {what}: oracle {got.shape[0]} users max_abs_err={err:.3e} "
        f"max={scale:.3e} rel={err / scale:.3e} (limit {tol:g})")
    if not err <= tol * scale:
        raise AssertionError(f"{tag} {what}: disagrees with the oracle")


def _beam_oracle(w, h):
    """|conj(W) H|^2 [U, R*B, K] of oracle channels H [U, R, T, K]."""
    g = np.abs(np.einsum("bt,urtk->urbk", w.conj(), h)) ** 2
    return g.reshape(h.shape[0], -1, h.shape[-1])


def _counted_calls(torch, tag, call, n, shape, dtype):
    """``h = call(i, prev)`` for i < n, each writing into the previous
    result: checks shape, dtype, finiteness and the reuse of ``out=``.
    Returns the last result."""
    h = None
    for i in range(n):
        prev = h
        h = call(i, prev)
        if tuple(h.shape) != tuple(shape) or h.dtype != dtype:
            raise AssertionError(f"{tag} {i}: {tuple(h.shape)} {h.dtype}, "
                                 f"expected {tuple(shape)} {dtype}")
        if prev is not None and h.data_ptr() != prev.data_ptr():
            raise AssertionError(f"{tag} {i}: out= buffer not reused")
        if not bool(torch.isfinite(h).all()):
            raise AssertionError(f"{tag} {i}: non-finite values")
    return h


def _modes(counts, name, want):
    """Fail unless the launches by mode in ``counts`` are ``want``
    ({mode key: launches}); returns them under their kernels-line names."""
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{name}: launches by mode {got}, expected "
                             f"{want}")
    return {entry(name, k): v for k, v in want.items()}


def profile_cell(torch, tag, calls, top=4):
    """Where one cell's time goes: ``torch.profiler`` over one sweep of
    ``calls``, after a warm-up sweep that the profiler also runs (its first
    cycle can drop device events). Prints the device window per call, the
    busy and idle share of it, and the largest kernels by time with their
    launch counts. A cycle that records no device event at all is
    profiled once more (the profiler dropped every event of one cycle in
    one run of about ten); a second empty cycle fails."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for call in calls:
                    call()
                torch.cuda.synchronize()
                prof.step()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type.name == "CUDA" and
                       e.time_range.end > e.time_range.start)
        if spans:
            break
        log(f"[profile] {tag}: the profiler saw no device time; profiling "
            f"again")
    else:
        raise AssertionError(f"{tag}: the profiler saw no device time "
                             f"twice")
    busy, reach, by_name = 0.0, spans[0][0], {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
    window = reach - spans[0][0]
    n = len(calls)
    largest = sorted(by_name.items(), key=lambda x: -x[1][0])[:top]
    log(f"[profile] {tag}: device window {window / n / 1e3:.4f} ms per call, "
        f"busy {busy / n / 1e3:.4f} ms, idle {100 * (1 - busy / window):.2f}%"
        f", {len(spans) / n:.0f} device ops per call; largest per call: " +
        "; ".join(f"{name[:40]} x{count} {t / n / 1e3:.4f} ms"
                  for name, (t, count) in largest))


def phase_beamgain(torch, datasets, params):
    """Beam-gain serving on the four headline datasets, counted: one
    beam-gain launch and no render launch per call."""
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    from deepmimo_tpu_torch.ops.kernels import render as kr

    w = codebook(BG_BEAMS, BS_SHAPE[0] * BS_SHAPE[1], seed=75)
    expected = (CHUNK, BG_BEAMS, N_SC)
    kb.LAUNCHES = kr.LAUNCHES = 0
    g = None
    for i, ds in enumerate(datasets):
        prev = g
        g = ds.compute_beam_gains(params, codebook=w, to_device=True,
                                  out=prev)
        if tuple(g.shape) != expected or g.dtype != torch.float32:
            raise AssertionError(f"beam gains {i}: {tuple(g.shape)} "
                                 f"{g.dtype}, expected {expected} float32")
        if prev is not None and g.data_ptr() != prev.data_ptr():
            raise AssertionError(f"beam gains {i}: out= buffer not reused")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"beam gains {i}: non-finite")
        h = _oracle(ds, N_ORACLE, ds["power"], ds["phase"])
        want = (np.abs(np.einsum("bt,urtk->urbk", w.conj(), h)) ** 2
                ).reshape(N_ORACLE, BG_BEAMS, N_SC)
        err = float(np.abs(g[:N_ORACLE].cpu().numpy() - want).max())
        scale = float(want.max())
        log(f"[beamgain] dataset {i}: {tuple(g.shape)} finite; oracle "
            f"{N_ORACLE} users max_abs_err={err:.3e} max|G|={scale:.3e} "
            f"rel={err / scale:.3e} (limit {BG_ORACLE_RTOL:g})")
        if not err <= BG_ORACLE_RTOL * scale:
            raise AssertionError(f"beam gains {i}: disagree with the oracle")
    launches = (kb.LAUNCHES, kr.LAUNCHES)
    if launches != (len(datasets), 0):
        raise AssertionError(f"(beam-gain, render) launches {launches} for "
                             f"{len(datasets)} compute_beam_gains calls")
    log(f"[beamgain] launches in the serving path: beam gain {launches[0]}, "
        f"render {launches[1]}")

    calls = [lambda ds=ds: ds.compute_beam_gains(params, codebook=w,
                                                 to_device=True, out=g)
             for ds in datasets]
    ms, wall = timed_sweep(torch, calls)
    log(f"[beamgain] sweep of 5 x {len(datasets)} datasets: {ms:.4f} ms per "
        f"{CHUNK}-user call (CUDA events), {CHUNK / ms * 1e3:.1f} users/s; "
        f"host wall {wall:.4f} ms per call")
    profile_cell(torch, "beam-gain serving", calls)
    return launches[0]


def make_pol_data(data, seed=8):
    """Four per-polarization power/phase matrices, NaN where ``data`` has
    no path (the loader's padding)."""
    from deepmimo_tpu_torch.generator.dataset import POLS
    rng = np.random.RandomState(seed)
    nan = np.isnan(data["power"])
    out = {}
    for pol in POLS:
        for key, lo, hi in (("power", -130, -60), ("phase", -180, 180)):
            out[f"{key}_{pol.lower()}"] = np.where(
                nan, np.nan, rng.uniform(lo, hi, nan.shape)).astype(
                    np.float32)
    return out


def phase_polar(torch, dmt):
    """Dual-polar channels and beam gains at the headline width, counted,
    against the oracle and the per-polarization fold; then the streamed
    dual-polar render against its single launch."""
    from deepmimo_tpu_torch.generator.dataset import POLS
    from deepmimo_tpu_torch.ops.channel import unpack_polar_planes_np
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    from deepmimo_tpu_torch.ops.kernels import render as kr

    d = make_data(CHUNK, MAX_PATHS, seed=7)
    d.update(make_pol_data(d))
    d["rx_pos"] = np.zeros((CHUNK, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    ds = dmt.Dataset(d)
    params = make_params(dmt)
    params[dmt.consts.PARAMSET_POLAR_EN] = 1
    cfg, _, _ = params.to_config(CHUNK)
    n_pol, t = len(POLS), BS_SHAPE[0] * BS_SHAPE[1]
    expected = (CHUNK, 1, t, 2 * n_pol * N_SC)

    kr.LAUNCHES = kb.LAUNCHES = 0
    h = None
    for i in range(2):
        prev = h
        h = ds.compute_channels(params, to_device=True, out=prev)
        if tuple(h.shape) != expected or not bool(torch.isfinite(h).all()):
            raise AssertionError(f"dual-polar call {i}: {tuple(h.shape)}, "
                                 f"expected {expected} finite")
        if prev is not None and h.data_ptr() != prev.data_ptr():
            raise AssertionError(f"dual-polar call {i}: out= not reused")
    ch_launches = (kr.LAUNCHES, kb.LAUNCHES)
    if ch_launches != (2, 0):
        raise AssertionError(f"dual-polar compute_channels: (render, beam "
                             f"gain) launches {ch_launches} for 2 calls")
    got = unpack_polar_planes_np(h[:N_ORACLE].cpu().numpy(), cfg)
    for ip, pol in enumerate(POLS):
        want = _oracle(ds, N_ORACLE, d[f"power_{pol.lower()}"],
                       d[f"phase_{pol.lower()}"])
        err = float(np.abs(got[ip] - want).max())
        scale = float(np.abs(want).max())
        log(f"[polar] {pol}: oracle {N_ORACLE} users max_abs_err={err:.3e} "
            f"max|H|={scale:.3e} rel={err / scale:.3e} (limit "
            f"{ORACLE_RTOL:g})")
        if not err <= ORACLE_RTOL * scale:
            raise AssertionError(f"dual-polar {pol}: disagrees with the "
                                 f"oracle")
    calls = [lambda: ds.compute_channels(params, to_device=True, out=h)]
    ms_ch, wall_ch = timed_sweep(torch, calls)
    log(f"[polar] compute_channels: {tuple(h.shape)} "
        f"({h.numel() * 4 / 1e9:.2f} GB), 1 render launch per call with "
        f"{n_pol} slots; {ms_ch:.4f} ms per {CHUNK}-user call (CUDA "
        f"events), {CHUNK / ms_ch * 1e3:.1f} users/s; host wall "
        f"{wall_ch:.4f} ms")
    profile_cell(torch, "dual-polar channels", calls)

    # The per-polarization fold of those channels, then free H.
    w = codebook(BG_BEAMS, t, seed=76)
    wr, wi = _planes_on_card(torch, w)
    sk = n_pol * N_SC
    fold = torch.cat([kb.codebook_gain(
        wr, wi, h[:, 0, :, ip * N_SC:(ip + 1) * N_SC],
        h[:, 0, :, sk + ip * N_SC:sk + (ip + 1) * N_SC])
        for ip in range(n_pol)], dim=-1)
    del h
    torch.cuda.empty_cache()

    kr.LAUNCHES = kb.LAUNCHES = 0
    g = None
    for i in range(2):
        prev = g
        g = ds.compute_beam_gains(params, codebook=w, to_device=True,
                                  out=prev)
        if prev is not None and g.data_ptr() != prev.data_ptr():
            raise AssertionError(f"dual-polar beam gains {i}: out= not "
                                 f"reused")
    bg_launches = (kb.LAUNCHES, kr.LAUNCHES)
    if bg_launches != (2, 0):
        raise AssertionError(f"dual-polar compute_beam_gains: (beam gain, "
                             f"render) launches {bg_launches} for 2 calls")
    err = float((g - fold).abs().max())
    scale = float(fold.max())
    log(f"[polar] compute_beam_gains: {tuple(g.shape)}, 1 beam-gain launch "
        f"per call; vs the per-polarization fold of the channels "
        f"max_abs_err={err:.3e} max|G|={scale:.3e} rel={err / scale:.3e} "
        f"(limit {BG_RTOL:g})")
    if not (math.isfinite(err) and err <= BG_RTOL * scale):
        raise AssertionError("dual-polar beam gains differ from the fold")
    calls = [lambda: ds.compute_beam_gains(params, codebook=w,
                                           to_device=True, out=g)]
    ms_bg, wall_bg = timed_sweep(torch, calls)
    log(f"[polar] compute_beam_gains: {ms_bg:.4f} ms per {CHUNK}-user call "
        f"(CUDA events), {CHUNK / ms_bg * 1e3:.1f} users/s; host wall "
        f"{wall_bg:.4f} ms")
    profile_cell(torch, "dual-polar beam gains", calls)
    del g, fold
    torch.cuda.empty_cache()

    # Streamed dual-polar render of a slice == its single launch.
    sub = dmt.Dataset({k: v[:POLAR_STREAM_USERS] if k != "tx_pos" else v
                       for k, v in d.items()})
    single = sub.compute_channels(params)
    old = {k: dmt.config.get(k)
           for k in ("max_device_output_bytes", "user_block")}
    block = -(-POLAR_STREAM_USERS // 3)
    dmt.config.set("max_device_output_bytes",
                   POLAR_STREAM_USERS * t * 2 * sk * 4 - 1)
    dmt.config.set("user_block", block)
    try:
        before = kr.LAUNCHES
        streamed = sub.compute_channels(params)
        blocks = kr.LAUNCHES - before
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
    if blocks != 3:
        raise AssertionError(f"streamed dual-polar rendered {blocks} blocks")
    for pol in POLS:
        if not np.array_equal(single[pol], streamed[pol]):
            raise AssertionError(f"streamed dual-polar {pol} differs from "
                                 f"the single launch")
    log(f"[polar] streamed: {blocks} blocks of <= {block} users, each "
        f"polarization {streamed['VV'].shape} equals the single launch "
        f"exactly")
    return ch_launches[0], bg_launches[0]


def phase_bf16_serving(torch, dmt, datasets):
    """bf16 serving on the four headline datasets, counted by kernel mode:
    ``compute_channels(..., to_device=True, out=prev)`` with
    ``planes_out_dtype`` "bfloat16" (f32 products, then bf16 products too)
    and ``compute_beam_gains`` with bf16 products, against the oracle;
    then a timed sweep of each (the f32 cells' recipe)."""
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    from deepmimo_tpu_torch.ops.kernels import render as kr

    old = {k: dmt.config.get(k) for k in ("planes_out_dtype", "matmul_dtype")}
    launches, n = {}, len(datasets)
    try:
        dmt.config.set("planes_out_dtype", "bfloat16")
        for mm, tol in (("float32", BF16_OUT_RTOL),
                        ("bfloat16", BF16_MM_RTOL)):
            dmt.config.set("matmul_dtype", mm)
            params = make_params(dmt)
            cfg, _, _ = params.to_config(CHUNK)
            key = kr.mode_key(mm, "bfloat16")
            tag = f"bf16-serving {key}"
            kr.MODE_LAUNCHES.clear()
            h = _counted_calls(
                torch, tag, lambda i, prev: datasets[i].compute_channels(
                    params, to_device=True, out=prev), n,
                (CHUNK, 1, BS_SHAPE[0] * BS_SHAPE[1], 2 * N_SC),
                torch.bfloat16)
            launches.update(_modes(kr.MODE_LAUNCHES, "fused_render",
                                   {key: n}))
            ds = datasets[-1]
            _check_oracle(f"bf16-serving {key}", f"dataset {n - 1}",
                          unpack_planes_np(h[:N_ORACLE], cfg),
                          _oracle(ds, N_ORACLE, ds["power"], ds["phase"]),
                          tol)
            calls = [lambda ds=ds: ds.compute_channels(params, to_device=True,
                                                       out=h)
                     for ds in datasets]
            ms, wall = timed_sweep(torch, calls)
            log(f"[bf16-serving {key}] sweep of 5 x {n} datasets: {ms:.4f} "
                f"ms per {CHUNK}-user dataset (CUDA events), "
                f"{CHUNK / ms * 1e3:.1f} users/s; host wall {wall:.4f} ms; "
                f"planes {h.numel() * 2 / 1e9:.2f} GB bf16")
            profile_cell(torch, f"bf16 serving {key}", calls)
            del h, calls
            torch.cuda.empty_cache()

        dmt.config.set("planes_out_dtype", "float32")
        dmt.config.set("matmul_dtype", "bfloat16")
        params = make_params(dmt)
        w = codebook(BG_BEAMS, BS_SHAPE[0] * BS_SHAPE[1], seed=75)
        kb.MODE_LAUNCHES.clear()
        kr.LAUNCHES = 0
        g = _counted_calls(
            torch, "bf16 beam gains",
            lambda i, prev: datasets[i].compute_beam_gains(
                params, codebook=w, to_device=True, out=prev), n,
            (CHUNK, BG_BEAMS, N_SC), torch.float32)
        launches.update(_modes(kb.MODE_LAUNCHES, "fused_beam_gain",
                               {"bf16_mm": n}))
        if kr.LAUNCHES:
            raise AssertionError("bf16 beam gains launched the render")
        ds = datasets[-1]
        _check_oracle("bf16-serving beam gains bf16_mm", f"dataset {n - 1}",
                      g[:N_ORACLE].cpu().numpy(),
                      _beam_oracle(w, _oracle(ds, N_ORACLE, ds["power"],
                                              ds["phase"])), BF16_MM_RTOL)
        calls = [lambda ds=ds: ds.compute_beam_gains(
            params, codebook=w, to_device=True, out=g) for ds in datasets]
        ms, wall = timed_sweep(torch, calls)
        log(f"[bf16-serving beam gains bf16_mm] sweep of 5 x {n} datasets: "
            f"{ms:.4f} ms per {CHUNK}-user call (CUDA events), "
            f"{CHUNK / ms * 1e3:.1f} users/s; host wall {wall:.4f} ms")
        del g, calls
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
    torch.cuda.empty_cache()
    return launches


def phase_doppler(torch, dmt):
    """Doppler: one 131,072-user dataset with synthetic radial velocities
    and accelerations (seed 9) at len(DOPPLER_TIMES) snapshots, through
    ``compute_channels`` (packed [U, 1, 64, 2*4*64], 17.2 GB, one render
    launch with 4 slots) and ``compute_beam_gains`` (16 beams, [U, 16,
    4*64]), counted, each snapshot against the oracle; ms per call."""
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    from deepmimo_tpu_torch.ops.kernels import render as kr

    c = dmt.consts
    d = make_data(CHUNK, MAX_PATHS, seed=9)
    rng = np.random.RandomState(10)
    nan = np.isnan(d["power"])
    for key, lo, hi in (("doppler_vel", -30, 30), ("doppler_acc", -5, 5)):
        d[key] = np.where(nan, np.nan, rng.uniform(lo, hi, nan.shape)
                          ).astype(np.float32)
    d["rx_pos"] = np.zeros((CHUNK, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    ds = dmt.Dataset(d)
    params = make_params(dmt)
    params[c.PARAMSET_DOPPLER_EN] = 1
    params[c.PARAMSET_DOPPLER_TIMES] = np.array(DOPPLER_TIMES)
    cfg, _, _ = params.to_config(CHUNK)
    n_s, t = len(DOPPLER_TIMES), BS_SHAPE[0] * BS_SHAPE[1]
    wants = [_oracle(ds, N_ORACLE, d["power"], d["phase"],
                     doppler_vel=d["doppler_vel"],
                     doppler_acc=d["doppler_acc"], doppler_time=ts)
             for ts in DOPPLER_TIMES]

    kr.MODE_LAUNCHES.clear()
    kb.LAUNCHES = 0
    h = _counted_calls(
        torch, "doppler channels",
        lambda i, prev: ds.compute_channels(params, to_device=True,
                                            out=prev), 2,
        (CHUNK, 1, t, 2 * n_s * N_SC), torch.float32)
    launches = _modes(kr.MODE_LAUNCHES, "fused_render", {"f32": 2})
    got = unpack_planes_np(h[:N_ORACLE], cfg)            # [..., K, S]
    for i, ts in enumerate(DOPPLER_TIMES):
        _check_oracle("doppler", f"channels t={ts:g} s", got[..., i],
                      wants[i], ORACLE_RTOL)
    calls = [lambda: ds.compute_channels(params, to_device=True, out=h)]
    ms, wall = timed_sweep(torch, calls, reps=3)
    log(f"[doppler] compute_channels: {tuple(h.shape)} "
        f"({h.numel() * 4 / 1e9:.2f} GB), 1 render launch per call with "
        f"{n_s} slots; {ms:.4f} ms per {CHUNK}-user call (CUDA events), "
        f"host wall {wall:.4f} ms")
    del h, calls
    torch.cuda.empty_cache()

    w = codebook(BG_BEAMS, t, seed=77)
    kb.MODE_LAUNCHES.clear()
    kr.LAUNCHES = 0
    g = _counted_calls(
        torch, "doppler beam gains",
        lambda i, prev: ds.compute_beam_gains(params, codebook=w,
                                              to_device=True, out=prev), 2,
        (CHUNK, BG_BEAMS, n_s * N_SC), torch.float32)
    launches.update(_modes(kb.MODE_LAUNCHES, "fused_beam_gain",
                           {"f32": 2}))
    if kr.LAUNCHES:
        raise AssertionError("Doppler beam gains launched the render")
    gh = g[:N_ORACLE].cpu().numpy()
    for i, ts in enumerate(DOPPLER_TIMES):
        _check_oracle("doppler", f"beam gains t={ts:g} s",
                      gh[..., i * N_SC:(i + 1) * N_SC],
                      _beam_oracle(w, wants[i]), BG_ORACLE_RTOL)
    calls = [lambda: ds.compute_beam_gains(params, codebook=w,
                                           to_device=True, out=g)]
    ms, wall = timed_sweep(torch, calls, reps=3)
    log(f"[doppler] compute_beam_gains: {tuple(g.shape)}, 1 beam-gain "
        f"launch per call; {ms:.4f} ms per {CHUNK}-user call (CUDA events), "
        f"host wall {wall:.4f} ms")
    del g, calls
    torch.cuda.empty_cache()
    return launches


def phase_angle_space(torch, dmt, datasets):
    """The fused render's angle-space prologue: the four headline datasets
    with a half-wave dipole BS pattern through ``compute_channels``, and an
    ops-level ``render_channels_planes`` with bs_fov=(120, 180) on the
    first; counted (one f32 render launch per call), against the oracle;
    ms per call."""
    from deepmimo_tpu_torch.ops.channel import (render_channels_planes,
                                                unpack_planes_np)
    from deepmimo_tpu_torch.ops.kernels import render as kr

    c = dmt.consts
    params = make_params(dmt)
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_RAD_PAT] = "halfwave-dipole"
    cfg, _, _ = params.to_config(CHUNK)
    n, t = len(datasets), BS_SHAPE[0] * BS_SHAPE[1]
    shape = (CHUNK, 1, t, 2 * N_SC)
    kr.MODE_LAUNCHES.clear()
    h = _counted_calls(
        torch, "dipole channels",
        lambda i, prev: datasets[i].compute_channels(params, to_device=True,
                                                     out=prev), n, shape,
        torch.float32)
    launches = _modes(kr.MODE_LAUNCHES, "fused_render", {"f32": n})
    ds = datasets[-1]
    _check_oracle("angle-space", f"dipole dataset {n - 1}",
                  unpack_planes_np(h[:N_ORACLE], cfg),
                  _oracle(ds, N_ORACLE, ds["power"], ds["phase"],
                          bs_pattern="halfwave-dipole"), ORACLE_RTOL)
    calls = [lambda ds=ds: ds.compute_channels(params, to_device=True, out=h)
             for ds in datasets]
    ms, wall = timed_sweep(torch, calls)
    log(f"[angle-space] dipole compute_channels: {ms:.4f} ms per "
        f"{CHUNK}-user dataset (CUDA events), {CHUNK / ms * 1e3:.1f} "
        f"users/s; host wall {wall:.4f} ms")

    ds = datasets[0]
    fov_cfg, bs, ue = make_params(dmt).to_config(CHUNK)
    fov_cfg = fov_cfg.replace(bs_fov=(120.0, 180.0))
    paths = dmt.PathData.from_numpy(*(ds[k] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")),
        device=DEV)
    kr.MODE_LAUNCHES.clear()
    buf = h
    h = _counted_calls(
        torch, "fov channels",
        lambda i, prev: render_channels_planes(paths, bs, ue, fov_cfg,
                                               out=buf), 1, shape,
        torch.float32)
    launches["fused_render"] += _modes(kr.MODE_LAUNCHES,
                                       "fused_render", {"f32": 1})[
        "fused_render"]
    _check_oracle("angle-space", "bs_fov=(120, 180)",
                  unpack_planes_np(h[:N_ORACLE], fov_cfg),
                  _oracle(ds, N_ORACLE, ds["power"], ds["phase"],
                          bs_fov=(120.0, 180.0)), ORACLE_RTOL)
    ms, wall = timed_sweep(torch, [lambda: render_channels_planes(
        paths, bs, ue, fov_cfg, out=h)])
    log(f"[angle-space] bs_fov render_channels_planes: {ms:.4f} ms per "
        f"{CHUNK}-user call (CUDA events), host wall {wall:.4f} ms")
    del h, buf, paths, calls
    torch.cuda.empty_cache()
    return launches


def _kernel_launches():
    """Launch counters of every fused kernel (render, its backward, path
    sum, beam gain)."""
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    from deepmimo_tpu_torch.ops.kernels import pathsum as kp
    from deepmimo_tpu_torch.ops.kernels import render as kr
    return (kr.LAUNCHES, kr.BWD_LAUNCHES, kp.LAUNCHES, kb.LAUNCHES)


def _nonfused_call(torch, tag, call, shape, dtype):
    """One counted non-fused phase-5g call: shape, dtype, finiteness, the
    peak device memory from a reset, and no fused-kernel launch. Returns
    the result."""
    before = _kernel_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h = call(None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if tuple(h.shape) != tuple(shape) or h.dtype != dtype:
        raise AssertionError(f"{tag}: {tuple(h.shape)} {h.dtype}, expected "
                             f"{tuple(shape)} {dtype}")
    if not bool(torch.isfinite(h).all()):
        raise AssertionError(f"{tag}: non-finite values")
    if _kernel_launches() != before:
        raise AssertionError(f"{tag}: a fused kernel was launched "
                             f"({before} -> {_kernel_launches()})")
    log(f"[nonfused] {tag}: {tuple(h.shape)} {str(h.dtype)[6:]} "
        f"({h.numel() * h.element_size() / 1e9:.2f} GB); peak device "
        f"memory {peak:.3f} GiB ({base / 2 ** 30:.3f} GiB held before)")
    return h


def phase_nonfused(torch, dmt):
    """The settings the JAX package renders with plain XLA ops, eager here
    (phase 5g): time domain (with and without FoV compaction), the sinc
    filter (DFT matrix at 64 of 512 subcarriers, FFT at the full band) and
    complex128 channels, each through the Dataset entry point, against the
    oracle, timed, with its peak memory and no fused-kernel launch; then
    complex128 beam gains, the beam-gain kernel's float64 instantiation.
    Returns the main-path launches of that kernel mode."""
    from deepmimo_tpu_torch.ops.channel import (_packed_layout,
                                                unpack_planes_np)
    from deepmimo_tpu_torch.ops.kernels import beamgain as kb
    c = dmt.consts
    d = make_data(CHUNK, MAX_PATHS, seed=7)
    d["rx_pos"] = np.zeros((CHUNK, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    t = BS_SHAPE[0] * BS_SHAPE[1]
    old = {k: dmt.config.get(k) for k in ("compute_dtype",
                                          "max_device_output_bytes",
                                          "user_block")}

    def users(n):
        return {k: v[:n] for k, v in d.items() if k != "tx_pos"} | \
            {"tx_pos": d["tx_pos"]}

    def run(tag, n, dtype, rtol, fov=None, **setting):
        dmt.config.set("compute_dtype", dtype)
        ds = dmt.Dataset(users(n))
        params = make_params(dmt)
        for k, v in setting.items():
            if k == "freq_domain":
                params[c.PARAMSET_FD_CH] = v
            else:
                params[c.PARAMSET_OFDM][k] = v
        kw = {}
        if fov is not None:
            ds.apply_fov(bs_fov=np.array(fov))
            kw["bs_fov"] = tuple(float(x) for x in fov)
        cfg, _, _ = params.to_config(n)
        k = N_SC if cfg.freq_domain else MAX_PATHS
        shape = ((n, 1, t, 2 * len(cfg.selected_subcarriers))
                 if _packed_layout(cfg) else (2, n, 1, t, k))
        pdt = torch.float64 if dtype == "complex128" else torch.float32
        h = _nonfused_call(
            torch, tag, lambda prev: ds.compute_channels(
                params, to_device=True, out=prev), shape, pdt)
        first = h[:N_ORACLE] if _packed_layout(cfg) else h[:, :N_ORACLE]
        got = unpack_planes_np(first, cfg)
        want = _oracle(ds, N_ORACLE, d["power"], d["phase"],
                       freq_domain=cfg.freq_domain, rx_filter=cfg.rx_filter,
                       selected_subcarriers=cfg.selected_subcarriers, **kw)
        _check_oracle("nonfused", tag, got, want, rtol)
        before = _kernel_launches()
        calls = [lambda: ds.compute_channels(params, to_device=True, out=h)]
        ms, wall = timed_sweep(torch, calls, reps=3)
        profile_cell(torch, f"nonfused {tag}", calls)
        if _kernel_launches() != before:
            raise AssertionError(f"{tag}: a fused kernel was launched")
        log(f"[nonfused] {tag}: {ms:.4f} ms per {n}-user call (CUDA "
            f"events), {n / ms * 1e3:.1f} users/s; host wall {wall:.4f} ms")
        return ds, params, cfg, got

    try:
        ds, params, _, _ = run("time domain", CHUNK, "complex64",
                               ORACLE_RTOL, freq_domain=0)
        # streamed over 3 blocks of a 16,384-user slice == one launch
        part = dmt.Dataset(users(POLAR_STREAM_USERS))
        single = part.compute_channels(params)
        dmt.config.set("max_device_output_bytes", 1)
        dmt.config.set("user_block", -(-POLAR_STREAM_USERS // 3))
        before = _kernel_launches()
        streamed = part.compute_channels(params)
        dmt.config.set("max_device_output_bytes",
                       old["max_device_output_bytes"])
        dmt.config.set("user_block", old["user_block"])
        if _kernel_launches() != before or not np.array_equal(single,
                                                              streamed):
            raise AssertionError("time domain: streamed result differs "
                                 "from the single launch")
        log(f"[nonfused] time domain streamed over 3 blocks of "
            f"{POLAR_STREAM_USERS} users: {streamed.shape} equals the "
            f"single launch exactly")
        del ds, part, single, streamed
        torch.cuda.empty_cache()

        ds, _, cfg, got = run("time domain + bs_fov (compaction)", CHUNK,
                              "complex64", ORACLE_RTOL, fov=(120, 180),
                              freq_domain=0)
        mask = ds["_fov_mask"][:N_ORACLE]
        n_valid = mask.sum(1)
        holes = int(sum(not mask[u, :n_valid[u]].all()
                        for u in range(N_ORACLE)))
        packed = all(np.all(got[u, ..., n_valid[u]:] == 0)
                     for u in range(N_ORACLE))
        if not holes or not packed:
            raise AssertionError(f"compaction: {holes} of {N_ORACLE} users "
                                 f"with FoV holes, front-packed {packed}")
        log(f"[nonfused] compaction: {holes} of {N_ORACLE} users had FoV "
            f"holes; each user's {int(n_valid.min())}-{int(n_valid.max())} "
            f"surviving paths front-packed, zeros after")
        del ds
        torch.cuda.empty_cache()

        run("sinc filter 64/512 (DFT)", CHUNK, "complex64", ORACLE_RTOL,
            rx_filter=1)
        torch.cuda.empty_cache()
        run("sinc filter 512/512 (FFT)", FULL_BAND_USERS, "complex64",
            ORACLE_RTOL, rx_filter=1,
            **{c.PARAMSET_OFDM_SC_SAMP: np.arange(N_FFT)})
        torch.cuda.empty_cache()
        run("complex128", CHUNK, "complex128", C128_RTOL)
        torch.cuda.empty_cache()

        # complex128 beam gains: the beam-gain kernel's float64
        # instantiation, one launch per call and no other kernel
        dmt.config.set("compute_dtype", "complex128")
        ds = dmt.Dataset(users(CHUNK))
        params = make_params(dmt)
        w = codebook(BG_BEAMS, t, seed=75)
        kb.MODE_LAUNCHES.clear()
        before = _kernel_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g = _counted_calls(
            torch, "complex128 beam gains",
            lambda i, prev: ds.compute_beam_gains(
                params, codebook=w, to_device=True, out=prev), 2,
            (CHUNK, BG_BEAMS, N_SC), torch.float64)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = _modes(kb.MODE_LAUNCHES, "fused_beam_gain", {"f64": 2})
        if _kernel_launches()[:3] != before[:3]:
            raise AssertionError("complex128 beam gains launched another "
                                 "kernel")
        log(f"[nonfused] complex128 beam gains: {tuple(g.shape)} float64 "
            f"({g.numel() * 8 / 1e9:.2f} GB), 1 beam-gain launch (float64) "
            f"per call; peak device memory {peak:.3f} GiB "
            f"({base / 2 ** 30:.3f} GiB held before)")
        want = _beam_oracle(w, _oracle(ds, N_ORACLE, d["power"],
                                       d["phase"]))
        _check_oracle("nonfused", "complex128 beam gains",
                      g[:N_ORACLE].cpu().numpy(), want, C128_RTOL)
        calls = [lambda: ds.compute_beam_gains(params, codebook=w,
                                               to_device=True, out=g)]
        ms, wall = timed_sweep(torch, calls, reps=3)
        profile_cell(torch, "nonfused complex128 beam gains", calls)
        log(f"[nonfused] complex128 beam gains: {ms:.4f} ms per "
            f"{CHUNK}-user call (CUDA events), {CHUNK / ms * 1e3:.1f} "
            f"users/s; host wall {wall:.4f} ms")
        del ds, g
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
        torch.cuda.empty_cache()
    return launches


# Phase 5h: scenarios from disk, at the headline width.
SCEN_TX = 4                  # TX points of the multi-TX scenario
SCEN_USERS = 32_768          # its RX grid, 256 x 128 users per TX
SCEN_SNAPSHOTS = 3           # snapshots of the dynamic scenario
SCEN_OBJECTS = 300           # box buildings of the dynamic scenario's scene
V3_CHUNK = 16_384            # users per BS{i}_UE file of the v3 folders
V3_SMALL = 4_096             # users per BS of the two-BS v3 folder
CKPT_BLOCK = 8_192           # user_block of the checkpoint runs
CKPT_POLAR_BLOCK = 4_096
SCEN_MATERIALS = {
    "material_0": {"id": 0, "name": "concrete", "permittivity": 5.24,
                   "conductivity": 0.123, "scattering_model": "none"},
    "material_1": {"id": 1, "name": "glass", "permittivity": 6.27,
                   "conductivity": 0.0043, "scattering_model": "none"},
    "material_2": {"id": 2, "name": "wood", "permittivity": 1.99,
                   "conductivity": 0.0047, "scattering_model": "lambertian",
                   "scattering_coefficient": 0.3},
}


def _grid_users(n, width=256):
    """``n`` user positions on a 1 m grid ``width`` users wide."""
    i = np.arange(n)
    return np.stack([i % width, i // width, np.full(n, 1.5)],
                    1).astype(np.float32)


def _scenario_data(n_ue, seed):
    """Headline path matrices with the rest of a converted pair: LoS code
    on the first path of even users, single bounces after, NaN
    interaction positions."""
    d = make_data(n_ue, MAX_PATHS, seed=seed)
    inter = np.where(np.isnan(d["power"]), np.nan, 1.0).astype(np.float32)
    inter[::2, 0] = 0.0
    d["inter"] = inter
    d["inter_pos"] = np.full((n_ue, MAX_PATHS, 3, 3), np.nan, np.float32)
    return d


def write_scenario(dmt, folder, datas, n_ue, n_scenes=1, scene_meta=None,
                   materials=None):
    """A scenario folder with the port's writers: TX set 0 with one point
    per ``datas`` entry, RX set 1 of ``n_ue`` grid users, params.json
    (only params.json when ``datas`` is None: the root of a dynamic
    scenario; only matrices for a snapshot folder, ``n_scenes`` > 1)."""
    from deepmimo_tpu_torch.utils import save_dict_as_json, save_mat
    c = dmt.consts
    os.makedirs(folder, exist_ok=True)
    rx_pos = _grid_users(n_ue)
    for i, d in enumerate(datas or []):
        tx_pos = np.array([[40.0 * i, -10.0, 25.0]], np.float32)
        for key, value in dict(d, rx_pos=rx_pos, tx_pos=tx_pos).items():
            save_mat(value, key, folder, tx_set_idx=0, tx_idx=i,
                     rx_set_idx=1)
    if datas is not None and n_scenes > 1:
        return
    n_tx = len(datas) if datas else 1
    sets = {"txrx_set_0": ("bs", True, n_tx), "txrx_set_1": ("users",
                                                             False, n_ue)}
    scene = dict(scene_meta or {})
    scene[c.SCENE_PARAM_NUMBER_SCENES] = n_scenes
    save_dict_as_json(os.path.join(folder, "params.json"), {
        c.VERSION_PARAM_NAME: "0.1.0",
        c.RT_PARAMS_PARAM_NAME: {c.RT_PARAM_FREQUENCY: 3.5e9,
                                 c.RT_PARAM_RAYTRACER: "synthetic"},
        c.TXRX_PARAM_NAME: {key: {
            "name": name, "id": int(key[-1]), "id_orig": int(key[-1]),
            "is_tx": tx, "is_rx": not tx, "num_points": n,
            "num_active_points": n, "num_ant": 1, "dual_pol": False}
            for key, (name, tx, n) in sets.items()},
        c.SCENE_PARAM_NAME: scene,
        c.MATERIALS_PARAM_NAME: materials or {}})


def box_scene(dmt, n_objects, seed):
    """``n_objects`` box buildings on a 20 m lattice (6 quad faces each)."""
    rng = np.random.RandomState(seed)
    scene = dmt.Scene()
    side = int(math.ceil(math.sqrt(n_objects)))
    for i in range(n_objects):
        x0, y0 = 20.0 * (i % side), 20.0 * (i // side)
        w, l, h = rng.uniform(5, 15), rng.uniform(5, 15), rng.uniform(6, 60)
        lo = [[x0, y0], [x0 + w, y0], [x0 + w, y0 + l], [x0, y0 + l]]
        bottom = [[x, y, 0.0] for x, y in lo]
        top = [[x, y, h] for x, y in lo]
        quads = [bottom, top] + [
            [bottom[k], bottom[(k + 1) % 4], top[(k + 1) % 4], top[k]]
            for k in range(4)]
        scene.add_object(dmt.PhysicalElement(
            [dmt.Face(np.array(q), material_idx=i % 3) for q in quads],
            object_id=i, label="buildings", name=f"building_{i}"))
    return scene


class _Launches:
    """Render and beam-gain launches of the checked calls of a phase
    (timing loops are not counted)."""

    def __init__(self):
        self.render = self.beam_gain = 0

    def __call__(self, fn, render=0, beam_gain=0, what=""):
        """``fn()``, failing unless it launched the render kernel
        ``render`` times and the beam-gain kernel ``beam_gain`` times."""
        from deepmimo_tpu_torch.ops.kernels import beamgain as kb
        from deepmimo_tpu_torch.ops.kernels import render as kr
        import torch
        before = (kr.LAUNCHES, kb.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        got = (kr.LAUNCHES - before[0], kb.LAUNCHES - before[1])
        if got != (render, beam_gain):
            raise AssertionError(f"{what}: (render, beam-gain) launches "
                                 f"{got}, expected {(render, beam_gain)}")
        self.render += render
        self.beam_gain += beam_gain
        return out


def _peak(torch, tag):
    torch.cuda.synchronize()
    log(f"[scenarios] {tag}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()


def _same_mats(tag, got, want, keys):
    for key in keys:
        a, b = np.asarray(got[key]), np.asarray(want[key], np.float32)
        if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{tag}: loaded {key} differs from the "
                                 f"written matrix")


def _v3_source(kind, n_ue, n_polar, n_small):
    """The matrices of a phase-5h v3 folder, from seeds: "single" (``n_ue``
    users with Doppler rows), "polar" (its first ``n_polar`` users with
    four polarizations) or "two_bs" (two BS of ``n_small`` users)."""
    v3 = _scenario_data(n_ue, seed=16)
    v3.pop("inter_pos")
    rng = np.random.RandomState(16)
    nan = np.isnan(v3["power"])
    for key, lim in (("doppler_vel", 30), ("doppler_acc", 5)):
        v3[key] = np.where(nan, np.nan, rng.uniform(
            -lim, lim, nan.shape)).astype(np.float32)
    v3["rx_pos"] = _grid_users(n_ue)
    tx_pos = np.array([[0.0, -10.0, 25.0]], np.float32)
    if kind == "single":
        return dict(v3, tx_pos=tx_pos)
    if kind == "polar":
        pol = {k: v[:n_polar] for k, v in v3.items()}
        pol.update(make_pol_data(pol, seed=19), tx_pos=tx_pos)
        return pol
    return [dict({k: v[i * n_small:(i + 1) * n_small]
                  for k, v in v3.items()}, tx_pos=tx_pos + 50.0 * i)
            for i in range(2)]


def _write_v3(kind, folder, n_ue, n_polar, n_small):
    """Export one phase-5h v3 folder with the port's ``export_matlab`` (run
    in a worker process); returns its host seconds."""
    import deepmimo_tpu_torch as dmt
    t0 = time.perf_counter()
    src = _v3_source(kind, n_ue, n_polar, n_small)
    ds = (dmt.MacroDataset([dmt.Dataset(d) for d in src])
          if kind == "two_bs" else dmt.Dataset(src))
    dmt.export_matlab(ds, folder, tx_power_dbm={"single": 30.0, "polar": 0.0,
                                                "two_bs": 10.0}[kind],
                      chunk=n_polar)
    return time.perf_counter() - t0


def phase_scenarios(torch, dmt):
    """Scenarios from disk (phase 5h): multi-TX batched renders (one launch
    for all children), a dynamic scenario with a scene and materials,
    legacy v3 folders, and checkpoint/resume of the streamed render; each
    folder written by the port's own writers into a temporary directory
    that is removed at the end. Returns the checked calls' launches."""
    import tempfile
    from deepmimo_tpu_torch.generator.checkpoint import ChunkStore
    from deepmimo_tpu_torch.generator.core import DynamicDataset
    from deepmimo_tpu_torch.generator.dataset import POLS
    from deepmimo_tpu_torch.ops.channel import (unpack_planes_np,
                                                unpack_polar_planes_np)
    c = dmt.consts
    t_phase = time.perf_counter()
    counted = _Launches()
    params = make_params(dmt)
    cfg, _, _ = params.to_config(CHUNK)
    t = BS_SHAPE[0] * BS_SHAPE[1]
    w = codebook(BG_BEAMS, t, seed=75)              # phase 5b's codebook
    root = tempfile.mkdtemp(prefix="deepmimo_scenarios_")
    old = {k: dmt.config.get(k) for k in ("user_block", "checkpoint_dir")}
    torch.cuda.reset_peak_memory_stats()

    def timed(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"[scenarios] {tag}: {time.perf_counter() - t0:.3f} s (host)")
        return out

    def oracle_check(tag, ds, planes, n_pol=1, pol_mats=None):
        if n_pol == 1:
            got = [unpack_planes_np(planes[:N_ORACLE].cpu().numpy(), cfg)]
            mats = [(ds["power"], ds["phase"])]
        else:
            pcfg = params_polar.to_config(N_ORACLE)[0]
            got = unpack_polar_planes_np(planes[:N_ORACLE].cpu().numpy(),
                                         pcfg)
            mats = pol_mats
        for i, (power, phase) in enumerate(mats):
            what = tag if n_pol == 1 else f"{tag} {POLS[i]}"
            _check_oracle("scenarios", what, got[i],
                          _oracle(ds, N_ORACLE, power, phase), ORACLE_RTOL)

    params_polar = make_params(dmt)
    params_polar[c.PARAMSET_POLAR_EN] = 1
    v3_sizes = (CHUNK, V3_CHUNK, V3_SMALL)
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"))
    try:
        # (a) Multi-TX: one TX set of 4 points, a 256 x 128 RX grid.
        n_child = SCEN_USERS
        big = _scenario_data(SCEN_TX * n_child, seed=12)
        datas = [{k: v[i * n_child:(i + 1) * n_child] for k, v in
                  big.items()} for i in range(SCEN_TX)]
        folder = os.path.join(root, "multi_tx")
        timed(f"multi-TX write ({SCEN_TX} TX x {n_child} users)",
              lambda: write_scenario(dmt, folder, datas, n_child,
                                     materials=SCEN_MATERIALS))
        macro = timed("multi-TX load", lambda: dmt.load(folder))
        shutil.rmtree(folder)            # loaded: keep the disk small
        if not isinstance(macro, dmt.MacroDataset) or len(macro) != SCEN_TX:
            raise AssertionError(f"multi-TX load gave {type(macro)} of "
                                 f"{len(macro)}")
        for i, child in enumerate(macro.datasets):
            _same_mats(f"multi-TX child {i}", child, datas[i],
                       ("power", "phase", "delay", "aod_el"))
        n_all = SCEN_TX * n_child
        h = counted(lambda: macro.compute_channels_batched(
            params, to_device=True), render=1,
            what="compute_channels_batched")
        if tuple(h.shape) != (n_all, 1, t, 2 * N_SC) or \
                not bool(torch.isfinite(h).all()):
            raise AssertionError(f"batched channels {tuple(h.shape)}")
        own = []
        diff = 0.0
        for i, child in enumerate(macro.datasets):
            part = h[i * n_child:(i + 1) * n_child]
            oracle_check(f"batched child {i}", child, part)
            mine = counted(lambda: child.compute_channels(
                params, to_device=True), render=1,
                what=f"child {i} compute_channels")
            own.append(mine)
            d = float((part - mine).abs().max())
            if not d <= KERNEL_RTOL * float(mine.abs().max()):
                raise AssertionError(f"batched child {i} differs from its "
                                     f"own render by {d:.3e}")
            diff = max(diff, d)
        log(f"[scenarios] compute_channels_batched: {tuple(h.shape)}, 1 "
            f"render launch for {SCEN_TX} children; vs each child's own "
            f"render max_abs_diff={diff:.3e} (limit {KERNEL_RTOL:g} x "
            f"max|H|)")
        batched = [lambda: macro.compute_channels_batched(
            params, to_device=True, out=h)]
        per_child = [lambda ch=ch, o=o: ch.compute_channels(
            params, to_device=True, out=o)
            for ch, o in zip(macro.datasets, own)]
        ms_b, wall_b = timed_sweep(torch, batched)
        ms_c, wall_c = (SCEN_TX * x for x in timed_sweep(torch, per_child))
        log(f"[scenarios] multi-TX channels, {n_all} users: batched "
            f"{ms_b:.4f} ms per call (host wall {wall_b:.4f}), per-child "
            f"route {ms_c:.4f} ms ({SCEN_TX} calls; host wall "
            f"{wall_c:.4f}); CUDA events over 5 calls")
        profile_cell(torch, "multi-TX batched channels", batched)
        profile_cell(torch, "multi-TX per-child channels", per_child)
        del h, own, batched, per_child   # the call lists hold planes too
        g = counted(lambda: macro.compute_beam_gains_batched(
            params, codebook=w, to_device=True), beam_gain=1,
            what="compute_beam_gains_batched")
        if tuple(g.shape) != (n_all, BG_BEAMS, N_SC):
            raise AssertionError(f"batched beam gains {tuple(g.shape)}")
        diff, own = 0.0, []
        for i, child in enumerate(macro.datasets):
            part = g[i * n_child:(i + 1) * n_child]
            want = _beam_oracle(w, _oracle(child, N_ORACLE, child["power"],
                                           child["phase"]))
            _check_oracle("scenarios", f"batched beam gains child {i}",
                          part[:N_ORACLE].cpu().numpy(), want,
                          BG_ORACLE_RTOL)
            mine = counted(lambda: child.compute_beam_gains(
                params, codebook=w, to_device=True), beam_gain=1,
                what=f"child {i} compute_beam_gains")
            own.append(mine)
            d = float((part - mine).abs().max())
            if not d <= BG_RTOL * float(mine.max()):
                raise AssertionError(f"batched beam gains child {i} differ "
                                     f"from its own by {d:.3e}")
            diff = max(diff, d)
        batched = [lambda: macro.compute_beam_gains_batched(
            params, codebook=w, to_device=True)]
        ms_gb, wall_gb = timed_sweep(torch, batched)
        ms_gc, wall_gc = (SCEN_TX * x for x in timed_sweep(torch, [
            lambda ch=ch, o=o: ch.compute_beam_gains(
                params, codebook=w, to_device=True, out=o)
            for ch, o in zip(macro.datasets, own)]))
        log(f"[scenarios] compute_beam_gains_batched: {tuple(g.shape)}, 1 "
            f"beam-gain launch; vs each child's own max_abs_diff="
            f"{diff:.3e} (limit {BG_RTOL:g} x max|G|); batched {ms_gb:.4f} "
            f"ms per call (host wall {wall_gb:.4f}), per-child route "
            f"{ms_gc:.4f} ms (host wall {wall_gc:.4f}); CUDA events over "
            f"5 calls")
        profile_cell(torch, "multi-TX batched beam gains", batched)
        del g, own, batched
        # append a fifth child: the batched render sees it
        fifth = _scenario_data(V3_CHUNK // 2, seed=17)
        fifth.update(rx_pos=_grid_users(V3_CHUNK // 2),
                     tx_pos=np.array([[0.0, 200.0, 30.0]], np.float32))
        extra = dmt.Dataset(fifth)
        macro.append(extra)
        h = counted(lambda: macro.compute_channels_batched(
            params, to_device=True), render=1, what="batched after append")
        mine = counted(lambda: extra.compute_channels(
            params, to_device=True), render=1, what="appended child")
        if h.shape[0] != n_all + extra.n_ue or \
                not torch.equal(h[n_all:], mine):
            raise AssertionError(f"batched render after append: "
                                 f"{tuple(h.shape)}, fifth slice equal "
                                 f"{torch.equal(h[n_all:], mine)}")
        log(f"[scenarios] after append: {tuple(h.shape)}, the fifth "
            f"child's slice equals its own render exactly")
        del h, mine
        _peak(torch, "multi-TX")
        # scipy writes the v3 folders' cells of structs at ~0.15 ms per
        # user on one core: worker processes export them while (b) runs
        # (after (a), whose per-child route is host-bound and would slow).
        v3_jobs = {kind: pool.submit(_write_v3, kind, os.path.join(
            root, f"v3_{kind}"), *v3_sizes)
            for kind in ("single", "polar", "two_bs")}

        # (b) Dynamic: scene_0..2 of CHUNK users, a scene and materials.
        folder = os.path.join(root, "dynamic")
        scene = box_scene(dmt, SCEN_OBJECTS, seed=18)

        def write_dynamic():
            for i in range(SCEN_SNAPSHOTS):
                write_scenario(dmt, os.path.join(folder, f"scene_{i}"),
                               [_scenario_data(CHUNK, seed=13 + i)], CHUNK,
                               n_scenes=SCEN_SNAPSHOTS)
            write_scenario(dmt, folder, None, CHUNK, n_scenes=SCEN_SNAPSHOTS,
                           scene_meta=scene.export_data(folder),
                           materials=SCEN_MATERIALS)
        timed(f"dynamic write ({SCEN_SNAPSHOTS} x {CHUNK} users, "
              f"{SCEN_OBJECTS} objects)", write_dynamic)
        dyn = timed("dynamic load", lambda: dmt.load(folder))
        shutil.rmtree(folder)
        if not isinstance(dyn, DynamicDataset) or \
                dyn.n_snapshots != SCEN_SNAPSHOTS:
            raise AssertionError(f"dynamic load gave {type(dyn)}")
        if not isinstance(dyn.scene, dmt.Scene) or \
                len(dyn.scene.objects) != SCEN_OBJECTS:
            raise AssertionError(f"dynamic scene: {dyn.scene!r}")
        if not isinstance(dyn.materials, dmt.MaterialList) or \
                len(dyn.materials) != len(SCEN_MATERIALS):
            raise AssertionError(f"dynamic materials: {dyn.materials!r}")
        hs = counted(lambda: dyn.compute_channels(params, to_device=True),
                     render=SCEN_SNAPSHOTS, what="dynamic compute_channels")
        for i, (snap, hi) in enumerate(zip(dyn.datasets, hs)):
            oracle_check(f"dynamic snapshot {i}", snap, hi)
        ms_d = timed_sweep(torch, [
            lambda s=s, o=o: s.compute_channels(params, to_device=True,
                                                out=o)
            for s, o in zip(dyn.datasets, hs)])[0]
        log(f"[scenarios] dynamic: {SCEN_SNAPSHOTS} snapshots, "
            f"{len(dyn.scene.objects)} objects, {len(dyn.materials)} "
            f"materials; 1 render launch per snapshot, {ms_d:.4f} ms per "
            f"{CHUNK}-user snapshot (CUDA events over 5 sweeps)")
        del hs, dyn
        torch.cuda.empty_cache()
        _peak(torch, "dynamic")

        # (c) Legacy v3 folders, exported by the worker processes.
        what = {"single": f"single-pol ({CHUNK} users, "
                          f"{CHUNK // V3_CHUNK} chunks, 30 dBm)",
                "polar": f"dual-polar ({V3_CHUNK} users)",
                "two_bs": f"two-BS (2 x {V3_SMALL} users)"}
        for kind, future in v3_jobs.items():
            log(f"[scenarios] v3 {what[kind]} export: {future.result():.3f} "
                f"s (host, in a worker process)")
        v3 = _v3_source("single", *v3_sizes)
        folder = os.path.join(root, "v3_single")
        ds = timed("v3 single-pol load", lambda: dmt.load(folder))
        if not isinstance(ds, dmt.Dataset) or os.path.exists(
                os.path.join(folder, "params.json")):
            raise AssertionError("v3 single-pol load")
        shutil.rmtree(folder)
        _same_mats("v3 single-pol", ds, v3,
                   ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
                    "aod_el", "doppler_vel", "doppler_acc"))
        h = counted(lambda: ds.compute_channels(params, to_device=True),
                    render=1, what="v3 single-pol compute_channels")
        oracle_check("v3 single-pol", ds, h)
        ms_v = event_ms(torch, lambda: ds.compute_channels(
            params, to_device=True, out=h), 5)
        log(f"[scenarios] v3 single-pol: matrices equal the written ones "
            f"(dBm on disk at 30 dBm, dBW loaded); {ms_v:.4f} ms per "
            f"{CHUNK}-user render (CUDA events)")
        del h

        pol = _v3_source("polar", *v3_sizes)
        folder = os.path.join(root, "v3_polar")
        dual = timed("v3 dual-polar load", lambda: dmt.load(folder))
        shutil.rmtree(folder)
        _same_mats("v3 dual-polar", dual, pol,
                   [f"{k}_{p.lower()}" for p in POLS
                    for k in ("power", "phase")])
        h = counted(lambda: dual.compute_channels(params_polar,
                                                  to_device=True),
                    render=1, what="v3 dual-polar compute_channels")
        if tuple(h.shape) != (V3_CHUNK, 1, t, 2 * len(POLS) * N_SC):
            raise AssertionError(f"v3 dual-polar planes {tuple(h.shape)}")
        oracle_check("v3 dual-polar", dual, h, n_pol=len(POLS), pol_mats=[
            (dual[f"power_{p.lower()}"], dual[f"phase_{p.lower()}"])
            for p in POLS])
        ms_p = event_ms(torch, lambda: dual.compute_channels(
            params_polar, to_device=True, out=h), 5)
        log(f"[scenarios] v3 dual-polar: 1 render launch with 4 slots, "
            f"{ms_p:.4f} ms per {V3_CHUNK}-user render (CUDA events)")
        del h

        two = _v3_source("two_bs", *v3_sizes)
        folder = os.path.join(root, "v3_two_bs")
        both = timed("v3 two-BS load", lambda: dmt.load(folder))
        shutil.rmtree(folder)
        if not isinstance(both, dmt.MacroDataset) or len(both) != 2:
            raise AssertionError(f"v3 two-BS load gave {type(both)}")
        for i in range(2):
            _same_mats(f"v3 two-BS {i}", both[i], two[i],
                       ("power", "phase", "delay", "tx_pos"))
        log("[scenarios] v3 two-BS: a MacroDataset of 2, matrices equal "
            "the written ones")
        _peak(torch, "v3")

        # (d) Checkpoint/resume: child 0 of (a), cut to its 32,768 users.
        ckpt = os.path.join(root, "ckpt")
        dmt.config.set("user_block", CKPT_BLOCK)
        dmt.config.set("checkpoint_dir", ckpt)
        child0, child1 = macro[0], macro[1]
        n_blocks = n_child // CKPT_BLOCK
        first = timed(f"checkpoint first run ({n_blocks} blocks of "
                      f"{CKPT_BLOCK} written)", lambda: counted(
                          lambda: child0.compute_channels(params),
                          render=n_blocks, what="checkpoint first run"))
        (fp,) = os.listdir(ckpt)
        store = ChunkStore(ckpt, fp)
        if store.blocks() != list(range(0, n_child, CKPT_BLOCK)):
            raise AssertionError(f"checkpoint blocks {store.blocks()}")
        for start in store.blocks()[1::2]:
            os.remove(store._block_path(start))
        again = timed("checkpoint resume (2 blocks rendered)", lambda:
                      counted(lambda: child0.compute_channels(params),
                              render=2, what="checkpoint resume"))
        if not np.array_equal(again, first):
            raise AssertionError("resumed render differs from the first")
        other = counted(lambda: child1.compute_channels(params),
                        render=n_blocks, what="child 1 checkpointed")
        dmt.config.set("checkpoint_dir", None)
        plain = counted(lambda: child1.compute_channels(params), render=1,
                        what="child 1 uncheckpointed")
        if len(os.listdir(ckpt)) != 2 or not np.array_equal(other, plain):
            raise AssertionError("child 1 shared child 0's checkpoint "
                                 "blocks")
        log(f"[scenarios] checkpoint: resume equals the first run bit for "
            f"bit with 2 of {n_blocks} blocks rendered; child 1 (same "
            f"n_ue and cfg) got its own store and equals its "
            f"uncheckpointed render")
        del first, again, other, plain
        shutil.rmtree(ckpt)
        dmt.config.set("checkpoint_dir", ckpt)
        dmt.config.set("user_block", CKPT_POLAR_BLOCK)
        n_blocks = V3_CHUNK // CKPT_POLAR_BLOCK
        first = timed(f"dual-polar checkpoint first run ({n_blocks} "
                      f"blocks)", lambda: counted(
                          lambda: dual.compute_channels(params_polar),
                          render=n_blocks, what="dual-polar first run"))
        (fp,) = os.listdir(ckpt)
        store = ChunkStore(ckpt, fp)
        for start in store.blocks()[::2]:
            os.remove(store._block_path(start))
        again = timed("dual-polar checkpoint resume (2 blocks rendered)",
                      lambda: counted(
                          lambda: dual.compute_channels(params_polar),
                          render=2, what="dual-polar resume"))
        for p in POLS:
            if not np.array_equal(again[p], first[p]):
                raise AssertionError(f"dual-polar resume {p} differs")
        log("[scenarios] dual-polar checkpoint: resume equals the first "
            "run bit for bit")
        del first, again
        _peak(torch, "checkpoint")
    finally:
        pool.shutdown(cancel_futures=True)
        for k, v in old.items():
            dmt.config.set(k, v)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"[scenarios] phase 5h: {time.perf_counter() - t_phase:.1f} s "
        f"(host wall, disk writes included); launches counted: render "
        f"{counted.render}, beam gain {counted.beam_gain}")
    return {"fused_render": counted.render,
            "fused_beam_gain": counted.beam_gain}


# Phase 5i: the public surface, at the headline width.
SURF_SEED = 16
SURF_PATH_STEPS = 256        # LinearPath steps across the 256 x 512 grid
SURF_LIMITS = {"x_max": 63, "y_max": 127}    # a 64 x 128 box: 8,192 users
SURF_SERVES = 5              # serving calls timed by StageTimer
SURF_SCEN_USERS = 16_384     # users of the scenario sent through the client
STAGE_FLOOR = 0.95           # stage time >= this x the call's CUDA-event time


def _steering_codebook(dmt):
    """16 beams of ``steering_vec`` on the BS panel: 4 polar angles x 4
    azimuths; complex128 [16, T]."""
    return np.stack([dmt.steering_vec(BS_SHAPE, phi=phi, theta=theta)
                     for phi in (60.0, 80.0, 100.0, 120.0)
                     for theta in (-45.0, -15.0, 15.0, 45.0)])


def _oracle_rows(ds, rows):
    """float64 oracle channels of the users ``rows`` of ``ds``."""
    sub = {k: np.asarray(ds[k])[rows] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")}
    return _oracle(sub, len(rows), sub["power"], sub["phase"])


def _trace_check(tdir):
    """(render-kernel events, ``dm.serve`` ranges, file MB, device window
    ms, device busy ms) of the one ``xla_trace`` file written into
    ``tdir``; window and busy span every kernel, copy and memset."""
    import glob
    (path,) = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and
               "render_fwd_kernel" in e.get("name", "")]
    ranges = [e for e in events if e.get("name") == "dm.serve"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, reach = 0.0, spans[0][0] if spans else 0.0
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    window = reach - spans[0][0] if spans else 0.0
    return (kernels, ranges, os.path.getsize(path) / 2 ** 20, window / 1e3,
            busy / 1e3)


def phase_surface(torch, dmt):
    """The public surface on the card (phase 5i): sampling and subset
    renders, a steering-vector codebook through the beam-gain kernel,
    profiling (stage timers, a ``torch.profiler`` trace, the roofline) and
    the scenario database client end to end against a loopback mock.
    Returns the checked calls' launches."""
    import tempfile
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.ops.kernels import render as kr
    from deepmimo_tpu_torch.utils.profiling import (StageTimer, annotate,
                                                    renderer_roofline,
                                                    xla_trace)
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from mock_db_server import MockDatabase
    t_phase = time.perf_counter()
    counted = _Launches()
    params = make_params(dmt)
    t = BS_SHAPE[0] * BS_SHAPE[1]

    def oracle_check(tag, planes, ds, rows):
        got = unpack_planes_np(planes[rows].cpu().numpy(),
                               params.to_config(len(rows))[0])
        _check_oracle("surface", tag, got, _oracle_rows(ds, rows),
                      ORACLE_RTOL)

    # (a) Sampling: a LinearPath and a coordinate box, each a subset
    # rendered in one launch.
    d = make_data(CHUNK, MAX_PATHS, seed=SURF_SEED)
    d["rx_pos"] = _grid_users(CHUNK)
    d["tx_pos"] = np.array([[128.0, -10.0, 25.0]], np.float32)
    ds = dmt.Dataset(d)
    t0 = time.perf_counter()
    path = dmt.LinearPath(d["rx_pos"], (0, 0), (255, 511),
                          n_steps=SURF_PATH_STEPS)
    log(f"[surface] LinearPath over {CHUNK} users, {SURF_PATH_STEPS} steps: "
        f"{time.perf_counter() - t0:.3f} s (host), {len(path.idxs)} users")
    sub = ds.subset(path.idxs)
    h = counted(lambda: sub.compute_channels(params, to_device=True),
                render=1, what="LinearPath subset")
    if tuple(h.shape) != (len(path.idxs), 1, t, 2 * N_SC):
        raise AssertionError(f"LinearPath subset: {tuple(h.shape)}")
    oracle_check(f"LinearPath subset, all {len(path.idxs)} users", h, sub,
                 np.arange(len(path.idxs)))
    box = dmt.get_idxs_with_limits(d["rx_pos"], **SURF_LIMITS)
    inside = np.flatnonzero((d["rx_pos"][:, 0] <= SURF_LIMITS["x_max"]) &
                            (d["rx_pos"][:, 1] <= SURF_LIMITS["y_max"]))
    if not np.array_equal(box, inside):
        raise AssertionError(f"get_idxs_with_limits: {len(box)} users, "
                             f"{len(inside)} inside the box")
    sub = ds.subset(box)
    h = counted(lambda: sub.compute_channels(params, to_device=True),
                render=1, what="box subset")
    oracle_check(f"box subset ({len(box)} users), every 128th", h, sub,
                 np.arange(0, len(box), len(box) // N_ORACLE))
    del sub, h

    # (b) A steering-vector codebook through the beam-gain kernel.
    w = _steering_codebook(dmt)
    g = counted(lambda: ds.compute_beam_gains(params, codebook=w,
                                              to_device=True),
                beam_gain=1, what="steering-codebook beam gains")
    if tuple(g.shape) != (CHUNK, BG_BEAMS, N_SC):
        raise AssertionError(f"steering-codebook beam gains: "
                             f"{tuple(g.shape)}")
    want = _beam_oracle(w, _oracle(ds, N_ORACLE, d["power"], d["phase"]))
    _check_oracle("surface", "steering-codebook beam gains",
                  g[:N_ORACLE].cpu().numpy(), want, BG_ORACLE_RTOL)
    ms = event_ms(torch, lambda: ds.compute_beam_gains(
        params, codebook=w, to_device=True, out=g), 5)
    log(f"[surface] steering-codebook beam gains: {ms:.4f} ms per "
        f"{CHUNK}-user call (CUDA events), {CHUNK / ms * 1e3:.1f} users/s")
    del g

    # (c) Profiling: stage timers, a trace, the roofline.
    h = counted(lambda: ds.compute_channels(params, to_device=True),
                render=1, what="serving warm call")
    timer = StageTimer()
    event_times = []
    before = kr.LAUNCHES
    for _ in range(SURF_SERVES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with timer.stage("serve"), annotate("dm.serve"):
            start.record()
            ds.compute_channels(params, to_device=True, out=h)
            end.record()
        if not end.query():
            raise AssertionError("StageTimer: a stage ended before its "
                                 "render")
        event_times.append(start.elapsed_time(end))
    if kr.LAUNCHES - before != SURF_SERVES:
        raise AssertionError(f"serving stages: {kr.LAUNCHES - before} "
                             f"render launches for {SURF_SERVES} calls")
    counted.render += SURF_SERVES
    stage_ms = [dt * 1e3 for _, dt in timer.records]
    log("[surface] StageTimer 'serve' ms (CUDA-event ms): " + "; ".join(
        f"{a:.4f} ({b:.4f})" for a, b in zip(stage_ms, event_times)))
    for a, b in zip(stage_ms, event_times):
        if not a >= STAGE_FLOOR * b:
            raise AssertionError(f"StageTimer: stage {a:.4f} ms < "
                                 f"{STAGE_FLOOR} x its call's {b:.4f} ms")
    root = tempfile.mkdtemp(prefix="deepmimo_surface_")
    old = {k: dmt.config.get(k) for k in ("scenarios_folder",
                                          "api_endpoint")}
    try:
        tdir = os.path.join(root, "trace")
        t0 = time.perf_counter()
        with xla_trace(tdir):
            with annotate("dm.serve"):
                counted(lambda: ds.compute_channels(params, to_device=True,
                                                    out=h),
                        render=1, what="traced serving call")
        kernels, ranges, mb, window, busy = _trace_check(tdir)
        log(f"[surface] xla_trace: {time.perf_counter() - t0:.3f} s (host), "
            f"{mb:.2f} MB; render kernel events {len(kernels)} ("
            + ", ".join(f"{e['dur'] / 1e3:.4f} ms" for e in kernels) +
            f"), 'dm.serve' ranges {len(ranges)} ("
            + ", ".join(sorted({e.get('cat', '?') for e in ranges})) +
            f"); device window {window:.4f} ms, busy {busy:.4f} ms, idle "
            f"{100 * (1 - busy / window) if window else 0:.2f}%")
        if not kernels or not ranges:
            raise AssertionError("xla_trace: the trace lacks the render "
                                 "kernel or the dm.serve range")
        roof = renderer_roofline(CHUNK, UE_SHAPE[0] * UE_SHAPE[1], t, N_SC,
                                 MAX_PATHS)
        bound = kernel_bounds()["fused_render"][0]
        got = roof["t_memory_bound_s"] * 1e3
        if not abs(got - bound) <= 1e-9 * bound:
            raise AssertionError(f"renderer_roofline {got} ms != "
                                 f"kernel_bounds {bound} ms")
        ms = sorted(event_times)[len(event_times) // 2]
        log(f"[surface] renderer_roofline: memory bound {got:.4f} ms "
            f"(kernel_bounds {bound:.4f}), compute bound "
            f"{roof['t_compute_bound_s'] * 1e3:.4f} ms, users/s at the "
            f"bound {roof['users_per_s_sol']:.1f}; measured "
            f"{CHUNK / ms * 1e3:.1f} users/s (median {ms:.4f} ms per call)")
        del h, ds

        # (d) The scenario database client against a loopback mock.
        dmt.config.set("scenarios_folder", root)
        name = "surface_scen"
        folder = os.path.join(root, name)
        data = _scenario_data(SURF_SCEN_USERS, seed=SURF_SEED + 1)
        write_scenario(dmt, folder, [data], SURF_SCEN_USERS)
        text = dmt.summary(name, print_summary=False)
        log("[surface] summary: " + " | ".join(text.splitlines()[1:7]))
        with MockDatabase() as db:
            dmt.config.set("api_endpoint", db.url)
            t0 = time.perf_counter()
            zip_path = dmt.zip(folder)
            log(f"[surface] zip of {SURF_SCEN_USERS} users: "
                f"{time.perf_counter() - t0:.3f} s (host), "
                f"{os.path.getsize(zip_path) / 2 ** 20:.2f} MB")
            t0 = time.perf_counter()
            dmt.upload(name, key="chip-smoke", include_images=False)
            log(f"[surface] upload: {time.perf_counter() - t0:.3f} s "
                f"(host)")
            sent = db.received["submission"]
            if sent["scenario"] != name or sent["summary"] != text:
                raise AssertionError("upload: wrong submission payload")
            shutil.rmtree(folder)
            os.remove(zip_path)
            t0 = time.perf_counter()
            loaded = dmt.load(name)           # downloads, then loads
            log(f"[surface] load of the missing scenario (download + "
                f"load): {time.perf_counter() - t0:.3f} s (host)")
        if not os.path.isfile(os.path.join(folder, "params.json")) or \
                isinstance(loaded, dmt.MacroDataset):
            raise AssertionError("download: params.json is not in "
                                 f"{folder}")
        t0 = time.perf_counter()
        dmt.load(name)
        log(f"[surface] load from disk: {time.perf_counter() - t0:.3f} s "
            f"(host)")
        _same_mats("downloaded scenario", loaded, data,
                   ("power", "phase", "delay", "aoa_az", "aod_el"))
        h = counted(lambda: loaded.compute_channels(params, to_device=True),
                    render=1, what="downloaded scenario")
        oracle_check("downloaded scenario", h, loaded, np.arange(N_ORACLE))
        del h, loaded
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"[surface] phase 5i: {time.perf_counter() - t_phase:.1f} s (host "
        f"wall); launches counted: render {counted.render}, beam gain "
        f"{counted.beam_gain}")
    return {"fused_render": counted.render,
            "fused_beam_gain": counted.beam_gain}


# Phase 5j: ray-tracer outputs converted by the port, at the headline width.
CONV_SEED = 20
CONV_GRID = 256              # users per grid row: 256 x 512 at CHUNK
CONV_PARTS = 8               # .paths.p2m text parts, CONV_PY_USERS each
CONV_WORKERS = 4             # worker processes writing them
CONV_PY_USERS = 16_384       # users of the file read by both parsers
CONV_CLI_USERS = 4_096       # users of each run of the batch CLI
CONV_AODT_USERS = 1_024      # users of the AODT export (a row per path)
CONV_FREQ = 3.5e9
CONV_TX = (128.0, -10.0, 25.0)
CONV_PROJ = "conv"           # InSite project name
CONV_PATH_KEYS = ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
                  "aod_el", "inter", "inter_pos", "rx_pos", "tx_pos")
P2M_XYZ = "%.17g %.17g %.17g\n"


def conv_source(n_ue, seed=CONV_SEED):
    """One set of ray-traced paths for both engines, in float64: complex
    amplitudes (-130 to -60 dB, NaN-free; 0 past a user's paths), delays,
    angles in radians, reflection chains of 0-2 bounces (path 0 is the
    line of sight, each later path 1 or 2 reflections, the rest of
    ``vertices`` NaN), users on a grid ``CONV_GRID`` wide, about 1 in 32
    with no path."""
    rng = np.random.RandomState(seed)
    p = MAX_PATHS
    n_valid = rng.randint(1, p + 1, n_ue)
    n_valid[rng.rand(n_ue) < 1 / 32] = 0
    valid = np.arange(p)[None, :] < n_valid[:, None]
    mag = 10.0 ** (rng.uniform(-130, -60, (n_ue, p)) / 20)
    a = np.where(valid, mag * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                                      (n_ue, p))), 0)
    bounces = rng.randint(1, 3, (n_ue, p))
    bounces[:, 0] = 0
    vertices = rng.uniform(-100.0, 100.0, (2, n_ue, p, 3))
    vertices[~((np.arange(2)[:, None, None] < bounces) & valid)] = np.nan
    i = np.arange(n_ue)
    src = {"a": a, "n_valid": n_valid, "bounces": bounces,
           "vertices": vertices, "tau": rng.uniform(1e-7, 4e-6, (n_ue, p)),
           "rx_pos": np.stack([i % CONV_GRID, i // CONV_GRID,
                               np.full(n_ue, 1.5)], 1).astype(np.float64),
           "tx_pos": np.array([CONV_TX])}
    for key, (lo, hi) in (("phi_r", (-np.pi, np.pi)), ("theta_r", (0, np.pi)),
                          ("phi_t", (-np.pi, np.pi)),
                          ("theta_t", (0, np.pi))):
        src[key] = rng.uniform(lo, hi, (n_ue, p))
    return src


def write_sionna_export(folder, src):
    """The six pickles of a Sionna RT export of ``src`` (one batch, one TX;
    path types per path index: 0 line of sight, then 1 reflection
    chains), as ``converter/sionna/exporter.py`` writes them."""
    import pickle
    os.makedirs(folder, exist_ok=True)
    n, p = src["a"].shape
    paths = {"a": src["a"].reshape(1, n, 1, 1, 1, p, 1),
             "types": np.concatenate([[0.0], np.ones(p - 1)])[None],
             "vertices": src["vertices"].reshape(2, n, 1, p, 3),
             "sources": src["tx_pos"], "targets": src["rx_pos"]}
    for key in ("tau", "phi_r", "theta_r", "phi_t", "theta_t"):
        paths[key] = src[key].reshape(1, n, 1, p)
    tri = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 0, 0],
                    [10, 10, 0], [0, 10, 0]], dtype=np.float64)
    pickles = {
        "paths": [paths],
        "rt_params": {
            "frequency": CONV_FREQ, "los": True, "synthetic_array": True,
            "max_depth": 2, "reflection": True, "diffraction": False,
            "scattering": False, "num_samples": 1_000_000,
            "method": "fibonacci", "scat_random_phases": False,
            "tx_array_size": 1, "tx_array_num_ant": 1, "rx_array_size": 1,
            "rx_array_num_ant": 1, "tx_array_ant_pos": [[0, 0, 0]],
            "rx_array_ant_pos": [[0, 0, 0]]},
        "materials": [{
            "name": "itu_concrete", "relative_permittivity": 5.24,
            "conductivity": 0.123, "scattering_coefficient": 0.0,
            "xpd_coefficient": 0.0, "scattering_pattern": "LambertianPattern",
            "alpha_r": 4.0, "alpha_i": 4.0, "lambda_": 0.5}],
        "material_indices": [0], "vertices": tri,
        "objects": {"building_1": (0, 6)}}
    for name, obj in pickles.items():
        with open(os.path.join(folder, f"sionna_{name}.pkl"), "wb") as f:
            pickle.dump(obj, f)


def _p2m_path_fmt(n_bounces):
    """One path of a .paths.p2m receiver block: the data line (path number,
    interactions, power dB, phase deg, delay s, AoA el/az, AoD el/az deg),
    the interaction chain, the TX, bounce and RX positions."""
    return ("%d %d" + " %.17g" * 7 + "\n" + "Tx-" + "R-" * n_bounces +
            "Rx\n" + P2M_XYZ * (n_bounces + 2))


def p2m_header(n_rx):
    """The 21 info lines and the receiver count of a .paths.p2m file."""
    return "".join(f"# {CONV_PROJ} paths, info line {i + 1}\n"
                   for i in range(21)) + f"{n_rx}\n"


def p2m_body(src, start, stop):
    """The receiver blocks of users ``start`` to ``stop`` of ``src``, every
    number printed with ``%.17g`` from the float64 values that the Sionna
    export holds (power 20 log10|a|, phase angle(a) and the angles in
    degrees), so both engines' converters read the same numbers."""
    a = src["a"][start:stop]
    with np.errstate(divide="ignore"):
        power = 20 * np.log10(np.abs(a))
    cols = [power, np.angle(a, deg=True), src["tau"][start:stop]] + [
        np.rad2deg(src[k][start:stop])
        for k in ("theta_r", "phi_r", "theta_t", "phi_t")]
    rows = np.stack(cols, -1).tolist()                   # [U, P, 7]
    verts = np.moveaxis(src["vertices"][:, start:stop], 0, 2).reshape(
        stop - start, MAX_PATHS, 6).tolist()
    tx = src["tx_pos"][0].tolist()
    fmts = [_p2m_path_fmt(b) for b in range(3)]
    out = []
    for u in range(stop - start):
        n = int(src["n_valid"][start + u])
        out.append("%d %d\n" % (start + u + 1, n))
        if not n:
            continue
        out.append("%.17g 0 0\n" % max(r[0] for r in rows[u][:n]))
        rx = src["rx_pos"][start + u].tolist()
        for p in range(n):
            b = int(src["bounces"][start + u, p])
            out.append(fmts[b] % tuple(
                [p + 1, b] + rows[u][p] + tx + verts[u][p][:3 * b] + rx))
    return "".join(out)


def pl_text(src):
    """The .pl.p2m file of ``src``: positions, distance, and path loss
    (250 dB marks a receiver with no path)."""
    d = np.linalg.norm(src["rx_pos"] - src["tx_pos"], axis=1)
    pl = np.where(src["n_valid"] == 0, 250.0, 100.0)
    return "# <rx> <x> <y> <z> <distance> <pathloss>\n" + "".join(
        "%d %.17g %.17g %.17g %.17g %.17g\n" % (i + 1, *xyz, di, pi)
        for i, (xyz, di, pi) in enumerate(zip(src["rx_pos"].tolist(),
                                              d.tolist(), pl.tolist())))


def _setup_text(serialize, node_cls):
    """A minimal .setup: one study area (2 reflections, no diffraction or
    scattering), an isotropic antenna and a sinusoid at ``CONV_FREQ``."""
    def node(kind, name="", values=None, children=(), data=()):
        n = node_cls(kind=kind, name=name)
        n.values.update(values or {})
        n.data.extend(data)
        for ch in children:
            n.children.append(ch)
            n.values.setdefault(ch.kind, ch)
        return n
    model = node("model", values={
        "ray_spacing": 0.25, "max_reflections": 2, "max_transmissions": 0,
        "max_wedge_diffractions": 0, "terrain_diffractions": "No"})
    boundary = node("boundary", children=[node("reference", values={
        "latitude": 0.0, "longitude": 0.0})], values={"nVertices": 4},
        data=[(-600.0, -600.0, 0.0), (-600.0, 600.0, 0.0),
              (600.0, 600.0, 0.0), (600.0, -600.0, 0.0)])
    studyarea = node("studyarea", "study_area", children=[
        model, node("apg_acceleration", values={"path_depth": 2}),
        node("diffuse_scattering", values={"enabled": False}), boundary])
    return serialize([node("project", CONV_PROJ, children=[
        studyarea,
        node("antenna", "Isotropic", values={"type": "isotropic"}),
        node("Waveform", "Sinusoid", values={"CarrierFrequency": CONV_FREQ,
                                             "bandwidth": BANDWIDTH})])])


def _xml_point(x, y, z):
    return ("<ProjectedPoint><remcom::rxapi::CartesianPoint>" + "".join(
        f'<{k}><remcom::rxapi::Double Value="{v!r}"/></{k}>'
        for k, v in (("X", x), ("Y", y), ("Z", z))) +
        "</remcom::rxapi::CartesianPoint></ProjectedPoint>")


def _xml_set(kind, role, out_id, name, points, extra=""):
    return (f"<TxRxSet><remcom::rxapi::{kind}><ControlPoints>"
            "<remcom::rxapi::ProjectedPointList>" +
            "".join(_xml_point(*p) for p in points) +
            "</remcom::rxapi::ProjectedPointList></ControlPoints>" + extra +
            f'<OutputID><remcom::rxapi::Integer Value="{out_id}"/>'
            f'</OutputID><ShortDescription><remcom::rxapi::String '
            f'Value="{name}"/></ShortDescription><{role}>'
            f"<remcom::rxapi::{role}/></{role}>"
            f"</remcom::rxapi::{kind}></TxRxSet>")


def project_xml(tx_points, nx, ny, rx_id=2):
    """The project XML: TX point set 1 at ``tx_points``, RX grid set
    ``rx_id`` of nx x ny users at 1 m spacing from (0, 0, 1.5)."""
    grid = "".join(f'<{k}><remcom::rxapi::Double Value="{v!r}"/></{k}>'
                   for k, v in (("LengthX", nx - 1.0), ("LengthY", ny - 1.0),
                                ("Spacing", 1.0)))
    return ("<!DOCTYPE InSite>\n<InSite><remcom::rxapi::Job><Scene>"
            "<remcom::rxapi::Scene><TxRxSetList>"
            "<remcom::rxapi::TxRxSetList>" +
            _xml_set("PointSet", "Transmitter", 1, "BS", tx_points) +
            _xml_set("GridSet", "Receiver", rx_id, "users",
                     [(0.0, 0.0, 1.5)], grid) +
            "</remcom::rxapi::TxRxSetList></TxRxSetList>"
            "</remcom::rxapi::Scene></Scene></remcom::rxapi::Job></InSite>")


CITY_TEXT = """Format type:keyword version: 1.1.0
begin_<city> site
begin_<Material> Concrete
Material 0
begin_<DielectricLayer>
conductivity 0.123
permittivity 5.24
roughness 0.0
thickness 0.3
end_<DielectricLayer>
end_<Material>
begin_<structure_group>
begin_<structure>
begin_<sub_structure>
begin_<face>
Material 0
nVertices 4
0.0000 0.0000 0.0000
10.0000 0.0000 0.0000
10.0000 10.0000 0.0000
0.0000 10.0000 0.0000
end_<face>
end_<sub_structure>
end_<structure>
end_<structure_group>
end_<city>
"""


def write_insite_project(folder, src, body=None):
    """An InSite project of ``src`` with the port's token writer: .setup,
    .xml, .city, and under ``study_area/`` the .pl.p2m and (unless
    ``body`` is False: written apart) the .paths.p2m of TX 1 of set 1 to RX
    set 2. Returns the .paths.p2m path."""
    from deepmimo_tpu_torch.converter.insite.tokenfmt import (
        InsiteNode, serialize_insite_text)
    study = os.path.join(folder, "study_area")
    os.makedirs(study, exist_ok=True)
    n = len(src["n_valid"])
    files = {f"{CONV_PROJ}.setup": _setup_text(serialize_insite_text,
                                               InsiteNode),
             f"{CONV_PROJ}.xml": project_xml([CONV_TX], CONV_GRID,
                                             n // CONV_GRID),
             f"{CONV_PROJ}.city": CITY_TEXT,
             f"study_area/{CONV_PROJ}.pl.t001_01.r002.p2m": pl_text(src)}
    paths = os.path.join(study, f"{CONV_PROJ}.paths.t001_01.r002.p2m")
    if body is not False:
        files[os.path.relpath(paths, folder)] = p2m_header(n) + (
            body if body is not None else p2m_body(src, 0, n))
    for name, text in files.items():
        with open(os.path.join(folder, name), "w") as f:
            f.write(text)
    return paths


def write_aodt_export(folder, src):
    """An AODT parquet export of ``src`` (the tables
    ``converter/aodt/aodt_converter.py`` reads: one RU, the UEs, a polyline
    and a channel amplitude per path, the scenario's carrier); needs pandas
    and pyarrow."""
    import pandas as pd
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "sim.aodt"), "w") as f:
        f.write("aodt export marker")
    tx = src["tx_pos"][0]
    rays, cirs = [], []
    for u, n in enumerate(src["n_valid"]):
        for p in range(n):
            b = int(src["bounces"][u, p])
            pts = np.concatenate([tx, src["vertices"][:b, u, p].ravel(),
                                  src["rx_pos"][u]])
            key = {"time_idx": 0, "ru_id": 0, "ue_id": u, "path_id": p}
            rays.append(dict(key, points=pts.tolist(),
                             interaction_types=[0] + [1] * b + [5]))
            a = src["a"][u, p]
            cirs.append(dict(key, cir_re=a.real, cir_im=a.imag,
                             cir_delay=src["tau"][u, p]))
    tables = {
        "rus": pd.DataFrame([{"id": 0, "x": tx[0], "y": tx[1], "z": tx[2]}]),
        "ues": pd.DataFrame({"id": np.arange(len(src["rx_pos"])),
                             "x": src["rx_pos"][:, 0],
                             "y": src["rx_pos"][:, 1],
                             "z": src["rx_pos"][:, 2]}),
        "raypaths": pd.DataFrame(rays), "cirs": pd.DataFrame(cirs),
        "scenario": pd.DataFrame([{"carrier_frequency": CONV_FREQ,
                                   "max_depth": 2}])}
    for name, table in tables.items():
        table.to_parquet(os.path.join(folder, f"{name}.parquet"))


def _write_p2m_part(path, n_ue, seed, start, stop):
    """Write the receiver blocks of users ``start`` to ``stop`` of
    ``conv_source(n_ue, seed)`` to ``path`` (run in a worker process);
    returns its host seconds."""
    t0 = time.perf_counter()
    text = p2m_body(conv_source(n_ue, seed), start, stop)
    with open(path, "w") as f:
        f.write(text)
    return time.perf_counter() - t0


def _concat(dest, head, parts):
    with open(dest, "wb") as out:
        out.write(head.encode())
        for part in parts:
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out, 16 << 20)


def phase_convert(torch, dmt):
    """Ray-tracer outputs converted by the port (phase 5j): one set of
    131,072 users x 25 paths written as a Wireless InSite project (the
    .paths.p2m text by worker processes while the Sionna conversion runs)
    and as a Sionna RT export; ``convert`` of each (InSite through the
    native p2m parser; a 16,384-user file also through the Python parser,
    bit for bit); the two scenarios' path matrices equal bit for bit;
    ``load`` of each, one render launch each against the oracle and equal
    channels; beam gains of the Sionna scenario in one launch; the batch
    CLI over an InSite run, a Sionna run and an unclaimed folder, its
    ``--retry``, ``copy_source``; an AODT export converted and rendered
    where pandas and pyarrow are installed, else ImportError. Everything lives in a temporary directory removed
    at the end. Returns the checked calls' launches."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    from deepmimo_tpu_torch import native
    from deepmimo_tpu_torch.converter.insite.p2m import parse_paths_p2m
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.scripts.convert_cli import (convert_folder_loop,
                                                        main as cli_main)
    from deepmimo_tpu_torch.utils import get_mat_filename, load_mat
    t_phase = time.perf_counter()
    counted = _Launches()
    params = make_params(dmt)
    cfg, _, _ = params.to_config(CHUNK)
    t = BS_SHAPE[0] * BS_SHAPE[1]
    root = tempfile.mkdtemp(prefix="deepmimo_convert_")
    old = dmt.config.get("scenarios_folder")
    dmt.config.set("scenarios_folder", os.path.join(root, "scenarios"))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def timed(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        log(f"[convert] {tag}: {dt:.3f} s (host)")
        return out, dt

    def quiet(fn):
        """``fn()`` with its standard output (the converters' chatter)
        dropped."""
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    if not native.p2m_native.available():
        raise AssertionError("the native p2m parser did not build")
    pool = ProcessPoolExecutor(CONV_WORKERS, mp_context=multiprocessing
                               .get_context("spawn"))
    try:
        src, _ = timed(f"source paths ({CHUNK} users x {MAX_PATHS})",
                       lambda: conv_source(CHUNK))
        insite_dir = os.path.join(root, "insite_run")
        sionna_dir = os.path.join(root, "sionna_run")
        parts = [os.path.join(root, f"part{i}.txt")
                 for i in range(CONV_PARTS)]
        jobs = [pool.submit(_write_p2m_part, part, CHUNK, CONV_SEED,
                            i * CONV_PY_USERS, (i + 1) * CONV_PY_USERS)
                for i, part in enumerate(parts)]
        t_text = time.perf_counter()
        timed("Sionna export write (6 pickles)",
              lambda: write_sionna_export(sionna_dir, src))
        timed("InSite project write (.setup, .xml, .city, .pl.p2m)",
              lambda: write_insite_project(insite_dir, src, body=False))
        sionna_name, sionna_s = timed("Sionna convert", lambda: dmt.convert(
            sionna_dir, overwrite=True, scenario_name="conv_sionna"))
        part_s = [job.result() for job in jobs]
        pool.shutdown()
        log(f"[convert] .paths.p2m text, {CONV_PARTS} parts of "
            f"{CONV_PY_USERS} users in {CONV_WORKERS} worker processes: "
            f"{max(part_s):.3f} s per part at most, "
            f"{time.perf_counter() - t_text:.3f} s wall beside the Sionna "
            f"convert (host)")
        paths_file = os.path.join(insite_dir, "study_area",
                                  f"{CONV_PROJ}.paths.t001_01.r002.p2m")
        timed("InSite .paths.p2m assembly", lambda: _concat(
            paths_file, p2m_header(CHUNK), parts))
        small = os.path.join(root, "small.paths.p2m")
        _concat(small, p2m_header(CONV_PY_USERS), parts[:1])
        for part in parts:
            os.remove(part)
        log(f"[convert] .paths.p2m: {os.path.getsize(paths_file) / 2**20:.1f}"
            f" MB for {CHUNK} users; {os.path.getsize(small) / 2**20:.1f} MB "
            f"for {CONV_PY_USERS}")
        before = native.NATIVE_PARSES
        insite_name, insite_s = timed(
            "InSite convert (native p2m parser)", lambda: dmt.convert(
                insite_dir, overwrite=True, scenario_name="conv_insite"))
        if native.NATIVE_PARSES != before + 1:
            raise AssertionError(f"InSite convert: "
                                 f"{native.NATIVE_PARSES - before} native "
                                 f"parses, expected 1")
        whole, whole_s = timed(f"native parse of the whole .paths.p2m "
                               f"({CHUNK} users) alone", lambda:
                               parse_paths_p2m(paths_file))
        del whole
        nat, nat_s = timed(f"native parse, {CONV_PY_USERS} users",
                           lambda: parse_paths_p2m(small, use_native=True))
        py, py_s = timed(f"Python parse, {CONV_PY_USERS} users",
                         lambda: parse_paths_p2m(small, use_native=False))
        if native.NATIVE_PARSES != before + 3:
            raise AssertionError("the native parse of the small file fell "
                                 "back to Python")
        for key in nat:
            if not np.array_equal(nat[key], py[key], equal_nan=True):
                raise AssertionError(f"native and Python parses differ in "
                                     f"{key}")
        log(f"[convert] native == Python parse bit for bit on "
            f"{CONV_PY_USERS} users ({len(nat)} matrices); native "
            f"{nat_s:.3f} s, Python {py_s:.3f} s ({py_s / nat_s:.1f}x); "
            f"convert: InSite {insite_s:.3f} s (its native parse alone "
            f"{whole_s:.3f} s), Sionna {sionna_s:.3f} s")
        del nat, py, src

        # Gate 1: the two scenarios' path matrices, bit for bit.
        folders = {e: dmt.get_scenario_folder(n) for e, n in (
            ("insite", insite_name), ("sionna", sionna_name))}
        for key in CONV_PATH_KEYS:
            fname = get_mat_filename(key, 0, 0, 1)
            a, b = (load_mat(os.path.join(f, fname), key)
                    for f in folders.values())
            if a.shape != b.shape or a.dtype != b.dtype or \
                    not np.array_equal(a, b, equal_nan=True):
                raise AssertionError(f"converted {key} differs: InSite "
                                     f"{a.shape} {a.dtype}, Sionna {b.shape}"
                                     f" {b.dtype}")
        log(f"[convert] InSite == Sionna path matrices bit for bit: "
            f"{', '.join(CONV_PATH_KEYS)}")

        # Gates 2-4: load, render each in one launch, the oracle.
        loaded = {}
        planes = {}
        for engine, name in (("insite", insite_name),
                             ("sionna", sionna_name)):
            ds, _ = timed(f"{engine} scenario load", lambda: dmt.load(name))
            if not isinstance(ds, dmt.Dataset) or ds.n_ue != CHUNK:
                raise AssertionError(f"{engine} load gave {type(ds)}")
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            h = counted(lambda: ds.compute_channels(params, to_device=True),
                        render=1, what=f"{engine} compute_channels")
            log(f"[convert] {engine} compute_channels: peak device memory "
                f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f}"
                f" GiB above the {base / 2 ** 30:.3f} GiB held before it, "
                f"{h.numel() * h.element_size() / 2 ** 30:.3f} GiB of it "
                f"the planes")
            if tuple(h.shape) != (CHUNK, 1, t, 2 * N_SC) or \
                    not bool(torch.isfinite(h).all()):
                raise AssertionError(f"{engine} channels {tuple(h.shape)}")
            _check_oracle("convert", f"{engine} channels", unpack_planes_np(
                h[:N_ORACLE].cpu().numpy(), cfg), _oracle(
                    ds, N_ORACLE, ds["power"], ds["phase"]), ORACLE_RTOL)
            ms = event_ms(torch, lambda: ds.compute_channels(
                params, to_device=True, out=h), 5)
            log(f"[convert] {engine} channels: 1 render launch, {ms:.4f} ms "
                f"per {CHUNK}-user call (CUDA events over 5 calls)")
            profile_cell(torch, f"converted {engine} channels", [
                lambda: ds.compute_channels(params, to_device=True, out=h)])
            loaded[engine], planes[engine] = ds, h
        if not torch.equal(planes["insite"], planes["sionna"]):
            raise AssertionError("the two converted scenarios' channels "
                                 "differ")
        log("[convert] InSite and Sionna channels equal bit for bit")
        del planes
        ds = loaded.pop("sionna")
        w = codebook(BG_BEAMS, t, seed=75)
        g = counted(lambda: ds.compute_beam_gains(params, codebook=w,
                                                  to_device=True),
                    beam_gain=1, what="converted beam gains")
        if tuple(g.shape) != (CHUNK, BG_BEAMS, N_SC):
            raise AssertionError(f"converted beam gains {tuple(g.shape)}")
        _check_oracle("convert", "Sionna beam gains",
                      g[:N_ORACLE].cpu().numpy(), _beam_oracle(w, _oracle(
                          ds, N_ORACLE, ds["power"], ds["phase"])),
                      BG_ORACLE_RTOL)
        ms = event_ms(torch, lambda: ds.compute_beam_gains(
            params, codebook=w, to_device=True, out=g), 5)
        log(f"[convert] Sionna beam gains: 1 beam-gain launch, {ms:.4f} ms "
            f"per {CHUNK}-user call (CUDA events over 5 calls)")
        del g, ds, loaded
        torch.cuda.synchronize()
        log(f"[convert] peak device memory from the Sionna render on "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
            f"{held / 2 ** 30:.3f} GiB held before the phase")
        shutil.rmtree(dmt.config.get("scenarios_folder"))
        shutil.rmtree(insite_dir)
        shutil.rmtree(sionna_dir)

        # Gate 5: the batch CLI over two runs and an unclaimed folder.
        runs = os.path.join(root, "runs")
        small_src = conv_source(CONV_CLI_USERS, seed=CONV_SEED + 1)
        timed(f"CLI runs write ({CONV_CLI_USERS} users each)", lambda: (
            write_insite_project(os.path.join(runs, "cli_insite"),
                                 small_src),
            write_sionna_export(os.path.join(runs, "cli_sionna"),
                                small_src),
            os.makedirs(os.path.join(runs, "cli_unclaimed"))))
        err_log = os.path.join(root, "conversion_errors.json")
        report, _ = timed("convert_folder_loop", lambda: quiet(
            lambda: convert_folder_loop(runs, error_log=err_log)))
        if sorted(report["converted"]) != ["cli_insite", "cli_sionna"] or \
                [e[0] for e in report["errors"]] != ["cli_unclaimed"] or \
                not os.path.exists(err_log):
            raise AssertionError(f"convert_folder_loop report {report}")
        log(f"[convert] convert_folder_loop: converted "
            f"{report['converted']} (s: {report['timing_s']}), errors "
            f"{report['errors']}; error log written")
        write_sionna_export(os.path.join(runs, "cli_unclaimed"), small_src)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main([runs, "--retry", "--error-log", err_log])
        retry = json.loads(out.getvalue().strip().splitlines()[-1])
        if rc != 0 or retry["converted"] != ["cli_unclaimed"] or \
                retry["errors"] or os.path.exists(err_log):
            raise AssertionError(f"--retry: rc {rc}, report {retry}")
        log(f"[convert] --retry read the error log: converted "
            f"{retry['converted']} only, rc 0, log removed")
        zipped, _ = timed("InSite convert with copy_source (zip)",
                          lambda: quiet(lambda: dmt.convert(
                              os.path.join(runs, "cli_insite"),
                              overwrite=True, copy_source=True,
                              scenario_name="cli_insite_src")))
        zip_path = os.path.join(dmt.get_scenario_folder(zipped),
                                "rt_source.zip")
        if not os.path.isfile(zip_path):
            raise AssertionError("copy_source wrote no rt_source.zip")
        log(f"[convert] copy_source: rt_source.zip "
            f"{os.path.getsize(zip_path) / 2 ** 20:.2f} MB")

        # AODT reads parquet tables through pandas and pyarrow: converted
        # and rendered where both are installed, else ImportError.
        aodt = os.path.join(runs, "aodt_run")
        if all(importlib.util.find_spec(m) for m in ("pandas", "pyarrow")):
            aodt_src = conv_source(CONV_AODT_USERS, seed=CONV_SEED + 2)
            timed(f"AODT export write ({CONV_AODT_USERS} users)",
                  lambda: write_aodt_export(aodt, aodt_src))
            name, _ = timed("AODT convert", lambda: quiet(
                lambda: dmt.convert(aodt, overwrite=True,
                                    scenario_name="conv_aodt")))
            ds = dmt.load(name)
            delay = np.asarray(ds["delay"])
            want = np.where(np.arange(MAX_PATHS) < aodt_src["n_valid"][
                :, None], aodt_src["tau"], np.nan).astype(np.float32)
            if ds.n_ue != CONV_AODT_USERS or not np.array_equal(
                    delay, want[:, :delay.shape[1]], equal_nan=True):
                raise AssertionError("AODT convert: wrong users or delays")
            h = counted(lambda: ds.compute_channels(params, to_device=True),
                        render=1, what="AODT compute_channels")
            _check_oracle("convert", "AODT channels", unpack_planes_np(
                h[:N_ORACLE].cpu().numpy(), cfg), _oracle(
                    ds, N_ORACLE, ds["power"], ds["phase"]), ORACLE_RTOL)
            del h, ds
        else:
            os.makedirs(aodt)
            with open(os.path.join(aodt, "sim.aodt"), "w") as f:
                f.write("aodt export marker")
            try:
                quiet(lambda: dmt.convert(aodt, overwrite=True))
            except ImportError as e:
                log(f"[convert] AODT without pandas/pyarrow: ImportError "
                    f"({e})")
            else:
                raise AssertionError("AODT convert without pandas did not "
                                     "raise ImportError")
    finally:
        pool.shutdown(cancel_futures=True)
        dmt.config.set("scenarios_folder", old)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"[convert] phase 5j: {time.perf_counter() - t_phase:.1f} s (host "
        f"wall, disk writes included); launches counted: render "
        f"{counted.render}, beam gain {counted.beam_gain}")
    return {"fused_render": counted.render,
            "fused_beam_gain": counted.beam_gain}


# Phase 5k: the scenario factory on the card, at the headline width.
FACT_SEED = 24
FACT_SPACING = 2.0           # m between the pipeline's grid users
FACT_BS_HEIGHT = 25.0
FACT_POPULATION = 100_000    # csvgen's --min-population
FACT_CITIES = ("city,city_ascii,lat,lng,population\n"
               "Tempe,Tempe,33.4255,-111.9400,180587\n"
               "Smallville,Smallville,40.0,-90.0,1200\n"
               "Jersey City,Jersey City,40.7178,-74.0431,292449\n")
FACT_FOV = (120, 180)        # bs_fov of the adapter's second run
FACT_CDL_MAT_USERS = 16_384  # users save_cdl_mat writes (~0.15 ms a user)
FACT_CIR_USERS = 4           # users synthesize_cdl_cir evaluates
FACT_BLOCK = 16_384          # users per block of the tau alignment check


def factory_box(bbox, n_x, n_y, spacing):
    """``bbox`` (min_lat, min_lon, max_lat, max_lon) resized about its
    centre so that ``gen_rx_grid`` at ``spacing`` places ``n_x`` x ``n_y``
    users: each side ``(n - 1) * spacing + spacing / 2`` m, half a
    spacing clear of the next grid line either way."""
    from deepmimo_tpu_torch.pipelines.geo_utils import (METERS_PER_DEG_LAT,
                                                        bbox_center,
                                                        meters_per_deg_lon)
    lat_c, lon_c = bbox_center(bbox)
    half_x = ((n_x - 1) * spacing + spacing / 2) / 2
    half_y = ((n_y - 1) * spacing + spacing / 2) / 2
    dlon = half_x / meters_per_deg_lon(lat_c)
    dlat = half_y / METERS_PER_DEG_LAT
    return tuple(float(v) for v in (lat_c - dlat, lon_c - dlon,
                                    lat_c + dlat, lon_c + dlon))


def tau_alignment(ch, tau, ref_ch, ref_tau, tol):
    """Under an FoV, is each column's ``tau`` the delay of the path whose
    gains sit in that column? ``ch``/``tau`` are the adapter's time-domain
    channels [U, R, T, P] and delays [U, P]; ``ref_*`` the same without
    the FoV (every path in its own column). A non-empty column j of user
    u passes when some path k has ``ref_tau[u, k] == tau[u, j]`` and
    ``ref_ch[u, ..., k]`` within ``tol`` of ``ch[u, ..., j]``; an empty
    column needs ``tau`` 0. Returns (columns checked, columns failed,
    users whose raw delay matrix would misplace a column)."""
    checked = failed = moved = 0
    for s in range(0, ch.shape[0], FACT_BLOCK):
        c, t = ch[s:s + FACT_BLOCK], tau[s:s + FACT_BLOCK]
        rc, rt = ref_ch[s:s + FACT_BLOCK], ref_tau[s:s + FACT_BLOCK]
        full = np.abs(c).max(axis=(1, 2)) > 0                       # [u, P]
        same = t[:, :, None] == rt[:, None, :]                      # [u,P,P]
        u, j, k = np.nonzero(same & full[:, :, None])
        close = np.abs(c[u, :, :, j] - rc[u, :, :, k]).max(axis=(1, 2)) \
            <= tol
        hit = np.zeros_like(full)
        hit[u[close], j[close]] = True
        checked += int(full.sum())
        failed += int((full & ~hit).sum() + (t[~full] != 0).sum())
        moved += int(((t != rt) & full).any(axis=1).sum())
    return checked, failed, moved


def phase_factory(torch, dmt):
    """The scenario factory on the card (phase 5k), at the headline width:
    ``csv_gen_cli`` on a three-city CSV, its rows read back by the runner,
    one row's box set to a 256 x 512 grid of users at 2 m; its InSite
    project (one inferred grid set) read back by the port's converter; the
    Blender script compiled; a Sionna export at those positions standing in
    for the ray tracers (no Blender or Sionna RT on the card), the row's
    ``scene`` and ``raytrace`` stages marked done; ``run_pipeline`` with an
    upload key against a loopback mock of the database: the row converts
    and uploads, the other row fails at ``fetch_osm_scene`` and is marked
    ``error``; the scenario loaded back by download, one render launch and
    one beam-gain launch against the oracle; ``DeepMIMOSionnaAdapter``
    over every user (time-domain channels, users per second, memory),
    against the time-domain oracle, and again under ``apply_fov`` with each
    column's delay its path's; ``export_cdl``, ``save_cdl_mat`` and
    ``synthesize_cdl_cir``; ``stats_cli --json``. Everything lives in a
    temporary directory removed at the end. Returns the checked calls'
    launches."""
    import contextlib
    import csv
    import io
    import tempfile
    import scipy.io
    from deepmimo_tpu_torch.converter.insite.rt_params import read_rt_params
    from deepmimo_tpu_torch.converter.insite.txrx import read_txrx
    from deepmimo_tpu_torch.integrations import (CDLConfig, export_cdl,
                                                 save_cdl_mat,
                                                 synthesize_cdl_cir)
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from deepmimo_tpu_torch.pipelines import (gen_rx_grid, gen_tx_pos,
                                              read_pipeline_csv,
                                              run_pipeline)
    from deepmimo_tpu_torch.pipelines.blender_osm import (
        build_blender_script, find_blender)
    from deepmimo_tpu_torch.pipelines.insite_project import \
        write_insite_project
    from deepmimo_tpu_torch.pipelines.runner import PipelineState
    from deepmimo_tpu_torch.scripts import csv_gen_cli, stats_cli
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    from mock_db_server import MockDatabase
    t_phase = time.perf_counter()
    counted = _Launches()
    params = make_params(dmt)
    cfg, _, _ = params.to_config(CHUNK)
    t = BS_SHAPE[0] * BS_SHAPE[1]
    n_x, n_y = CONV_GRID, CHUNK // CONV_GRID
    root = tempfile.mkdtemp(prefix="deepmimo_factory_")
    old = {k: dmt.config.get(k) for k in ("scenarios_folder",
                                          "api_endpoint")}
    dmt.config.set("scenarios_folder", os.path.join(root, "scenarios"))
    dmt.config.set("api_endpoint", "http://127.0.0.1:1")
    work = os.path.join(root, "work")

    def timed(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"[factory] {tag}: {time.perf_counter() - t0:.3f} s (host)")
        return out

    def quiet(fn):
        """``fn()`` with its standard output and error captured; returns
        (result, the captured text)."""
        text = io.StringIO()
        with contextlib.redirect_stdout(text), \
                contextlib.redirect_stderr(text):
            out = fn()
        return out, text.getvalue()

    try:
        # (a) Sites: csvgen over three cities (one under the population
        # floor), read back by the runner; row 0's box set to the grid.
        cities = os.path.join(root, "worldcities.csv")
        with open(cities, "w", encoding="utf-8") as f:
            f.write(FACT_CITIES)
        sites = os.path.join(root, "sites.csv")
        rc, _ = timed("csv_gen_cli", lambda: quiet(lambda: csv_gen_cli.main(
            [cities, sites, "--box-m", "400", "--num-bs", "1",
             "--bs-height", f"{FACT_BS_HEIGHT:g}", "--min-population",
             str(FACT_POPULATION)])))
        rows = read_pipeline_csv(sites)
        if rc != 0 or [r.name for r in rows] != ["city_0000_tempe",
                                                 "city_0001_jersey_city"]:
            raise AssertionError(f"csv_gen_cli: rc {rc}, rows "
                                 f"{[r.name for r in rows]}")
        row, other = rows
        (row.min_lat, row.min_lon, row.max_lat, row.max_lon) = factory_box(
            row.gps_bbox, n_x, n_y, FACT_SPACING)
        with open(sites, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "min_lat", "min_lon", "max_lat", "max_lon",
                        "bs_lat", "bs_lon", "bs_height"])
            for r in rows:
                w.writerow([r.name, *(repr(x) for x in r.gps_bbox)] + [
                    "|".join(repr(x) for x in v) for v in (
                        r.bs_lats, r.bs_lons, r.bs_heights)])
        if read_pipeline_csv(sites)[0].gps_bbox != row.gps_bbox:
            raise AssertionError("the sites CSV did not keep row 0's box")
        rt = {"gps_bbox": row.gps_bbox, "bs_lats": row.bs_lats,
              "bs_lons": row.bs_lons, "bs_heights": row.bs_heights,
              "grid_spacing": FACT_SPACING, "ue_height": 1.5,
              "frequency": CONV_FREQ, "name": row.name}
        rx = gen_rx_grid(rt)
        tx = gen_tx_pos(rt)
        if rx.shape != (CHUNK, 3) or tx.shape != (1, 3) or \
                tx[0, 2] != FACT_BS_HEIGHT:
            raise AssertionError(f"placement: {rx.shape} users, BS {tx}")
        log(f"[factory] {len(rows)} sites from {FACT_CITIES.count(chr(10)) - 1}"
            f" cities; {row.name}: gen_rx_grid {n_x} x {n_y} = {len(rx)} "
            f"users at {FACT_SPACING:g} m, BS at {tx[0].round(3).tolist()}")

        # (b) Projects: the InSite project (one inferred grid set) read
        # back by the port's converter; the Blender script compiles.
        row_dir = os.path.join(work, row.name)
        proj = os.path.join(row_dir, "insite_project")
        timed("write_insite_project", lambda: write_insite_project(
            row_dir, proj, tx, rx, rt))
        with open(os.path.join(proj, f"{row.name}.xml")) as f:
            xml = f.read()
        setup, sets, locations = timed("InSite setup read back", lambda: (
            read_rt_params(proj), *quiet(lambda: read_txrx(proj))[0]))
        users = [i for i, s in enumerate(sets.values()) if s["is_rx"]]
        if xml.count("<remcom::rxapi::GridSet>") != 1 or len(users) != 1 \
                or setup["frequency"] != CONV_FREQ or \
                not np.allclose(locations[users[0]], rx, atol=1e-6):
            raise AssertionError("InSite project: not one grid set of the "
                                 "users at the frequency")
        script = build_blender_script(row.gps_bbox,
                                      os.path.join(row_dir, "osm"))
        compile(script, "osm_export.py", "exec")
        if "deepmimo_tpu" in script:
            raise AssertionError("the Blender script names a package")
        log(f"[factory] InSite project: one grid set, {len(rx)} users read "
            f"back; Blender script {len(script)} chars compiles")

        # (c) Ray-tracer output: a Sionna export at the placement.
        src = timed(f"source paths ({CHUNK} users x {MAX_PATHS})",
                    lambda: conv_source(CHUNK, seed=FACT_SEED))
        src["rx_pos"], src["tx_pos"] = rx, tx
        timed("Sionna export write", lambda: write_sionna_export(
            os.path.join(row_dir, "rt_output"), src))
        state = PipelineState(work)
        for stage in ("scene", "raytrace"):
            state.mark(row.name, stage)
        n_valid = src["n_valid"]
        del src

        # (d) The pipeline: converts and uploads row 0; row 1 has no
        # Blender.
        if find_blender() is not None:
            raise AssertionError(f"Blender found at {find_blender()}: the "
                                 "phase expects the OSM stage to fail")
        with MockDatabase() as db:
            dmt.config.set("api_endpoint", db.url)
            done, text = timed("run_pipeline (convert + upload, 2 rows)",
                               lambda: quiet(lambda: run_pipeline(
                                   sites, work, raytracer="sionna",
                                   upload_key="chip-smoke",
                                   grid_spacing=FACT_SPACING)))
            state = PipelineState(work).state
            if done != [row.name] or any(
                    state[row.name].get(s) != "done"
                    for s in ("convert", "upload")) or \
                    "Blender" not in state.get(other.name, {}).get(
                        "error", "") or \
                    db.received["submission"]["scenario"] != row.name:
                raise AssertionError(f"run_pipeline: completed {done}, "
                                     f"state {state}, output {text[-2000:]}")
            log(f"[factory] run_pipeline: completed {done}; state "
                f"{state[row.name]}; {other.name} error: "
                f"{state[other.name]['error'][:60]!r}; archive "
                f"{len(db.received['zip']) / 2 ** 20:.1f} MB; "
                + ("images skipped (no matplotlib)" if "Image upload "
                   "skipped" in text else "images uploaded"))

            # (e) Render: loaded back by download.
            shutil.rmtree(dmt.get_scenario_folder(row.name))
            ds = timed("load by download", lambda: quiet(
                lambda: dmt.load(row.name))[0])
        if not isinstance(ds, dmt.Dataset) or ds.n_ue != CHUNK or not \
                np.allclose(ds.rx_pos, rx, atol=1e-3):
            raise AssertionError("downloaded scenario: wrong users")
        h = counted(lambda: ds.compute_channels(params, to_device=True),
                    render=1, what="pipeline scenario compute_channels")
        if tuple(h.shape) != (CHUNK, 1, t, 2 * N_SC):
            raise AssertionError(f"channels {tuple(h.shape)}")
        _check_oracle("factory", "channels", unpack_planes_np(
            h[:N_ORACLE].cpu().numpy(), cfg), _oracle(
                ds, N_ORACLE, ds["power"], ds["phase"]), ORACLE_RTOL)
        ms = event_ms(torch, lambda: ds.compute_channels(
            params, to_device=True, out=h), 5)
        log(f"[factory] channels: 1 render launch, {ms:.4f} ms per "
            f"{CHUNK}-user call (CUDA events over 5 calls)")
        del h
        w = codebook(BG_BEAMS, t, seed=75)
        g = counted(lambda: ds.compute_beam_gains(params, codebook=w,
                                                  to_device=True),
                    beam_gain=1, what="pipeline scenario beam gains")
        if tuple(g.shape) != (CHUNK, BG_BEAMS, N_SC):
            raise AssertionError(f"beam gains {tuple(g.shape)}")
        _check_oracle("factory", "beam gains", g[:N_ORACLE].cpu().numpy(),
                      _beam_oracle(w, _oracle(ds, N_ORACLE, ds["power"],
                                              ds["phase"])), BG_ORACLE_RTOL)
        del g
        torch.cuda.empty_cache()

        # (f) Downstream: the Sionna adapter over every user, then under
        # an FoV.
        def adapter(tag):
            before = _kernel_launches()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a = timed(f"DeepMIMOSionnaAdapter ({tag}; time-domain "
                      f"channels)", lambda: dmt.DeepMIMOSionnaAdapter(ds))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ch, dl = a._channels[0], a._delays[0]
            if _kernel_launches() != before:
                raise AssertionError("the adapter launched a fused kernel")
            if ch.shape != (CHUNK, 1, t, MAX_PATHS) or ch.dtype != \
                    np.complex64 or a.num_paths != MAX_PATHS or \
                    a.num_tx_ant != t or len(a) != CHUNK:
                raise AssertionError(f"adapter: {ch.shape} {ch.dtype}")
            log(f"[factory] adapter ({tag}): channels {ch.shape} "
                f"{ch.dtype} ({ch.nbytes / 1e9:.2f} GB on the host, delays "
                f"{dl.nbytes / 1e6:.1f} MB); peak device memory "
                f"{peak / 2 ** 30:.3f} GiB above the "
                f"{base / 2 ** 30:.3f} GiB held; no fused launch")
            return a

        def first_yields(a):
            got, taus = [], []
            for i, (x, tau) in enumerate(a()):
                if i == N_ORACLE:
                    break
                got.append(x[0, :, 0, :, :, 0])
                taus.append(tau[0, 0])
            return np.stack(got), np.stack(taus)

        ad = adapter("no FoV")
        n = 0
        t0 = time.perf_counter()
        for x, tau in ad():
            n += 1
        dt = time.perf_counter() - t0
        if n != CHUNK:
            raise AssertionError(f"adapter yielded {n} samples")
        log(f"[factory] adapter: {n} yields of {x.shape} {x.dtype} + "
            f"{tau.shape} in {dt:.3f} s (host), {n / dt:.1f} users/s; none "
            f"kept")
        got, taus = first_yields(ad)
        _check_oracle("factory", "adapter time-domain yields", got, _oracle(
            ds, N_ORACLE, ds["power"], ds["phase"], freq_domain=False),
            ORACLE_RTOL)
        want = np.nan_to_num(np.asarray(ds["delay"])[:N_ORACLE, :MAX_PATHS])
        if not np.array_equal(taus, want.astype(np.float32)):
            raise AssertionError("adapter tau differs from the delays")
        ref_ch, ref_tau = ad._channels[0], ad._delays[0]
        del ad
        ds.apply_fov(bs_fov=np.array(FACT_FOV))
        fov = adapter(f"bs_fov {FACT_FOV}")
        got, _ = first_yields(fov)
        _check_oracle("factory", f"adapter under bs_fov {FACT_FOV}", got,
                      _oracle(ds, N_ORACLE, ds["power"], ds["phase"],
                              freq_domain=False,
                              bs_fov=tuple(float(v) for v in FACT_FOV)),
                      ORACLE_RTOL)
        checked, failed, moved = timed("tau alignment check", lambda:
                                       tau_alignment(
                                           fov._channels[0], fov._delays[0],
                                           ref_ch, ref_tau,
                                           ORACLE_RTOL * float(np.abs(
                                               ref_ch[:N_ORACLE]).max())))
        if failed or not checked or not moved:
            raise AssertionError(f"adapter under FoV: {failed} of {checked} "
                                 f"columns with another path's delay; "
                                 f"{moved} users with moved paths")
        log(f"[factory] adapter under FoV: every one of {checked} kept "
            f"columns carries its own path's delay, empty columns 0; "
            f"{moved} users had a kept path moved forward (their raw delay "
            f"matrix would misplace it)")
        del fov, ref_ch, ref_tau
        ds.apply_fov()

        # (g) NR CDL export.
        cdl = timed(f"export_cdl ({CHUNK} users)", lambda: export_cdl(
            ds, CDLConfig()))
        active = [u for u, x in enumerate(cdl) if x is not None]
        power = np.asarray(ds["power"])
        if len(cdl) != CHUNK or len(active) != int((n_valid > 0).sum()) or \
                not np.array_equal(cdl[active[0]]["PathDelays"], np.asarray(
                    ds["delay"], np.float64)[active[0]][~np.isnan(
                        power[active[0]])]):
            raise AssertionError("export_cdl: wrong users or delays")
        mat = os.path.join(root, "cdl_users.mat")
        n_mat = min(FACT_CDL_MAT_USERS, CHUNK)
        timed(f"save_cdl_mat ({n_mat} users)",
              lambda: save_cdl_mat(cdl[:n_mat], mat))
        back = scipy.io.loadmat(mat, squeeze_me=True)["cdl_users"]
        if back.shape != (n_mat,) or [
                int(np.asarray(r["NumPaths"])) for r in back[:64]] != [
                0 if x is None else len(x["PathDelays"]) for x in cdl[:64]]:
            raise AssertionError("save_cdl_mat: wrong read-back")
        t_cir = np.linspace(0, 1e-3, 8)
        for u in active[:FACT_CIR_USERS]:
            cir = synthesize_cdl_cir(cdl[u], t_cir)
            amp = 10 ** (np.asarray(cdl[u]["AveragePathGains"]) / 20)
            if cir.shape != (8, len(amp)) or not np.allclose(
                    np.abs(cir), amp[None], rtol=1e-9):
                raise AssertionError("synthesize_cdl_cir: wrong CIR")
        log(f"[factory] export_cdl: {len(active)} of {CHUNK} users active; "
            f"save_cdl_mat read back ({os.path.getsize(mat) / 2 ** 20:.1f} "
            f"MB); {FACT_CIR_USERS} CIRs of constant |a_p|")
        del cdl

        # (h) Statistics of the scenario.
        (rc, out) = timed("stats_cli --json", lambda: quiet(
            lambda: stats_cli.main([row.name, "--json"])))
        stats = json.loads(out[out.index("[\n"):])
        cov = round(100.0 * float((n_valid > 0).mean()), 2)
        if rc != 0 or len(stats) != 1 or stats[0]["n_ue"] != CHUNK or \
                stats[0]["coverage_pct"] != cov or \
                stats[0]["frequency_ghz"] != CONV_FREQ / 1e9:
            raise AssertionError(f"stats_cli: rc {rc}, {stats}")
        log(f"[factory] stats_cli: {json.dumps(stats[0])}")
        del ds
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"[factory] phase 5k: {time.perf_counter() - t_phase:.1f} s (host "
        f"wall, disk writes included); launches counted: render "
        f"{counted.render}, beam gain {counted.beam_gain}")
    return {"fused_render": counted.render,
            "fused_beam_gain": counted.beam_gain}


def kernel_bounds(fma=False):
    """Least card time (ms) of each kernel's work, in each mode, at its
    headline shapes, and what bounds it: bytes (each input read once, each
    output written once; bf16 output half of H's) over HBM_BYTES_PER_S, or
    flops (FMA = 2): at f32 grade on the tensor cores, TF32_PASSES * flops
    over TF32_FLOPS_PER_S, the fastest f32-grade route the card offers;
    one-pass bf16 products at BF16_FLOPS_PER_S; float64 flops at
    FP64_TC_FLOPS_PER_S (``fma``: all flops over FP32_FLOPS_PER_S, or
    FP64_FLOPS_PER_S in float64, instead, the SIMT rates). sincosf is not
    counted."""
    u, p, k = CHUNK, MAX_PATHS, N_SC
    r, t = UE_SHAPE[0] * UE_SHAPE[1], BS_SHAPE[0] * BS_SHAPE[1]
    q, b = r * t, BG_BEAMS
    per_path = 4 * 7 * u * p                       # the 7 [U, P] inputs
    h_planes = u * q * 2 * k                       # values of H's planes
    fwd = 8 * u * q * k * p        # H = E g^T: 8 flops per complex MAC
    bwd = 16 * u * q * k * p       # dE = ct g and dG = ct^T E
    fold = 8 * u * b * t * p       # eb = conj(W) a_tx, B*T*P MACs
    bg_sum = 8 * u * r * b * k * p     # the path sum, R*B*K*P MACs
    bg_pow = 3 * u * r * b * k         # |y|^2
    bg_bytes = per_path + 4 * 2 * b * t + 4 * u * r * b * k
    work = {   # name: (bytes, flops at f32 grade, flops of one bf16 pass)
        "fused_render": (per_path + 4 * h_planes, fwd, 0),
        "fused_render[bf16_out]": (per_path + 2 * h_planes, fwd, 0),
        "fused_render[bf16_mm]": (per_path + 4 * h_planes, 0, fwd),
        "fused_render[bf16_mm+bf16_out]": (per_path + 2 * h_planes, 0, fwd),
        # reads ct, writes 7 gradients
        "fused_render_bwd": (2 * per_path + 4 * h_planes, bwd, 0),
        "fused_render_bwd[bf16_mm]": (2 * per_path + 4 * h_planes, 0, bwd),
        # B = (amp a_rx) g (8 flops per (r, k, p)), then the path sum
        "fused_path_sum": (4 * u * p * (2 * r + 2 * t + 3) + 4 * k +
                           4 * 2 * u * q * k,
                           8 * u * r * k * p + 8 * u * q * k * p, 0),
        # the fold stays f32 grade in every mode
        "fused_beam_gain": (bg_bytes, fold + bg_sum + bg_pow, 0),
        "fused_beam_gain[bf16_mm]": (bg_bytes, fold + bg_pow, bg_sum),
        # every value and product in float64 (its flops counted apart)
        "fused_beam_gain[f64]": (2 * bg_bytes, 0, 0),
    }
    f64_flops = {"fused_beam_gain[f64]": fold + bg_sum + bg_pow}
    out = {}
    for name, (n_bytes, flops, bf16_flops) in work.items():
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ((flops + bf16_flops) / FP32_FLOPS_PER_S if fma else
                 TF32_PASSES * flops / TF32_FLOPS_PER_S +
                 bf16_flops / BF16_FLOPS_PER_S) * 1e3
        t_ops += f64_flops.get(name, 0) / (
            FP64_FLOPS_PER_S if fma else FP64_TC_FLOPS_PER_S) * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


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


def _planes_target(torch, dmt, paths, cfg):
    """The calibration target: the planes with the BS rotated 10 degrees."""
    from deepmimo_tpu_torch.ops.channel import render_channels_planes
    with torch.no_grad():
        return render_channels_planes(
            paths, dmt.AntennaPanel.make((0.0, 0.0, 10.0), device=DEV),
            dmt.AntennaPanel.make(device=DEV), cfg)


def _check_train_grads(torch, dmt, paths, target, cfg, tol, tag):
    """The first step's gradients of every CalibParams leaf on GRAD_USERS
    users: kernels (card) vs plain versions (CPU), within ``tol`` *
    max|g|."""
    from deepmimo_tpu_torch.parallel import sharded as sh
    ue = dmt.AntennaPanel.make(device=DEV)
    bs0 = dmt.AntennaPanel.make((0.0, 0.0, 0.0), device=DEV)
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
        if not (math.isfinite(err) and err <= tol * scale + 1e-30):
            raise AssertionError(f"training gradient {name}: kernels "
                                 f"{err:.3e} off the plain versions "
                                 f"(max|g| {scale:.3e})")
    log(f"[{tag}] {GRAD_USERS}-user gradients, kernels vs plain, rel err "
        f"per leaf: {', '.join(rels)} (limit {tol:g}); loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f}")


def phase_train(torch, dmt, fwd_ms, bwd_ms):
    """The calibration step on the planes path: fused fwd + bwd kernels."""
    from deepmimo_tpu_torch.ops.kernels import render as kr
    from deepmimo_tpu_torch.parallel import sharded as sh

    d = make_data(CHUNK, MAX_PATHS, seed=11)
    paths = dmt.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], device=DEV)
    cfg = _train_config(dmt, "fused")
    target = _planes_target(torch, dmt, paths, cfg)
    params = sh.init_calib_params(
        paths, dmt.AntennaPanel.make((0.0, 0.0, 0.0), device=DEV),
        dmt.AntennaPanel.make(device=DEV))
    _check_train_grads(torch, dmt, paths, target, cfg, GRAD_RTOL, "train")

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
    profile_cell(torch, "calibration planes", [
        lambda: sh.training_step_planes(params, paths, target, cfg, lr=LR)])
    first_loss = losses[0]
    del target
    torch.cuda.empty_cache()
    return paths, launches, first_loss


def phase_train_bf16(torch, dmt, paths, planes_loss):
    """The calibration step with ``matmul_dtype`` "bfloat16": the forward
    and backward kernels in their one-pass modes, once each per step,
    counted; the first step's gradients against the plain versions in the
    same mode, the first loss against the f32 planes loss (the same
    start), ms per step and peak memory."""
    from deepmimo_tpu_torch.ops.kernels import render as kr
    from deepmimo_tpu_torch.parallel import sharded as sh

    cfg = _train_config(dmt, "fused").replace(matmul_dtype="bfloat16")
    target = _planes_target(torch, dmt, paths, cfg.replace(
        matmul_dtype="float32"))
    _check_train_grads(torch, dmt, paths, target, cfg, BF16_MM_RTOL,
                       "train-bf16")
    params = sh.init_calib_params(
        paths, dmt.AntennaPanel.make((0.0, 0.0, 0.0), device=DEV),
        dmt.AntennaPanel.make(device=DEV))
    kr.MODE_LAUNCHES.clear()
    kr.BWD_MODE_LAUNCHES.clear()
    losses, step_ms, peak = run_steps(
        torch, lambda p: sh.training_step_planes(p, paths, target, cfg,
                                                 lr=LR),
        params, BF16_STEPS, per_step=(1, 1, 0))
    launches = _modes(kr.MODE_LAUNCHES, "fused_render",
                      {"bf16_mm": BF16_STEPS})
    launches.update(_modes(kr.BWD_MODE_LAUNCHES, "fused_render_bwd",
                           {"bf16_mm": BF16_STEPS}))
    rel = abs(losses[0] - planes_loss) / abs(planes_loss)
    log(f"[train-bf16] {BF16_STEPS} training_step_planes steps, {CHUNK} "
        f"users, matmul_dtype bfloat16: losses "
        f"{['%.7f' % x for x in losses]}; first loss vs f32 "
        f"{planes_loss:.7f}: rel {rel:.2e} (limit {BF16_MM_RTOL:g}); ms per "
        f"step (CUDA events; the first warms up) "
        f"{', '.join('%.4f' % x for x in step_ms)}; peak device memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0] and rel <= BF16_MM_RTOL):
        raise AssertionError("bf16 training loss not finite, not "
                             "decreasing or off the f32 loss")
    del target
    torch.cuda.empty_cache()
    return launches


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
    bg = phase_bg_kernels(torch)
    launches = Counter()                 # main-path launches by entry
    datasets, params, serve_launches = phase_main(torch, dmt)
    phase_streamed(torch, dmt, datasets, params)
    bg_launches = phase_beamgain(torch, datasets, params)
    bf16_serving = phase_bf16_serving(torch, dmt, datasets)
    angle_space = phase_angle_space(torch, dmt, datasets)
    del datasets
    torch.cuda.empty_cache()
    nonfused = phase_nonfused(torch, dmt)
    scenarios = phase_scenarios(torch, dmt)
    surface = phase_surface(torch, dmt)
    converted = phase_convert(torch, dmt)
    factory = phase_factory(torch, dmt)
    doppler = phase_doppler(torch, dmt)
    polar_render, polar_bg = phase_polar(torch, dmt)
    torch.cuda.empty_cache()
    paths, (train_fwd, train_bwd), planes_loss = phase_train(
        torch, dmt, fwd["f32"]["ms"], bwd["f32"]["ms"])
    train_bf16 = phase_train_bf16(torch, dmt, paths, planes_loss)
    pallas_launches = phase_train_pallas(torch, dmt, paths, planes_loss)
    launches.update({"fused_render": serve_launches + polar_render +
                     train_fwd, "fused_render_bwd": train_bwd,
                     "fused_path_sum": pallas_launches,
                     "fused_beam_gain": bg_launches + polar_bg})
    for phase in (bf16_serving, angle_space, doppler, nonfused, train_bf16,
                  scenarios, surface, converted, factory):
        launches.update(phase)
    log(f"[launches] fused_render: serving {serve_launches} + dual-polar "
        f"{polar_render} + training {train_fwd} + angle space "
        f"{angle_space['fused_render']} + Doppler {doppler['fused_render']}"
        f" + scenarios from disk {scenarios['fused_render']} + public "
        f"surface {surface['fused_render']} + converted scenarios "
        f"{converted['fused_render']} + scenario factory "
        f"{factory['fused_render']}; "
        f"fused_render_bwd: training {train_bwd}; fused_path_sum: pallas "
        f"training {pallas_launches}; fused_beam_gain: serving "
        f"{bg_launches} + dual-polar {polar_bg} + Doppler "
        f"{doppler['fused_beam_gain']} + scenarios from disk "
        f"{scenarios['fused_beam_gain']} + public surface "
        f"{surface['fused_beam_gain']} + converted scenarios "
        f"{converted['fused_beam_gain']} + scenario factory "
        f"{factory['fused_beam_gain']}; modes: complex128 beam gains "
        f"{nonfused}, bf16 serving {bf16_serving}, "
        f"bf16 training {train_bf16}")
    src = "deepmimo_tpu_torch/csrc/"
    tpu = "deepmimo_tpu/ops/pallas/"
    bounds = kernel_bounds()
    log("[bounds] ms, tensor-core rule (3xTF32 for f32 grade, one bf16 "
        "pass for bf16_mm, FP64 for f64) (SIMT FMA rule): " + "; ".join(
            f"{name} {t:.4f} {by} ({f:.4f} {fby})"
            for (name, (t, by)), (f, fby)
            in zip(bounds.items(), kernel_bounds(fma=True).values())))
    sources = {  # kernel: (source, TPU kernel, headline metrics by mode)
        "fused_render": ("render_fwd.cu", "render.py:432", fwd),
        "fused_render_bwd": ("render_bwd.cu", "render.py:659", bwd),
        "fused_path_sum": ("pathsum.cu", "pathsum.py:66", {"f32": psum}),
        "fused_beam_gain": ("beamgain.cu", "beamgain.py:77", bg),
    }
    # library_ms: one PyTorch call computing the same function. The path
    # sum has one (the complex einsum over its given planes, g formed
    # outside the timed window); the render and beam-gain kernels build
    # their operands from trig inside, and the beam gain never forms H, so
    # no single call computes theirs.
    kernels = []
    for name, (source, replaces, by_mode) in sources.items():
        for key, m in by_mode.items():
            e = entry(name, key)
            if not launches[e]:
                raise AssertionError(f"{e} was not launched on a main path")
            kernels.append({
                "name": e, "route": "cuda", "source": src + source,
                "replaces": tpu + replaces, "launches": launches[e],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": bounds[e][0],
                "bound_by": bounds[e][1], "library_ms": m.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
