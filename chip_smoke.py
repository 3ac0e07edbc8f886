"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. Card and toolchain: ``nvidia-smi`` name and power limit, torch/CUDA.
2. Build: compiles every kernel of the main path from ``csrc/`` with nvcc
   for sm_90a and prints the ptxas report.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes, max abs error <= 3e-5 * max|H|, with
   CUDA-event times of both.
4. Main path: four 131,072-user x 25-path datasets (synthetic, seed 7)
   through ``Dataset.compute_channels(params, to_device=True, out=prev)``
   — one kernel launch per call — checked for shape and finiteness and on
   64 users per dataset against the float64 oracle ``tests/oracle.py``;
   then a timed sweep.
5. Streamed path: ``to_device=False`` over 3 user blocks must equal the
   single-dispatch result exactly.

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
    lib = _build.build("render_fwd")
    log(f"[build] render_fwd -> {os.path.relpath(lib, HERE)} "
        f"({time.perf_counter() - t0:.1f} s)")
    for line in _build.build_log("render_fwd").splitlines():
        if "ptxas" in line:
            log(f"[build] {line.strip()}")


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
    return [torch.from_numpy(a).cuda() for a in arrs]


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
    headline = phase_kernels(torch)
    datasets, params, launches = phase_main(torch, dmt)
    phase_streamed(torch, dmt, datasets, params)
    kernels = [{
        "name": "fused_render", "route": "cuda",
        "source": "deepmimo_tpu_torch/csrc/render_fwd.cu",
        "replaces": "deepmimo_tpu/ops/pallas/render.py:432",
        "launches": launches, "max_abs_err": headline["max_abs_err"],
        "ms": headline["ms"], "plain_ms": headline["plain_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
