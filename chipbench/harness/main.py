"""One run of one cell: set-up, the measured window, the traced cycle
(``--trace 1``), the comparison with the reference, the result line."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import drive as drives, readers, registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "deepmimo_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="chipbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``deepmimo_tpu_torch`` is not ``deepmimo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_limits(cell: str) -> dict:
    with open(os.path.join(registry.BENCH_DIR, "limits",
                           f"{cell}.json")) as f:
        return json.load(f)["limits"]


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: str, t_start: float, n_users=None):
    """Runs the cell; returns (result dict, check lines)."""
    import torch
    t_torch = time.perf_counter()
    import deepmimo_tpu_torch as dmt

    t_imported = time.perf_counter()
    mix = registry.load_mix(cell["traffic"])
    with drives.program_config(dmt, mix):
        return _run_cell(bench, cell, seed, seconds, traced, device, mix,
                         (t_start, t_torch, t_imported), n_users)


def _run_cell(bench, cell, seed, seconds, traced, device, mix, clock,
              n_users):
    import torch
    import deepmimo_tpu_torch as dmt
    t_start, t_torch, t_imported = clock
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dmt.config.set("device", device)
    config = registry.load_config(cell["config"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drive = drives.make(dmt, config, mix, seed, device, n_users)
    drive.setup()
    sync()
    t_set = time.perf_counter()
    setup_s = t_set - t_start
    w = drives.run_window(drive, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    result = {"correct": False, "attempted": w["calls"], "failed": 0,
              "metrics": {}}
    lines = [f"[setup] {setup_s:.3f} s: torch and the card "
             f"{t_torch - t_start:.3f}, import deepmimo_tpu_torch "
             f"{t_imported - t_torch:.3f}, inputs {drive.inputs_s:.3f}, the "
             f"rest (datasets, kernel builds or loads, warm calls) "
             f"{t_set - t_imported - drive.inputs_s:.3f}"]
    wctx = readers.WindowContext(peak_bytes=peak, setup_s=setup_s, **w)
    if traced:
        tr = trace.traced_cycle(drive.call, mix["trace_calls"], sync)
        n = mix["trace_calls"]
        ctx = readers.LayerContext(tr, [
            drives.shapes(config, mix, drive.parts[i])
            for i in drive.history[-n:]], wctx)
        for m in registry.metrics_for(bench, cell["name"], "per_layer"):
            value = registry.load_module("layer_metrics", m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        for name in ctx.kernels:
            if tr.named(ctx.kernels[name].KERNEL):
                t, by = ctx.bound(name)
                lines.append(f"[roofline] {name}: least {t * 1e3 / n:.6f} "
                             f"ms per call, set by {by}")
        lines.append(f"[card] {card_line() if cuda else device}")
    else:
        for m in registry.metrics_for(bench, cell["name"], "end_to_end"):
            value = registry.load_module("end_to_end", m["name"]).read(wctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if cuda else device,
        "kind": torch.cuda.get_device_name(0) if cuda else device,
        "count": 1, "memory_peak_bytes": peak}
    if traced:
        result["device"].update(busy_s=tr.busy_us() * 1e-6,
                                window_s=tr.window_us() * 1e-6)
        result["breakdown"] = tr.breakdown()
    drive.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drive.numbers()
    limits = load_limits(cell["name"])
    over = [k for k, v in limits.items() if not numbers[k] <= v]
    result["correct"] = not over
    result["failed"] = len(over)
    result["check"] = {k: {"value": numbers[k], "limit": v}
                       for k, v in limits.items()}
    lines += [f"check {k}: {numbers[k]!r} (limit {v!r})"
              for k, v in limits.items()]
    lines += [f"reading {k}: {v!r} (no limit)" for k, v in numbers.items()
              if k not in limits]
    lines.append(f"correct: {result['correct']}")
    return result, lines


def main(argv, t_start: float, root: str) -> int:
    args = parse(argv)
    bench = registry.load_benchmark(root)
    cell = registry.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"chipbench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; no result", file=sys.stderr)
        return 2
    result, lines = run_cell(bench, cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"chipbench: modules {found} were loaded; no result",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
