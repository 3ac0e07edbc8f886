"""Readings that a cell's correctness limits are set from, on the card.

    python3 chipbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2] [--fault NAME] [--table] \
        [--out FILE]

For each seed of ``--seeds``: the cell's set-up and timed loop at its own
size for ``--seconds``, then the numbers its runs compare (the lower
readings: sound runs of the program). For each seed of
``--control-seeds``: the same numbers of the control, the reference
computed in TF32 put in the program's place (the upper readings). With
``--fault`` the program runs with that fault planted
(``harness/faults.py``); with ``--table`` a calibration reading gives each
leaf's figures too. One JSON line per reading goes to standard output
and, with ``--out``, to that file. The benchmark's own runs never run the
control or a fault.
"""

import os
import sys
import time


def main(argv):
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="chipbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    import deepmimo_tpu_torch as dmt
    from chipbench.harness import drive as drives, faults, registry

    if not torch.cuda.is_available():
        print("chipbench readings: no CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(registry.BENCH_DIR)
    cell = registry.workload(registry.load_benchmark(root), args.workload)
    config = registry.load_config(cell["config"])
    mix = registry.load_mix(cell["traffic"])
    dmt.config.set("device", "cuda")
    if args.fault:
        faults.plant(args.fault, dmt)
    out = open(args.out, "a") if args.out else None
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        with drives.program_config(dmt, mix):
            drive = drives.make(dmt, config, mix, seed, "cuda")
            drive.setup()
            drives.run_window(drive, args.seconds, torch.cuda.synchronize)
            drive.release()
        torch.cuda.empty_cache()
        row = {"workload": cell["name"], "seed": seed, "control": control,
               "fault": args.fault,
               "numbers": drive.numbers(control=control)}
        if args.table:
            row["leaves"] = drive.numbers(control=control, table=True)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del drive
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[0] = os.path.dirname(here)
    sys.exit(main(sys.argv[1:]))
