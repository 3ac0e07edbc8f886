"""Batch conversion CLI: convert a folder of ray-tracing runs in a loop.

Every subfolder of ``base_path`` holding a ray-tracer output is converted
to a scenario with ``deepmimo_tpu_torch.convert``; failures are collected
into an error log that a later ``--retry`` run consumes. Optionally
uploads each converted scenario. Copied from
``deepmimo_tpu/scripts/convert_cli.py``.

Usage::

    deepmimo-tpu-torch-convert BASE_PATH [--retry] [--upload KEY]
        [--error-log conversion_errors.json] [--no-overwrite]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def convert_folder_loop(base_path: str, retry: bool = False,
                        error_log: str = "conversion_errors.json",
                        upload_key: str = None,
                        overwrite: bool = True) -> dict:
    """Convert every ray-tracing subfolder under ``base_path``.

    Returns a report dict: converted names, per-folder timing, errors.
    """
    import deepmimo_tpu_torch as dm

    subfolders = sorted(
        e.path for e in os.scandir(base_path) if e.is_dir())

    if retry and os.path.exists(error_log):
        with open(error_log) as f:
            failed = {item[0] for item in json.load(f)}
        subfolders = [p for p in subfolders
                      if os.path.basename(p) in failed]

    report = {"converted": [], "errors": [], "timing_s": {}}
    for folder in subfolders:
        name = os.path.basename(folder)
        t0 = time.perf_counter()
        try:
            scen_name = dm.convert(folder, overwrite=overwrite)
            report["timing_s"][name] = round(time.perf_counter() - t0, 2)
            report["converted"].append(scen_name)
            if upload_key:
                dm.upload(scen_name, key=upload_key)
        except Exception as e:  # collect-and-continue: one bad run
            report["errors"].append([name, f"{type(e).__name__}: {e}"])

    if report["errors"]:
        with open(error_log, "w") as f:
            json.dump(report["errors"], f, indent=2)
    elif retry and os.path.exists(error_log):
        os.remove(error_log)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deepmimo-tpu-torch-convert",
        description="Batch-convert ray-tracing output folders to scenarios.")
    ap.add_argument("base_path", help="folder whose subfolders are RT runs")
    ap.add_argument("--retry", action="store_true",
                    help="only retry folders recorded in the error log")
    ap.add_argument("--error-log", default="conversion_errors.json")
    ap.add_argument("--upload", metavar="KEY", default=None,
                    help="upload each converted scenario with this API key")
    ap.add_argument("--no-overwrite", action="store_true")
    args = ap.parse_args(argv)

    report = convert_folder_loop(
        args.base_path, retry=args.retry, error_log=args.error_log,
        upload_key=args.upload, overwrite=not args.no_overwrite)
    print(json.dumps(report))  # one line: machine-parseable after chatter
    return 1 if report["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
