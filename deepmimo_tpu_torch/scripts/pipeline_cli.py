"""CLI of the scenario factory pipeline (copied from
``deepmimo_tpu/scripts/pipeline_cli.py``).

Usage::

    deepmimo-tpu-torch-pipeline sites.csv --work-dir runs/ --raytracer sionna \
        [--upload-key KEY] [--grid-spacing 2.0] [--frequency 3.5e9]

CSV columns: name, min_lat, min_lon, max_lat, max_lon, bs_lat, bs_lon,
bs_height ('|'-separated lists for multiple BSs).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv", help="CSV of scenario sites")
    ap.add_argument("--work-dir", default="pipeline_runs")
    ap.add_argument("--raytracer", choices=("sionna", "insite"),
                    default="sionna")
    ap.add_argument("--upload-key", default=None)
    ap.add_argument("--grid-spacing", type=float, default=2.0)
    ap.add_argument("--ue-height", type=float, default=1.5)
    ap.add_argument("--frequency", type=float, default=3.5e9)
    args = ap.parse_args(argv)

    from ..pipelines import run_pipeline
    completed = run_pipeline(
        args.csv, args.work_dir, raytracer=args.raytracer,
        upload_key=args.upload_key, grid_spacing=args.grid_spacing,
        ue_height=args.ue_height, frequency=args.frequency)
    print(f"Completed {len(completed)} scenario(s): {completed}")
    return 0 if completed else 1


if __name__ == "__main__":
    sys.exit(main())
