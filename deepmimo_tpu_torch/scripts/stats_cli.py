"""Dataset statistics CLI: aggregate metrics over local scenarios.

Usage::

    deepmimo-tpu-torch-stats [scenario ...]   # default: all local scenarios

Prints per-scenario user counts, coverage (active users), path counts,
LoS fraction, and pathloss statistics as a table, or as JSON with
``--json``. Copied from ``deepmimo_tpu/scripts/stats_cli.py``, on the
port's ``load``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def scenario_stats(name: str) -> dict:
    import deepmimo_tpu_torch as dm

    ds = dm.load(name)
    d = ds[0] if hasattr(ds, "datasets") else ds

    num_paths = np.asarray(d.num_paths)
    los = np.asarray(d.los)
    pl = np.asarray(d.pathloss)
    active = num_paths > 0
    return {
        "scenario": name,
        "n_ue": int(d.n_ue),
        "n_pairs": len(ds) if hasattr(ds, "datasets") else 1,
        "coverage_pct": round(100.0 * active.mean(), 2),
        "mean_paths": round(float(num_paths[active].mean()), 2)
        if active.any() else 0.0,
        "los_pct": round(100.0 * float((los == 1).mean()), 2),
        "pathloss_db": {
            "min": round(float(np.nanmin(pl)), 1) if active.any() else None,
            "median": round(float(np.nanmedian(pl)), 1)
            if active.any() else None,
            "max": round(float(np.nanmax(pl)), 1) if active.any() else None,
        },
        "frequency_ghz": round(
            float(d.rt_params.get("frequency", 0)) / 1e9, 3)
        if d.get("rt_params") else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scenarios", nargs="*",
                    help="scenario names (default: all local)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    import deepmimo_tpu_torch as dm
    names = args.scenarios or dm.get_available_scenarios()
    if not names:
        print("No scenarios found")
        return 1

    stats = []
    for name in names:
        try:
            stats.append(scenario_stats(name))
        except Exception as e:
            print(f"[stats] {name} failed: {e}", file=sys.stderr)

    if args.as_json:
        print(json.dumps(stats, indent=2))
    else:
        hdr = (f"{'scenario':24s} {'users':>8s} {'cov%':>6s} "
               f"{'paths':>6s} {'LoS%':>6s} {'PL med':>8s}")
        print(hdr)
        print("-" * len(hdr))
        for s in stats:
            print(f"{s['scenario']:24s} {s['n_ue']:8d} "
                  f"{s['coverage_pct']:6.1f} {s['mean_paths']:6.2f} "
                  f"{s['los_pct']:6.1f} "
                  f"{str(s['pathloss_db']['median']):>8s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
