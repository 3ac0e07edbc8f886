"""Pipeline-CSV generator: city list -> scenario bbox CSV for the runner.

Reads a worldcities-style CSV (columns: city, lat, lng, population),
filters by population, builds a fixed-size GPS bounding box around each
city center, places base stations inside it, and writes the bbox CSV
consumed by ``deepmimo-tpu-torch-pipeline`` /
``pipelines.runner.read_pipeline_csv``. Copied from
``deepmimo_tpu/scripts/csv_gen_cli.py``.

Usage::

    deepmimo-tpu-torch-csvgen worldcities.csv out.csv
        [--min-population 5000000] [--box-m 500] [--num-bs 3]
        [--bs-height 10] [--max-cities 0]
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import List

from ..pipelines.geo_utils import meters_per_deg_lon

M_PER_DEG_LAT = 111_320.0


def city_bbox(lat: float, lon: float, box_m: float):
    """Square GPS bbox of side ``box_m`` centered on (lat, lon)."""
    dlat = (box_m / 2) / M_PER_DEG_LAT
    dlon = (box_m / 2) / meters_per_deg_lon(lat)
    return (lat - dlat, lon - dlon, lat + dlat, lon + dlon)


def place_bs_grid(bbox, num_bs: int) -> List[tuple]:
    """Deterministic BS placement: evenly spread along the bbox diagonal
    band (center for 1 BS; otherwise interior points away from edges)."""
    min_lat, min_lon, max_lat, max_lon = bbox
    if num_bs == 1:
        return [((min_lat + max_lat) / 2, (min_lon + max_lon) / 2)]
    fracs = [(i + 1) / (num_bs + 1) for i in range(num_bs)]
    return [(min_lat + f * (max_lat - min_lat),
             min_lon + f * (max_lon - min_lon)) for f in fracs]


def generate_rows(cities_csv: str, min_population: float, box_m: float,
                  num_bs: int, bs_height: float,
                  max_cities: int = 0) -> List[dict]:
    rows = []
    with open(cities_csv, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            try:
                pop = float(rec.get("population") or 0)
            except ValueError:
                pop = 0.0
            if pop < min_population:
                continue
            lat, lon = float(rec["lat"]), float(rec["lng"])
            bbox = city_bbox(lat, lon, box_m)
            bs = place_bs_grid(bbox, num_bs)
            name = (rec.get("city_ascii") or rec["city"]).lower()
            name = "".join(ch if ch.isalnum() else "_" for ch in name)
            rows.append({
                "name": f"city_{len(rows):04d}_{name}",
                "min_lat": round(bbox[0], 6), "min_lon": round(bbox[1], 6),
                "max_lat": round(bbox[2], 6), "max_lon": round(bbox[3], 6),
                "bs_lat": "|".join(f"{b[0]:.6f}" for b in bs),
                "bs_lon": "|".join(f"{b[1]:.6f}" for b in bs),
                "bs_height": "|".join(f"{bs_height:g}" for _ in bs),
            })
            if max_cities and len(rows) >= max_cities:
                break
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deepmimo-tpu-torch-csvgen",
        description="Generate a scenario bbox CSV from a worldcities CSV.")
    ap.add_argument("cities_csv")
    ap.add_argument("out_csv")
    ap.add_argument("--min-population", type=float, default=5_000_000)
    ap.add_argument("--box-m", type=float, default=500.0)
    ap.add_argument("--num-bs", type=int, default=3)
    ap.add_argument("--bs-height", type=float, default=10.0)
    ap.add_argument("--max-cities", type=int, default=0,
                    help="stop after this many rows (0 = all)")
    args = ap.parse_args(argv)

    rows = generate_rows(args.cities_csv, args.min_population, args.box_m,
                         args.num_bs, args.bs_height, args.max_cities)
    if not rows:
        print("no cities matched the filters", file=sys.stderr)
        return 1
    with open(args.out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} scenario rows -> {args.out_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
