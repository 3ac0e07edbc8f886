"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

- ``configs/<config>.json``: a deployment (the channel parameters and the
  site's size), one file per configuration;
- ``mixes/<traffic>.json``: a traffic mix (the drive it runs, the number
  of datasets, the path statistics, the program's settings);
- ``drives/<drive>.py``: what a mix drives (``Drive``: the program's entry
  point in a closed loop and the comparison of its answers);
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  per metric, ``read(ctx)`` returning a number, or None where it finds
  nothing to read. A metric ``<base>.<part>`` without a file of its own is
  read by ``<base>.py`` (``idle_pct.serve`` and ``idle_pct.calib`` by
  ``idle_pct.py``);
- ``roofline/<kernel>.py``: the bytes and operations of one kernel's work;
- ``reference/<feature>.py``: one feature of the plain reference
  (``reference/channels.py``).

A later change adds a cell, a drive, a metric, a kernel's count or a
reference feature by adding files and entries; none of the files here
needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_mix(name: str) -> dict:
    return _json("mixes", name)


def module_path(kind: str, name: str) -> str:
    """``<kind>/<name>.py``, or ``<kind>/<base>.py`` for a name
    ``<base>.<part>`` that has no file of its own."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, kind, f"{name.split('.')[0]}.py")
    return path


def load_module(kind: str, name: str):
    """The module that ``module_path`` finds (names may hold dots)."""
    path = module_path(kind, name)
    spec = importlib.util.spec_from_file_location(
        f"chipbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those without a ``workloads``
    key whose end-to-end metric (itself, or the one it ``moves``) the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
