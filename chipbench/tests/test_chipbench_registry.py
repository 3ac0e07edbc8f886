"""BENCHMARK.json against the benchmark's rules, and every file it names
found by its name."""

import json
import os
import re

import pytest

from chipbench.harness import main, readers, registry

ROOT = os.path.dirname(registry.BENCH_DIR)
BENCH = registry.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|_dim$|_rank$|experts_per_tok)")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    n = len(BENCH["workloads"])
    assert (BENCH["run_seconds"] + 60) * (2 + 14 * 24) + 24 * 2 * 90 + \
        1200 <= 43200, "a check of 24 cells must fit its time"
    assert 1 <= n <= 24


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [x["name"] for x in BENCH[section]]
    assert len(set(names)) == len(names)
    for x in BENCH[section]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
            assert x["source"] in SOURCES


def test_configs_found_and_cut_only_in_scale():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("chipbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = registry.load_config(c["name"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
    assert len({c["source"] for c in BENCH["configs"]}) == \
        len(BENCH["configs"])


def test_workloads_found():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = registry.load_mix(w["traffic"])
        assert hasattr(registry.load_module("drives", mix["drive"]),
                       "Drive")
        assert set(main.load_limits(w["name"]))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_found_and_reported():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert hasattr(registry.load_module("end_to_end", m["name"]), "read")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert hasattr(registry.load_module("layer_metrics", m["name"]),
                       "read")
        for cell in m["workloads"]:
            assert m in registry.metrics_for(BENCH, cell, "per_layer")
            assert e2e[m["moves"]] in registry.metrics_for(BENCH, cell,
                                                           "end_to_end")
    for cell in cells:
        got = {m["name"] for m in registry.metrics_for(BENCH, cell,
                                                       "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert registry.metrics_for(BENCH, cell, "per_layer")


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_roofline_files_name_their_kernels():
    names = readers.roofline_names()
    assert names == ["beam_gain", "render_bwd", "render_fwd"]
    for n in names:
        mod = registry.load_module("roofline", n)
        assert mod.KERNEL.endswith("_kernel") and callable(mod.count)


def test_a_metric_part_falls_back_to_its_base():
    """``idle_pct.serve`` is read by ``idle_pct.py``; a file of the whole
    name goes first, and a name without a dot has no fallback."""
    assert registry.module_path("layer_metrics", "idle_pct.anything") == \
        registry.module_path("layer_metrics", "idle_pct")
    assert registry.module_path("end_to_end", "users_per_s.host").endswith(
        "/end_to_end/users_per_s.py")
    assert registry.module_path("layer_metrics", "nothing").endswith(
        "/layer_metrics/nothing.py")


def test_files_named_from_names():
    for dirpath, _, files in os.walk(registry.BENCH_DIR):
        rel = os.path.relpath(dirpath, ROOT)
        if "__pycache__" in rel:
            continue
        for f in files:
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", f"{rel}/{f}"), f


def test_json_files_parse():
    for kind in ("configs", "mixes", "limits"):
        for f in os.listdir(os.path.join(registry.BENCH_DIR, kind)):
            with open(os.path.join(registry.BENCH_DIR, kind, f)) as fh:
                assert isinstance(json.load(fh), dict)
