"""What the harness and the reference load, and how run.py fails."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from chipbench.harness import main, registry

ROOT = os.path.dirname(registry.BENCH_DIR)
ENV = dict(os.environ, PYTHONPATH=ROOT)


def _loaded(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program_and_no_jax():
    names = _loaded("import chipbench.reference.channels")
    assert not names & {"jax", "jaxlib", "flax", "deepmimo_tpu",
                        "deepmimo_tpu_torch"}


def test_a_run_loads_no_jax():
    names = _loaded(
        "import time\n"
        "from chipbench.harness import main, registry\n"
        "import deepmimo_tpu_torch as dmt\n"
        "b = registry.load_benchmark('.')\n"
        "for w in b['workloads']:\n"
        "    main.run_cell(b, w, 1, 0.05, False, 'cpu', time.perf_counter(),"
        " n_users=16)\n"
        "assert main.forbidden_modules() == []")
    assert "deepmimo_tpu_torch" in names
    assert not names & set(main.FORBIDDEN)


def test_forbidden_names_compared_whole(monkeypatch):
    before = main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deepmimo_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "deepmimo_tpu_torch.ops", sys)
    assert main.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in main.forbidden_modules()


def _run(cwd, seconds="1"):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "mimo64.beam_gains", "--seed", str(2**31 + 9), "--seconds",
         seconds, "--trace", "0"], capture_output=True, text=True, cwd=cwd,
        timeout=600, env=dict(os.environ, PYTHONPATH=""))


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.gpu
def test_without_the_program_no_result(card, tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_one_short_run_on_the_card(card):
    out = _run(ROOT, "2")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1] == "correct: True"
