"""The PyTorch port's worked examples run end to end on the CPU
(``deepmimo_tpu_torch/examples``; tests/test_examples.py runs the JAX
package's). Each runs in a fresh interpreter with ``--cpu``, as a user
would start it; the figure generator writes into a temporary folder here,
and its default folder is the port's own ``docs/imgs``, never the repo's
``docs/``.
"""

import hashlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, module, *args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("WORLD_SIZE", "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))
    r = subprocess.run(
        [sys.executable, "-m", f"deepmimo_tpu_torch.examples.{module}",
         *args], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_quickstart_runs_end_to_end(tmp_path):
    out = _run(tmp_path, "quickstart", "--cpu")
    assert "device: cpu" in out
    assert "sharded render" in out
    assert "quickstart complete" in out


def test_serve_channels_runs(tmp_path):
    out = _run(tmp_path, "serve_channels", "--cpu")
    assert "allclose=True" in out and "allclose=False" not in out
    assert "dual-polar: {'VV'" in out
    assert "serve_channels complete" in out


def test_learn_beam_codebook_runs(tmp_path):
    out = _run(tmp_path, "learn_beam_codebook", "--cpu", "--steps", "12")
    assert "step   11" in out
    assert "best-beam agreement" in out and "done" in out


def _tree_digest(root):
    h = hashlib.sha256()
    for base, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            path = os.path.join(base, name)
            h.update(path.encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_generate_docs_imgs_writes_the_ports_folder(tmp_path):
    from deepmimo_tpu_torch.examples import generate_docs_imgs
    assert generate_docs_imgs.OUT == os.path.join(
        REPO, "deepmimo_tpu_torch", "docs", "imgs")
    repo_docs = _tree_digest(os.path.join(REPO, "docs"))
    port_imgs = _tree_digest(generate_docs_imgs.OUT)
    out = tmp_path / "imgs"
    assert f"wrote images to {out}" in _run(tmp_path, "generate_docs_imgs",
                                            "--out", str(out))
    names = sorted(os.listdir(out))
    assert names == ["coverage.png", "power_discarding.png", "rays.png",
                     "scene.png"]
    for name in names:
        with open(out / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert _tree_digest(os.path.join(REPO, "docs")) == repo_docs
    assert _tree_digest(generate_docs_imgs.OUT) == port_imgs


@pytest.mark.parametrize("module", ["quickstart", "serve_channels",
                                    "learn_beam_codebook",
                                    "generate_docs_imgs"])
def test_examples_import_no_jax(module):
    """No example imports JAX, the JAX package or tests/ helpers."""
    path = os.path.join(REPO, "deepmimo_tpu_torch", "examples",
                        f"{module}.py")
    with open(path) as f:
        text = f.read()
    for word in ("import jax", "from jax", "deepmimo_tpu.", "import "
                 "deepmimo_tpu\n", "scenario_utils", "oracle"):
        assert word not in text, (module, word)
