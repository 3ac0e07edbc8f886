"""The port's profiling module (``deepmimo_tpu_torch.utils.profiling``)
against the JAX package's.

- ``StageTimer``: the same stage names, nesting, totals and report text,
  with sync off and on; with sync on a stage ends with
  ``torch.cuda.synchronize()`` once CUDA is initialised, and an error of
  that sync reaches the caller (the JAX timer swallows every exception of
  its device barrier).
- ``renderer_roofline``: equal to the JAX helper's when both are given the
  same rates; its defaults are the H100's, and at the headline shape its
  memory bound equals ``chip_smoke.kernel_bounds()``'s byte term of the
  render kernel (the JAX defaults are TPU figures).
- ``xla_trace`` writes a TensorBoard-readable ``torch.profiler`` trace that
  holds an ``annotate`` range.
- On the card (``gpu``): a stage around a render takes at least the
  render's CUDA-event time.

JAX is imported only inside the tests that use it, so the ``gpu`` test
also runs where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_profiling.py``.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import make_synthetic_paths  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = (131072, 1, 64, 64, 25)       # users, R, T, K, P


@pytest.fixture
def ref_profiling():
    """The JAX package's profiling module (imported here only)."""
    from deepmimo_tpu.utils import profiling as ref
    return ref


def _nest(timer):
    with timer.stage("load"):
        pass
    with timer.stage("outer"):
        with timer.stage("inner"):
            with timer.stage("leaf"):
                pass
        with timer.stage("inner"):
            pass
    with timer.stage("render"):
        pass


@pytest.mark.parametrize("sync", [False, True])
def test_stage_timer_matches_reference(ref_profiling, sync):
    ours, theirs = profiling.StageTimer(sync=sync), \
        ref_profiling.StageTimer(sync=sync)
    _nest(ours)
    _nest(theirs)
    assert [n for n, _ in ours.records] == [n for n, _ in theirs.records]
    assert list(ours.totals()) == list(theirs.totals())
    assert {"outer", "outer/inner", "outer/inner/leaf"} <= set(ours.totals())
    assert all(dt >= 0 for _, dt in ours.records)
    # The same records give the same totals and report text.
    fixed = [(n, 1e-3 * (i + 1)) for i, (n, _) in enumerate(ours.records)]
    ours.records, theirs.records = list(fixed), list(fixed)
    assert ours.totals() == theirs.totals()
    # Records close innermost first: load, leaf, inner, inner, outer, ...
    assert ours.totals()["outer/inner"] == pytest.approx(3e-3 + 4e-3)
    lines = ([], [])
    ours.report(printer=lines[0].append)
    theirs.report(printer=lines[1].append)
    assert lines[0] == lines[1]
    assert lines[0][0] == "Stage timings:"


def test_stage_timer_syncs_only_after_cuda_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    timer = profiling.StageTimer()
    with timer.stage("a"):
        pass
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with timer.stage("b"):
        with timer.stage("c"):
            pass
    assert len(calls) == 2
    with profiling.StageTimer(sync=False).stage("d"):
        pass
    assert len(calls) == 2


def test_stage_timer_sync_error_reaches_caller(monkeypatch):
    def broken():
        raise RuntimeError("device lost")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", broken)
    timer = profiling.StageTimer()
    with pytest.raises(RuntimeError, match="device lost"):
        with timer.stage("a"):
            pass
    assert timer._stack == []


@pytest.mark.parametrize("shape", [HEADLINE, (4096, 2, 16, 256, 80, 4),
                                   (7, 1, 1, 1, 1)])
def test_roofline_matches_reference_at_same_rates(ref_profiling, shape):
    ours = profiling.renderer_roofline(*shape, hbm_gbps=819.0,
                                       mxu_tflops=98.0)
    theirs = ref_profiling.renderer_roofline(*shape, hbm_gbps=819.0,
                                             mxu_tflops=98.0)
    assert ours == theirs
    assert profiling.renderer_roofline(*shape, hbm_gbps=3350.0,
                                       mxu_tflops=165.0) == \
        ref_profiling.renderer_roofline(*shape, hbm_gbps=3350.0,
                                        mxu_tflops=165.0)


def test_roofline_defaults_are_the_h100s():
    r = profiling.renderer_roofline(*HEADLINE)
    assert r["t_memory_bound_s"] * 1e3 == pytest.approx(1.3095, abs=1e-4)
    assert r["t_speed_of_light_s"] == r["t_memory_bound_s"]
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    t_bytes, by = chip_smoke.kernel_bounds()["fused_render"]
    assert by == "bytes"
    assert r["t_memory_bound_s"] * 1e3 == pytest.approx(t_bytes, rel=1e-9)
    # f32 grade: 3 TF32 passes at 495 TFLOP/s, chip_smoke's rule.
    flops = 8 * np.prod(HEADLINE, dtype=np.float64)
    assert r["t_compute_bound_s"] == pytest.approx(
        chip_smoke.TF32_PASSES * flops / chip_smoke.TF32_FLOPS_PER_S,
        rel=1e-12)


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_xla_trace_writes_annotated_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.xla_trace(logdir):
        with profiling.annotate("dm.test_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _trace_events(logdir)}
    assert "dm.test_range" in names


def test_annotate_outside_a_trace_is_a_no_op():
    with profiling.annotate("dm.nothing"):
        x = torch.arange(4).sum()
    assert int(x) == 6


def test_profiling_names_exist():
    """The names ``tests/test_docs.py`` checks in the JAX package."""
    for attr in ("StageTimer", "xla_trace", "renderer_roofline",
                 "annotate"):
        assert hasattr(profiling, attr), attr


# ----------------------------------------------------------------------------
# On the card (skipped without one)
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = dmt.config.get("device")
    dmt.config.set("device", "cuda")
    yield torch.device("cuda")
    dmt.config.set("device", old)


@pytest.mark.gpu
def test_card_stage_waits_for_the_render(cuda):
    """A stage around a card render times the render, not its launch:
    each stage is at least 0.95 x the same call's CUDA-event time."""
    c = dmt.consts
    n = 32768
    d = make_synthetic_paths(n_ue=n, max_paths=25, seed=21)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    ds = dmt.Dataset(d)
    params = dmt.ChannelGenParameters()
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([8, 8])
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(64)
    h = ds.compute_channels(params, to_device=True)
    torch.cuda.synchronize()
    timer = profiling.StageTimer()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with timer.stage("serve"):
            start.record()
            ds.compute_channels(params, to_device=True, out=h)
            end.record()
        assert end.query(), "the stage ended before the render"
        assert timer.records[-1][1] * 1e3 >= 0.95 * start.elapsed_time(end)
