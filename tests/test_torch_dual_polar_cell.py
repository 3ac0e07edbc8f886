"""The dual-polarized headline deployment of the benchmark
(``chipbench/configs/asu_campus_mimo64_dualpol.json``, cell
``dualpol.serve_device``) on the port's CPU path, against the plain
reference ``chipbench/reference/dual_polar.py``:

- dual-polar ``Dataset.compute_channels`` (the host dict and the raw
  device planes, packed and stacked) on seeded random paths of the cell's
  mix, for 2x2 and 8x8 panels at 8 and 64 subcarriers: within 1e-5 of
  max|H| of the float64 reference;
- the reference's four slices are four single-polarization references,
  each with its polarization's power and phase;
- the cell through ``main.run_cell`` at 64 users: correct, and not
  correct with each serving fault planted;
- ``render_fwd_polar_roofline``: its count against the closed form, the
  headline's least time, its slot count tied to ``POLS``, and its reading
  from a trace.
"""

import ast
import copy
import os
import time

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from chipbench.harness import drive, faults, inputs, main, peaks, registry
from chipbench.harness.trace import Trace
from chipbench.reference import channels as ref
from deepmimo_tpu_torch.generator.dataset import POLS

CONFIG = "asu_campus_mimo64_dualpol"
CELL = "dualpol.serve_device"
BENCH = registry.load_benchmark(os.path.dirname(registry.BENCH_DIR))
ROOFLINE = registry.load_module("layer_metrics", "render_fwd_polar_roofline")
TOL = 1e-5                     # of max|H|: float32 against float64
N_UE = 48


@pytest.fixture
def cpu():
    old = dmt.config.get("device")
    dmt.config.set("device", "cpu")
    yield dmt
    dmt.config.set("device", old)


def _config(bs, n_k):
    config = copy.deepcopy(registry.load_config(CONFIG))
    cp = config["channel_params"]
    cp["bs_antenna"]["shape"] = list(bs)
    cp["ofdm"]["selected_subcarriers"] = list(range(n_k))
    return config


def _paths(seed=2**31 + 5, n_ue=N_UE):
    """The cell's mix at ``n_ue`` users: 1-25 valid paths a user and the
    four polarizations' powers and phases."""
    return inputs.path_matrices(n_ue, 25, seed,
                                registry.load_mix("serve_device_polar"))


def _dataset(data):
    n = data["n_valid"].shape[0]
    return dmt.Dataset(dict({k: v for k, v in data.items()
                             if k != "n_valid"},
                            rx_pos=np.zeros((n, 3), np.float32),
                            tx_pos=np.zeros((1, 3), np.float32)))


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("n_k", [8, 64])
@pytest.mark.parametrize("bs", [(2, 2), (8, 8)])
def test_dual_polar_channels_match_the_reference(cpu, bs, n_k):
    config = _config(bs, n_k)
    data = _paths()
    ds, params = _dataset(data), drive.channel_params(cpu, config)
    want = ref.channels(ref.paths_to_tensors(data, slice(None), "cpu"),
                        config["channel_params"])       # [U, R, T, 4K]
    assert want.shape == (N_UE, 1, bs[0] * bs[1], len(POLS) * n_k)
    host = ds.compute_channels(params)
    assert list(host) == list(POLS)
    got = torch.cat([torch.as_tensor(host[q]) for q in POLS], dim=-1)
    assert _gap(got.to(torch.complex128), want) <= TOL
    planes = ds.compute_channels(params, to_device=True)
    if planes.dim() == 4:                    # packed [U, R, T, 2*4K]
        got = registry.load_module("drives", "channels") \
            .planes_to_complex(planes, want.shape)
    else:                                    # stacked [2, U, R, T, 4, 1, K]
        got = torch.complex(planes[0].double(),
                            planes[1].double()).reshape(want.shape)
    assert (planes.dim() == 4) == (n_k == 64)
    assert _gap(got, want) <= TOL


def test_reference_slices_are_single_polarization_references():
    config = _config((8, 8), 16)
    single = dict(config["channel_params"], enable_dual_polar=0)
    assert ref.features(config["channel_params"]) == ["dual_polar"]
    assert ref.features(single) == []
    p = ref.paths_to_tensors(_paths(n_ue=16), slice(None), "cpu")
    both = ref.channels(p, config["channel_params"])
    for i, q in enumerate(POLS):
        one = ref.channels(dict(p, power=p["power_" + q.lower()],
                                phase=p["phase_" + q.lower()]), single)
        part = both[..., i * 16:(i + 1) * 16]
        assert float((part - one).abs().max()) <= \
            1e-12 * float(one.abs().max())
    assert not torch.equal(both[..., :16], both[..., 16:32])


def test_reference_imports_only_torch():
    path = os.path.join(registry.BENCH_DIR, "reference", "dual_polar.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"torch"}


@pytest.mark.parametrize("fault", [None] + list(faults.SERVING))
def test_cell_correct_and_faults_caught(cpu, fault):
    undo = faults.plant(fault, cpu) if fault else (lambda: None)
    try:
        result, lines = main.run_cell(
            BENCH, registry.workload(BENCH, CELL), 2**31 + 17, 0.2, False,
            "cpu", time.perf_counter(), n_users=64)
    finally:
        undo()
    assert result["correct"] is (fault is None), lines
    assert set(result["check"]) == {"channels_rel_err"}


def test_polar_cell_renders_four_slots(cpu):
    """The cell's answer is the packed polar planes, 4 x 64 columns of hr
    then of hi a row, written into the previous call's buffer."""
    w = registry.workload(BENCH, CELL)
    mix = registry.load_mix(w["traffic"])
    d = drive.make(cpu, registry.load_config(w["config"]), mix, 3, "cpu",
                   32)
    d.setup()
    first = d.out.data_ptr()
    d.call()
    assert d.out.data_ptr() == first
    assert tuple(d.out.shape) == (32, 1, 64, 2 * len(POLS) * 64)


HEAD = dict(users=131_072, max_paths=25, valid_paths=13 * 131_072, rx=1,
            tx=64, k=64)


def test_roofline_count_closed_form():
    u, p, q, k, nv = 131_072, 25, 64, 64, 13 * 131_072
    n = len(POLS)
    n_bytes = 4 * 5 * u * p + 4 * 2 * n * u * p + 4 * u * q * 2 * n * k
    assert ROOFLINE.count(HEAD) == (n_bytes, 8 * q * n * k * nv)
    assert ROOFLINE.count(HEAD, slots=1) == \
        registry.load_module("roofline", "render_fwd").count(HEAD)


def test_roofline_headline_least_time():
    t, by = peaks.bound_s(*ROOFLINE.count(HEAD))
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(5.179, abs=5e-4)
    assert ROOFLINE.count(HEAD)[0] == 17_350_262_784


def test_roofline_slots_are_the_polarizations():
    assert ROOFLINE.SLOTS == len(POLS) == 4


def _ctx(kernel_us, calls):
    """A traced cycle of ``calls`` calls, with a render kernel of
    ``kernel_us`` at each listed call."""
    from chipbench.harness.readers import LayerContext
    events = []
    for i in range(calls):
        t = 10_000.0 * i
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "chipbench.call", "ts": t, "dur": 9_000.0})
        if i < len(kernel_us):
            events.append({"ph": "X", "cat": "kernel", "ts": t + 100.0,
                           "dur": kernel_us[i],
                           "name": "void render_fwd_kernel<3, float>"})
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "dm.polar", "ts": t + 10.0, "dur": 500.0})
    return LayerContext(Trace(events), [HEAD] * calls)


def test_roofline_reads_one_kernel_a_call():
    least = peaks.bound_s(*ROOFLINE.count(HEAD))[0]
    ctx = _ctx([2 * least * 1e6] * 2, 2)
    assert ROOFLINE.read(ctx) == pytest.approx(50.0)
    assert ROOFLINE.read(_ctx([1000.0], 2)) is None
    assert ROOFLINE.read(_ctx([], 2)) is None


def test_polar_span_reader():
    reader = registry.load_module("layer_metrics", "polar_span_ms.serve")
    assert reader.read(_ctx([1000.0] * 4, 4)) == pytest.approx(0.5)
    bare = _ctx([1000.0], 1)
    bare.trace.host = []                  # a program without the span
    assert reader.read(bare) is None
