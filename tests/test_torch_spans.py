"""The port's program spans (``deepmimo_tpu_torch.utils.profiling.span``,
the port's name for ``annotate``).

- With no profiler running, ``span`` is one shared null context and no
  ``record_function`` is entered by a whole ``compute_channels`` call.
- Under a CPU ``torch.profiler``, a host-result ``compute_channels`` and a
  ``compute_beam_gains`` each record ``dm.entry``, ``dm.prologue`` and
  ``dm.unpack`` once, in that order and one after another (the beam
  gains' ``dm.codebook`` inside ``dm.entry``), and neither
  ``dm.h2d`` nor ``dm.d2h`` (nothing crosses a bus on the host); streamed
  over two user blocks, each block records its prologue and its unpack; a
  calibration step records ``dm.calib.forward`` (with ``dm.calib.loss``
  inside it), ``dm.calib.backward`` and ``dm.calib.update``.
- A dual-polar serving call records ``dm.polar`` inside ``dm.prologue``
  (between ``dm.entry`` and the unpack), and a single-polarization call
  records none (its order above is unchanged).
- Results are bit-identical with the profiler on and off.
- On the card (``gpu``): one serving call's trace holds the program's
  spans and the device's operations on one clock, in one launch and
  streamed over two blocks; a dual-polar dataset's two polarization
  stacks are each uploaded inside a ``dm.h2d`` span on the first call,
  and not again.

No test here imports JAX, so the ``gpu`` tests run where JAX is not
installed: ``python -m pytest -m gpu --noconftest tests/test_torch_spans.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.parallel import sharded
from deepmimo_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import make_synthetic_paths  # noqa: E402

SERVING = ("dm.entry", "dm.prologue", "dm.unpack")
BUS = ("dm.h2d", "dm.d2h")
CALIB = ("dm.calib.forward", "dm.calib.loss", "dm.calib.backward",
         "dm.calib.update")


@pytest.fixture
def cpu():
    old = dmt.config.get("device")
    dmt.config.set("device", "cpu")
    yield torch.device("cpu")
    dmt.config.set("device", old)


@pytest.fixture
def streamed():
    """Host results streamed over user blocks of 24 (``_dataset``'s 48
    users: two blocks)."""
    old = {k: dmt.config.get(k)
           for k in ("max_device_output_bytes", "user_block")}
    dmt.config.set("max_device_output_bytes", 1)
    dmt.config.set("user_block", 24)
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


def _dataset(n_ue=48, max_paths=10, seed=3):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    return dmt.Dataset(d)


def _polar_dataset(n_ue=48, max_paths=10, seed=3):
    """``_dataset`` with the four polarizations' powers and phases."""
    ds = _dataset(n_ue, max_paths, seed)
    r = np.random.default_rng(seed)
    nan = np.isnan(ds["power"])
    for pol in ("vv", "vh", "hh", "hv"):
        for key, lo, hi in (("power", -130, -60), ("phase", -180, 180)):
            ds[f"{key}_{pol}"] = np.where(
                nan, np.nan, r.uniform(lo, hi, nan.shape)).astype(np.float32)
    return ds


def _params(bs=(4, 2), n_k=4, polar=False):
    c = dmt.consts
    params = dmt.ChannelGenParameters()
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array(bs)
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(n_k)
    params[c.PARAMSET_POLAR_EN] = int(polar)
    return params


def _codebook(n_beams=3, n_tx=8, seed=5):
    r = np.random.default_rng(seed)
    return np.exp(1j * r.uniform(-np.pi, np.pi, (n_beams, n_tx))) / \
        np.sqrt(n_tx)


def _calib_state(n_ue=24, seed=7):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=6, seed=seed)
    paths = dmt.PathData.from_numpy(*(d[k] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")),
        device="cpu")
    cfg, bs, ue = _params().to_config(n_ue, device="cpu")
    target = dmt.ops.render_channels_planes(
        paths, dmt.AntennaPanel.make((10.0, 0.0, 0.0), 0.5, device="cpu"),
        ue, cfg)
    return sharded.init_calib_params(paths, bs, ue), paths, target, cfg


def _calib_step(state):
    params, paths, target, cfg = state
    new, loss = sharded.training_step_planes(params, paths, target, cfg,
                                             lr=1e-3)
    return [x.detach() for x in new.leaves()] + [loss]


def _spans(prof):
    """(start, end, name) of the program's spans in ``prof``, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("dm."))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_off_is_the_shared_null_context(cpu, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span is profiling.annotate
    assert profiling.span("dm.entry") is profiling.span("dm.d2h")
    with profiling.span("dm.entry") as inside:
        assert inside is None
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    ds, params = _dataset(), _params()
    ds.compute_channels(params)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        ds.compute_channels(params)
    assert set(SERVING) <= set(entered)


@pytest.mark.parametrize("entry", ["compute_channels", "compute_beam_gains"])
def test_serving_call_records_its_stages_in_order(cpu, entry):
    ds, params = _dataset(), _params()
    kw = {"codebook": _codebook()} if entry == "compute_beam_gains" else {}
    getattr(ds, entry)(params, **kw)        # the caches filled, as served
    _, spans = _profiled(lambda: getattr(ds, entry)(params, **kw))
    names = [n for _, _, n in spans]
    if entry == "compute_beam_gains":   # the codebook's planes, in the entry
        assert names == [SERVING[0], "dm.codebook", *SERVING[1:]], names
        (s0, e0, _), (s1, e1, _) = spans[:2]
        assert s0 <= s1 and e1 <= e0
        spans = [spans[0]] + spans[2:]
        names = [n for _, _, n in spans]
    assert names == list(SERVING), names
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start                 # one after another, none nested


@pytest.mark.parametrize("entry", ["channels", "channels_device",
                                   "beam_gains"])
def test_dual_polar_call_records_polar_inside_prologue(cpu, entry):
    ds, params = _polar_dataset(), _params(polar=True)
    if entry == "beam_gains":
        def call():
            return ds.compute_beam_gains(params, codebook=_codebook())
    else:
        def call():
            return ds.compute_channels(
                params, to_device=entry == "channels_device")
    call()                                  # the caches filled, as served
    _, spans = _profiled(call)
    names = [n for _, _, n in spans]
    tail = [] if entry == "channels_device" else ["dm.unpack"]
    book = ["dm.codebook"] if entry == "beam_gains" else []
    assert names == ["dm.entry"] + book + ["dm.prologue", "dm.polar"] + \
        tail, names
    by = {n: (s, e) for s, e, n in spans}
    if book:
        assert by["dm.entry"][0] <= by["dm.codebook"][0] and \
            by["dm.codebook"][1] <= by["dm.entry"][1]
    pro, pol = by["dm.prologue"], by["dm.polar"]
    assert pro[0] <= pol[0] and pol[1] <= pro[1]
    assert by["dm.entry"][1] <= pro[0]
    if tail:
        assert pro[1] <= by["dm.unpack"][0]


def test_streamed_call_records_each_blocks_stages(cpu, streamed):
    """Two blocks: both render (a prologue each) before the first is
    collected, as two blocks stay in flight; then each is unpacked."""
    ds, params = _dataset(), _params()
    ds.compute_channels(params)
    _, spans = _profiled(lambda: ds.compute_channels(params))
    names = [n for _, _, n in spans]
    assert names == ["dm.entry", "dm.prologue", "dm.prologue", "dm.unpack",
                     "dm.unpack"], names
    assert not set(BUS) & set(names)


def test_calibration_step_records_its_stages(cpu):
    _, spans = _profiled(lambda: _calib_step(_calib_state()))
    by = {n: (s, e) for s, e, n in spans if n.startswith("dm.calib.")}
    assert sorted(by) == sorted(CALIB)
    assert sum(n.startswith("dm.calib.") for _, _, n in spans) == 4
    fwd, loss = by["dm.calib.forward"], by["dm.calib.loss"]
    assert fwd[0] <= loss[0] and loss[1] <= fwd[1]
    assert fwd[1] <= by["dm.calib.backward"][0]
    assert by["dm.calib.backward"][1] <= by["dm.calib.update"][0]
    # The forward renders inside it: its prologue is there too.
    assert any(n == "dm.prologue" and fwd[0] <= s and e <= fwd[1]
               for s, e, n in spans)


@pytest.mark.parametrize("what", ["channels", "beam_gains", "calibration",
                                  "streamed"])
def test_results_bit_identical_with_the_profiler_on(cpu, what, request):
    if what == "calibration":
        def call():
            return _calib_step(_calib_state())
    else:
        if what == "streamed":
            request.getfixturevalue("streamed")
        ds, params = _dataset(seed=11), _params()

        def call():
            if what != "beam_gains":
                return [ds.compute_channels(params)]
            return [ds.compute_beam_gains(params, codebook=_codebook())]
    off = call()
    on, spans = _profiled(call)
    assert spans
    for a, b in zip(off, on):
        a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


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


def _chrome_events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"]


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _enqueued_by(ev):
    """Each device op with the runtime call that enqueued it, linked by
    correlation id."""
    runtime = {e["args"]["correlation"]: e for e in ev
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    return [(e, runtime[e["args"]["correlation"]]) for e in ev
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in runtime]


def _card_profiles(call, n, tmp_path):
    """``n`` fresh profiles of one ``call`` on the card, each as (Chrome
    events, device ops linked to their enqueues, the program's spans by
    name)."""
    out = []
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ev = _chrome_events(prof, tmp_path)
        spans = {}
        for e in ev:
            if e.get("cat") == "user_annotation" and \
                    e["name"].startswith("dm."):
                spans.setdefault(e["name"], []).append(_interval(e))
        out.append((ev, _enqueued_by(ev), spans))
    return out


def _inside(t, spans):
    return any(s <= t <= e for s, e in spans)


#: Profiles of 5 in which the device-side relations must hold: the
#: profiler places the device's timeline on the host's clock, and in about
#: one profile in nine places it up to ~0.6 ms early, so that a kernel
#: starts before the span that launches it.
ON_CLOCK = 3


@pytest.mark.gpu
def test_card_spans_and_device_ops_share_a_clock(cuda, tmp_path):
    """One host-result serving call on the card, profiled 5 times. In every
    profile, on the host's clock: the program's spans, ``dm.h2d`` among
    them; the render kernel enqueued inside ``dm.kernel.render_fwd``; the
    copy to the host enqueued inside ``dm.d2h``. Against the device's
    clock: the render kernel starts after its span starts and the copy
    ends inside ``dm.d2h``, in at least ``ON_CLOCK`` profiles, and every
    profile where the kernel starts early is one the benchmark's
    ``device_early`` catches."""
    from chipbench.harness import spans as bench_spans, trace as bench_trace
    ds, params = _dataset(n_ue=8192, max_paths=25), _params((8, 8), 64)
    ds.compute_channels(params)              # the kernel built, caches set
    torch.cuda.synchronize()
    on_clock = 0
    for ev, links, spans in _card_profiles(
            lambda: ds.compute_channels(params), 5, tmp_path):
        assert set(SERVING) | set(BUS) | {"dm.kernel.render_fwd"} <= \
            set(spans)
        if not links:                        # no device event recorded
            continue
        (k0, k1), = spans["dm.kernel.render_fwd"]
        (c0, c1), = spans["dm.d2h"]
        (d, r), = [(d, r) for d, r in links
                   if "render_fwd_kernel" in d["name"]]
        assert k0 <= float(r["ts"]) <= k1
        d2h = [(d, r) for d, r in links if "DtoH" in d["name"]]
        assert d2h and all(c0 <= float(r["ts"]) <= c1 for _, r in d2h)
        early = float(d["ts"]) < k0
        assert bench_spans.device_early(bench_trace.Trace(ev)) is early
        on_clock += not early and all(c0 <= _interval(c)[1] <= c1
                                      for c, _ in d2h)
    assert on_clock >= ON_CLOCK


@pytest.mark.gpu
def test_card_streamed_copies_inside_d2h(cuda, tmp_path):
    """A host result streamed over two user blocks on the card, profiled 5
    times: each block's copy to the host enqueued inside a ``dm.d2h`` span
    (on the side stream, behind the block's render) in every profile, and
    waited for in a later one (the two waits are the ``dm.d2h`` spans that
    enqueue no copy), which it ends before in at least ``ON_CLOCK``."""
    ds, params = _dataset(n_ue=8192, max_paths=25), _params((8, 8), 64)
    old = {k: dmt.config.get(k)
           for k in ("max_device_output_bytes", "user_block")}
    dmt.config.set("max_device_output_bytes", 1)
    dmt.config.set("user_block", 4096)
    try:
        ds.compute_channels(params)
        torch.cuda.synchronize()
        profiles = _card_profiles(lambda: ds.compute_channels(params), 5,
                                  tmp_path)
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)
    on_clock = 0
    for ev, links, spans in profiles:
        d2h = sorted(spans["dm.d2h"])
        assert len(d2h) == 4 and "dm.unpack" in spans
        if not links:
            continue
        copies = sorted(((d, r) for d, r in links if "DtoH" in d["name"]),
                        key=lambda x: float(x[1]["ts"]))
        assert len(copies) == 2
        assert all(_inside(float(r["ts"]), d2h) for _, r in copies)
        waits = [w for w in d2h if not any(
            w[0] <= float(r["ts"]) <= w[1] for _, r in copies)]
        assert len(waits) == 2
        on_clock += all(_interval(c)[1] <= w[1]
                        for (c, _), w in zip(copies, waits))
    assert on_clock >= ON_CLOCK


@pytest.mark.gpu
def test_card_polar_stacks_uploaded_once(cuda):
    """A dual-polar dataset's power and phase stacks go to the card inside
    one ``dm.h2d`` span each on the first call, and come from the cache
    after: no span on the next call, the same tensors."""
    ds = _polar_dataset(n_ue=256, max_paths=25)
    first, spans = _profiled(ds._polar_stacks)
    assert [n for _, _, n in spans] == ["dm.h2d", "dm.h2d"]
    assert all(x.device.type == "cuda" and x.shape == (4, 256, 25)
               for x in first)
    again, spans = _profiled(ds._polar_stacks)
    assert spans == [] and all(a is b for a, b in zip(first, again))
