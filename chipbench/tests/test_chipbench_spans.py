"""The readers of the program's spans (``harness/spans.py``), on hand-made
Chrome traces with their closed forms, and on a CPU profile of a cell's
own calls."""

import json
import os
import tempfile

import pytest

from chipbench.harness import drive, readers, registry, spans, trace

SPAN_METRICS = ("entry_span_ms.serve", "entry_span_ms.host",
                "prologue_span_ms.serve", "prologue_span_ms.host",
                "uploads_per_call.serve", "uploads_per_call.host",
                "d2h_wait_ms.host", "unpack_ms.host",
                "idle_in_program_pct.serve", "idle_in_program_pct.host",
                "idle_in_program_pct.calib")


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def two_calls(program=True):
    """Two calls of 100 us, as ``test_chipbench_trace.two_calls``, with the
    program's spans: entry 1-9 (two uploads inside), prologue 10-20, the
    render's launch 20-23, the copy to the host 70-91, the unpack 91-97;
    on the device a small kernel 12-20, the render 30-70, the copy 72-90."""
    ev = []
    for c in (0, 200):
        ev += [X("user_annotation", trace.SPAN, c, 100),
               X("cuda_runtime", "cudaLaunchKernel", c + 10, 2),
               X("kernel", "elementwise_kernel", c + 12, 8),
               X("kernel", "void render_fwd_kernel<3, float>(...)",
                 c + 30, 40),
               X("cuda_runtime", "cudaMemcpyAsync", c + 70, 20),
               X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", c + 72,
                 18)]
        if program:
            ev += [X("user_annotation", "dm.entry", c + 1, 8),
                   X("user_annotation", "dm.h2d", c + 2, 1),
                   X("user_annotation", "dm.h2d", c + 4, 1),
                   X("user_annotation", "dm.prologue", c + 10, 10),
                   X("user_annotation", "dm.kernel.render_fwd", c + 20, 3),
                   X("user_annotation", "dm.d2h", c + 70, 21),
                   X("user_annotation", "dm.unpack", c + 91, 6),
                   X("gpu_user_annotation", "dm.prologue", c + 12, 8)]
    return ev


def read_all(tr):
    ctx = readers.LayerContext(tr, [])
    return {n: registry.load_module("layer_metrics", n).read(ctx)
            for n in SPAN_METRICS + ("idle_pct.serve",)}


def test_span_readers_closed_form():
    got = read_all(trace.Trace(two_calls()))
    assert got["entry_span_ms.serve"] == pytest.approx(0.008)
    assert got["entry_span_ms.host"] == got["entry_span_ms.serve"]
    assert got["prologue_span_ms.host"] == pytest.approx(0.010)
    assert got["uploads_per_call.serve"] == 2
    assert got["d2h_wait_ms.host"] == pytest.approx(0.021)
    assert got["unpack_ms.host"] == pytest.approx(0.006)
    # Idle inside the spans, per call: 8 + 2 us of the gap before the first
    # kernel (entry, prologue), 3 of the one before the render (launch),
    # 2 before the copy, 7 after it (the copy's span, the unpack).
    assert got["idle_in_program_pct.serve"] == pytest.approx(
        100 * 2 * 22 / 300)
    assert got["idle_pct.serve"] == pytest.approx(100 * (1 - 132 / 300))
    for part in ("serve", "host", "calib"):
        assert got[f"idle_in_program_pct.{part}"] <= got["idle_pct.serve"]


def test_span_readers_silent_without_program_spans():
    got = read_all(trace.Trace(two_calls(program=False)))
    assert all(got[n] is None for n in SPAN_METRICS), got
    assert got["idle_pct.serve"] is not None


def test_uploads_count_zero_where_the_program_made_none():
    ev = [e for e in two_calls() if e["name"] != "dm.h2d"]
    got = read_all(trace.Trace(ev))
    assert got["uploads_per_call.serve"] == 0
    assert got["d2h_wait_ms.host"] == pytest.approx(0.021)


def test_idle_in_program_never_exceeds_idle():
    """Spans covering the whole window read the whole idle share; spans on
    the device's busy time only read none."""
    ev = two_calls(program=False)
    tr = trace.Trace(ev + [X("user_annotation", "dm.entry", 0, 300)])
    whole = read_all(tr)
    assert whole["idle_in_program_pct.serve"] == pytest.approx(
        whole["idle_pct.serve"])
    tr = trace.Trace(ev + [X("user_annotation", "dm.kernel.render_fwd",
                             c + 30, 40) for c in (0, 200)])
    assert read_all(tr)["idle_in_program_pct.serve"] == 0


def shifted(events, us):
    """The events with the device's timeline moved by ``us``."""
    return [dict(e, ts=e["ts"] + us) if e["cat"] in trace.DEVICE_CATS
            else e for e in events]


@pytest.mark.parametrize("us, early", [(0, False), (-5, False),
                                       (-15, True), (-60, True)])
def test_idle_in_program_silent_where_the_device_timeline_is_early(us,
                                                                   early):
    """The render kernel starts 10 us after its launch span starts; moved
    more than that early, the cycle is caught, and the program's spans are
    moved early by the lead before they meet the device's gaps: the
    reading stays, within the device's idle share. The host-only readers
    read as before."""
    tr = trace.Trace(shifted(two_calls(), us))
    assert spans.device_early(tr) is early
    assert spans.device_lead_us(tr) == (max(0, -us - 10))
    got = read_all(tr)
    assert 0 < got["idle_in_program_pct.serve"] <= got["idle_pct.serve"]
    assert got["entry_span_ms.serve"] == pytest.approx(0.008)
    assert got["d2h_wait_ms.host"] == pytest.approx(0.021)


def test_idle_in_program_reads_an_early_cycle_with_the_spans_moved():
    """The device's timeline 15 us early: the lead is 5 us, the window
    -3..300 us. With the spans 5 us earlier, per call: 10 us of the gap
    before the render (prologue, launch), 17 after the copy (its span, the
    unpack), and 1 us of the next call's entry in the first call's last
    gap."""
    tr = trace.Trace(shifted(two_calls(), -15))
    assert read_all(tr)["idle_in_program_pct.serve"] == pytest.approx(
        100 * 55 / 303)


def test_device_early_pairs_launches_only_where_counts_agree():
    """A cycle that dropped a kernel event cannot pair launches with
    kernels, and is not judged."""
    ev = shifted(two_calls(), -15)
    tr = trace.Trace([e for e in ev if not (
        "render_fwd_kernel" in e["name"] and e["ts"] > 100)])
    assert not spans.device_early(tr)
    beam = [dict(e, name="dm.kernel.beam_gain")
            if e["name"] == "dm.kernel.render_fwd" else
            dict(e, name="void beamgain_kernel<float>(...)")
            if "render_fwd_kernel" in e["name"] else e
            for e in shifted(two_calls(), -15)]
    assert spans.device_early(trace.Trace(beam))


def test_breakdown_names_the_idle_by_program_span():
    idle = dict(trace.Trace(two_calls()).breakdown()["idle_gaps"])
    assert {"dm.entry", "dm.unpack"} <= set(idle)
    before = dict(trace.Trace(two_calls(False)).breakdown()["idle_gaps"])
    unnamed = "host, outside any profiled operator"
    assert idle.get(unnamed, 0) < before[unnamed]


def test_union_and_overlap():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    a, b = [(0, 10), (20, 30)], [(5, 25), (28, 40)]
    assert spans.overlap_us(a, b) == 5 + 5 + 2
    assert spans.overlap_us(a, []) == 0


def test_a_cells_calls_reach_the_readers(cpu_port):
    """Two calls of ``quickstart.host_result`` at 64 users on the port's
    CPU path, profiled as the traced cycle profiles them: the program's
    spans come through ``Trace`` unchanged. (No device: nothing is uploaded
    or copied to the host, and the whole window is idle.)"""
    from torch.profiler import ProfilerActivity, profile, record_function
    bench = registry.load_benchmark(os.path.dirname(registry.BENCH_DIR))
    w = registry.workload(bench, "quickstart.host_result")
    mix = registry.load_mix(w["traffic"])
    with drive.program_config(cpu_port, mix):
        d = drive.make(cpu_port, registry.load_config(w["config"]), mix,
                       2**31 + 5, "cpu", 64)
        d.setup()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with record_function(trace.SPAN):
                    d.call()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = trace.Trace(json.load(f)["traceEvents"])
    assert tr.calls == 2
    got = read_all(tr)
    for name in ("entry_span_ms.host", "prologue_span_ms.host",
                 "unpack_ms.host", "idle_in_program_pct.host"):
        assert got[name] is not None and got[name] > 0, name
    # Nothing crosses a bus on the host: no upload, no copy to the host.
    assert got["uploads_per_call.host"] == 0
    assert got["d2h_wait_ms.host"] is None
    assert got["idle_in_program_pct.host"] <= got["idle_pct.serve"]
