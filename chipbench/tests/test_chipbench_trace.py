"""The reduction of a traced cycle, on a hand-made Chrome trace."""

import pytest

from chipbench.harness import readers, registry, trace


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def two_calls():
    """Two calls of 100 us: host entry 10 us, a small kernel, the render
    kernel, a D2H copy, then 10 us to return."""
    ev = []
    for c in (0, 200):
        ev += [X("user_annotation", trace.SPAN, c, 100),
               X("cpu_op", "aten::to", c + 2, 6),
               X("cuda_runtime", "cudaLaunchKernel", c + 10, 2),
               X("kernel", "elementwise_kernel", c + 12, 8),
               X("cuda_runtime", "cudaLaunchKernel", c + 20, 2),
               X("kernel", "void render_fwd_kernel<3, float>(...)",
                 c + 30, 40),
               X("cuda_runtime", "cudaMemcpyAsync", c + 70, 20),
               X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", c + 72,
                 18),
               X("gpu_user_annotation", trace.SPAN, c + 12, 78)]
    return ev


def test_window_busy_gaps():
    tr = trace.Trace(two_calls())
    assert tr.calls == 2
    assert tr.window_us() == 300
    assert tr.busy_us() == 2 * (8 + 40 + 18)
    assert tr.gaps()[0] == (0, 12)
    assert sum(e - s for s, e in tr.gaps()) == 300 - tr.busy_us()
    assert tr.first_enqueue_us() == [10, 10]
    assert tr.after_last_device_us() == [10, 10]


def test_breakdown_top_ops_and_idle_by_host():
    b = trace.Trace(two_calls()).breakdown()
    assert b["device_ops"][0] == ["void render_fwd_kernel<3, float>(...)",
                                  pytest.approx(80e-6)]
    idle = dict(b["idle_gaps"])
    assert idle["aten::to"] == pytest.approx(2 * 6e-6) or \
        "aten::to" in idle
    assert sum(idle.values()) == pytest.approx(
        (300 - 2 * 66) * 1e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_layer_readers():
    shape = dict(users=1000, max_paths=25, valid_paths=13000, rx=1, tx=64,
                 k=64, beams=0)
    ctx = readers.LayerContext(trace.Trace(two_calls()), [shape, shape])
    read = {n: registry.load_module("layer_metrics", n).read(ctx)
            for n in ("entry_host_ms.serve", "result_host_ms.host",
                      "prologue_ms.serve", "launches_per_call.serve",
                      "render_fwd_roofline.serve", "beam_gain_roofline",
                      "idle_pct.serve", "step_other_ms.calib")}
    assert read["entry_host_ms.serve"] == pytest.approx(0.010)
    assert read["result_host_ms.host"] == pytest.approx(0.010)
    assert read["prologue_ms.serve"] == pytest.approx(0.008)
    assert read["launches_per_call.serve"] == 3
    assert read["beam_gain_roofline"] is None     # never ran: no reading
    least = ctx.bound("render_fwd")[0] / 2
    assert read["render_fwd_roofline.serve"] == pytest.approx(
        100 * least / 40e-6)
    assert read["idle_pct.serve"] == pytest.approx(100 * (1 - 132 / 300))
    assert read["step_other_ms.calib"] == pytest.approx(0.026)


def test_no_span_no_device():
    tr = trace.Trace([X("cpu_op", "aten::add", 0, 5)])
    assert tr.calls == 0 and tr.device == [] and tr.busy_us() == 0


def test_tail_of_the_window():
    window = readers.WindowContext(call_s=[i * 1e-3 for i in range(1, 101)])
    ctx = readers.LayerContext(trace.Trace(two_calls()), [], window)
    p95 = registry.load_module("layer_metrics", "call_ms_p95.host").read(ctx)
    assert p95 == pytest.approx(95.05)
    ctx.window = readers.WindowContext(call_s=[1e-3] * 5)
    assert registry.load_module("layer_metrics",
                                "call_ms_p95.host").read(ctx) is None
