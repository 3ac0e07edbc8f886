"""The traced run: ``torch.profiler`` over a few calls, reduced to what the
per-layer readers take.

Each call runs inside a ``record_function`` span named ``SPAN``. The
profiler runs one warm cycle and one active cycle of ``trace_calls`` calls
each (its first cycle can drop device events), and the active cycle's
Chrome trace is read back: device operations (kernels, copies, memsets),
the host's CUDA runtime calls, its operators and the harness's spans, all
on one clock in microseconds. A cycle in which the profiler recorded no
device event is traced again, up to ``TRIES`` cycles.
"""

from __future__ import annotations

import json
import os
import tempfile

SPAN = "chipbench.call"
TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
ENQUEUES = ("Launch", "Memcpy", "Memset")      # runtime calls that enqueue
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    """One traced cycle: ``device``, ``spans``, ``runtime`` and ``host``
    lists of (start, end, name) in microseconds, sorted by start."""

    def __init__(self, events: list):
        def pick(cats, name=None):
            return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]) for e in events
                          if e.get("ph") == "X" and e.get("cat") in cats and
                          (name is None or e["name"] == name))
        self.device = pick(DEVICE_CATS)
        self.spans = pick(("user_annotation",), SPAN)
        self.runtime = pick(RUNTIME_CATS)
        self.host = [h for h in pick(HOST_CATS) if h[2] != SPAN and
                     not h[2].startswith("ProfilerStep")]
        ends = [s[1] for s in self.spans] + [d[1] for d in self.device]
        starts = [s[0] for s in self.spans] + [d[0] for d in self.device]
        self.start, self.end = (min(starts), max(ends)) if starts else (0, 0)

    @property
    def calls(self) -> int:
        return len(self.spans)

    def busy_us(self) -> float:
        """Time in which some device operation ran (their union)."""
        busy, reach = 0.0, self.start
        for s, e, _ in self.device:
            busy += max(0.0, e - max(s, reach))
            reach = max(reach, e)
        return busy

    def window_us(self) -> float:
        return self.end - self.start

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with no device op."""
        out, reach = [], self.start
        for s, e, _ in self.device:
            if s > reach:
                out.append((reach, s))
            reach = max(reach, e)
        if self.end > reach:
            out.append((reach, self.end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host activity at time ``t``."""
        inner = [h for h in self.host if h[0] <= t <= h[1]]
        if not inner:
            return "host, outside any profiled operator"
        return min(inner, key=lambda h: h[1] - h[0])[2]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (at each gap's middle), in seconds."""
        ops, idle = {}, {}
        for s, e, name in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
        for s, e in self.gaps():
            name = self.host_at((s + e) / 2)
            idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
        return {k: [[n, v] for n, v in sorted(d.items(),
                                              key=lambda x: -x[1])[:top]]
                for k, d in (("device_ops", ops), ("idle_gaps", idle))}

    def named(self, kernel: str) -> list:
        """Device operations whose name holds ``kernel``."""
        return [d for d in self.device if kernel in d[2]]

    def first_enqueue_us(self) -> list:
        """Per span: from its start to its first runtime call that
        enqueues device work (None where it makes none)."""
        out = []
        for s, e, _ in self.spans:
            first = next((r[0] for r in self.runtime
                          if s <= r[0] <= e and
                          any(k in r[2] for k in ENQUEUES)), None)
            out.append(None if first is None else first - s)
        return out

    def after_last_device_us(self) -> list:
        """Per span: from the end of the last device op that ends inside it
        to the span's end (None where none does)."""
        out = []
        for s, e, _ in self.spans:
            last = max((d[1] for d in self.device if s <= d[1] <= e),
                       default=None)
            out.append(None if last is None else e - last)
        return out


def traced_cycle(call, n_calls: int, sync) -> Trace:
    """Profiles ``n_calls`` calls of ``call`` (after a warm cycle) and
    returns the active cycle's trace; raises if ``TRIES`` cycles recorded
    no device event."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    for _ in range(TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n_calls):
                    with record_function(SPAN):
                        call()
                sync()
                prof.step()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = Trace(json.load(f)["traceEvents"])
        if trace.device and trace.calls == n_calls:
            return trace
        del prof
        torch.cuda.synchronize()
    raise RuntimeError(f"the profiler recorded no device event (or not "
                       f"{n_calls} spans) in {TRIES} cycles")
