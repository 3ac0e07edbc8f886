"""What the metric readers read: the window's statistics (end-to-end
readers, ``end_to_end/<name>.py``) and the traced cycle with the cell's
shapes (per-layer readers, ``layer_metrics/<name>.py``). Each reader's
``read(ctx)`` returns a number, or None where there is nothing to read.
"""

from __future__ import annotations

import glob
import os

from . import peaks, registry


class WindowContext:
    """``window_s``, ``calls``, ``users``, ``call_s`` (each call's host
    seconds), ``peak_bytes`` and ``setup_s`` of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class LayerContext:
    """The traced cycle (``trace``), the shapes of each traced call
    (``shapes``: the dict a roofline count takes), the port's named
    kernels (``KERNEL`` of every ``roofline/*.py``) and the untraced
    window that ran before (``window``, a WindowContext)."""

    def __init__(self, trace, shapes, window=None):
        self.trace, self.shapes, self.window = trace, shapes, window
        self.kernels = {name: registry.load_module("roofline", name)
                        for name in roofline_names()}

    @property
    def calls(self) -> int:
        return self.trace.calls

    def is_named(self, op_name: str) -> bool:
        return any(m.KERNEL in op_name for m in self.kernels.values())

    def bound(self, kernel: str):
        """(least seconds of the kernel's work summed over the traced
        calls, what sets it)."""
        total, by = 0.0, set()
        for s in self.shapes:
            t, b = peaks.bound_s(*self.kernels[kernel].count(s))
            total += t
            by.add(b)
        return total, "/".join(sorted(by))

    def roofline_pct(self, kernel: str):
        """The kernel's least time over its profiled time, in percent;
        None where it did not run, or ran other than once per call."""
        ops = self.trace.named(self.kernels[kernel].KERNEL)
        if not ops or len(ops) != len(self.shapes):
            return None
        spent = sum(e - s for s, e, _ in ops) * 1e-6
        return 100.0 * self.bound(kernel)[0] / spent

    def device_ms_per_call(self, keep) -> float:
        """Device milliseconds per call of the ops ``keep(name)`` takes."""
        return sum(e - s for s, e, n in self.trace.device if keep(n)) \
            * 1e-3 / self.calls

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.trace.busy_us() /
                        self.trace.window_us())


def roofline_names() -> list:
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(registry.BENCH_DIR, "roofline", "*.py")))


def mean_ms(values):
    """Mean of the non-None microsecond values, in ms; None if none."""
    vals = [v for v in values if v is not None]
    return sum(vals) / len(vals) * 1e-3 if vals else None
