"""The program's own spans in a traced cycle: the ``dm.*`` ranges of
``deepmimo_tpu_torch.utils.profiling.span``, which the program records
through ``record_function`` while a profiler runs. ``Trace.host`` keeps
them beside the profiler's operators, on the device's clock, so they reach
the readers unchanged. A program without spans (or a trace without them)
gives no reading: each function returns None.
"""

from __future__ import annotations

PREFIX = "dm."
#: The program's launch spans and the device kernels each launches (a
#: substring of the kernel's name, as ``roofline/*.py`` names them).
LAUNCHES = {"dm.kernel.render_fwd": "render_fwd_kernel",
            "dm.kernel.render_bwd": "render_bwd_kernel",
            "dm.kernel.beam_gain": "beamgain_kernel",
            "dm.kernel.pathsum": "pathsum_kernel"}


def program_spans(trace, name=None) -> list:
    """(start, end, name) of the program's spans, or of those named
    ``name``, in microseconds."""
    return [h for h in trace.host if h[2].startswith(PREFIX) and
            (name is None or h[2] == name)]


def ms_per_call(trace, name: str):
    """Host ms per call inside the spans named ``name`` (spans of one name
    do not nest); None where there is none."""
    spans = program_spans(trace, name)
    if not spans:
        return None
    return sum(e - s for s, e, _ in spans) * 1e-3 / trace.calls


def count_per_call(trace, name: str):
    """Spans named ``name`` per call; None where the program recorded no
    span at all (a count of 0 is a reading where it did)."""
    if not program_spans(trace):
        return None
    return len(program_spans(trace, name)) / trace.calls


def union(intervals) -> list:
    """The (start, end) intervals merged into sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_lead_us(trace) -> float:
    """How far, at the least, the profiler placed this cycle's device
    timeline early against the host's: the most by which a port kernel
    starts on the device before the host span that launches it (each
    kernel's launches paired with its spans in order, where their counts
    agree), or 0. The profiler does so in about one cycle in nine, by up
    to ~0.6 ms."""
    lead = 0.0
    for name, kernel in LAUNCHES.items():
        launches, ops = program_spans(trace, name), trace.named(kernel)
        if len(launches) == len(ops):
            lead = max([lead] + [s[0] - d[0] for s, d in zip(launches, ops)])
    return lead


def device_early(trace) -> bool:
    """Whether some port kernel starts on the device before the span that
    launches it (:func:`device_lead_us`)."""
    return device_lead_us(trace) > 0


def idle_in_program_pct(trace):
    """Share of the traced window, in percent, in which no device op ran
    while the host was inside some program span: the part of the device's
    idle share (``idle_pct``) that the program's own code holds; the rest
    is the caller's. None where the program recorded no span. Where the
    device's timeline is placed early, the spans are moved early by the
    lead (:func:`device_lead_us`) before they meet the device's gaps, so
    that no kernel starts before its launch; the gaps, and so the bound
    ``idle_pct``, stay as the trace has them."""
    spans = program_spans(trace)
    if not spans:
        return None
    lead = device_lead_us(trace)
    inside = union((s - lead, e - lead) for s, e, _ in spans)
    return 100.0 * overlap_us(trace.gaps(), inside) / trace.window_us()
