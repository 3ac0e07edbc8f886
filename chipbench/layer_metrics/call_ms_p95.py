"""95th percentile of every call's host time in the run's window (before
the traced cycle, with the profiler off), from the call to the return of
its result (statistics.quantiles, inclusive method)."""

import statistics


def read(ctx):
    call_s = ctx.window.call_s
    if len(call_s) < 20:
        return None
    return 1e3 * statistics.quantiles(call_s, n=100, method="inclusive")[94]
