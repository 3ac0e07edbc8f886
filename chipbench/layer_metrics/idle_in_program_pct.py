"""Share of the traced window, in percent, in which the device is idle while
the host is inside a ``dm.*`` span (``harness/spans.py``); ``idle_pct`` less
this is the caller's share."""

from chipbench.harness.spans import idle_in_program_pct


def read(ctx):
    return idle_in_program_pct(ctx.trace)
