"""Host ms per call inside the program's ``dm.d2h`` span: the copy of the
result to the host, its wait for the device's queued work included."""

from chipbench.harness.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx.trace, "dm.d2h")
