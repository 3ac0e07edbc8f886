"""Host ms per call inside the program's ``dm.unpack`` span: the host unpack
of the copied planes or gains into numpy."""

from chipbench.harness.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx.trace, "dm.unpack")
