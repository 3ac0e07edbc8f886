"""Host-to-device uploads per call: the program's ``dm.h2d`` spans (a small
tensor, or a whole path-data struct, each)."""

from chipbench.harness.spans import count_per_call


def read(ctx):
    return count_per_call(ctx.trace, "dm.h2d")
