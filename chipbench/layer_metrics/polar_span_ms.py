"""Host ms per call inside the program's ``dm.polar`` span: the
per-polarization part of a dual-polar prologue (the power and phase stacks
made linear, masked and laid on the kernel's slot axis), inside
``dm.prologue``."""

from chipbench.harness.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx.trace, "dm.polar")
