"""Host ms per call inside the program's ``dm.prologue`` span: the time to
enqueue the fused kernels' per-path inputs (beside ``prologue_ms``, the same
ops' device time: the prologue is enqueue-bound where this is the larger)."""

from chipbench.harness.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx.trace, "dm.prologue")
