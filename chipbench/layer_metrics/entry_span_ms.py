"""Host ms per call inside the program's ``dm.entry`` span: from the entry
point to its render call (validation, ``to_config`` and its uploads, the
cached path data, the codebook)."""

from chipbench.harness.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx.trace, "dm.entry")
