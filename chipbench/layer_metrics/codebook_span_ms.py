"""Host ms per call inside the program's ``dm.codebook`` spans: the
codebook made into the kernel's planes (``_codebook_planes``, inside
``dm.entry``, its uploads in ``dm.h2d``) and laid out for the launch
(``beamgain._launch``'s conj(W) [T, B, 2])."""

from chipbench.harness.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx.trace, "dm.codebook")
