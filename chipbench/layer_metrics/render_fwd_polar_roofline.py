"""Least time of the forward render kernel's work with ``SLOTS`` slots on
its slot axis, each with its own amplitude and phase (the four
polarizations of a dual-polar render), over its profiled time, in percent;
None unless the kernel ran once a call.

Bytes: the 5 shared per-path inputs (gry, grz, gty, gtz, omega [U, P]) and
the per-slot amp and psi ([U, SLOTS*P]) read once, the planes of H
[U, R*T, 2*SLOTS*K] (float32) written once. Operations: 8 flops per
complex multiply-add, one per (r, t, slot, k) and valid path. The cell's
shapes carry no slot count, so it is kept here.
"""

from chipbench.harness import peaks

SLOTS = 4


def count(s: dict, slots: int = SLOTS):
    """(bytes, flops) for the shapes ``s``: users, max_paths, valid_paths
    (the sum over users), rx, tx, k."""
    q = s["rx"] * s["tx"]
    n_bytes = 4 * s["users"] * s["max_paths"] * (5 + 2 * slots) + \
        4 * s["users"] * q * 2 * slots * s["k"]
    return n_bytes, 8 * q * slots * s["k"] * s["valid_paths"]


def read(ctx):
    ops = ctx.trace.named(ctx.kernels["render_fwd"].KERNEL)
    if not ops or len(ops) != len(ctx.shapes):
        return None
    least = sum(peaks.bound_s(*count(s))[0] for s in ctx.shapes)
    return 100.0 * least / (sum(e - s for s, e, _ in ops) * 1e-6)
