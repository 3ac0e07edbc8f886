"""Least time of the render_fwd kernel's work on the card
(``roofline/render_fwd.py``, ``harness/peaks.py``) over its profiled time, in
percent."""


def read(ctx):
    return ctx.roofline_pct("render_fwd")
