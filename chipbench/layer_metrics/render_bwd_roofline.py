"""Least time of the render_bwd kernel's work on the card
(``roofline/render_bwd.py``, ``harness/peaks.py``) over its profiled time, in
percent."""


def read(ctx):
    return ctx.roofline_pct("render_bwd")
