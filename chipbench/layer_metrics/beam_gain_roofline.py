"""Least time of the beam_gain kernel's work on the card
(``roofline/beam_gain.py``, ``harness/peaks.py``) over its profiled time, in
percent."""


def read(ctx):
    return ctx.roofline_pct("beam_gain")
