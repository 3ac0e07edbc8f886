"""Seconds from the process's start to the window's first call: imports,
the card, kernel builds or loads, the inputs from the seed, warm calls."""


def read(w):
    return w.setup_s
