"""Window milliseconds over the calibration steps completed in it."""


def read(w):
    return 1e3 * w.window_s / w.calls if w.calls else None
