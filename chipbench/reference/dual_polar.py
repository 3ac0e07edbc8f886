"""Dual polarization (``enable_dual_polar``), as DeepMIMO v3's generator
renders it: four channels VV, VH, HH and HV, each from its own per-path
power and phase (``power_<pol>``, ``phase_<pol>``, dBW and degrees), with
the angles and delays of the paths shared by all four.

For each polarization q the path gains are the default stage's with q's
power and phase in place of the paths' own:

    g_q[u, p, k] = sqrt(10^(power_q / 10) / N_fft)
                   exp(j (phase_q - 2 pi k d / N_fft)),

zero where the path is not valid or d = delay * bandwidth >= N_fft. Which
paths are valid, and their delays, come from the shared ``power`` and
``delay``. The four are concatenated on the last axis, pol-major
([U, P, 4K]: VV's K subcarriers, then VH's, HH's and HV's), the layout of
the program's packed polar planes, so the combine stage gives H
[U, R, T, 4K]. Departure from the upstream generator: none.
"""

import torch

POLS = ("vv", "vh", "hh", "hv")


def path_gains(default, p, params, corr):
    return torch.cat([default(dict(p, power=p["power_" + q],
                                   phase=p["phase_" + q]), params, corr)
                      for q in POLS], dim=-1)
