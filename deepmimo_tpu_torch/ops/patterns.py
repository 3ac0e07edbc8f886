"""Antenna radiation patterns as smooth tensor functions.

Counterpart of ``deepmimo_tpu/ops/patterns.py``. Pattern gains multiply
*linear path power*.
"""

from __future__ import annotations

import math

import torch


def _pattern_isotropic(theta_rad: torch.Tensor,
                       phi_rad: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(theta_rad)


def _pattern_halfwave_dipole(theta_rad: torch.Tensor,
                             phi_rad: torch.Tensor) -> torch.Tensor:
    """Half-wave dipole: G(theta) = 1.643 cos^2(pi/2 cos theta) / sin theta.

    The divisor is sin(theta), not sin^2, as in the scenario toolchain.
    Within sin(theta) <= 1e-7 of the dipole axis the gain is 0 (float32
    rounds theta ~ pi to a value whose sine is slightly negative).
    """
    sin_t = torch.sin(theta_rad)
    valid = sin_t > 1e-7
    sin_safe = torch.where(valid, sin_t, torch.ones_like(sin_t))
    cos_term = torch.cos(math.pi / 2 * torch.cos(theta_rad))
    return torch.where(valid, 1.643 * cos_term * cos_term / sin_safe,
                       torch.zeros_like(sin_t))


PATTERN_REGISTRY = {
    "isotropic": _pattern_isotropic,
    "halfwave-dipole": _pattern_halfwave_dipole,
}


def pattern_gain(name: str, theta_rad: torch.Tensor,
                 phi_rad: torch.Tensor) -> torch.Tensor:
    """Evaluate a registered pattern by name."""
    if name not in PATTERN_REGISTRY:
        raise NotImplementedError(
            f"Antenna pattern '{name}' not in {sorted(PATTERN_REGISTRY)}")
    return PATTERN_REGISTRY[name](theta_rad, phi_rad)
