"""Half-wave dipole elements along the panel's z axis: linear power gain
1.643 cos^2(pi/2 cos theta) / sin(theta) toward a path at zenith angle
theta in the panel's frame (the divisor sin(theta), not its square, as
DeepMIMO's antenna patterns have it), and 0 within sin(theta) <= 1e-7 of
the axis."""

import math

import torch


def element_gain(default, side, x, y, z):
    if side.get("radiation_pattern") != "halfwave-dipole":
        return default(side, x, y, z)
    sin_t = torch.sqrt(torch.clamp(1 - z * z, min=0))
    on = sin_t > 1e-7
    lobe = torch.cos(math.pi / 2 * z) ** 2 / torch.where(
        on, sin_t, torch.ones_like(sin_t))
    return torch.where(on, 1.643 * lobe, torch.zeros_like(z))
