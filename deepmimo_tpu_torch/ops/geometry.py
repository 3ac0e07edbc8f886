"""Geometry: Euler-angle rotation, FoV masks, array responses (PyTorch).

Counterpart of ``deepmimo_tpu/ops/geometry.py``, same formulas and
conventions: theta = elevation from the z-axis, phi = azimuth in the x-y
plane; public inputs in DEGREES, ``rotate_angles`` outputs in RADIANS.
Validity masks replace NaN propagation, and ``safe_arccos`` /
``safe_angle`` keep gradients finite at |x| -> 1 and at the origin.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


# ============================================================================
# Gradient-safe primitives
# ============================================================================

class _SafeArccos(torch.autograd.Function):
    """arccos of the clamped input; gradient bounded at |x| -> 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.arccos(x.clamp(-1.0, 1.0))

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        xc = x.clamp(-1.0 + 1e-7, 1.0 - 1e-7)
        return -grad / torch.sqrt(1.0 - xc * xc)


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos with a clamped input and a bounded gradient at |x| -> 1."""
    return _SafeArccos.apply(x)


def safe_angle(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """atan2(im, re) that yields zero gradient (not NaN) at the origin."""
    safe = re * re + im * im > 0
    re_s = torch.where(safe, re, torch.ones_like(re))
    return torch.where(safe, torch.atan2(im, re_s), torch.zeros_like(re))


# ============================================================================
# Euler rotation of spherical angles
# ============================================================================

def _rotation_columns(rotation_deg: torch.Tensor):
    rot = torch.deg2rad(rotation_deg)
    if rot.dim() == 1:
        rot = rot[None, :]
    return rot[:, 0:1], rot[:, 1:2], rot[:, 2:3]


def _rotated_unit_components(rot_x, rot_y, rot_z, theta, phi):
    """(x', y', z') = unit vector of (theta, phi) in the rotated frame."""
    sin_az = torch.sin(phi - rot_z)
    cos_az = torch.cos(phi - rot_z)
    sin_y, cos_y = torch.sin(rot_y), torch.cos(rot_y)
    sin_x, cos_x = torch.sin(rot_x), torch.cos(rot_x)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    z = cos_y * cos_x * cos_t + \
        sin_t * (sin_y * cos_x * cos_az - sin_x * sin_az)
    x = cos_y * sin_t * cos_az - sin_y * cos_t
    y = cos_y * sin_x * cos_t + \
        sin_t * (sin_y * sin_x * cos_az + cos_x * sin_az)
    return x, y, z


def rotate_angles(rotation_deg: torch.Tensor, el_deg: torch.Tensor,
                  az_deg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate spherical angles by the array Euler rotation [x, y, z] (deg).

    z-axis first, then y, then x (3GPP TR 38.901 7.1-15/16 closed form).
    ``rotation_deg`` is [3] or [U, 3]; angles [U, P] in degrees. Returns
    (theta_rot, phi_rot) in RADIANS, [U, P].
    """
    x, y, z = _rotated_unit_components(*_rotation_columns(rotation_deg),
                                       torch.deg2rad(el_deg),
                                       torch.deg2rad(az_deg))
    return safe_arccos(z), safe_angle(x, y)


def rotate_unit_vec(rotation_deg: torch.Tensor, el_deg: torch.Tensor,
                    az_deg: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotated-frame unit-vector components (x', y', z').

    What the fused render needs (kd*y', kd*z'; panel elements lie in the
    y-z plane) without the arccos/atan2/sincos round trip through angles.
    With a [3] rotation the angles may be flat [U*P] views.
    """
    return _rotated_unit_components(*_rotation_columns(rotation_deg),
                                    torch.deg2rad(el_deg),
                                    torch.deg2rad(az_deg))


# ============================================================================
# Field of view
# ============================================================================

def apply_fov(fov_deg, theta_rad: torch.Tensor,
              phi_rad: torch.Tensor) -> torch.Tensor:
    """Boolean inclusion mask for a [horizontal, vertical] FoV in degrees.

    Horizontal FoV centred on azimuth 0; vertical FoV on elevation 90 deg.
    """
    fov = np.deg2rad(np.asarray(fov_deg, dtype=np.float64))
    two_pi = 2 * math.pi
    theta = torch.remainder(theta_rad, two_pi)
    phi = torch.remainder(phi_rad, two_pi)
    incl_phi = (phi <= fov[0] / 2) | (phi >= two_pi - fov[0] / 2)
    incl_theta = ((theta <= math.pi / 2 + fov[1] / 2) &
                  (theta >= math.pi / 2 - fov[1] / 2))
    return incl_phi & incl_theta


def is_full_fov(fov_deg) -> bool:
    """Host-side check: does this FoV cover the whole sphere?"""
    fov = np.asarray(fov_deg)
    return bool(fov[0] >= 360 and fov[1] >= 180)


# ============================================================================
# Antenna array geometry
# ============================================================================

def ant_indices(panel_shape: Tuple[int, int]) -> np.ndarray:
    """Element positions (integer grid) of an (M1, M2) panel in the y-z
    plane as a numpy [N, 3] array: x = 0, y over M1, z over M2."""
    m1, m2 = int(panel_shape[0]), int(panel_shape[1])
    y = np.tile(np.arange(m1), m2)
    z = np.repeat(np.arange(m2), m1)
    return np.stack([np.zeros_like(y), y, z], axis=1)


def array_response_phase(theta_rad: torch.Tensor, phi_rad: torch.Tensor,
                         kd) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Per-path wave-vector components (kx, ky, kz) scaled by kd."""
    st = torch.sin(theta_rad)
    return (kd * st * torch.cos(phi_rad),
            kd * st * torch.sin(phi_rad),
            kd * torch.cos(theta_rad))


def _panel_phase(panel_shape: Tuple[int, int], spacing,
                 theta_rad: torch.Tensor, phi_rad: torch.Tensor):
    """Element phases y_n ky + z_n kz of a panel, [U, N, P]."""
    kd = 2 * math.pi * spacing
    _, ky, kz = array_response_phase(theta_rad, phi_rad, kd)
    pos = ant_indices(panel_shape)
    y = torch.as_tensor(pos[:, 1], dtype=theta_rad.dtype,
                        device=theta_rad.device)
    z = torch.as_tensor(pos[:, 2], dtype=theta_rad.dtype,
                        device=theta_rad.device)
    return y[None, :, None] * ky[:, None, :] + \
        z[None, :, None] * kz[:, None, :]


def array_response(panel_shape: Tuple[int, int], spacing,
                   theta_rad: torch.Tensor, phi_rad: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Complex array response [U, N, P] in ``dtype``: exp(j (y_n ky +
    z_n kz)) with the phase in ``dtype``'s real precision; invalid paths
    give zeros."""
    phase = _panel_phase(panel_shape, spacing, theta_rad, phi_rad)
    rd = torch.float64 if dtype == torch.complex128 else torch.float32
    resp = torch.exp(1j * phase.to(rd))
    if valid is not None:
        resp = torch.where(valid[:, None, :], resp, torch.zeros_like(resp))
    return resp


def array_response_planes(panel_shape: Tuple[int, int], spacing,
                          theta_rad: torch.Tensor, phi_rad: torch.Tensor,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Array response as (real, imag) planes, each [U, N, P].

    response[n] = exp(j (y_n ky + z_n kz)); invalid paths give zeros.
    """
    phase = _panel_phase(panel_shape, spacing, theta_rad, phi_rad)
    re, im = torch.cos(phase), torch.sin(phase)
    if valid is not None:
        v = valid[:, None, :]
        re = torch.where(v, re, torch.zeros_like(re))
        im = torch.where(v, im, torch.zeros_like(im))
    return re, im


def steering_vec(array, phi: float = 0, theta: float = 0,
                 spacing: float = 0.5) -> np.ndarray:
    """Normalized steering vector (numpy complex128 [M1 * M2]) of an
    (M1, M2) panel toward (phi, theta), with the JAX package's angle
    convention: the panel's polar angle is phi (degrees) and its azimuth
    is theta + 90 degrees."""
    pos = ant_indices(array)
    kd = 2 * np.pi * spacing
    t = np.deg2rad(phi)
    p = np.deg2rad(theta) + np.pi / 2
    kvec = kd * np.array([np.sin(t) * np.cos(p),
                          np.sin(t) * np.sin(p),
                          np.cos(t)])
    resp = np.exp(1j * pos @ kvec)
    return resp / np.linalg.norm(resp)
