"""Differentiable calibration of the channel model (the training step).

One step of gradient-based calibration of the array geometry and of
per-path corrections to the ray parameters against target channels, with
plain SGD. Counterpart of the calibration half of
``deepmimo_tpu/parallel/sharded.py`` (``CalibParams`` ..
``training_step``); on one device, so no mesh. With ``cfg.backend``
"fused", :func:`training_step_planes` runs the fused render's forward and
backward CUDA kernels; :func:`training_step` with "pallas" runs the
path-sum kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from ..ops.channel import render_channels, render_channels_planes
from ..ops.types import AntennaPanel, ChannelConfig, PathData


@dataclasses.dataclass(frozen=True)
class CalibParams:
    """Learnable parameters of the channel model: panel geometry (shared
    across users) plus per-path corrections to the ray parameters."""

    bs: AntennaPanel
    ue: AntennaPanel
    d_power_dbw: torch.Tensor     # [U, P]
    d_phase_deg: torch.Tensor     # [U, P]
    d_delay_ns: torch.Tensor      # [U, P] (nanoseconds, for conditioning)
    d_angles_deg: torch.Tensor    # [U, P, 4]: aoa_az, aoa_el, aod_az, aod_el

    def leaves(self) -> List[torch.Tensor]:
        """The 8 tensors, panels first, in a fixed order."""
        return [self.bs.rotation_deg, self.bs.spacing, self.ue.rotation_deg,
                self.ue.spacing, self.d_power_dbw, self.d_phase_deg,
                self.d_delay_ns, self.d_angles_deg]

    @classmethod
    def from_leaves(cls, leaves) -> "CalibParams":
        bs_rot, bs_sp, ue_rot, ue_sp, *rest = leaves
        return cls(AntennaPanel(bs_rot, bs_sp), AntennaPanel(ue_rot, ue_sp),
                   *rest)


def init_calib_params(paths: PathData, bs: AntennaPanel,
                      ue: AntennaPanel) -> CalibParams:
    z = torch.zeros_like(paths.power_dbw)
    return CalibParams(bs=bs, ue=ue, d_power_dbw=z, d_phase_deg=z,
                       d_delay_ns=z,
                       d_angles_deg=torch.zeros(z.shape + (4,),
                                                dtype=z.dtype,
                                                device=z.device))


def _apply_calib(paths: PathData, params: CalibParams) -> PathData:
    da = params.d_angles_deg
    return PathData(
        power_dbw=paths.power_dbw + params.d_power_dbw,
        phase_deg=paths.phase_deg + params.d_phase_deg,
        delay_s=paths.delay_s + params.d_delay_ns * 1e-9,
        aoa_az_deg=paths.aoa_az_deg + da[..., 0],
        aoa_el_deg=paths.aoa_el_deg + da[..., 1],
        aod_az_deg=paths.aod_az_deg + da[..., 2],
        aod_el_deg=paths.aod_el_deg + da[..., 3],
        valid=paths.valid,
        doppler_vel=paths.doppler_vel,
        doppler_acc=paths.doppler_acc,
    )


def calib_loss(params: CalibParams, paths: PathData, target: torch.Tensor,
               cfg: ChannelConfig) -> torch.Tensor:
    """Normalized mean squared complex error vs the target channels.

    ``(err * conj(err)).real`` and not ``abs(err)**2``: the gradient of
    ``abs`` at 0 is NaN.
    """
    h = render_channels(_apply_calib(paths, params), params.bs, params.ue,
                        cfg)
    err = h - target
    num = torch.mean((err * err.conj()).real)
    den = torch.mean((target * target.conj()).real) + 1e-30
    return num / den


def calib_loss_planes(params: CalibParams, paths: PathData,
                      target: torch.Tensor, cfg: ChannelConfig
                      ) -> torch.Tensor:
    """Planes-layout calibration loss (normalized MSE on real planes).

    Same objective as :func:`calib_loss` through
    :func:`render_channels_planes`; ``target`` is in the planes layout the
    cfg selects (stacked or packed). The error is one ``mse_loss`` (one
    fused elementwise kernel forward and one backward), where
    ``mean((h - target)**2)`` spends separate passes on the difference,
    the square and their backward. The target's power is the mean squared
    norm of the minor-axis rows: one read of the planes and no
    planes-sized temporary. (Not one ``vector_norm`` or ``dot`` over the
    whole tensor: on the CPU they sum float32 with too few partial sums
    and drift by 1e-5 to 1e-3 relative at tens of millions of elements;
    rows of a few hundred elements do not.)
    """
    h = render_channels_planes(_apply_calib(paths, params), params.bs,
                               params.ue, cfg)
    den = torch.linalg.vector_norm(target, dim=-1).square().mean() / \
        target.shape[-1]
    return torch.nn.functional.mse_loss(h, target) / (den + 1e-30)


def calib_value_and_grad(loss_fn: Callable, params: CalibParams,
                         paths: PathData, target: torch.Tensor,
                         cfg: ChannelConfig
                         ) -> Tuple[torch.Tensor, CalibParams]:
    """(loss, gradients) of ``loss_fn(params, paths, target, cfg)`` with
    respect to every leaf of ``params``; None for a leaf the loss does not
    reach."""
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    with torch.enable_grad():
        loss = loss_fn(CalibParams.from_leaves(leaves), paths, target, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), CalibParams.from_leaves(grads)


def _sgd_step(loss_fn, params, paths, target, cfg, lr):
    loss, grads = calib_value_and_grad(loss_fn, params, paths, target, cfg)
    new = [p if g is None else p.detach() - lr * g
           for p, g in zip(params.leaves(), grads.leaves())]
    return CalibParams.from_leaves(new), loss


def training_step_planes(params: CalibParams, paths: PathData,
                         target: torch.Tensor, cfg: ChannelConfig,
                         lr: float = 1e-3) -> Tuple[CalibParams,
                                                    torch.Tensor]:
    """One SGD calibration step on the planes path (fused fwd + bwd)."""
    return _sgd_step(calib_loss_planes, params, paths, target, cfg, lr)


def training_step(params: CalibParams, paths: PathData,
                  target: torch.Tensor, cfg: ChannelConfig,
                  lr: float = 1e-3) -> Tuple[CalibParams, torch.Tensor]:
    """One SGD step of channel-model calibration (complex loss)."""
    return _sgd_step(calib_loss, params, paths, target, cfg, lr)
