"""Differentiable calibration of the channel model (the training step).

Counterpart of the calibration half of ``deepmimo_tpu.parallel``; meshes,
sharded renders and ``make_sharded_training_step`` are not ported yet
(ROADMAP.md, port queue item 12).
"""

from .sharded import (CalibParams, calib_loss, calib_loss_planes,
                      calib_value_and_grad, init_calib_params,
                      training_step, training_step_planes)

__all__ = ["CalibParams", "calib_loss", "calib_loss_planes",
           "calib_value_and_grad", "init_calib_params", "training_step",
           "training_step_planes"]
