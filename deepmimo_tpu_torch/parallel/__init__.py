"""Multi-device sharding: meshes, sharded renders, distributed calibration.

Counterpart of ``deepmimo_tpu.parallel`` on ``torch.distributed``: a
(users, tile) ``DeviceMesh`` over process ranks, one device per rank
(``mesh.py``); sharded renders and beam gains returning DTensors, and the
calibration step, single-device and sharded (``sharded.py``);
multi-process loading of a scenario's users (``multihost.py``); and
``dryrun.dryrun_multichip``, which drives the sharded paths on n spawned
ranks against their single-device runs.
"""

from .mesh import make_mesh, default_mesh_shape
from .sharded import (CalibParams, calib_loss, calib_loss_planes,
                      calib_value_and_grad, init_calib_params,
                      make_sharded_training_step, render_beam_gains_polar_sharded,
                      render_beam_gains_sharded, render_channels_sharded,
                      render_polar_sharded, shard_paths, training_step,
                      training_step_planes)
from .multihost import load_paths_sharded, host_user_range

__all__ = ["make_mesh", "default_mesh_shape", "shard_paths",
           "render_channels_sharded", "render_polar_sharded",
           "render_beam_gains_sharded", "render_beam_gains_polar_sharded",
           "training_step", "training_step_planes", "load_paths_sharded",
           "host_user_range", "make_sharded_training_step", "CalibParams",
           "calib_loss", "calib_loss_planes", "calib_value_and_grad",
           "init_calib_params"]
