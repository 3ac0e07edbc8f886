"""Faults planted in the program underneath a run, to show that the
comparison with the reference catches them (the tests, and the readings
that set a training cell's upper limits on the card):

- ``alter``: one user's answer off by 1%, where it is produced;
- ``half_users``: the second half of the users left unrendered;
- ``unchanged``: a calibration step that returns its state unchanged;
- ``half_batch``: the calibration loss over the first half of the users,
  the mean taken over them.

``plant(name, dmt)`` patches the port and returns a function that undoes
it. There is one device and no exchange between devices to leave out.
"""

from __future__ import annotations

import numpy as np

SERVING = ("alter", "half_users")
TRAINING = ("unchanged", "half_batch")


def _users_axis(result) -> int:
    """1 for stacked planes [2, U, ...], else 0."""
    return int(not isinstance(result, np.ndarray) and result.dim() == 5)


def _alter(result):
    ax = _users_axis(result)
    result[(slice(None),) * ax + (result.shape[ax] // 3,)] *= 1.01
    return result


def _half_users(result):
    ax = _users_axis(result)
    result[(slice(None),) * ax + (slice(result.shape[ax] // 2, None),)] = 0
    return result


def plant(name: str, dmt):
    """Patches the fault ``name`` into the port; returns the undo."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name in SERVING:
        fault = _alter if name == "alter" else _half_users
        for attr in ("compute_channels", "compute_beam_gains"):
            orig = getattr(dmt.Dataset, attr)

            def broken(self, *a, _orig=orig, **kw):
                return fault(_orig(self, *a, **kw))
            patch(dmt.Dataset, attr, broken)
    elif name == "unchanged":
        from deepmimo_tpu_torch.parallel import sharded as sh

        def step(params, paths, target, cfg, lr=1e-3):
            return params, sh.calib_loss_planes(params, paths, target, cfg)
        patch(sh, "training_step_planes", step)
    elif name == "half_batch":
        from deepmimo_tpu_torch.parallel import sharded as sh
        orig = sh.calib_loss_planes

        def loss(params, paths, target, cfg):
            n = paths.n_ue // 2
            leaves = params.leaves()
            return orig(sh.CalibParams.from_leaves(
                leaves[:4] + [x[:n] for x in leaves[4:]]),
                paths.slice_users(0, n), target[:n], cfg)
        patch(sh, "calib_loss_planes", loss)
    else:
        raise ValueError(f"no fault {name!r}")

    def restore():
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
    return restore
