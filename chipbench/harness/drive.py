"""The common part of the drives, and the timed loop.

A traffic mix names its drive (``"drive"``): ``drives/<drive>.py``, whose
``Drive(dmt, config, mix, seed, device, n_users=None)`` is the program's
entry point in a closed loop. A drive

- ``setup()``: builds the program's state from the seed, warm calls
  included; sets ``inputs_s`` (seconds spent making the inputs) and
  ``parts`` (the path matrices of each dataset);
- ``call()``: one call of the timed loop; returns the users it completed
  and appends the dataset it used to ``history``;
- ``release()``: after the window, frees the program's state but what is
  judged;
- ``numbers(control=False)``: the numbers that hold the answers to the
  plain reference (``chipbench/reference``), which works out everything
  again from the same numpy inputs; with ``control`` the reference in TF32
  stands in for the program.

``ServeDrive`` is the part that the serving drives share. The mix's
``program_config`` settings (``dmt.config``: the render backend, the
planes' layout and dtype, ...) hold while a cell runs
(``program_config``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..reference import channels as ref
from . import inputs, registry

REF_BLOCK = 8192            # users per block of the reference


def make(dmt, config, mix, seed, device, n_users=None):
    """The mix's drive, found by name (``drives/<drive>.py``)."""
    mod = registry.load_module("drives", mix["drive"])
    return mod.Drive(dmt, config, mix, seed, device, n_users)


@contextlib.contextmanager
def program_config(dmt, mix: dict):
    """The mix's ``program_config`` set in ``dmt.config``, and put back
    after."""
    old = {k: dmt.config.get(k) for k in mix.get("program_config", {})}
    for k, v in mix.get("program_config", {}).items():
        dmt.config.set(k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)


def channel_params(dmt, config: dict):
    """The configuration's ``channel_params`` as ChannelGenParameters."""
    params = dmt.ChannelGenParameters()
    for key, value in config["channel_params"].items():
        if isinstance(value, dict):
            for sub, v in value.items():
                params[key][sub] = np.asarray(v) if isinstance(v, list) \
                    else v
        else:
            params[key] = value
    return params


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| of a user over that user's largest |want|,
    the worst user's ([U, ...] tensors)."""
    diff = (got - want).abs().flatten(1).amax(1)
    scale = want.abs().flatten(1).amax(1)
    return float((diff / scale).max())


def shapes(config: dict, mix: dict, part: dict) -> dict:
    """The sizes a roofline count takes, for one dataset ``part``."""
    cp = config["channel_params"]
    return dict(users=int(part["n_valid"].shape[0]),
                max_paths=int(cp["num_paths"]),
                valid_paths=int(part["n_valid"].sum()),
                rx=int(np.prod(cp["ue_antenna"]["shape"])),
                tx=int(np.prod(cp["bs_antenna"]["shape"])),
                k=len(cp["ofdm"]["selected_subcarriers"]),
                beams=int(mix.get("codebook_beams") or 0))


class ServeDrive:
    """An entry point of ``Dataset`` over ``datasets`` datasets in turn,
    with ``to_device`` and ``out=`` the previous answer where the answer
    stays on the device. A serving drive gives ``NUMBER`` (the name of
    its number), ``entry(dataset, out)``, ``reference(paths, precision)``
    and ``answer(result, rows, shape)`` (rows of the program's answer in
    the reference's layout)."""

    NUMBER = ""

    def __init__(self, dmt, config, mix, seed, device, n_users=None):
        self.dmt, self.config, self.mix = dmt, config, mix
        self.seed, self.device = seed, device
        self.n_users = n_users or config["n_users"]
        self.to_device = bool(mix["to_device"])
        self.history = []               # dataset index of every call

    def setup(self):
        mix, n_d = self.mix, self.mix["datasets"]
        cp = self.config["channel_params"]
        t0 = time.perf_counter()
        data = inputs.path_matrices(self.n_users * n_d, cp["num_paths"],
                                    self.seed, mix)
        self.inputs_s = time.perf_counter() - t0
        self.parts = inputs.split(data, n_d)
        zeros = np.zeros((self.n_users, 3), np.float32)
        self.datasets = [self.dmt.Dataset(dict(
            {k: v for k, v in part.items() if k != "n_valid"}, rx_pos=zeros,
            tx_pos=np.zeros((1, 3), np.float32))) for part in self.parts]
        self.params = channel_params(self.dmt, self.config)
        self.prepare()
        self.out, self.results = None, {}
        for _ in range(mix["warm_rounds"] * n_d):
            self.call()

    def prepare(self):
        """What the drive makes from the seed besides the paths."""

    def call(self) -> int:
        i = len(self.history) % len(self.datasets)
        res = self.entry(self.datasets[i], self.out)
        if self.to_device:
            self.out = res
            self.results = {i: res}
        else:
            self.results[i] = res
        self.history.append(i)
        return self.n_users

    def release(self):
        """Frees the program's state except its last answers."""
        del self.datasets
        if self.to_device:
            self.results = {self.history[-1]: self.out}
        self.out = None

    def numbers(self, control: bool = False) -> dict:
        """The worst user's gap to the float64 reference, relative to the
        user's largest value, over every user of every answer still held:
        of the program, or with ``control`` of the reference in TF32."""
        worst = 0.0
        for i, res in sorted(self.results.items()):
            for u0 in range(0, self.n_users, REF_BLOCK):
                rows = slice(u0, min(u0 + REF_BLOCK, self.n_users))
                p = ref.paths_to_tensors(self.parts[i], rows, self.device)
                want = self.reference(p, "float64")
                if control:
                    p = ref.paths_to_tensors(self.parts[i], rows,
                                             self.device, "tf32")
                    got = self.reference(p, "tf32").to(want.dtype)
                else:
                    got = self.answer(res, rows, want.shape)
                worst = max(worst, rel_gap(got, want))
        return {self.NUMBER: worst}


def run_window(drive, seconds: float, sync) -> dict:
    """Calls in a closed loop for ``seconds``; the window ends in a
    synchronise. Returns the window's length, its calls, the users they
    completed and each call's host time (call to return)."""
    sync()
    t0 = time.perf_counter()
    call_s, users = [], 0
    while True:
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
        users += drive.call()
        call_s.append(time.perf_counter() - t)
    sync()
    return {"window_s": time.perf_counter() - t0, "calls": len(call_s),
            "users": users, "call_s": call_s}
