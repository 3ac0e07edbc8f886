"""Full-batch SGD calibration of one dataset's geometry: the mix's
``step`` of ``deepmimo_tpu_torch.parallel.sharded`` (``training_step_planes``
against planes, ``training_step`` against complex channels; the backend
and the planes' layout are the mix's ``program_config``), one step after
another, against the channels rendered with the BS rotated by
``target_bs_rotation``.

The set-up builds the state and drives it through its first
``CHECK_STEPS`` steps with the window's own call; the same object goes on
into the window. After the window, ``release`` drives it through
``CHECK_STEPS`` steps more from where the window left it. Both stretches
are held to the float64 reference (``reference.channels.calibration``):
the first from the configuration's own start, the second from the
program's state after the window (the reference can follow the program
that far only from the program's state). The numbers: each step's loss,
and by leaf the norms of the first gradient (from the state after one
step) and of the change over the steps; the second stretch's carry
``_after``.

A gradient read from a float32 state is known only to within the
state's rounding: half an ulp of the stored state per step, over the
learning rate. Where the window has moved the per-path corrections off
zero, that rounding grows with the steps the window took (about 3e-8
of the gradient per step), so the second stretch's gaps count only what
lies beyond it (``slack``).
"""

import math
import time

import numpy as np
import torch

from chipbench.harness import inputs
from chipbench.harness.drive import REF_BLOCK, channel_params
from chipbench.reference import channels as ref


class Drive:
    CHECK_STEPS = 3

    def __init__(self, dmt, config, mix, seed, device, n_users=None):
        self.dmt, self.config, self.mix = dmt, config, mix
        self.seed, self.device = seed, device
        self.n_users = n_users or config["n_users"]
        self.history = []

    def setup(self):
        from deepmimo_tpu_torch.ops import channel
        from deepmimo_tpu_torch.parallel import sharded
        dmt, dev = self.dmt, self.device
        t0 = time.perf_counter()
        self.data = inputs.path_matrices(
            self.n_users, self.config["channel_params"]["num_paths"],
            self.seed, self.mix)
        self.inputs_s = time.perf_counter() - t0
        self.parts = [self.data]
        self.paths = dmt.PathData.from_numpy(
            *(self.data[k] for k in inputs.PATH_FIELDS), device=dev)
        params = channel_params(dmt, self.config)
        self.cfg, bs, ue = params.to_config(self.n_users, device=dev)
        self.step = getattr(sharded, self.mix["step"])
        render = channel.render_channels_planes if \
            self.mix["step"] == "training_step_planes" else \
            channel.render_channels
        with torch.no_grad():
            self.target = render(self.paths, dmt.AntennaPanel.make(
                self.mix["target_bs_rotation"], float(
                    params["bs_antenna"]["spacing"]), device=dev), ue,
                self.cfg)
        self.state = sharded.init_calib_params(self.paths, bs, ue)
        self.first = self._steps()

    def _steps(self) -> dict:
        """``CHECK_STEPS`` calls from the state where it stands: the leaves
        before, each step's loss, the leaves after the first and after the
        last step."""
        start = [x.clone() for x in self.state.leaves()]
        losses, first = [], None
        for _ in range(self.CHECK_STEPS):
            self.call()
            losses.append(float(self.loss))
            if first is None:
                first = [x.clone() for x in self.state.leaves()]
        return dict(start=start, losses=losses, first=first,
                    last=[x.clone() for x in self.state.leaves()])

    def call(self) -> int:
        self.state, self.loss = self.step(self.state, self.paths,
                                          self.target, self.cfg,
                                          lr=self.mix["lr"])
        self.history.append(0)
        return self.n_users

    def release(self):
        self.after = self._steps()
        del self.paths, self.target, self.state, self.loss

    def numbers(self, control: bool = False, table: bool = False) -> dict:
        """Gaps to the float64 reference over both stretches (see the
        module's doc; ``norm_gaps``); with ``control`` of the reference in
        TF32; with ``table`` each leaf's figures."""
        out, lr = {}, self.mix["lr"]
        for tag, got in (("", self.first), ("_after", self.after)):
            slack = None if not tag else (
                [ulp(b) / 2 / lr for b in got["first"]],
                [1.5 * ulp(torch.maximum(a.abs(), b.abs()))
                 for a, b in zip(got["start"], got["last"])])
            run = dict(data=self.data,
                       params=self.config["channel_params"],
                       target_rotation=self.mix["target_bs_rotation"],
                       lr=self.mix["lr"], steps=self.CHECK_STEPS,
                       block=REF_BLOCK, device=self.device,
                       start=got["start"] if tag else None)
            want_loss, want_g, want_d = ref.calibration(**run)
            if control:
                loss, g, d = ref.calibration(**run, precision="tf32")
            else:
                loss = got["losses"]
                g = [(a.double() - b.double()) / lr
                     for a, b in zip(got["start"], got["first"])]
                d = [b.double() - a.double()
                     for a, b in zip(got["start"], got["last"])]
            if table:
                out[tag or "first"] = norm_gaps(g, d, want_g, want_d,
                                                slack, table=True)
                continue
            out[f"loss_gap{tag}"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(loss, want_loss))
            out.update({k + tag: v for k, v in
                        norm_gaps(g, d, want_g, want_d, slack).items()})
        return out


def ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at each |x|, as float64."""
    x = x.float().abs()
    return (torch.nextafter(x, torch.full_like(x, math.inf)) - x).double()


def norm_gaps(g, d, want_g, want_d, slack=None, table=False) -> dict:
    """Per leaf, for the first gradient and for the change: the gap
    between the program's norm and the reference's, and the norm of their
    difference, each relative to the reference's norm of that leaf or of
    the median leaf, whichever is larger; with ``slack`` (per-element
    bounds of the state's rounding, for the gradient and for the change)
    each less the norm of the leaf's bound, and not under 0. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (they move by round-off alone). Returns the worst leaf's norm gap
    (``*_norm_gap``) and the median leaf's difference (``*_diff_median``);
    with ``table`` every leaf's figures instead."""
    def norms(xs):
        return [float(torch.linalg.vector_norm(x.to(torch.float64)))
                for x in xs]

    ng = norms(want_g)
    keep = [i for i, n in enumerate(ng) if n >= 1e-3 * float(np.median(ng))]
    out, rows = {}, {}
    for j, (tag, got, want) in enumerate((("grad", g, want_g),
                                          ("change", d, want_d))):
        nw, ngot = norms(want), norms(got)
        nd = norms([a.to(torch.float64).to(b.device) - b
                    for a, b in zip(got, want)])
        ns = [0.0] * len(nw) if slack is None else norms(slack[j])
        med = float(np.median([nw[i] for i in keep]))
        gap = [max(0.0, abs(ngot[i] - nw[i]) - ns[i]) / max(nw[i], med)
               for i in keep]
        diff = [max(0.0, nd[i] - ns[i]) / max(nw[i], med) for i in keep]
        out[f"{tag}_norm_gap"] = max(gap)
        out[f"{tag}_diff_median"] = float(np.median(diff))
        rows[tag] = {ref.CALIB_LEAVES[i]: (nw[i], gap[j], diff[j])
                     for j, i in enumerate(keep)}
    return rows if table else out
