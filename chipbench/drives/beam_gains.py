"""``Dataset.compute_beam_gains(params, codebook=W, to_device=...,
out=prev)`` over the mix's datasets in turn, with a ``codebook_beams``-beam
random-phase codebook from the seed. Judged by ``beam_gain_rel_err``: the
worst user's largest gap to the float64 reference's gains over that
user's largest gain."""

import numpy as np
import torch

from chipbench.harness import inputs
from chipbench.harness.drive import ServeDrive
from chipbench.reference import channels as ref


class Drive(ServeDrive):
    NUMBER = "beam_gain_rel_err"

    def prepare(self):
        n_tx = int(np.prod(self.config["channel_params"]["bs_antenna"][
            "shape"]))
        self.w = inputs.codebook(self.mix["codebook_beams"], n_tx,
                                 self.seed)

    def entry(self, ds, out):
        return ds.compute_beam_gains(self.params, codebook=self.w,
                                     to_device=self.to_device, out=out)

    def reference(self, p, precision):
        return ref.beam_gains(p, self.config["channel_params"], self.w,
                              precision=precision)

    def answer(self, res, rows, shape):
        g = torch.as_tensor(res[rows], device=self.device)
        return g.to(torch.float64).reshape(shape)
