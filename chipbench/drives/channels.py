"""``Dataset.compute_channels(params, to_device=..., out=prev)`` over the
mix's datasets in turn: complex64 numpy on the host, or the planes on the
device (packed [U, R, T, 2K] or stacked [2, U, R, T, K]) written into the
previous call's buffer. Judged by ``channels_rel_err``: the worst user's
largest gap to the float64 reference's channels over that user's largest
value."""

import torch

from chipbench.harness.drive import ServeDrive
from chipbench.reference import channels as ref


def planes_to_complex(x: torch.Tensor, shape) -> torch.Tensor:
    """The renderer's planes as complex [U, R, T, K]: packed
    [U, R, T, 2K] (real half, then imaginary half) or stacked
    [2, U, R, T, K]."""
    x = x.to(torch.float64)
    if tuple(x.shape) == tuple(shape[:3]) + (2 * shape[3],):
        return torch.complex(x[..., :shape[3]], x[..., shape[3]:])
    if tuple(x.shape) == (2,) + tuple(shape):
        return torch.complex(x[0], x[1])
    raise ValueError(f"planes {tuple(x.shape)} fit no layout of {shape}")


class Drive(ServeDrive):
    NUMBER = "channels_rel_err"

    def entry(self, ds, out):
        return ds.compute_channels(self.params, to_device=self.to_device,
                                   out=out)

    def reference(self, p, precision):
        return ref.channels(p, self.config["channel_params"],
                            precision=precision)

    def answer(self, res, rows, shape):
        if not isinstance(res, torch.Tensor):
            return torch.as_tensor(res[rows], device=self.device).to(
                torch.complex128)
        if res.dim() == 5:                  # stacked [2, U, R, T, K]
            return planes_to_complex(res[:, rows], shape)
        return planes_to_complex(res[rows], shape)
