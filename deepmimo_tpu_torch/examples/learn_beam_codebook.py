"""Example: learn a BS beam codebook by differentiating through the renderer.

Gradient-based codebook design: maximize the users' best-beam gain
(proportional fairness) over a scenario by optimizing 16 phase-only
precoding vectors jointly with the antenna spacing, with
``torch.autograd`` through the channel render (channels -> beam gains ->
loss -> gradients w.r.t. the codebook AND the spacing). The learned
codebook is then served through ``render_beam_gains``: the beam-gain
kernel on the card, which folds the codebook into the path sum and never
forms H.

Run: ``python -m deepmimo_tpu_torch.examples.learn_beam_codebook
[--cpu] [--steps N]`` (on the CUDA card unless ``--cpu``).
"""

import math

import numpy as np
import torch

from .quickstart import make_ray_data, parse_device

N_BEAMS, N_ANT, N_UE, MAX_PATHS = 16, 64, 512, 10


def main(argv=None):
    args = parse_device(__doc__.splitlines()[0], argv,
                        **{"--steps": dict(type=int, default=100)})
    import deepmimo_tpu_torch as dm
    from deepmimo_tpu_torch.ops.channel import (render_beam_gains,
                                                render_channels)

    data = make_ray_data(n_ue=N_UE, max_paths=MAX_PATHS, seed=1)
    paths = dm.PathData.from_numpy(*(data[k] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")))
    dev = paths.valid.device
    cfg = dm.ChannelConfig(bs_shape=(N_ANT, 1), ue_shape=(1, 1),
                           freq_domain=True, subcarriers=512,
                           selected_subcarriers=(0,), num_paths=MAX_PATHS)
    ue = dm.AntennaPanel.make()
    zero_rot = torch.zeros(3, device=dev)

    def beam_gains(phases, spacing):
        """[N_UE, N_BEAMS] beamforming gains |h conj(w)^T|^2."""
        bs = dm.AntennaPanel(rotation_deg=zero_rot, spacing=spacing)
        h = render_channels(paths, bs, ue, cfg)[:, 0, :, 0]   # [U, T]
        codebook = torch.polar(torch.ones_like(phases), phases) \
            / math.sqrt(N_ANT)                                # [B, T]
        y = h @ codebook.T.conj()
        return (y * y.conj()).real                            # [U, B]

    def loss_fn(phases, spacing):
        best = beam_gains(phases, spacing).max(dim=1).values
        return -torch.mean(torch.log(best + 1e-18))   # log utility

    rng = np.random.RandomState(0)
    phases = torch.tensor(rng.uniform(0, 2 * np.pi, (N_BEAMS, N_ANT)),
                          dtype=torch.float32, device=dev,
                          requires_grad=True)
    spacing = torch.tensor(0.5, device=dev, requires_grad=True)
    lr_phase, lr_spacing = 0.3, 1e-3
    losses = []
    for step in range(args.steps):
        val = loss_fn(phases, spacing)
        g_phase, g_spacing = torch.autograd.grad(val, (phases, spacing))
        with torch.no_grad():
            phases -= lr_phase * g_phase
            spacing -= lr_spacing * g_spacing
        losses.append(float(val.detach()))
        if step % 10 == 0 or step == args.steps - 1:
            with torch.no_grad():
                gains = beam_gains(phases, spacing)
                served = float(gains.max(dim=1).values.mean() /
                               gains.mean())
            print(f"step {step:4d}  loss={losses[-1]:+.4f}  "
                  f"spacing={float(spacing.detach()):.4f}  "
                  f"mean-best/mean gain={served:.2f}x", flush=True)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

    # Serving: the LEARNED codebook over the scenario through the fused
    # beam-gain route (the kernel on the card; its plain version on the
    # CPU): the codebook folds into the path sum, H is never formed.
    with torch.no_grad():
        bs = dm.AntennaPanel(rotation_deg=zero_rot, spacing=spacing)
        wr = torch.cos(phases) / math.sqrt(N_ANT)
        wi = torch.sin(phases) / math.sqrt(N_ANT)
        g_fused = render_beam_gains(paths, bs, ue,
                                    cfg.replace(backend="fused"), wr, wi)
        g_ref = beam_gains(phases, spacing)                # [U, B]
    agree = float((g_fused[:, :, 0].argmax(dim=1) ==
                   g_ref.argmax(dim=1)).float().mean())
    print(f"fused serving sweep: G{tuple(g_fused.shape)}, best-beam "
          f"agreement with the training-path gains: {agree:.3f}")
    assert agree > 0.99, "fused beam gains disagree with the train path"
    print("done — codebook learned through the differentiable renderer; "
          "served through the fused beam-gain route")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
