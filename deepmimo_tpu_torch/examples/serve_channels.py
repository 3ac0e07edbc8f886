"""Serving-loop example: constant-memory device-resident channel renders.

The product's render modes on a synthetic 256-user scenario:

1. one-shot host render (numpy complex out),
2. the serving loop: device planes written into the previous call's
   buffer (one kernel launch per batch on the card, no host copy,
   constant device memory),
3. a legacy-v3 dual-polarization scenario rendered to the VV/VH/HH/HV
   quadruple,
4. codebook beam gains with the codebook folded into the kernel (H is
   never formed).

Run: ``python -m deepmimo_tpu_torch.examples.serve_channels [--cpu]`` (on
the CUDA card unless ``--cpu``).
"""

import os
import tempfile

import numpy as np

from .quickstart import make_ray_data, parse_device, write_scenario


def main(argv=None):
    parse_device(__doc__.splitlines()[0], argv)
    with tempfile.TemporaryDirectory(prefix="dm_serve_") as tmp:
        run(tmp)
    return 0


def run(tmp):
    import deepmimo_tpu_torch as dm
    from deepmimo_tpu_torch.integrations import export_matlab
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np

    folder = write_scenario(os.path.join(tmp, "demo_city"),
                            make_ray_data(n_ue=256, max_paths=8, seed=1))
    ds = dm.load(folder)

    params = dm.ChannelGenParameters()
    params["bs_antenna"]["shape"] = np.array([8, 8])
    params["ofdm"]["selected_subcarriers"] = np.arange(64)

    # 1. one-shot host render
    H = ds.compute_channels(params)
    print(f"host render: {H.shape} {H.dtype}, "
          f"|H| max {np.abs(H).max():.3e}")

    # 2. serving loop: device planes, the buffer reused
    h = None
    for _ in range(4):                         # pretend new batches arrive
        prev = h
        h = ds.compute_channels(params, to_device=True, out=prev)
        assert prev is None or h.data_ptr() == prev.data_ptr()
    cfg, _, _ = params.to_config(ds.n_ue)
    H2 = unpack_planes_np(h.cpu().numpy(), cfg)
    same = np.allclose(H2, H, atol=1e-5 * np.abs(H).max())
    print(f"serving loop: device planes {tuple(h.shape)} on {h.device} -> "
          f"complex {H2.shape}; allclose={same}")
    assert same

    # 3. dual-polarization from a v3-format scenario on disk
    rng = np.random.RandomState(0)
    base_power = np.asarray(ds.power)
    for pol in ("vv", "vh", "hh", "hv"):
        ds[f"power_{pol}"] = (base_power - rng.uniform(0, 10)).astype(
            np.float32)
        ds[f"phase_{pol}"] = np.asarray(ds.phase)
    v3_folder = os.path.join(tmp, "demo_v3_dualpolar")
    export_matlab(ds, v3_folder)

    ds3 = dm.load(v3_folder)                  # v3 dispatch, dual-polar keys
    params["enable_dual_polar"] = 1
    quad = ds3.compute_channels(params)
    print("dual-polar:", {k: v.shape for k, v in quad.items()})
    assert all(np.isfinite(v).all() for v in quad.values())

    # 4. beam-gain serving: the codebook folded into the kernel's path
    #    sum, the channel never formed (the beam-training primitive).
    params["enable_dual_polar"] = 0
    n_tx = 64
    rng = np.random.RandomState(3)
    codebook = np.exp(1j * rng.uniform(-np.pi, np.pi, (16, n_tx))) \
        / np.sqrt(n_tx)
    G = ds.compute_beam_gains(params, codebook=codebook)
    best = G.sum(axis=-1).argmax(axis=-1)[:, 0]     # per-user best beam
    expect = np.abs(np.einsum("bt,urtk->urbk", codebook.conj(), H)) ** 2
    same = np.allclose(G, expect, atol=1e-5 * expect.max())
    print(f"beam gains: {G.shape}, best-beam histogram "
          f"{np.bincount(best, minlength=16).tolist()}, allclose={same}")
    assert same
    print("serve_channels complete")


if __name__ == "__main__":
    raise SystemExit(main())
