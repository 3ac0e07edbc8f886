"""End-to-end worked example: ray data -> scenario -> channels -> training.

The runnable companion to the port's ``docs/manual.md``. Covers the
product loop:

1. synthesize per-path ray data (stand-in for a ray tracer),
2. write a v4-format scenario folder to disk,
3. load it and render OFDM MIMO channels,
4. derived quantities (pathloss, LoS),
5. Doppler snapshots,
6. a gradient through the renderer (``torch.autograd``),
7. a render with users sharded over a device mesh.

Run: ``python -m deepmimo_tpu_torch.examples.quickstart [--cpu]`` (on the
CUDA card unless ``--cpu``).
"""

import argparse
import os
import tempfile

import numpy as np
import torch


def make_ray_data(n_ue=64, max_paths=8, seed=0):
    """Synthetic NaN-padded path matrices shaped like converter output."""
    rng = np.random.RandomState(seed)
    n_valid = rng.randint(1, max_paths + 1, size=n_ue)
    mask = np.arange(max_paths)[None, :] < n_valid[:, None]

    def mat(lo, hi):
        return np.where(mask, rng.uniform(lo, hi, (n_ue, max_paths)),
                        np.nan).astype(np.float32)

    xs, ys = np.meshgrid(np.arange(8) * 2.0, np.arange(n_ue // 8) * 2.0)
    # Interaction codes: 0 = LoS on the first path of even users, else a
    # single reflection (code 1) — enough for ds.los / inter statistics.
    inter = np.where(mask, 1.0, np.nan)
    inter[::2, 0] = 0.0
    return {
        "power": mat(-120, -70), "phase": mat(-180, 180),
        "delay": mat(1e-7, 2e-6),
        "aoa_az": mat(-180, 180), "aoa_el": mat(0, 180),
        "aod_az": mat(-180, 180), "aod_el": mat(0, 180),
        "inter": inter.astype(np.float32),
        "rx_pos": np.stack([xs.ravel(), ys.ravel(),
                            np.full(n_ue, 1.5)], 1).astype(np.float32),
        "tx_pos": np.array([[0.0, -10.0, 25.0]], np.float32),
    }


def write_scenario(folder, data):
    """Write a loadable v4-format scenario folder (converter contract)."""
    from deepmimo_tpu_torch import consts as c
    from deepmimo_tpu_torch.converter.converter_utils import (save_mat,
                                                              save_params)

    os.makedirs(folder, exist_ok=True)
    for key, mat in data.items():       # the matrices, inter_pos too
        save_mat(mat, key, folder, tx_set_idx=0, tx_idx=0, rx_set_idx=1)
    n_ue = data["power"].shape[0]

    def txrx(name, i, is_tx, n):
        return {"name": name, "id": i, "id_orig": i,
                c.TXRX_PARAM_IS_TX: is_tx, c.TXRX_PARAM_IS_RX: not is_tx,
                c.TXRX_PARAM_NUM_POINTS: n,
                c.TXRX_PARAM_NUM_ACTIVE_POINTS: n,
                c.TXRX_PARAM_NUM_ANT: 1, c.TXRX_PARAM_DUAL_POL: False}

    save_params({
        c.VERSION_PARAM_NAME: "0.1.0",
        c.RT_PARAMS_PARAM_NAME: {
            c.RT_PARAM_RAYTRACER: c.RAYTRACER_NAME_SIONNA,
            c.RT_PARAM_RAYTRACER_VERSION: "0.19.2",
            c.RT_PARAM_FREQUENCY: 3.5e9,
            c.RT_PARAM_PATH_DEPTH: 3,
            c.RT_PARAM_MAX_REFLECTIONS: 3,
            c.RT_PARAM_MAX_DIFFRACTIONS: 1,
            c.RT_PARAM_MAX_SCATTERING: 1,
            c.RT_PARAM_MAX_TRANSMISSIONS: 0,
        },
        c.TXRX_PARAM_NAME: {
            "txrx_set_0": txrx("bs", 0, True, 1),
            "txrx_set_1": txrx("users", 1, False, n_ue),
        },
        c.SCENE_PARAM_NAME: {
            c.SCENE_PARAM_NUMBER_SCENES: 1, c.SCENE_PARAM_N_OBJECTS: 0,
            c.SCENE_PARAM_N_VERTICES: 0, c.SCENE_PARAM_N_FACES: 0,
            c.SCENE_PARAM_N_TRIANGULAR_FACES: 0,
        },
        c.MATERIALS_PARAM_NAME: {},
    }, folder)
    return folder


def parse_device(description, argv, **extra):
    """Parse ``--cpu`` (and ``extra``: flag -> add_argument keywords);
    ``--cpu`` sets ``config['device']`` to "cpu". Returns the arguments."""
    import deepmimo_tpu_torch as dm
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    for flag, kw in extra.items():
        ap.add_argument(flag, **kw)
    args = ap.parse_args(argv)
    if args.cpu:
        dm.config.set("device", "cpu")
    return args


def main(argv=None):
    parse_device(__doc__.splitlines()[0], argv)
    with tempfile.TemporaryDirectory(prefix="dm_quickstart_") as root:
        run(os.path.join(root, "quickstart_city"))
    return 0


def run(folder):
    import deepmimo_tpu_torch as dm
    from deepmimo_tpu_torch import consts as c

    print(f"device: {dm.config.get('device')}")
    write_scenario(folder, make_ray_data())

    # --- load + render -------------------------------------------------
    ds = dm.load(folder)
    params = dm.ChannelGenParameters()
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 4])
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 128
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(16)
    H = ds.compute_channels(params)
    assert H.shape == (64, 1, 16, 16) and np.isfinite(H).all()
    print(f"channels: {H.shape} {H.dtype}")

    # --- derived quantities -------------------------------------------
    pl = ds.pathloss
    los = ds.los
    print(f"pathloss[dB] median={np.nanmedian(pl):.1f}  "
          f"LoS fraction={np.mean(los == 1):.2f}")

    # --- Doppler snapshots --------------------------------------------
    dp = dm.ChannelGenParameters()
    dp[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([4, 4])
    dp[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 128
    dp[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(16)
    dp[c.PARAMSET_DOPPLER_EN] = 1
    dp[c.PARAMSET_DOPPLER_TIMES] = np.array([0.0, 1e-3])
    ds[c.DOPPLER_VEL_PARAM_NAME] = np.where(
        np.isnan(np.asarray(ds.power)), np.nan, 12.0).astype(np.float32)
    ds[c.DOPPLER_ACC_PARAM_NAME] = np.zeros_like(
        ds[c.DOPPLER_VEL_PARAM_NAME])
    Ht = ds.compute_channels(dp)
    assert Ht.shape == (64, 1, 16, 16, 2)
    print(f"doppler channels: {Ht.shape}")

    # --- differentiable: a gradient through the renderer ---------------
    import dataclasses
    from deepmimo_tpu_torch.ops.channel import render_channels
    from deepmimo_tpu_torch.ops.types import PathData

    cfg, bs_panel, ue_panel = params.to_config(ds.n_ue)
    pd = PathData.from_numpy(
        power=np.asarray(ds.power), phase=np.asarray(ds.phase),
        delay=np.asarray(ds.delay),
        aoa_az=np.asarray(ds[c.AOA_AZ_PARAM_NAME]),
        aoa_el=np.asarray(ds[c.AOA_EL_PARAM_NAME]),
        aod_az=np.asarray(ds[c.AOD_AZ_PARAM_NAME]),
        aod_el=np.asarray(ds[c.AOD_EL_PARAM_NAME]))
    target = render_channels(pd, bs_panel, ue_panel, cfg).abs()

    # A per-path phase perturbation pattern scaled by one parameter t (a
    # GLOBAL phase offset would rotate H uniformly and leave |H|
    # invariant — the gradient would be exactly zero).
    pattern = torch.as_tensor(
        np.random.RandomState(0).uniform(-30, 30, tuple(pd.phase_deg.shape)),
        dtype=torch.float32, device=pd.phase_deg.device)
    t = torch.full((), 0.1, device=pd.phase_deg.device, requires_grad=True)
    shifted = dataclasses.replace(pd, phase_deg=pd.phase_deg + t * pattern)
    h = render_channels(shifted, bs_panel, ue_panel, cfg)
    loss = torch.mean((h.abs() - target) ** 2)
    (g,) = torch.autograd.grad(loss, t)
    assert torch.isfinite(g) and float(g) != 0.0
    print(f"d(loss)/dt = {float(g):.3e}")

    # --- multi-device: shard users over the mesh -----------------------
    from deepmimo_tpu_torch import parallel as par
    mesh = par.make_mesh()
    Hs = par.render_channels_sharded(par.shard_paths(pd, mesh), bs_panel,
                                     ue_panel, cfg, mesh)
    np.testing.assert_allclose(
        Hs.full_tensor().abs().cpu().numpy(), target.cpu().numpy(),
        atol=1e-5)
    print(f"sharded render on {mesh.size()} device(s) "
          f"({mesh.device_type}, mesh {tuple(mesh.shape)}): OK")
    print("quickstart complete")


if __name__ == "__main__":
    raise SystemExit(main())
