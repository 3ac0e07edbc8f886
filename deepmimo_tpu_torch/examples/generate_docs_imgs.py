"""Render the port's documentation figures from a synthetic scenario.

Writes ``coverage.png``, ``rays.png``, ``power_discarding.png`` and
``scene.png`` headlessly (matplotlib's Agg backend) into the port's own
``deepmimo_tpu_torch/docs/imgs/``, or into ``--out``. It runs on the CPU
(plots are host work).

Run: ``python -m deepmimo_tpu_torch.examples.generate_docs_imgs [--out DIR]``.
"""

import argparse
import os
import tempfile

import numpy as np

from .quickstart import make_ray_data, write_scenario

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs", "imgs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT, help="folder of the images")
    out = ap.parse_args(argv).out

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import deepmimo_tpu_torch as dm
    from deepmimo_tpu_torch.scene import Face, PhysicalElement, Scene

    dm.config.set("device", "cpu")
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_ray_data(n_ue=512, max_paths=10, seed=4)
        # One bounce point per reflected path, for the ray plot.
        rng = np.random.RandomState(5)
        refl = data["inter"] == 1
        inter_pos = np.full(refl.shape + (1, 3), np.nan, np.float32)
        inter_pos[refl, 0] = rng.uniform(-50, 50, (int(refl.sum()), 3))
        inter_pos[refl, 0, 2] = np.abs(inter_pos[refl, 0, 2])
        data["inter_pos"] = inter_pos
        folder = write_scenario(os.path.join(tmp, "docs_city"), data)
        ds = dm.load(folder)

        ax = ds.plot_coverage(np.asarray(ds.pathloss),
                              cbar_title="Pathloss (dB)", scat_sz=8)
        ax.figure.savefig(os.path.join(out, "coverage.png"), dpi=120)
        plt.close("all")

        idx = int(np.argmax(np.asarray(ds.num_paths)))
        ax = ds.plot_rays(idx)
        ax.figure.savefig(os.path.join(out, "rays.png"), dpi=120)
        plt.close("all")

        ds.compute_channels(dm.ChannelGenParameters())
        ax = dm.plot_power_discarding(ds)
        ax.figure.savefig(os.path.join(out, "power_discarding.png"),
                          dpi=120)
        plt.close("all")

    scene = Scene()
    rng = np.random.RandomState(0)
    for _ in range(12):
        x, y = rng.uniform(-60, 60, 2)
        w, d, h = rng.uniform(8, 20, 3) * (1, 1, 2)
        base = [[x, y, 0], [x + w, y, 0], [x + w, y + d, 0], [x, y + d, 0]]
        top = [[v[0], v[1], h] for v in base]
        faces = [Face(base), Face(top)]
        for a, b in zip(range(4), [1, 2, 3, 0]):
            faces.append(Face([base[a], base[b], top[b], top[a]]))
        scene.add_object(PhysicalElement(faces, label="buildings"))
    ax = scene.plot()
    ax.figure.savefig(os.path.join(out, "scene.png"), dpi=120)
    plt.close("all")
    print(f"wrote images to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
