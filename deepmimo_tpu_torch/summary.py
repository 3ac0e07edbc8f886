"""Scenario summary: human-readable text + overview plots from params.json.

Copied from ``deepmimo_tpu/summary.py``: the text is the same for the same
scenario, because the scenario database indexes it
(``api.generate_key_components``). matplotlib is imported inside
``plot_summary`` only.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from . import consts as c
from .utils import load_dict_from_json, get_params_path, get_scenario_folder


def summary(scenario_name: str, print_summary: bool = True) -> str:
    """Build (and optionally print) a text summary of a scenario."""
    params = load_dict_from_json(get_params_path(scenario_name))
    rt = params.get(c.RT_PARAMS_PARAM_NAME, {})
    txrx = params.get(c.TXRX_PARAM_NAME, {})
    scene = params.get(c.SCENE_PARAM_NAME, {})
    materials = params.get(c.MATERIALS_PARAM_NAME, {})

    # Website-compatible layout: `[Section]` headers, bare subsection lines,
    # `- ` items — the same grammar api.generate_key_components parses into
    # the submission metadata the database indexes.
    lines = [
        "=" * 50,
        f"DeepMIMO {scenario_name} Scenario Summary",
        "=" * 50,
        "",
        "[Ray-Tracing Configuration]",
        f"Engine: {rt.get(c.RT_PARAM_RAYTRACER, '?')} "
        f"v{rt.get(c.RT_PARAM_RAYTRACER_VERSION, '?')}",
        f"- Frequency: {float(rt.get(c.RT_PARAM_FREQUENCY, 0))/1e9:.3f} GHz",
        "",
        "[Ray-tracing parameters]",
        "Interaction limits",
        f"- Max path depth: {rt.get(c.RT_PARAM_PATH_DEPTH, '?')}",
        f"- Max reflections: {rt.get(c.RT_PARAM_MAX_REFLECTIONS, '?')}",
        f"- Max diffractions: {rt.get(c.RT_PARAM_MAX_DIFFRACTIONS, '?')}",
        f"- Max scatterings: {rt.get(c.RT_PARAM_MAX_SCATTERING, '?')}",
        f"- Max transmissions: {rt.get(c.RT_PARAM_MAX_TRANSMISSIONS, '?')}",
        "Ray casting",
        f"- Number of rays: {rt.get(c.RT_PARAM_NUM_RAYS, '?')}",
        "",
        "[Scene]",
        f"- Number of scenes: {scene.get(c.SCENE_PARAM_NUMBER_SCENES, 1)}",
        f"- Total objects: {scene.get(c.SCENE_PARAM_N_OBJECTS, '?')}",
        f"- Vertices: {scene.get(c.SCENE_PARAM_N_VERTICES, '?')}",
        f"- Faces: {scene.get(c.SCENE_PARAM_N_FACES, '?')}",
        f"- Triangular faces: "
        f"{scene.get(c.SCENE_PARAM_N_TRIANGULAR_FACES, '?')}",
        "",
        "[Materials]",
        f"Total materials: {len(materials)}",
    ]
    for key in sorted(materials.keys()):
        m = materials[key]
        lines += [
            f"{m.get('name', key)}:",
            f"- Permittivity: {m.get(c.MATERIALS_PARAM_PERMITTIVITY)}",
            f"- Conductivity: {m.get(c.MATERIALS_PARAM_CONDUCTIVITY)} S/m",
            f"- Scattering model: "
            f"{m.get(c.MATERIALS_PARAM_SCATTERING_MODEL)}",
        ]

    lines += ["", "[TX/RX Configuration]"]
    n_rx = sum(int(s.get(c.TXRX_PARAM_NUM_ACTIVE_POINTS, 0) or 0)
               for s in txrx.values() if s.get(c.TXRX_PARAM_IS_RX))
    n_tx = sum(int(s.get(c.TXRX_PARAM_NUM_ACTIVE_POINTS, 0) or 0)
               for s in txrx.values() if s.get(c.TXRX_PARAM_IS_TX))
    lines += [f"Total number of receivers: {n_rx}",
              f"Total number of transmitters: {n_tx}"]
    for key in sorted(txrx.keys()):
        s = txrx[key]
        role = " & ".join(r for r, on in
                          (("TX", s.get(c.TXRX_PARAM_IS_TX)),
                           ("RX", s.get(c.TXRX_PARAM_IS_RX))) if on)
        lines += [
            f"{key} ({s.get('name', key)}):",
            f"- Role: {role}",
            f"- Total points: {s.get(c.TXRX_PARAM_NUM_POINTS)}",
            f"- Active points: "
            f"{s.get(c.TXRX_PARAM_NUM_ACTIVE_POINTS, '?')}",
            f"- Antennas per point: {s.get(c.TXRX_PARAM_NUM_ANT, 1)}",
            f"- Dual polarization: {s.get(c.TXRX_PARAM_DUAL_POL, False)}",
        ]

    bbox = rt.get(c.RT_PARAM_GPS_BBOX)
    if bbox and tuple(bbox) != (0, 0, 0, 0):
        lines += ["", "[GPS Bounding Box]",
                  f"- Min latitude: {bbox[0]:.2f}",
                  f"- Min longitude: {bbox[1]:.2f}",
                  f"- Max latitude: {bbox[2]:.2f}",
                  f"- Max longitude: {bbox[3]:.2f}"]

    text = "\n".join(lines)
    if print_summary:
        print(text)
    return text


def plot_summary(scenario_name: str, save_imgs: bool = False,
                 show_plots: bool = True) -> Optional[List[str]]:
    """Render overview plots: LoS map, scene 3D, aggregate statistics.

    Returns the list of saved image paths when ``save_imgs`` is True.
    """
    import matplotlib
    if not show_plots:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .generator import load

    dataset = load(scenario_name)
    d = dataset[0] if hasattr(dataset, "datasets") else dataset

    folder = get_scenario_folder(scenario_name)
    saved: List[str] = []

    # LoS map
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111)
    rx = np.asarray(d[c.RX_POS_PARAM_NAME])
    los = np.asarray(d[c.LOS_PARAM_NAME])
    sc = ax.scatter(rx[:, 0], rx[:, 1], c=los, s=2, cmap="viridis")
    fig.colorbar(sc, ax=ax, label="LoS status")
    ax.set_title(f"{scenario_name}: LoS map")
    if save_imgs:
        path = os.path.join(folder, "summary_los.png")
        fig.savefig(path, dpi=120)
        saved.append(path)

    # Pathloss map
    fig2 = plt.figure(figsize=(8, 6))
    ax2 = fig2.add_subplot(111)
    pl = np.asarray(d[c.PATHLOSS_PARAM_NAME])
    sc2 = ax2.scatter(rx[:, 0], rx[:, 1], c=pl, s=2, cmap="magma")
    fig2.colorbar(sc2, ax=ax2, label="Pathloss (dB)")
    ax2.set_title(f"{scenario_name}: pathloss")
    if save_imgs:
        path = os.path.join(folder, "summary_pathloss.png")
        fig2.savefig(path, dpi=120)
        saved.append(path)

    # Scene
    scene = d.get(c.SCENE_PARAM_NAME)
    if scene is not None:
        ax3 = scene.plot()
        if save_imgs:
            path = os.path.join(folder, "summary_scene.png")
            ax3.figure.savefig(path, dpi=120)
            saved.append(path)

    if show_plots:
        plt.show()
    else:
        plt.close("all")
    return saved if save_imgs else None
