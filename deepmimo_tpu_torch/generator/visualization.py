"""Visualization: coverage maps, ray plots, power-discarding diagnostics.

Copied from ``deepmimo_tpu/generator/visualization.py``. matplotlib is
imported inside the plotting functions, so the package imports without
it; tensors (on the card or not) go to the host with ``.cpu()`` before
they reach numpy or matplotlib.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import consts as c

METERS_PER_DEG_LAT = 111_320.0     # the scenario pipelines' GPS convention


def _host(x, dtype=None) -> np.ndarray:
    """``x`` as a host numpy array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _cartesian_to_gps(x, y, origin_lat: float, origin_lon: float):
    """Local x (east) / y (north) metres -> (lat, lon) around an origin."""
    lat = origin_lat + np.asarray(y, np.float64) / METERS_PER_DEG_LAT
    lon = origin_lon + np.asarray(x, np.float64) / (
        METERS_PER_DEG_LAT * np.cos(np.radians(origin_lat)))
    return lat, lon


def plot_coverage(rxs, cov_map, dpi: int = 100, figsize=(6, 4),
                  cbar_title: Optional[str] = None, title: bool = True,
                  scat_sz: float = 0.5, bs_pos=None, bs_ori=None,
                  legend: bool = False, lims=None, proj_3D: bool = False,
                  equal_aspect: bool = False, tight: bool = True,
                  cmap: str = "viridis", ax=None):
    """Scatter users colored by a per-user metric (2D or 3D).

    Args:
        rxs: [n_ue, 3] user positions.
        cov_map: [n_ue] metric to color by (power, LoS, pathloss, ...).
        bs_pos: optional [3] (or [3, 1]) BS position marker.
        bs_ori: optional [3] BS orientation (radians) to draw a boresight
            arrow.
    """
    import matplotlib.pyplot as plt

    rxs = _host(rxs)
    cov_map = _host(cov_map, np.float64)

    if ax is None:
        fig = plt.figure(figsize=figsize, dpi=dpi)
        ax = fig.add_subplot(111, projection="3d" if proj_3D else None)
    else:
        fig = ax.figure

    if proj_3D:
        sc = ax.scatter(rxs[:, 0], rxs[:, 1], rxs[:, 2], c=cov_map,
                        s=scat_sz, cmap=cmap)
    else:
        sc = ax.scatter(rxs[:, 0], rxs[:, 1], c=cov_map, s=scat_sz, cmap=cmap)

    cbar = fig.colorbar(sc, ax=ax)
    if cbar_title:
        cbar.set_label(cbar_title)

    if bs_pos is not None:
        bs_pos = _host(bs_pos).reshape(-1)
        if proj_3D:
            ax.scatter([bs_pos[0]], [bs_pos[1]], [bs_pos[2]], marker="^",
                       c="red", s=60, label="BS")
        else:
            ax.scatter([bs_pos[0]], [bs_pos[1]], marker="^", c="red", s=60,
                       label="BS")
        if bs_ori is not None and not proj_3D:
            ori = _host(bs_ori).reshape(-1)
            length = 0.05 * (rxs[:, 0].max() - rxs[:, 0].min() + 1e-9)
            ax.arrow(bs_pos[0], bs_pos[1],
                     length * np.cos(ori[2]), length * np.sin(ori[2]),
                     head_width=length / 3, color="red")

    if title:
        ax.set_title("Coverage map")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    if lims is not None:
        ax.set_xlim(lims[0])
        ax.set_ylim(lims[1])
    if equal_aspect and not proj_3D:
        ax.set_aspect("equal")
    if legend:
        ax.legend()
    if tight:
        fig.tight_layout()
    return ax


def transform_coordinates(pos: np.ndarray, origin_lat: float,
                          origin_lon: float) -> np.ndarray:
    """Local cartesian positions -> GPS (lat, lon, alt) rows (GIS export)."""
    pos = _host(pos, np.float64)
    lat, lon = _cartesian_to_gps(pos[:, 0], pos[:, 1], origin_lat,
                                origin_lon)
    alt = pos[:, 2] if pos.shape[1] > 2 else np.zeros(len(pos))
    return np.column_stack([lat, lon, alt])


def export_xyz_csv(dataset, metric, path: str,
                   origin_lat: Optional[float] = None,
                   origin_lon: Optional[float] = None) -> str:
    """Export a per-user metric as CSV for GIS tools.

    Columns: x,y,z,value — or lat,lon,alt,value when a GPS origin is given
    (taken from rt_params' gps_bbox center when available).
    """
    rx = _host(dataset[c.RX_POS_PARAM_NAME], np.float64)
    vals = _host(metric, np.float64).reshape(-1)

    if origin_lat is None:
        rt = dataset.get(c.RT_PARAMS_PARAM_NAME) or {}
        bbox = rt.get(c.RT_PARAM_GPS_BBOX)
        if bbox is not None and any(bbox):
            origin_lat = (bbox[0] + bbox[2]) / 2
            origin_lon = (bbox[1] + bbox[3]) / 2

    if origin_lat is not None:
        rows = transform_coordinates(rx, origin_lat, origin_lon)
        header = "lat,lon,alt,value"
    else:
        rows = rx
        header = "x,y,z,value"

    data = np.column_stack([rows, vals])
    np.savetxt(path, data, delimiter=",", header=header, comments="")
    return path


# Interaction-type colors for ray plots
_INTER_COLORS = {
    c.INTERACTION_LOS: ("tab:green", "LoS"),
    c.INTERACTION_REFLECTION: ("tab:blue", "Reflection"),
    c.INTERACTION_DIFFRACTION: ("tab:orange", "Diffraction"),
    c.INTERACTION_SCATTERING: ("tab:purple", "Scattering"),
    c.INTERACTION_TRANSMISSION: ("tab:red", "Transmission"),
}


def plot_rays(rx_pos, tx_pos, inter_pos, inter, proj_3D: bool = True,
              color_by_type: bool = True, dpi: int = 100, figsize=(7, 5),
              ax=None):
    """Plot the ray polylines of one user, colored by first-bounce type.

    Args:
        rx_pos: [3] user position.
        tx_pos: [3] transmitter position.
        inter_pos: [n_paths, max_inter, 3] interaction positions (NaN pad).
        inter: [n_paths] interaction codes.
    """
    import matplotlib.pyplot as plt

    rx_pos = _host(rx_pos).reshape(-1)
    tx_pos = _host(tx_pos).reshape(-1)
    inter_pos = _host(inter_pos, np.float64)
    inter = _host(inter, np.float64)

    if ax is None:
        fig = plt.figure(figsize=figsize, dpi=dpi)
        ax = fig.add_subplot(111, projection="3d" if proj_3D else None)

    seen_labels = set()
    n_paths = inter_pos.shape[0] if inter_pos.ndim == 3 else 0
    for p in range(n_paths):
        if np.isnan(inter[p]):
            continue
        bounces = inter_pos[p]
        bounces = bounces[~np.isnan(bounces[:, 0])] if bounces.ndim == 2 \
            else np.zeros((0, 3))
        pts = np.vstack([tx_pos[None, :], bounces, rx_pos[None, :]])

        first_code = int(str(int(inter[p]))[0]) if inter[p] > 0 else 0
        color, label = _INTER_COLORS.get(first_code, ("gray", "other")) \
            if color_by_type else ("tab:blue", None)
        kwargs = {}
        if label and label not in seen_labels:
            kwargs["label"] = label
            seen_labels.add(label)
        if proj_3D:
            ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], color=color,
                    linewidth=0.8, **kwargs)
        else:
            ax.plot(pts[:, 0], pts[:, 1], color=color, linewidth=0.8,
                    **kwargs)

    marker3d = ([tx_pos[2]],) if proj_3D else ()
    ax.scatter([tx_pos[0]], [tx_pos[1]], *marker3d, marker="^", c="red",
               s=60, label="TX")
    marker3d = ([rx_pos[2]],) if proj_3D else ()
    ax.scatter([rx_pos[0]], [rx_pos[1]], *marker3d, marker="o", c="black",
               s=30, label="RX")
    ax.legend()
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title("Ray paths")
    return ax


def plot_power_discarding(dataset, dpi: int = 100, figsize=(6, 4), ax=None):
    """Map the % of per-user power lost to OFDM delay trimming.

    Paths whose delay exceeds the OFDM symbol duration are zeroed during
    frequency-domain generation; this plots how much energy that discards.
    """
    params = dataset.ch_params
    ofdm = params[c.PARAMSET_OFDM]
    ts = 1.0 / float(ofdm[c.PARAMSET_OFDM_BANDWIDTH])
    n_fft = int(ofdm[c.PARAMSET_OFDM_SC_NUM])
    symbol_duration = n_fft * ts

    delay = _host(dataset[c.DELAY_PARAM_NAME], np.float64)
    power = _host(dataset[c.PWR_LINEAR_PARAM_NAME], np.float64)

    over = delay > symbol_duration
    total = np.nansum(power, axis=1)
    lost = np.nansum(np.where(over, power, 0.0), axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        pct = np.where(total > 0, 100.0 * lost / total, 0.0)

    ax = plot_coverage(_host(dataset[c.RX_POS_PARAM_NAME]), pct,
                       dpi=dpi, figsize=figsize,
                       cbar_title="Power discarded (%)", ax=ax)
    ax.set_title("OFDM delay-trimming power loss")
    return ax
