"""Plain PyTorch reference of the DeepMIMO channel, beam-gain and
calibration arithmetic, written from the formulas.

For every user u, path p, receive element r, transmit element t and
selected subcarrier k (NaN-padded path matrices; a path is valid where its
power is not NaN):

- each side's path direction in the panel's frame: the unit vector of
  (elevation, azimuth) after the panel's Euler rotation (rx, ry, rz);
- a panel's response to it, for elements at (0, y, z) * spacing
  wavelengths (y fastest, then z): exp(j 2 pi spacing (y u_y + z u_z));
- the path's gain at subcarrier k: sqrt(10^(power / 10) / N_fft)
  exp(j (phase - 2 pi k d / N_fft)), with d = delay * bandwidth, zero
  where d >= N_fft (isotropic elements);
- H[u, r, t, k] = sum_p a_rx[u, r, p] a_tx[u, t, p] g[u, p, k];
- beam gains G[u, r, b, k] = |sum_t conj(W[b, t]) H[u, r, t, k]|^2;
- the calibration loss: sum |H(params) - T|^2 / sum |T|^2, with the
  per-path corrections (dB, degrees, nanoseconds) added to the paths and
  T the channels with the BS rotated as the target says.

A feature that the channel parameters turn on (``features``: an element
pattern other than isotropic, Doppler, dual polarisation, the time
domain, the receive filter) lives in a file of its own,
``reference/<feature>.py``, found by that name. It may define any of
the stages in ``STAGES``; each takes the stage it replaces as its first
argument, so features compose:

- ``element_gain(default, side, x, y, z)``: [U, P] linear power gain of
  one element of the panel ``side`` (its parameters) toward each path,
  from the path direction's components in the panel's frame; None for a
  gain of 1 (the default, isotropic);
- ``path_gains(default, p, params, corr)``: [U, P, K] complex gain of
  each path at each selected subcarrier;
- ``combine(default, a_rx, a_tx, g, precision)``: H from the responses
  [U, R, P], [U, T, P] and the gains.

A configuration that turns on a feature without a file is refused.

``precision`` "float64" computes in float64. "tf32" computes in float32
and rounds both operands of every path-sum product to TF32 (10 mantissa
bits), as a one-pass TF32 tensor-core kernel would: the benchmark's
control, the nearest precision below the configuration's float32.

Imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import os

import numpy as np
import torch

CALIB_LEAVES = ("bs.rotation_deg", "bs.spacing", "ue.rotation_deg",
                "ue.spacing", "d_power_dbw", "d_phase_deg", "d_delay_ns",
                "d_angles_deg")


STAGES = ("element_gain", "path_gains", "combine")


def features(params: dict) -> list:
    """Names of the features that the channel parameters turn on."""
    names = []
    for side in (params["bs_antenna"], params["ue_antenna"]):
        pattern = side.get("radiation_pattern", "isotropic")
        if pattern != "isotropic":
            names.append(f"pattern.{pattern}")
    for key, name in (("enable_doppler", "doppler"),
                      ("enable_dual_polar", "dual_polar")):
        if params.get(key):
            names.append(name)
    if not params.get("freq_domain", 1):
        names.append("time_domain")
    if params["ofdm"].get("rx_filter"):
        names.append("rx_filter")
    return sorted(set(names))


@functools.lru_cache(maxsize=None)
def _feature(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    if not os.path.exists(path):
        raise NotImplementedError(
            f"the reference has no feature {name!r}: add reference/{name}.py")
    spec = importlib.util.spec_from_file_location(
        "chipbench_reference_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stages(params: dict) -> dict:
    """Each stage's function, the features' composed over the defaults."""
    out = {"element_gain": lambda side, x, y, z: None,
           "path_gains": _gains, "combine": _combine}
    for name in features(params):
        mod = _feature(name)
        for stage in STAGES:
            if hasattr(mod, stage):
                out[stage] = functools.partial(getattr(mod, stage),
                                               out[stage])
    return out


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the backward too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).transpose(-1, -2), tf32(a).transpose(-1, -2) @ g


def _mm(a, b, precision):
    """Complex a @ b: exact complex matmul, or four real TF32 products."""
    if precision == "float64":
        return a @ b
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    mm = _TF32Matmul.apply
    return torch.complex(mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br))


def paths_to_tensors(data: dict, rows: slice, device, precision="float64"):
    """Rows of NaN-padded numpy matrices (every per-path field of ``data``)
    as tensors, invalid paths zeroed, and the validity mask."""
    dt = _dtype(precision)
    power = np.asarray(data["power"][rows], np.float64)
    valid = ~np.isnan(power)
    out = {k: torch.as_tensor(np.where(valid, np.asarray(
        data[k][rows], np.float64), 0.0), dtype=dt, device=device)
        for k in data if k != "n_valid"}
    out["valid"] = torch.as_tensor(valid, device=device)
    return out


def unit_vectors(rotation_deg, el_deg, az_deg):
    """Unit vector (x', y', z') of each direction in the rotated frame."""
    rx, ry, rz = (torch.deg2rad(rotation_deg[i]) for i in range(3))
    theta, phi = torch.deg2rad(el_deg), torch.deg2rad(az_deg)
    s_az, c_az = torch.sin(phi - rz), torch.cos(phi - rz)
    s_t, c_t = torch.sin(theta), torch.cos(theta)
    sx, cx, sy, cy = torch.sin(rx), torch.cos(rx), torch.sin(ry), \
        torch.cos(ry)
    x = cy * s_t * c_az - sy * c_t
    y = cy * sx * c_t + s_t * (sy * sx * c_az + cx * s_az)
    z = cy * cx * c_t + s_t * (sy * cx * c_az - sx * s_az)
    return x, y, z


def response(shape, spacing, uy, uz):
    """[U, N, P] complex response of a (m1, m2) panel to [U, P] directions."""
    m1, m2 = int(shape[0]), int(shape[1])
    n = torch.arange(m1 * m2, device=uy.device, dtype=uy.dtype)
    ys, zs = torch.remainder(n, m1), torch.div(n, m1, rounding_mode="floor")
    ph = 2 * math.pi * spacing * (ys[None, :, None] * uy[:, None, :] +
                                  zs[None, :, None] * uz[:, None, :])
    return torch.polar(torch.ones_like(ph), ph)


def _gains(p, params, corr):
    """[U, P, K] complex path gains in the frequency domain."""
    ofdm = params["ofdm"]
    d_power, d_phase, d_delay_ns = (corr.get(k, 0.0) for k in (
        "d_power_dbw", "d_phase_deg", "d_delay_ns"))
    n_fft = int(ofdm["subcarriers"])
    k = torch.as_tensor(ofdm["selected_subcarriers"], dtype=p["power"].dtype,
                        device=p["power"].device)
    d = (p["delay"] + d_delay_ns * 1e-9) * float(ofdm["bandwidth"])
    keep = p["valid"] & (d < n_fft)
    amp = torch.where(keep, torch.pow(10.0, (p["power"] + d_power) / 20.0),
                      torch.zeros_like(d)) / math.sqrt(n_fft)
    ph = torch.deg2rad(p["phase"] + d_phase)[..., None] - \
        2 * math.pi / n_fft * d[..., None] * k
    return torch.polar(amp[..., None].expand_as(ph), ph)


def _combine(a_rx, a_tx, g, precision):
    """H [U, R, T, K] = sum over paths of a_rx a_tx g."""
    u, n_r, n_p = a_rx.shape
    n_t = a_tx.shape[1]
    e = (a_rx[:, :, None, :] * a_tx[:, None, :, :]).reshape(u, n_r * n_t,
                                                             n_p)
    return _mm(e, g, precision).reshape(u, n_r, n_t, -1)


def channels(p, params: dict, bs_rot=None, bs_spacing=None, ue_rot=None,
             ue_spacing=None, corr=None, precision="float64"):
    """[U, R, T, K] complex channels of the users in ``p``
    (``paths_to_tensors``) under the channel parameters ``params`` (the
    configuration's ``channel_params``). Panel rotations and spacings, and
    the per-path corrections ``corr`` (d_power_dbw, d_phase_deg,
    d_delay_ns [U, P], d_angles_deg [U, P, 4]: aoa_az, aoa_el, aod_az,
    aod_el), may be given as tensors to differentiate through."""
    dt = p["power"].dtype
    bs, ue = params["bs_antenna"], params["ue_antenna"]
    stage = stages(params)

    def given(x, default):
        return torch.as_tensor(default if x is None else x, dtype=dt,
                               device=p["power"].device)

    bs_rot, ue_rot = given(bs_rot, bs["rotation"]), given(ue_rot,
                                                          ue["rotation"])
    bs_sp, ue_sp = given(bs_spacing, bs["spacing"]), given(ue_spacing,
                                                           ue["spacing"])
    c = corr or {}
    da = c.get("d_angles_deg")
    ang = {k: p[k] if da is None else p[k] + da[..., i]
           for i, k in enumerate(("aoa_az", "aoa_el", "aod_az", "aod_el"))}
    tx, ty, tz = unit_vectors(bs_rot, ang["aod_el"], ang["aod_az"])
    rx, ry, rz = unit_vectors(ue_rot, ang["aoa_el"], ang["aoa_az"])
    a_tx = response(bs["shape"], bs_sp, ty, tz)          # [U, T, P]
    a_rx = response(ue["shape"], ue_sp, ry, rz)          # [U, R, P]
    g = stage["path_gains"](p, params, c)                # [U, P, K]
    gains = [x for x in (stage["element_gain"](bs, tx, ty, tz),
                         stage["element_gain"](ue, rx, ry, rz))
             if x is not None]
    if gains:
        g = g * torch.sqrt(functools.reduce(torch.mul, gains))[..., None]
    return stage["combine"](a_rx, a_tx, g, precision)


def beam_gains(p, params: dict, w: np.ndarray, precision="float64"):
    """[U, R, B, K] beam gains |conj(W) H|^2 of codebook ``w`` [B, T]."""
    cdt = torch.complex128 if precision == "float64" else torch.complex64
    wc = torch.as_tensor(np.conj(w), dtype=cdt, device=p["power"].device)
    h = channels(p, params, precision=precision)          # [U, R, T, K]
    y = _mm(wc.expand(h.shape[0] * h.shape[1], *wc.shape),
            h.reshape(-1, h.shape[2], h.shape[3]), precision)
    return (y.real ** 2 + y.imag ** 2).reshape(h.shape[0], h.shape[1],
                                               wc.shape[0], h.shape[3])


def calibration(data: dict, params: dict, target_rotation, lr: float,
                steps: int, block: int, device, precision="float64",
                start=None):
    """``steps`` SGD steps of the calibration loss over users in blocks of
    ``block``: from zero corrections and the configured panels, or from
    the leaves ``start`` (``CALIB_LEAVES`` order). Returns
    the loss at each step's start, the first step's gradients and the
    change of every leaf after the steps, both in ``CALIB_LEAVES`` order
    (float64 tensors on ``device``)."""
    dt = _dtype(precision)
    n_u, n_p = np.asarray(data["power"]).shape
    blocks = [slice(i, min(i + block, n_u)) for i in range(0, n_u, block)]
    bs, ue = params["bs_antenna"], params["ue_antenna"]

    def vec(x):
        return torch.as_tensor(x, dtype=dt, device=device)

    leaves = [vec(bs["rotation"]), vec(bs["spacing"]), vec(ue["rotation"]),
              vec(ue["spacing"])] + [
        torch.zeros((n_u, n_p) + s, dtype=dt, device=device)
        for s in ((), (), (), (4,))] if start is None else [
        torch.as_tensor(x, device=device).to(dt).clone() for x in start]
    start = [x.clone() for x in leaves]
    with torch.no_grad():
        paths = [paths_to_tensors(data, b, device, precision) for b in blocks]
        target = [channels(p, params, bs_rot=vec(target_rotation),
                           precision=precision) for p in paths]
        den = sum(float((t.real ** 2 + t.imag ** 2).sum()) for t in target)
    losses, first = [], None
    for _ in range(steps):
        grads = [torch.zeros_like(x) for x in leaves]
        loss = 0.0
        for b, p, t in zip(blocks, paths, target):
            shared = [x.detach().requires_grad_(True) for x in leaves[:4]]
            rows = [x[b].detach().requires_grad_(True) for x in leaves[4:]]
            with torch.enable_grad():
                h = channels(p, params, *shared, corr=dict(zip(
                    CALIB_LEAVES[4:], rows)), precision=precision)
                err = h - t
                part = (err.real ** 2 + err.imag ** 2).sum() / den
                got = torch.autograd.grad(part, shared + rows,
                                          allow_unused=True)
            loss += float(part.detach())
            for i, gi in enumerate(got[:4]):
                if gi is not None:
                    grads[i] += gi
            for i, gi in enumerate(got[4:]):
                if gi is not None:
                    grads[4 + i][b] = gi
        losses.append(loss)
        if first is None:
            first = [g.to(torch.float64) for g in grads]
        leaves = [x - lr * g for x, g in zip(leaves, grads)]
    change = [(x - s).to(torch.float64) for x, s in zip(leaves, start)]
    return losses, first, change
