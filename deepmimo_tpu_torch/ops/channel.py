"""Path -> channel renderer (PyTorch): the frequency-domain paths.

Synthesizes MIMO channel matrices from per-path ray data,

    H[u, r, t, k] = sum_p  a_rx[u, r, p] * a_tx[u, t, p] * g[u, p, k],

as real/imag float32 planes (:func:`render_channels_planes`) or complex64
(:func:`render_channels`, with :func:`render_channels_and_grads`).
Counterpart of the complex64, OFDM branches of
``deepmimo_tpu/ops/channel.py``. ``render_channels_planes``:

- the fused backend (``backend`` "fused"/"pallas", the product default)
  rotates the path directions to unit-vector phase steps and hands seven
  per-path scalars to the hand-written CUDA kernel
  (``ops/kernels/render.py``), which writes H once;
- the "xla" backend, and configs the kernel does not take, go through the
  eager planes path (rotated angles, FoV, pattern gains, array responses,
  OFDM gains, four real batched products).

``render_channels`` always goes through angle space and the array-response
planes; its path sum is the eager planes product, or with ``backend``
"pallas" the hand-written CUDA path-sum kernel (``ops/kernels/pathsum.py``).
Both renderers are differentiable; on CUDA the fused render's gradient is
its backward kernel.

Configurations outside this slice raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import consts as c
from .geometry import (apply_fov, array_response_planes, is_full_fov,
                       rotate_angles, rotate_unit_vec)
from .kernels import render as _render
from .kernels.pathsum import fused_path_sum
from .patterns import pattern_gain
from .types import AntennaPanel, ChannelConfig, PathData


def not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, port queue item {item})")


def _check_complex_path(cfg: ChannelConfig) -> None:
    """The configurations :func:`render_channels` does not take yet."""
    if not cfg.freq_domain:
        raise not_ported("Time-domain rendering", "9 (non-fused paths)")
    if cfg.rx_filter:
        raise not_ported("The sinc receive filter (rx_filter)",
                          "9 (non-fused paths)")
    if cfg.dtype != "complex64":
        raise not_ported(f"compute_dtype={cfg.dtype!r}",
                          "9 (non-fused paths)")
    if cfg.matmul_dtype != "float32":
        raise not_ported(f"matmul_dtype={cfg.matmul_dtype!r}",
                          "4 (forward variants)")


def check_in_slice(cfg: ChannelConfig) -> None:
    """Raise NotImplementedError for planes configurations not yet
    ported."""
    _check_complex_path(cfg)
    if cfg.enable_doppler and len(cfg.doppler_times) > 1:
        raise not_ported("Doppler with several snapshots",
                          "4 (forward variants)")
    if cfg.out_dtype != "float32":
        raise not_ported(f"out_dtype={cfg.out_dtype!r}",
                          "4 (forward variants)")
    if cfg.backend in ("pallas", "fused") and _fused_render_eligible(cfg) \
            and _angles_needed(cfg):
        raise not_ported("The fused render with FoV or a non-isotropic "
                          "pattern (angle-space prologue)",
                          "4 (forward variants)")


# ============================================================================
# Stage helpers
# ============================================================================

def _rotated_angles(paths: PathData, bs: AntennaPanel, ue: AntennaPanel):
    """Departure angles rotated by the BS panel, arrival angles by the UE
    panel. Radians, [U, P] each."""
    aod_theta, aod_phi = rotate_angles(bs.rotation_deg, paths.aod_el_deg,
                                       paths.aod_az_deg)
    aoa_theta, aoa_phi = rotate_angles(ue.rotation_deg, paths.aoa_el_deg,
                                       paths.aoa_az_deg)
    return aod_theta, aod_phi, aoa_theta, aoa_phi


def _fov_valid(cfg: ChannelConfig, valid, aod_theta, aod_phi, aoa_theta,
               aoa_phi):
    """AND the path-validity mask with the FoV inclusion masks."""
    if cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov):
        valid = valid & apply_fov(cfg.bs_fov, aod_theta, aod_phi)
    if cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov):
        valid = valid & apply_fov(cfg.ue_fov, aoa_theta, aoa_phi)
    return valid


def _powers_linear(cfg: ChannelConfig, paths: PathData, valid,
                   aod_theta, aod_phi, aoa_theta, aoa_phi):
    """Linear path power [W] with TX/RX pattern gains applied ([U, P])."""
    p_lin = torch.pow(10.0, paths.power_dbw / 10.0)
    gain = (pattern_gain(cfg.bs_pattern, aod_theta, aod_phi) *
            pattern_gain(cfg.ue_pattern, aoa_theta, aoa_phi))
    return torch.where(valid, p_lin * gain, torch.zeros_like(p_lin))


def _doppler_phase(cfg: ChannelConfig, vel, acc, t):
    """Doppler phase -2 pi f_c (v t / c + a t^2 / 2c) at times t."""
    return -2 * math.pi * cfg.carrier_freq * (
        vel * t / c.LIGHTSPEED + acc * (t * t) / (2 * c.LIGHTSPEED))


def _ofdm_gain_planes(cfg: ChannelConfig, powers_lin, delays, phase_deg,
                      valid, t_snap, paths: PathData):
    """Per-path OFDM gains as (gr, gi) planes, [U, P, K] each (non-LPF)."""
    n_fft = cfg.subcarriers
    k_sel = torch.as_tensor(np.asarray(cfg.selected_subcarriers,
                                       dtype=np.float64),
                            dtype=cfg.rdtype, device=delays.device)
    delay_n = delays / (1.0 / cfg.bandwidth)
    pvalid = valid & (delay_n < n_fft)
    amp = torch.where(pvalid, torch.sqrt(powers_lin / n_fft),
                      torch.zeros_like(powers_lin))
    base = (torch.deg2rad(phase_deg)[..., None] -
            (2 * math.pi / n_fft) * delay_n[..., None] * k_sel)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        base = base + _doppler_phase(cfg, paths.doppler_vel,
                                     paths.doppler_acc,
                                     delays + t_snap)[..., None]
    return amp[..., None] * torch.cos(base), amp[..., None] * torch.sin(base)


def _path_sum_planes_ri(arx, atx, gr, gi):
    """H = sum_p (a_rx a_tx) g via four real batched products -> (hr, hi),
    each [U, R, T, K]; accumulation in float32."""
    (arx_r, arx_i), (atx_r, atx_i) = arx, atx
    u, r, p = arx_r.shape
    t = atx_r.shape[1]
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :]).reshape(u, r * t, p)
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :]).reshape(u, r * t, p)

    def mm(a, b):
        return torch.einsum("uqp,upk->uqk", a, b)

    hr = mm(er, gr) - mm(ei, gi)
    hi = mm(er, gi) + mm(ei, gr)
    k = gr.shape[-1]
    return hr.reshape(u, r, t, k), hi.reshape(u, r, t, k)


def _path_sum_pallas(cfg: ChannelConfig, arx, atx, powers_lin,
                     paths: PathData, valid, t_snap):
    """Complex [U, R, T, K] through the path-sum kernel (E and g never
    leave the chip)."""
    n_fft = cfg.subcarriers
    k_sel = torch.as_tensor(np.asarray(cfg.selected_subcarriers,
                                       dtype=np.float64),
                            dtype=cfg.rdtype, device=paths.delay_s.device)
    delay_n = paths.delay_s / (1.0 / cfg.bandwidth)
    pvalid = valid & (delay_n < n_fft)
    amp = torch.where(pvalid, torch.sqrt(powers_lin / n_fft),
                      torch.zeros_like(powers_lin))
    psi = torch.deg2rad(paths.phase_deg)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        psi = psi + _doppler_phase(cfg, paths.doppler_vel, paths.doppler_acc,
                                   paths.delay_s + t_snap)
    omega = (2 * math.pi / n_fft) * delay_n
    (arx_r, arx_i), (atx_r, atx_i) = arx, atx
    u, r, _ = arx_r.shape
    hr, hi = fused_path_sum(*(x.contiguous() for x in (
        arx_r, arx_i, atx_r, atx_i, amp, psi, omega)), k_sel)
    return torch.complex(hr, hi).reshape(u, r, atx_r.shape[1], -1)


def _k_progression(cfg: ChannelConfig):
    """(k0, stride) if selected subcarriers form an arithmetic progression
    (a single subcarrier counts, stride 1); else None."""
    ks = tuple(int(k) for k in cfg.selected_subcarriers)
    if len(ks) == 1:
        return ks[0], 1
    d = ks[1] - ks[0]
    if d != 0 and all(b - a == d for a, b in zip(ks, ks[1:])):
        return ks[0], d
    return None


def _fused_n_snap(cfg: ChannelConfig) -> int:
    return len(cfg.doppler_times) if cfg.enable_doppler else 1


def _packed_layout(cfg: ChannelConfig) -> bool:
    """Emit the packed [..., 2*S*K] plane layout? Needs the opt-in, the
    frequency domain and S*K % 64 == 0 (kept from the JAX package so both
    packages produce the same layout for the same config)."""
    sk = len(cfg.selected_subcarriers) * _fused_n_snap(cfg)
    return (cfg.planes_layout == "packed" and cfg.freq_domain
            and sk % 64 == 0)


def _angles_needed(cfg: ChannelConfig) -> bool:
    """Does any stage need rotated ANGLES (FoV masks, non-isotropic
    patterns), rather than the rotated unit vectors?"""
    fov_on = ((cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov)) or
              (cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov)))
    return (fov_on or cfg.bs_pattern != "isotropic"
            or cfg.ue_pattern != "isotropic")


def _fused_render_eligible(cfg: ChannelConfig) -> bool:
    """Can this config render through the CUDA kernel? Same answer on
    every device: the JAX predicate (frequency domain, no LPF, complex64,
    arithmetic subcarriers) plus the kernel's shared-memory bound."""
    if not (cfg.freq_domain and not cfg.rx_filter
            and cfg.dtype == "complex64" and _k_progression(cfg)):
        return False
    return _render.kernel_fits(cfg.ue_shape, cfg.bs_shape, cfg.num_paths,
                               len(cfg.selected_subcarriers),
                               _fused_n_snap(cfg))


def _fused_path_scalars(cfg: ChannelConfig, paths: PathData, valid,
                        powers_lin):
    """(amp [U, P], psi [U, S*P], omega [U, P]) for the fused kernel.

    Per-path math on flat [U*P] views; k0 folds into psi and the
    subcarrier stride into omega.
    """
    u, p = paths.delay_s.shape
    valid_f = valid.reshape(-1)
    n_fft = cfg.subcarriers
    delay_f = paths.delay_s.reshape(-1)
    delay_n = delay_f * cfg.bandwidth
    pvalid = valid_f & (delay_n < n_fft)
    pw = powers_lin.reshape(-1)
    amp = torch.where(pvalid, torch.sqrt(pw / n_fft), torch.zeros_like(pw))

    k0, stride = _k_progression(cfg)
    omega_base = (2 * math.pi / n_fft) * delay_n
    psi0 = torch.deg2rad(paths.phase_deg.reshape(-1)) - omega_base * k0
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    n_s = len(snapshots)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        vel = paths.doppler_vel.reshape(-1)
        acc = paths.doppler_acc.reshape(-1)
        psi = torch.stack([psi0 + _doppler_phase(cfg, vel, acc, delay_f + t)
                           for t in snapshots])
        psi = psi.reshape(n_s, u, p).transpose(0, 1).reshape(u, n_s * p)
    else:
        psi = psi0.reshape(u, 1, p).expand(u, n_s, p).reshape(u, n_s * p)
    omega = (omega_base * stride).reshape(u, p)
    return (amp.reshape(u, p).contiguous(), psi.contiguous(),
            omega.contiguous())


def _render_fused_planes(cfg: ChannelConfig, paths: PathData, valid,
                         powers_lin, gry, grz, gty, gtz,
                         out: Optional[torch.Tensor] = None):
    """Fully fused OFDM render: per-path scalars -> H planes, one kernel
    launch. ``gry..gtz`` are the RX/TX wave-vector phase steps kd*y',
    kd*z' in the rotated frame; invalid paths are zeroed here. Returns the
    kernel's layout viewed as [U, R, T, 2*S*K] (packed) or
    [2, U, R, T, S, K] (stacked); ``out`` (that shape) is written in place.
    """
    u, p = paths.delay_s.shape
    valid_f = valid.reshape(-1)

    def z(x):
        x = x.reshape(-1)
        return torch.where(valid_f, x, torch.zeros_like(x)).reshape(u, p)

    amp, psi, omega = _fused_path_scalars(cfg, paths, valid, powers_lin)
    n_k = len(cfg.selected_subcarriers)
    n_s = _fused_n_snap(cfg)
    packed = _packed_layout(cfg)
    r = cfg.ue_shape[0] * cfg.ue_shape[1]
    t = cfg.bs_shape[0] * cfg.bs_shape[1]
    kout = None
    if out is not None:
        kout = out.view(u, r * t, 2 * n_s * n_k) if packed else \
            out.view(2, u, r * t, n_s * n_k)
    h = _render.fused_render(z(gry), z(grz), z(gty), z(gtz), amp, psi,
                             omega, cfg.ue_shape, cfg.bs_shape, n_k,
                             packed, out=kout)
    if packed:
        return h.view(u, r, t, 2 * n_s * n_k)
    return h.view(2, u, r, t, n_s, n_k)


def render_out_shape(n_ue: int, cfg: ChannelConfig):
    """Shape of :func:`render_channels_planes`' output for ``n_ue`` users."""
    r, t, k = cfg.n_rx_ant, cfg.n_tx_ant, cfg.n_sel_subcarriers
    if _packed_layout(cfg):
        return (n_ue, r, t, 2 * _fused_n_snap(cfg) * k)
    return (2, n_ue, r, t, k)


# ============================================================================
# Public renderer
# ============================================================================

def render_channels_planes(paths: PathData, bs: AntennaPanel,
                           ue: AntennaPanel, cfg: ChannelConfig,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Render OFDM channels as float32 real/imag planes.

    Layout (:func:`_packed_layout`):
    - stacked: [2, U, R, T, K];
    - packed (cfg.planes_layout == "packed", K % 64 == 0):
      [U, R, T, 2*K] with hr in the first minor half.

    ``out``, when given, must have exactly that shape (float32, on the
    paths' device); the result is written into it, overwriting what it
    held, and returned. Tensors are on the device of ``paths``.
    """
    check_in_slice(cfg)
    shape = render_out_shape(paths.n_ue, cfg)
    if out is not None and (tuple(out.shape) != shape or
                            out.dtype != torch.float32 or
                            out.device != paths.valid.device or
                            not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {shape} tensor "
                         f"on {paths.valid.device}; got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    paths = paths.trim_paths(cfg.num_paths)
    if cfg.backend in ("pallas", "fused") and _fused_render_eligible(cfg):
        # Isotropic patterns and full-sphere FoV (check_in_slice): angle
        # space is never entered; a [3] rotation broadcasts against flat
        # [U*P] views.
        valid = paths.valid
        powers_lin = torch.where(
            valid, torch.pow(10.0, paths.power_dbw / 10.0),
            torch.zeros_like(paths.power_dbw))
        flat = ue.rotation_deg.dim() == 1 and bs.rotation_deg.dim() == 1
        v = (lambda x: x.reshape(-1)) if flat else (lambda x: x)
        _, ry, rz = rotate_unit_vec(ue.rotation_deg, v(paths.aoa_el_deg),
                                    v(paths.aoa_az_deg))
        _, ty, tz = rotate_unit_vec(bs.rotation_deg, v(paths.aod_el_deg),
                                    v(paths.aod_az_deg))
        kd_ue = 2 * math.pi * ue.spacing
        kd_bs = 2 * math.pi * bs.spacing
        h = _render_fused_planes(cfg, paths, valid, powers_lin,
                                 kd_ue * ry, kd_ue * rz, kd_bs * ty,
                                 kd_bs * tz, out=out)
        return h if _packed_layout(cfg) else h.view(shape)

    aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs, ue)
    valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi, aoa_theta,
                       aoa_phi)
    powers_lin = _powers_linear(cfg, paths, valid, aod_theta, aod_phi,
                                aoa_theta, aoa_phi)
    arx = array_response_planes(cfg.ue_shape, ue.spacing, aoa_theta,
                                aoa_phi, valid)
    atx = array_response_planes(cfg.bs_shape, bs.spacing, aod_theta,
                                aod_phi, valid)
    t_snap = cfg.doppler_times[0] if cfg.enable_doppler else 0.0
    gr, gi = _ofdm_gain_planes(cfg, powers_lin, paths.delay_s,
                               paths.phase_deg, valid, t_snap, paths)
    hr, hi = _path_sum_planes_ri(arx, atx, gr, gi)
    h = torch.cat((hr, hi), dim=-1) if _packed_layout(cfg) else \
        torch.stack((hr, hi))
    return h if out is None else out.copy_(h)


def render_channels(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                    cfg: ChannelConfig) -> torch.Tensor:
    """Render complex64 MIMO channels [U, R, T, K] (frequency domain).

    With Doppler over several snapshots a trailing time axis is added:
    [U, R, T, K, len(cfg.doppler_times)]. ``backend`` "pallas" takes the
    path-sum kernel; any other backend the eager planes product.
    """
    _check_complex_path(cfg)
    paths = paths.trim_paths(cfg.num_paths)
    aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs, ue)
    valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi, aoa_theta,
                       aoa_phi)
    powers_lin = _powers_linear(cfg, paths, valid, aod_theta, aod_phi,
                                aoa_theta, aoa_phi)
    arx = array_response_planes(cfg.ue_shape, ue.spacing, aoa_theta,
                                aoa_phi, valid)
    atx = array_response_planes(cfg.bs_shape, bs.spacing, aod_theta,
                                aod_phi, valid)
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    outs = []
    for t_snap in snapshots:
        if cfg.backend == "pallas":
            h = _path_sum_pallas(cfg, arx, atx, powers_lin, paths, valid,
                                 t_snap)
        else:
            gr, gi = _ofdm_gain_planes(cfg, powers_lin, paths.delay_s,
                                       paths.phase_deg, valid, t_snap,
                                       paths)
            h = torch.complex(*_path_sum_planes_ri(arx, atx, gr, gi))
        outs.append(h)
    return torch.stack(outs, dim=-1) if len(outs) > 1 else outs[0]


def _grad_leaf(x):
    if x is None or not torch.is_floating_point(x):
        return x
    return x.detach().requires_grad_(True)


def render_channels_and_grads(paths: PathData, bs: AntennaPanel,
                              ue: AntennaPanel, cfg: ChannelConfig,
                              cotangent: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, Tuple]:
    """Forward channels plus the VJP w.r.t. (paths, bs, ue) for a
    cotangent (ones when None): d Re(sum(H * cot)) / d params, the JAX
    package's convention. JAX's VJP with cotangent c is PyTorch's backward
    with grad_output ``c.conj()``.

    Returns ``(h, (path_grads, bs_grads, ue_grads))``: a PathData and two
    AntennaPanels of gradients, with None for ``valid`` and absent fields.
    """
    objs = [type(o)(**{f.name: _grad_leaf(getattr(o, f.name))
                       for f in dataclasses.fields(o)})
            for o in (paths, bs, ue)]
    leaves = [(i, f.name, getattr(o, f.name)) for i, o in enumerate(objs)
              for f in dataclasses.fields(o)
              if getattr(getattr(o, f.name), "requires_grad", False)]
    with torch.enable_grad():
        h = render_channels(*objs, cfg)
        ct = torch.ones_like(h) if cotangent is None else \
            torch.as_tensor(cotangent, device=h.device).to(h.dtype)
        grads = torch.autograd.grad(h, [x for _, _, x in leaves], ct.conj(),
                                    allow_unused=True)
    found = {(i, name): torch.zeros_like(x) if g is None else g
             for (i, name, x), g in zip(leaves, grads)}
    out = tuple(type(o)(**{f.name: found.get((i, f.name))
                           for f in dataclasses.fields(o)})
                for i, o in enumerate(objs))
    return h.detach(), out


def unpack_planes_np(arr, cfg: ChannelConfig) -> np.ndarray:
    """Host-side inverse of :func:`render_channels_planes`' layouts.

    Takes the planes as a numpy array and returns the complex channel
    [U, R, T, K] (complex64 for float32 planes), with a trailing time axis
    for multi-snapshot Doppler.
    """
    arr = np.asarray(arr)
    cdt = np.complex128 if arr.dtype == np.float64 else np.complex64
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    if _packed_layout(cfg):
        n_s = _fused_n_snap(cfg)
        n_k = len(cfg.selected_subcarriers)
        sk = n_s * n_k
        h = np.empty(arr.shape[:-1] + (sk,), dtype=cdt)
        h.real = arr[..., :sk]
        h.imag = arr[..., sk:]
        if n_s > 1:                      # snapshot-major -> time axis last
            u, r, t = h.shape[:3]
            h = np.moveaxis(h.reshape(u, r, t, n_s, n_k), 3, 4)
        return h
    h = np.empty(arr.shape[1:], dtype=cdt)
    h.real = arr[0]
    h.imag = arr[1]
    return h
