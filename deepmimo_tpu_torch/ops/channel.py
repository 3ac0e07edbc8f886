"""Path -> channel renderer (PyTorch).

Synthesizes MIMO channel matrices from per-path ray data,

    H[u, r, t, k] = sum_p  a_rx[u, r, p] * a_tx[u, t, p] * g[u, p, k],

as real/imag planes (:func:`render_channels_planes`) or complex
(:func:`render_channels`, with :func:`render_channels_and_grads`).
Counterpart of ``deepmimo_tpu/ops/channel.py``. ``render_channels_planes``:

- the fused backend (``backend`` "fused"/"pallas", the product default)
  rotates the path directions to unit-vector phase steps and hands seven
  per-path scalars to the hand-written CUDA kernel
  (``ops/kernels/render.py``), which writes H once;
- the "xla" backend, and configs the kernel does not take, go through the
  eager planes path (rotated angles, FoV, pattern gains, array responses,
  OFDM gains, four real batched products).

Both take several Doppler snapshots (the kernel on its slot axis, the
eager path one snapshot at a time), FoV masks and antenna patterns (the
fused path's angle-space prologue), ``out_dtype`` "bfloat16" (the kernel
stores bf16; the eager path casts at the end) and the ``matmul_dtype``
modes of :data:`kernels.render.MM_PASSES`.

``render_channels`` always goes through angle space and, without the
receive filter, the array-response planes; its path sum is the eager
planes product, or with ``backend`` "pallas" the hand-written CUDA
path-sum kernel (``ops/kernels/pathsum.py``).
Both renderers are differentiable; on CUDA the fused render's gradient is
its backward kernel.

``render_beam_gains`` folds a codebook into the path sum of the
hand-written beam-gain kernel (``ops/kernels/beamgain.py``), so codebook
beam gains |conj(W) H|^2 come without H. Dual-polar scenarios render their
four polarizations in one launch, riding the kernels' slot axis
(``render_channels_planes_polar``, ``render_beam_gains_polar``).

The configurations the JAX package sends to plain XLA ops stay eager
PyTorch here, by the same gates (:func:`_kernel_config`), never because a
kernel failed: the time domain (H[u, r, t, p] per path, valid paths
packed to the front when an FoV punches holes, :func:`_compact_paths`),
the sinc receive filter (per-tap gains projected onto the subcarriers by
an FFT for the full band or a DFT matrix otherwise; the one render
through complex stages) and complex128 channels (the planes path in
float64, planes out in float64). Complex128 beam gains take the beam-gain
kernel's float64 instantiation, as the JAX package's gate does not look
at the dtype there.
"""

from __future__ import annotations

import math
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import consts as c
from .geometry import (apply_fov, array_response, array_response_phase,
                       array_response_planes, is_full_fov, rotate_angles,
                       rotate_unit_vec)
from .kernels import beamgain as _beamgain
from .kernels import render as _render
from .kernels.pathsum import fused_path_sum
from .patterns import pattern_gain
from .types import AntennaPanel, ChannelConfig, PathData


def planes_dtype(cfg: ChannelConfig) -> torch.dtype:
    """dtype of :func:`render_channels_planes`' output: ``cfg.out_dtype``,
    float64 for a complex128 render in "float32" (as the JAX package, which
    casts only to another ``out_dtype``). ValueError for an unknown
    ``out_dtype`` or ``matmul_dtype``."""
    _render.mm_passes(cfg.matmul_dtype)
    dtype = _render.out_torch_dtype(cfg.out_dtype)
    if cfg.dtype == "complex128" and dtype == torch.float32:
        return torch.float64
    return dtype


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


def _ofdm_path_gains(cfg: ChannelConfig, powers_lin, delays, phase_deg,
                     valid, t_snap, paths: PathData):
    """Per-path complex gains g [U, P, K] in ``cfg.cdtype`` with the sinc
    receive filter: the OFDM path constant sqrt(P/N) e^{j psi} (over-FFT
    paths zeroed) spread over the N delay taps d by sinc(d - d_n), Doppler
    per tap at the tap delay d * Ts, and the taps projected onto the
    selected subcarriers by an FFT (full band) or a DFT matrix."""
    n_fft = cfg.subcarriers
    ts = 1.0 / cfg.bandwidth
    rd, cd = cfg.rdtype, cfg.cdtype
    dev = delays.device
    k_sel = torch.as_tensor(np.asarray(cfg.selected_subcarriers,
                                       dtype=np.float64), dtype=rd,
                            device=dev)
    delay_n = delays / ts
    pvalid = valid & (delay_n < n_fft)
    amp = torch.where(pvalid, torch.sqrt(powers_lin / n_fft),
                      torch.zeros_like(powers_lin))
    psi = torch.deg2rad(phase_deg)
    d = torch.arange(n_fft, dtype=rd, device=dev)
    taps = torch.sinc(d - delay_n[..., None])                # [U, P, D]
    path_const = (amp * torch.exp(1j * psi.to(rd)))[..., None] * taps
    del taps                  # [U, P, N] real: free it before the next one
    if cfg.enable_doppler and paths.doppler_vel is not None:
        path_const = path_const * torch.exp(1j * _doppler_phase(
            cfg, paths.doppler_vel[..., None], paths.doppler_acc[..., None],
            d * ts + t_snap).to(rd))
    path_const = path_const.to(cd)
    if tuple(cfg.selected_subcarriers) == tuple(range(n_fft)):
        return torch.fft.fft(path_const, dim=-1)
    dft = torch.exp(-1j * ((2 * math.pi / n_fft) *
                           (d[:, None] * k_sel[None, :])).to(rd)).to(cd)
    return torch.einsum("upd,dk->upk", path_const, dft)


def _path_sum(a_rx, a_tx, g):
    """H [U, R, T, K] = sum_p a_rx a_tx g, complex: E = a_rx (x) a_tx
    [U, R*T, P] then one batched product with g [U, P, K]."""
    u, r, p = a_rx.shape
    t = a_tx.shape[1]
    e = (a_rx[:, :, None, :] * a_tx[:, None, :, :]).reshape(u, r * t, p)
    return torch.einsum("uqp,upk->uqk", e, g).reshape(u, r, t, g.shape[-1])


def _td_gain_planes(cfg: ChannelConfig, powers_lin, phase_deg, valid,
                    t_snap, paths: PathData):
    """Time-domain per-path gains as (gr, gi) planes [U, P]."""
    amp = torch.where(valid, torch.sqrt(powers_lin),
                      torch.zeros_like(powers_lin))
    psi = torch.deg2rad(phase_deg)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        psi = psi + _doppler_phase(cfg, paths.doppler_vel, paths.doppler_acc,
                                   paths.delay_s + t_snap)
    return amp * torch.cos(psi), amp * torch.sin(psi)


def _td_channel_planes_ri(arx, atx, gr, gi):
    """Time-domain H [U, R, T, P] planes (hr, hi) = (a_rx a_tx) g, all
    elementwise (no path sum)."""
    (arx_r, arx_i), (atx_r, atx_i) = arx, atx
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :])
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :])
    g_r = gr[:, None, None, :]
    g_i = gi[:, None, None, :]
    return er * g_r - ei * g_i, er * g_i + ei * g_r


def _td_compact_active(cfg: ChannelConfig) -> bool:
    """Does the time-domain render pack the valid paths to the front?
    ``compact_td_paths`` True always, False never, "auto" when an FoV
    filter is active (loaded path data is tail-padded, so only the FoV
    punches interior holes)."""
    if not cfg.compact_td_paths:
        return False
    if cfg.compact_td_paths == "auto":
        return ((cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov)) or
                (cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov)))
    return True


def _compact_paths(paths: PathData, valid, powers_lin, *angles):
    """Valid path slots packed to the front in their order, then the
    invalid ones (the reference's time-domain ordering): a stable sort of
    each user's slots by invalidity and one gather per per-path array
    (Doppler too), so each output slot is one input value, exactly.

    Returns (paths, valid, powers_lin, *angles) in the new slot order.
    """
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)

    def take(x):
        return torch.take_along_dim(x, order, dim=1)

    new_valid = take(valid)
    new_paths = dataclasses.replace(paths._map(take), valid=new_valid)
    return (new_paths, new_valid, take(powers_lin),
            *(take(a) for a in angles))


def _angle_stage(cfg: ChannelConfig, paths: PathData, bs: AntennaPanel,
                 ue: AntennaPanel):
    """(paths, valid, powers_lin, aod_theta, aod_phi, aoa_theta, aoa_phi)
    of the eager paths: rotated angles, the FoV mask, the pattern-weighted
    linear powers and, in the time domain when :func:`_td_compact_active`,
    every per-path array with its valid slots packed to the front."""
    angles = _rotated_angles(paths, bs, ue)
    valid = _fov_valid(cfg, paths.valid, *angles)
    powers_lin = _powers_linear(cfg, paths, valid, *angles)
    if not cfg.freq_domain and _td_compact_active(cfg):
        return _compact_paths(paths, valid, powers_lin, *angles)
    return (paths, valid, powers_lin, *angles)


def td_path_delays(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                   cfg: ChannelConfig) -> torch.Tensor:
    """[U, P] delay (s) of the path in each column of the time-domain
    channel rendered for ``cfg`` (P = min(num_paths, the paths' slots)):
    the columns as :func:`_angle_stage` orders them for the render (with
    an FoV, each user's kept paths packed to the front in their order),
    0 in the empty columns."""
    paths = paths.trim_paths(cfg.num_paths)
    paths, valid, *_ = _angle_stage(cfg.replace(freq_domain=False), paths,
                                    bs, ue)
    return torch.where(valid, paths.delay_s, torch.zeros_like(paths.delay_s))


def _path_sum_planes_ri(arx, atx, gr, gi, mm_dtype: str = "float32"):
    """H = sum_p (a_rx a_tx) g via four real batched products -> (hr, hi),
    each [U, R, T, K]; accumulation in float32. For ``mm_dtype``
    "bfloat16"/"default" E and g are rounded to bf16 first, as the JAX
    package casts them and asks for float32 results
    (``preferred_element_type``)."""
    rnd = _render.operand_rounding(mm_dtype)
    (arx_r, arx_i), (atx_r, atx_i) = arx, atx
    u, r, p = arx_r.shape
    t = atx_r.shape[1]
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :]).reshape(u, r * t, p)
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :]).reshape(u, r * t, p)
    er, ei, gr, gi = rnd(er), rnd(ei), rnd(gr), rnd(gi)

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


def _packed_layout(cfg: ChannelConfig, n_pol: int = 1) -> bool:
    """Emit the packed [..., 2*n_pol*S*K] plane layout? Needs the opt-in,
    the frequency domain and n_pol*S*K % 64 == 0 (kept from the JAX
    package so both packages produce the same layout for the same
    config)."""
    sk = len(cfg.selected_subcarriers) * _fused_n_snap(cfg) * n_pol
    return (cfg.planes_layout == "packed" and cfg.freq_domain
            and sk % 64 == 0)


def _angles_needed(cfg: ChannelConfig) -> bool:
    """Does any stage need rotated ANGLES (FoV masks, non-isotropic
    patterns), rather than the rotated unit vectors?"""
    fov_on = ((cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov)) or
              (cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov)))
    return (fov_on or cfg.bs_pattern != "isotropic"
            or cfg.ue_pattern != "isotropic")


def _kernel_config(cfg: ChannelConfig) -> bool:
    """The JAX package's gate of its fused kernels: frequency domain, no
    LPF, complex64, arithmetic subcarriers."""
    return bool(cfg.freq_domain and not cfg.rx_filter
                and cfg.dtype == "complex64" and _k_progression(cfg))


def _fused_render_eligible(cfg: ChannelConfig, n_pol: int = 1) -> bool:
    """Can this config render through the CUDA kernel, with ``n_pol``
    polarizations on its slot axis? Same answer on every device:
    :func:`_kernel_config` plus the kernel's shared-memory bound."""
    return _kernel_config(cfg) and _render.kernel_fits(
        cfg.ue_shape, cfg.bs_shape, cfg.num_paths,
        len(cfg.selected_subcarriers), n_pol * _fused_n_snap(cfg))


def _fused_path_scalars(cfg: ChannelConfig, paths: PathData, valid,
                        powers_lin, phase_deg=None):
    """(amp, psi, omega [U, P]) for the fused kernel.

    ``powers_lin`` [U, P] gives amp [U, P] and psi [U, S*P]. Stacked as
    [N, U, P] for N polarizations, with ``phase_deg`` [N, U, P], it gives
    amp and psi [U, N*S*P], pol-major on the kernel's slot axis
    (slot = pol*S + s). ``phase_deg`` (finite) replaces the paths' own
    phase. Per-path math on flat [N, U*P] views; k0 folds into psi and the
    subcarrier stride into omega.
    """
    u, p = paths.delay_s.shape
    n_pol = powers_lin.shape[0] if powers_lin.dim() == 3 else 1
    valid_f = valid.reshape(-1)
    n_fft = cfg.subcarriers
    delay_f = paths.delay_s.reshape(-1)
    delay_n = delay_f * cfg.bandwidth
    pvalid = valid_f & (delay_n < n_fft)
    pw = powers_lin.reshape(n_pol, u * p)
    amp = torch.where(pvalid, torch.sqrt(pw / n_fft), torch.zeros_like(pw))

    k0, stride = _k_progression(cfg)
    omega_base = (2 * math.pi / n_fft) * delay_n
    if phase_deg is None:
        phase_deg = paths.phase_deg
    psi0 = torch.deg2rad(phase_deg.reshape(n_pol, u * p)) - omega_base * k0
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    n_s = len(snapshots)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        vel = paths.doppler_vel.reshape(-1)
        acc = paths.doppler_acc.reshape(-1)
        psi = torch.stack([psi0 + _doppler_phase(cfg, vel, acc, delay_f + t)
                           for t in snapshots], dim=1)
    else:
        psi = psi0[:, None].expand(n_pol, n_s, u * p)

    def slots(x):                       # [N, S, U*P] -> [U, N*S*P]
        return x.reshape(n_pol * n_s, u, p).transpose(0, 1).reshape(u, -1)

    if powers_lin.dim() == 3:
        amp = slots(amp[:, None].expand(n_pol, n_s, u * p))
    omega = (omega_base * stride).reshape(u, p)
    return (amp.reshape(u, -1).contiguous(), slots(psi).contiguous(),
            omega.contiguous())


def _wavevec_steps(cfg: ChannelConfig, paths: PathData, bs: AntennaPanel,
                   ue: AntennaPanel):
    """(valid, gain, gry, grz, gty, gtz) for the fused kernels.

    ``valid`` is the path mask with the FoV applied, ``gain`` the TX x RX
    pattern gain [U, P] (None when no stage needs angle space), and
    gry..gtz the RX/TX wave-vector phase steps kd*y', kd*z' in the rotated
    frames. Angle space (rotated theta/phi, FoV, patterns) is entered only
    when a stage needs it; otherwise ``rotate_unit_vec`` gives the rotated
    components directly, on flat [U*P] views when both rotations are [3].
    """
    kd_ue = 2 * math.pi * ue.spacing
    kd_bs = 2 * math.pi * bs.spacing
    if _angles_needed(cfg):
        aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs,
                                                                 ue)
        valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi, aoa_theta,
                           aoa_phi)
        gain = (pattern_gain(cfg.bs_pattern, aod_theta, aod_phi) *
                pattern_gain(cfg.ue_pattern, aoa_theta, aoa_phi))
        _, gry, grz = array_response_phase(aoa_theta, aoa_phi, kd_ue)
        _, gty, gtz = array_response_phase(aod_theta, aod_phi, kd_bs)
        return valid, gain, gry, grz, gty, gtz
    flat = ue.rotation_deg.dim() == 1 and bs.rotation_deg.dim() == 1
    v = (lambda x: x.reshape(-1)) if flat else (lambda x: x)
    _, ry, rz = rotate_unit_vec(ue.rotation_deg, v(paths.aoa_el_deg),
                                v(paths.aoa_az_deg))
    _, ty, tz = rotate_unit_vec(bs.rotation_deg, v(paths.aod_el_deg),
                                v(paths.aod_az_deg))
    return (paths.valid, None, kd_ue * ry, kd_ue * rz, kd_bs * ty,
            kd_bs * tz)


def _wavevec_inputs(cfg: ChannelConfig, paths: PathData, bs: AntennaPanel,
                    ue: AntennaPanel):
    """(valid, powers_lin, gry, grz, gty, gtz) for the fused kernels: the
    steps of :func:`_wavevec_steps` with the linear path power (pattern
    gains applied, zero on invalid paths)."""
    valid, gain, *steps = _wavevec_steps(cfg, paths, bs, ue)
    p_lin = torch.pow(10.0, paths.power_dbw / 10.0)
    if gain is not None:
        p_lin = p_lin * gain
    return (valid, torch.where(valid, p_lin, torch.zeros_like(p_lin)),
            *steps)


def _render_fused_planes(cfg: ChannelConfig, paths: PathData, valid,
                         powers_lin, gry, grz, gty, gtz,
                         out: Optional[torch.Tensor] = None):
    """Fully fused OFDM render: per-path scalars -> H planes, one kernel
    launch with every Doppler snapshot on its slot axis. ``gry..gtz`` are
    the RX/TX wave-vector phase steps kd*y', kd*z' in the rotated frame;
    invalid paths are zeroed here. Returns the kernel's layout viewed as
    [U, R, T, 2*S*K] (packed) or [2, U, R, T, S, K] (stacked) in
    ``cfg.out_dtype``; ``out`` (that shape) is written in place.
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
                             packed, out=kout, mm_dtype=cfg.matmul_dtype,
                             out_dtype=cfg.out_dtype)
    if packed:
        return h.view(u, r, t, 2 * n_s * n_k)
    return h.view(2, u, r, t, n_s, n_k)


def render_out_shape(n_ue: int, cfg: ChannelConfig,
                     max_paths: Optional[int] = None):
    """Shape of :func:`render_channels_planes`' output for ``n_ue`` users:
    packed [U, R, T, 2*S*K], stacked [2, U, R, T, K] and, with several
    Doppler snapshots, [2, U, R, T, K, S]. The time domain has a path axis
    for the subcarriers, [2, U, R, T, P(, S)] with P = min(num_paths,
    ``max_paths``), the paths' slot count, which it needs."""
    r, t, k = cfg.n_rx_ant, cfg.n_tx_ant, cfg.n_sel_subcarriers
    n_s = _fused_n_snap(cfg)
    snaps = (n_s,) if n_s > 1 else ()
    if not cfg.freq_domain:
        if max_paths is None:
            raise ValueError("render_out_shape needs the paths' max_paths "
                             "in the time domain")
        return (2, n_ue, r, t, min(cfg.num_paths, max_paths)) + snaps
    if _packed_layout(cfg):
        return (n_ue, r, t, 2 * n_s * k)
    return (2, n_ue, r, t, k) + snaps


def _planes_out(cfg: ChannelConfig, outs, dtype, out):
    """Planes of the per-snapshot (hr, hi) pairs ``outs`` in the layout of
    :func:`render_out_shape`, in ``dtype`` or written into ``out``."""
    if _packed_layout(cfg):              # hr of all (s, k), then hi
        h = torch.cat([o[0] for o in outs] + [o[1] for o in outs], dim=-1)
    elif len(outs) > 1:
        h = torch.stack([torch.stack(o) for o in outs], dim=-1)
    else:
        h = torch.stack(outs[0])
    return h.to(dtype) if out is None else out.copy_(h)


# ============================================================================
# Public renderer
# ============================================================================

def render_channels_planes(paths: PathData, bs: AntennaPanel,
                           ue: AntennaPanel, cfg: ChannelConfig,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Render channels as real/imag planes in :func:`planes_dtype`
    (``cfg.out_dtype``: float32, or bfloat16, half the bytes at ~2^-9
    relative; float64 for complex128).

    Layout (:func:`_packed_layout`, :func:`render_out_shape`), with S the
    Doppler snapshots:
    - stacked: [2, U, R, T, K], or [2, U, R, T, K, S] when S > 1 (time
      axis last); in the time domain P path slots replace the K
      subcarriers;
    - packed (cfg.planes_layout == "packed", frequency domain,
      S*K % 64 == 0): [U, R, T, 2*S*K], hr of every (s, k) snapshot-major
      in the first minor half and hi in the second.

    The receive filter renders through :func:`render_channels` and is
    split into planes; complex64 takes the fused kernel when
    :func:`_fused_render_eligible`, else the eager planes path (the time
    domain and complex128, in float64, among them).

    ``out``, when given, must have exactly that shape and dtype (on the
    paths' device); the result is written into it, overwriting what it
    held, and returned. Tensors are on the device of ``paths``.
    """
    shape = render_out_shape(paths.n_ue, cfg, paths.max_paths)
    dtype = planes_dtype(cfg)
    if out is not None:
        _render._check_layout("out", out, shape, paths.valid.device, dtype)
    if _filtered(cfg):
        h = render_channels(paths, bs, ue, cfg)
        snaps = h.unbind(-1) if _fused_n_snap(cfg) > 1 else (h,)
        return _planes_out(cfg, [(x.real, x.imag) for x in snaps], dtype,
                           out)
    paths = paths.trim_paths(cfg.num_paths)
    packed = _packed_layout(cfg)
    if cfg.backend in ("pallas", "fused") and _fused_render_eligible(cfg):
        # Angle space (FoV, patterns) is entered only when a stage needs
        # it (_wavevec_steps).
        several = _fused_n_snap(cfg) > 1 and not packed
        h = _render_fused_planes(cfg, paths,
                                 *_wavevec_inputs(cfg, paths, bs, ue),
                                 out=None if several else out)
        if packed:
            return h
        if not several:
            return h.view(shape)
        h = h.movedim(4, 5)              # [2, U, R, T, K, S]: time last
        return h.contiguous() if out is None else out.copy_(h)

    (paths, valid, powers_lin, aod_theta, aod_phi, aoa_theta,
     aoa_phi) = _angle_stage(cfg, paths, bs, ue)
    arx = array_response_planes(cfg.ue_shape, ue.spacing, aoa_theta,
                                aoa_phi, valid)
    atx = array_response_planes(cfg.bs_shape, bs.spacing, aod_theta,
                                aod_phi, valid)
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    if cfg.freq_domain:
        outs = [_path_sum_planes_ri(
            arx, atx, *_ofdm_gain_planes(cfg, powers_lin, paths.delay_s,
                                         paths.phase_deg, valid, t_snap,
                                         paths),
            _mm_dtype(cfg)) for t_snap in snapshots]
    else:
        outs = [_td_channel_planes_ri(arx, atx, *_td_gain_planes(
            cfg, powers_lin, paths.phase_deg, valid, t_snap, paths))
            for t_snap in snapshots]
    return _planes_out(cfg, outs, dtype, out)


def _filtered(cfg: ChannelConfig) -> bool:
    """Does the sinc receive filter apply? It acts on the OFDM gains only,
    so the time domain renders the same with and without it."""
    return bool(cfg.rx_filter and cfg.freq_domain)


def _mm_dtype(cfg: ChannelConfig) -> str:
    """The ``matmul_dtype`` of the eager path sum and the beam gains: the
    config's in complex64; complex128 runs in float64 at full grade, as
    the JAX package's complex products."""
    return cfg.matmul_dtype if cfg.dtype == "complex64" else "float32"


def render_channels(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                    cfg: ChannelConfig) -> torch.Tensor:
    """Render MIMO channels in ``cfg.cdtype``: [U, R, T, K] in the
    frequency domain, [U, R, T, P] (P = min(num_paths, the paths' slots))
    in the time domain.

    With Doppler over several snapshots a trailing time axis is added:
    [..., len(cfg.doppler_times)]. Without the receive filter the render
    goes through the array-response planes, in the real dtype of the
    paths (float64 for complex128): in the frequency domain with
    ``backend`` "pallas" and complex64 the path-sum kernel, else the eager
    planes product. Both stay f32 grade whatever ``matmul_dtype`` (which
    must be one of :data:`kernels.render.MM_PASSES`): the JAX path-sum
    kernel takes no ``mm_dtype``. The filter goes through the complex
    stages (:func:`_ofdm_path_gains`, :func:`_path_sum`), as in the JAX
    package.
    """
    _render.mm_passes(cfg.matmul_dtype)
    paths = paths.trim_paths(cfg.num_paths)
    (paths, valid, powers_lin, aod_theta, aod_phi, aoa_theta,
     aoa_phi) = _angle_stage(cfg, paths, bs, ue)
    if _filtered(cfg):
        a_rx = array_response(cfg.ue_shape, ue.spacing, aoa_theta, aoa_phi,
                              valid, cfg.cdtype)
        a_tx = array_response(cfg.bs_shape, bs.spacing, aod_theta, aod_phi,
                              valid, cfg.cdtype)
    else:
        arx = array_response_planes(cfg.ue_shape, ue.spacing, aoa_theta,
                                    aoa_phi, valid)
        atx = array_response_planes(cfg.bs_shape, bs.spacing, aod_theta,
                                    aod_phi, valid)
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    outs = []
    for t_snap in snapshots:
        if _filtered(cfg):
            h = _path_sum(a_rx, a_tx, _ofdm_path_gains(
                cfg, powers_lin, paths.delay_s, paths.phase_deg, valid,
                t_snap, paths))
        elif (cfg.freq_domain and cfg.backend == "pallas"
              and cfg.dtype == "complex64"):
            h = _path_sum_pallas(cfg, arx, atx, powers_lin, paths, valid,
                                 t_snap)
        elif cfg.freq_domain:
            gr, gi = _ofdm_gain_planes(cfg, powers_lin, paths.delay_s,
                                       paths.phase_deg, valid, t_snap,
                                       paths)
            h = torch.complex(*_path_sum_planes_ri(arx, atx, gr, gi))
        else:
            h = torch.complex(*_td_channel_planes_ri(arx, atx,
                                                     *_td_gain_planes(
                cfg, powers_lin, paths.phase_deg, valid, t_snap, paths)))
        outs.append(h.to(cfg.cdtype))
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


def planes_to_numpy(x) -> np.ndarray:
    """Planes as a host numpy array. A tensor is copied to the host as it
    lies; bfloat16 planes (half the bytes over the bus) are widened to
    float32 there, since numpy has no bfloat16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def unpack_planes_np(arr, cfg: ChannelConfig) -> np.ndarray:
    """Host-side inverse of :func:`render_channels_planes`' layouts.

    Takes the planes (a numpy array or a tensor, :func:`planes_to_numpy`)
    and returns the complex channel [U, R, T, K], or [U, R, T, P] in the
    time domain (complex64 for float32 or bfloat16 planes, complex128 for
    float64), with a trailing time axis for multi-snapshot Doppler.
    """
    arr = planes_to_numpy(arr)
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


# ============================================================================
# Beam-gain maps and dual-polar renders
# ============================================================================

def _check_beam_gain_cfg(cfg: ChannelConfig, what: str) -> None:
    """The configurations the beam-gain renderers do not take."""
    if not cfg.freq_domain or not _k_progression(cfg):
        raise ValueError(
            f"{what} requires the frequency domain and an arithmetic "
            f"subcarrier selection; render channels and fold the codebook "
            f"downstream for other configs.")
    if cfg.rx_filter:
        raise ValueError(
            f"{what} does not take the receive filter (rx_filter): the "
            f"beam-gain fold renders the unfiltered channel; render "
            f"channels with the filter and fold the codebook downstream.")
    _render.mm_passes(cfg.matmul_dtype)


def beam_gain_eligible(cfg: ChannelConfig, n_beams: int) -> bool:
    """Can beam gains render through the CUDA kernel? Same answer on every
    device: the JAX package's gate of its beam-gain kernel (frequency
    domain, arithmetic subcarriers, whatever the dtype; the filter is
    refused before) plus the kernel's shared-memory bound in the config's
    real dtype (which does not grow with the slots, so it holds for
    dual-polar too).
    """
    return bool(cfg.freq_domain and not cfg.rx_filter
                and _k_progression(cfg)) and _beamgain.beam_gain_fits(
        cfg.ue_shape, cfg.bs_shape, n_beams, cfg.num_paths,
        len(cfg.selected_subcarriers), cfg.dtype == "complex128")


def _on_card(dev: torch.device) -> bool:
    return dev.type != "cpu"


def _beam_gain_route(cfg: ChannelConfig, n_beams: int,
                     dev: torch.device) -> bool:
    """Kernel (True) or plain version (False) for the beam-gain maps.

    ``backend`` "xla" takes the plain version. The fused backends take the
    kernel wrapper (its float64 instantiation for complex128), whose CPU
    route is the plain version; past the kernel's shared memory they take
    the plain version on the CPU (as the JAX package does) and raise on
    the card, where the plain version would form the whole channel in
    device memory.
    """
    if cfg.backend not in ("pallas", "fused"):
        return False
    if beam_gain_eligible(cfg, n_beams):
        return True
    if not _on_card(dev):
        return False
    n_k = len(cfg.selected_subcarriers)
    need = _beamgain.smem_bytes(cfg.ue_shape, cfg.bs_shape, n_beams,
                                cfg.num_paths, n_k,
                                cfg.dtype == "complex128")
    raise ValueError(
        f"Beam gains at R={cfg.n_rx_ant}, T={cfg.n_tx_ant}, B={n_beams}, "
        f"K={n_k}, P={cfg.num_paths} in {cfg.dtype} need {need} bytes of "
        f"the beam-gain kernel's shared memory, over its "
        f"{_render.SMEM_LIMIT}-byte bound; use fewer beams or TX elements, "
        f"or backend='xla' for the plain version.")


def _beam_gains(cfg: ChannelConfig, args, wr, wi,
                out: Optional[torch.Tensor]):
    """G [U, R*B, S*K] in ``cfg.rdtype`` from the 7 masked per-path
    inputs, through the route of :func:`_beam_gain_route`; ``out`` (that
    shape) is written in place. complex128 folds in float64 at full grade
    whatever ``matmul_dtype`` (:func:`_mm_dtype`)."""
    dev = args[-1].device
    rd = cfg.rdtype
    args = [x.to(rd) for x in args]
    wr = torch.as_tensor(wr, dtype=rd, device=dev).contiguous()
    wi = torch.as_tensor(wi, dtype=rd, device=dev).contiguous()
    n_k = len(cfg.selected_subcarriers)
    u, p = args[-1].shape
    shape = (u, cfg.n_rx_ant * wr.shape[0], args[5].shape[1] // p * n_k)
    if out is not None:
        _render._check_layout("out", out, shape, dev, rd)
    mm = _mm_dtype(cfg)
    if _beam_gain_route(cfg, wr.shape[0], dev):
        return _beamgain.fused_beam_gain(*args, wr, wi, cfg.ue_shape,
                                         cfg.bs_shape, n_k, out=out,
                                         mm_dtype=mm)
    g = _beamgain.beam_gain_reference(*args, wr, wi, cfg.ue_shape,
                                      cfg.bs_shape, n_k, mm)
    return g if out is None else out.copy_(g)


def render_beam_gains(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                      cfg: ChannelConfig, wr, wi,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Codebook beam-gain maps G [U, R*B, S*K] (float32, float64 for
    complex128; snapshot-major columns) without materializing H.

    G[u, r*B + b, k] = |sum_t conj(w[b, t]) H[u, r, t, k]|^2, with the
    codebook folded into the path sum (``ops/kernels/beamgain.py``): H is
    never formed, and the output is T/B x 2 smaller than the planes.

    Args:
        wr/wi: codebook real/imag planes [B, T] (conj applied inside,
            matching ``abs(h @ codebook.conj().T)**2``).
        out: a contiguous [U, R*B, S*K] tensor of G's dtype on the paths'
            device, overwritten with the result.

    The "xla" backend runs the plain version; so do shapes beyond the
    kernel's shared memory on the CPU, while on the card they raise
    (ValueError). complex128 takes the kernel's float64 instantiation.
    Frequency domain and arithmetic subcarrier selections only; the
    receive filter is refused (ValueError).
    """
    _check_beam_gain_cfg(cfg, "render_beam_gains")
    paths = paths.trim_paths(cfg.num_paths)
    valid, powers_lin, *steps = _wavevec_inputs(cfg, paths, bs, ue)
    u, p = paths.delay_s.shape
    valid_f = valid.reshape(-1)

    def z(x):
        x = x.reshape(-1)
        return torch.where(valid_f, x, torch.zeros_like(x)).reshape(u, p)

    args = (*(z(x) for x in steps),
            *_fused_path_scalars(cfg, paths, valid, powers_lin))
    return _beam_gains(cfg, args, wr, wi, out)


def polar_fused_eligible(cfg: ChannelConfig, n_pol: int = 4) -> bool:
    """Can the polarizations render in ONE kernel launch? The gates of
    :func:`_fused_render_eligible`, with the kernel's slot axis carrying
    n_pol * n_snapshots slots."""
    return _fused_render_eligible(cfg, n_pol)


def polar_out_shape(n_ue: int, cfg: ChannelConfig, n_pol: int = 4):
    """Shape of :func:`render_channels_planes_polar`' output."""
    r, t, k = cfg.n_rx_ant, cfg.n_tx_ant, cfg.n_sel_subcarriers
    n_s = _fused_n_snap(cfg)
    if _packed_layout(cfg, n_pol):
        return (n_ue, r, t, 2 * n_pol * n_s * k)
    return (2, n_ue, r, t, n_pol, n_s, k)


def _polar_fused_inputs(cfg: ChannelConfig, paths: PathData,
                        bs: AntennaPanel, ue: AntennaPanel, pol_power_dbw,
                        pol_phase_deg):
    """Shared dual-polar prologue of the fused render and beam-gain paths.

    Returns (gry, grz, gty, gtz [U, P] zero-masked, amp [U, st*P],
    psi [U, st*P], omega [U, P]) with st = n_pol * n_snapshots: the
    per-polarization amplitudes and phases stacked pol-major on the kernel
    slot axis (slot = pol*S + s). Angles and delays are shared across
    polarizations. The polarization matrices [N_pol, U, P] arrive
    NaN-padded from the loader, so both amp and psi are masked: a NaN psi
    would poison the kernel's trig even at amp = 0.
    """
    paths = paths.trim_paths(cfg.num_paths)
    pol_power_dbw = pol_power_dbw[..., :cfg.num_paths]
    pol_phase_deg = pol_phase_deg[..., :cfg.num_paths]
    valid, gain, *steps = _wavevec_steps(cfg, paths, bs, ue)
    zero = torch.zeros((), dtype=paths.delay_s.dtype,
                       device=paths.delay_s.device)

    def z(x):
        return torch.where(valid, x, zero)

    p_lin = torch.pow(10.0, pol_power_dbw / 10.0)
    if gain is not None:
        p_lin = p_lin * gain
    u, p = paths.delay_s.shape          # the steps may be flat [U*P] views
    return (*(z(x.reshape(u, p)) for x in steps),
            *_fused_path_scalars(cfg, paths, valid, z(p_lin),
                                 z(pol_phase_deg)))


def render_channels_planes_polar(paths: PathData, bs: AntennaPanel,
                                 ue: AntennaPanel, cfg: ChannelConfig,
                                 pol_power_dbw: torch.Tensor,
                                 pol_phase_deg: torch.Tensor,
                                 out: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """All polarizations in ONE launch of the fused render kernel.

    The polarization axis rides the kernel's slot axis with per-slot
    amplitudes and phases, so rotations, FoV, pattern gains, panel
    responses and the subcarrier tables are computed once (angles and
    delays are shared across polarizations).

    Args:
        paths: shared geometry (angles, delays, Doppler); its own power and
            phase are not used.
        pol_power_dbw / pol_phase_deg: [N_pol, U, P] per-polarization power
            (dBW) and phase (deg), NaN-padded as loaded.
        out: a tensor of the output's shape and ``cfg.out_dtype``
            (contiguous, on the paths' device), overwritten with the
            result.

    Returns (pol-major, slot = pol*S + s):
        packed layout: [U, R, T, 2*N_pol*S*K], hr of every (pol, s, k) in
        the first minor half and hi in the second;
        stacked: [2, U, R, T, N_pol, S, K].
    Unpack host-side with :func:`unpack_polar_planes_np`.
    """
    n_pol = pol_power_dbw.shape[0]
    _render.mm_passes(cfg.matmul_dtype)
    dtype = _render.out_torch_dtype(cfg.out_dtype)
    if not polar_fused_eligible(cfg, n_pol):
        raise ValueError(
            "render_channels_planes_polar needs a fused-eligible config "
            "(OFDM, no rx_filter, complex64, arithmetic subcarrier "
            "selection, within the kernel's shared memory); render each "
            "polarization with render_channels_planes instead.")
    shape = polar_out_shape(paths.n_ue, cfg, n_pol)
    if out is not None:
        _render._check_layout("out", out, shape, paths.valid.device, dtype)
    args = _polar_fused_inputs(cfg, paths, bs, ue, pol_power_dbw,
                               pol_phase_deg)
    n_k = len(cfg.selected_subcarriers)
    u, q = paths.n_ue, cfg.n_rx_ant * cfg.n_tx_ant
    sk = n_pol * _fused_n_snap(cfg) * n_k
    packed = _packed_layout(cfg, n_pol)
    kout = None
    if out is not None:
        kout = out.view(u, q, 2 * sk) if packed else out.view(2, u, q, sk)
    h = _render.fused_render(*args, cfg.ue_shape, cfg.bs_shape, n_k, packed,
                             out=kout, mm_dtype=cfg.matmul_dtype,
                             out_dtype=cfg.out_dtype)
    return h.view(shape)


def unpack_polar_planes_np(arr, cfg: ChannelConfig, n_pol: int = 4):
    """Host-side inverse of :func:`render_channels_planes_polar`.

    Returns [N_pol, U, R, T, K] complex (complex64 for float32 or bfloat16
    planes, as :func:`unpack_planes_np` takes them), with a trailing time
    axis for multi-snapshot Doppler: the per-polarization output of
    :func:`render_channels`.
    """
    arr = planes_to_numpy(arr)
    cdt = np.complex128 if arr.dtype == np.float64 else np.complex64
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    n_s = _fused_n_snap(cfg)
    n_k = len(cfg.selected_subcarriers)
    if _packed_layout(cfg, n_pol):
        sk = n_pol * n_s * n_k
        u, r, t = arr.shape[:3]
        h = np.empty((u, r, t, sk), dtype=cdt)
        h.real = arr[..., :sk]
        h.imag = arr[..., sk:]
        h = np.moveaxis(h.reshape(u, r, t, n_pol, n_s, n_k), 3, 0)
    else:
        h = np.empty(arr.shape[1:], dtype=cdt)       # [U, R, T, NP, S, K]
        h.real = arr[0]
        h.imag = arr[1]
        h = np.moveaxis(h, 3, 0)                     # [NP, U, R, T, S, K]
    if n_s > 1:
        return np.moveaxis(h, 4, 5)                  # time axis last
    return h[:, :, :, :, 0, :]


def render_beam_gains_polar(paths: PathData, bs: AntennaPanel,
                            ue: AntennaPanel, cfg: ChannelConfig,
                            pol_power_dbw: torch.Tensor,
                            pol_phase_deg: torch.Tensor, wr, wi,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Per-polarization beam-gain maps G [U, R*B, N_pol*S*K] in ONE
    launch of the beam-gain kernel: the polarizations ride the slot axis
    (as in :func:`render_channels_planes_polar`) and the codebook folds
    into the path sum, so no polarization's H is formed. Slot axis
    pol-major: G[..., ip*S*K:(ip + 1)*S*K] is polarization ip. ``out``
    and the routes as in :func:`render_beam_gains`."""
    _check_beam_gain_cfg(cfg, "render_beam_gains_polar")
    args = _polar_fused_inputs(cfg, paths, bs, ue, pol_power_dbw,
                               pol_phase_deg)
    return _beam_gains(cfg, args, wr, wi, out)
