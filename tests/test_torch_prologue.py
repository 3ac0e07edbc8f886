"""The fused kernels' prologue kernel (``ops/kernels/prologue.py``,
``csrc/prologue.cu``) and its route (``ops/channel.py``
``_prologue_route``).

On the CPU: the kernel's strides and layouts emulated at every case
(``_launch`` replaced by the PyTorch prologue, ``_fused_inputs`` or
``_polar_fused_inputs`` with the route patched off, on the raw storage
read at the strides and for the config the wrapper passes), bit for bit
against the PyTorch prologue on the call's own tensors; the wrapper's
refusals; the route, with the card patched in (``channel._on_card``): the
kernel for a float32, isotropic, full-FoV, Doppler-free call without
autograd, the PyTorch prologue (counted in ``FALLBACKS``) for FoV, a
dipole, Doppler, float64, the CPU, autograd and the calibration step; a
CPU render unchanged.

On a CUDA card (``gpu``): the kernel's seven outputs against the PyTorch
prologue on the card at every case, and one render, beam-gain and
dual-polar render call each, held to the same call on the CPU, with one
launch counted a call. Tolerances: rtol 2e-6 (a few float32 ulps: the two
use the same float32 ops, but ``sincosf`` and ``powf`` may round an ulp
apart), and an atol of 4 ulps of the terms a value is summed from: kd for
the phase steps, pi + |omega0 k0| for psi. Whole calls at the render
kernel's 3e-5 of max|H| (tests/test_torch_render.py).

No JAX is imported: ``python -m pytest -m gpu --noconftest
tests/test_torch_prologue.py`` runs the card tests where JAX is missing.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes
from deepmimo_tpu_torch.ops.kernels import beamgain as kb
from deepmimo_tpu_torch.ops.kernels import prologue as kp
from deepmimo_tpu_torch.ops.kernels import render as kr
from deepmimo_tpu_torch.parallel import sharded as tsh

from oracle import make_synthetic_paths

torch.set_num_threads(1)
RTOL = 2e-6
ULPS = 4 * float(np.finfo(np.float32).eps)
CALL_RTOL = 3e-5
BS_ROT, UE_ROT = (5.0, -10.0, 20.0), (0.0, 10.0, -5.0)

# name: users, path slots, num_paths, BS panel, UE panel, n_fft, selected
# subcarriers, polarization slots (0: single-polarized), per-user rotations
CASES = {
    "headline": (131_072, 25, 25, (8, 8), (1, 1), 512, range(64), 0, False),
    "quickstart": (4099, 25, 25, (8, 1), (1, 1), 512, (0,), 0, False),
    "one_user": (1, 25, 25, (8, 8), (1, 1), 512, range(64), 0, False),
    "odd_users": (1031, 25, 25, (8, 8), (2, 1), 512, range(64), 0, False),
    "paths_37": (517, 37, 37, (4, 4), (1, 1), 512, range(16), 0, False),
    "trimmed_view": (613, 30, 25, (8, 8), (1, 1), 512, range(64), 0, False),
    # delays of up to 400 samples against a 64-point FFT
    "late_delays": (709, 25, 25, (8, 8), (1, 1), 64, range(64), 0, False),
    "polar_2": (811, 25, 25, (8, 8), (1, 1), 512, range(64), 2, False),
    "polar_4": (911, 30, 25, (8, 8), (1, 1), 512, range(64), 4, False),
    "polar_5": (503, 25, 25, (8, 8), (1, 1), 512, range(16), 5, False),
    "per_user_rotations": (419, 25, 25, (8, 8), (1, 1), 512, range(64), 0,
                           True),
    "k0_stride": (307, 25, 25, (8, 8), (1, 1), 512, range(5, 65, 3), 0,
                  False),
}
CPU_USERS = 53


def _state(name, dev, n_ue=None, seed=7):
    """(paths, bs, ue, cfg, stacks) of a case on ``dev``: NaN-padded
    synthetic paths with invalid slots, the stacks [N, U, max_paths]
    NaN-padded as a dual-polar dataset loads them (None when N = 0)."""
    u, max_p, n_p, bs_shape, ue_shape, n_fft, ks, n_pol, per_user = \
        CASES[name]
    u = u if n_ue is None else min(u, n_ue)
    d = make_synthetic_paths(n_ue=u, max_paths=max_p, seed=seed)
    paths = ttypes.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], device=dev)
    rng = np.random.RandomState(seed + 1)
    bs_rot, ue_rot = BS_ROT, UE_ROT
    if per_user:
        bs_rot, ue_rot = (rng.uniform(-40, 40, (u, 3)) for _ in range(2))
    bs = ttypes.AntennaPanel.make(bs_rot, device=dev)
    ue = ttypes.AntennaPanel.make(ue_rot, spacing=0.4, device=dev)
    cfg = ttypes.ChannelConfig(
        bs_shape=bs_shape, ue_shape=ue_shape, subcarriers=n_fft,
        selected_subcarriers=tuple(ks), num_paths=n_p, backend="fused")
    stacks = None
    if n_pol:
        pad = np.isnan(d["power"])[None]
        draw = lambda lo, hi: torch.tensor(np.where(
            pad, np.nan, rng.uniform(lo, hi, (n_pol, u, max_p))),
            dtype=torch.float32, device=dev)
        stacks = (draw(-130, -60), draw(-180, 180))
    return paths, bs, ue, cfg, stacks


def _prologue(paths, bs, ue, cfg, stacks):
    """The fused kernels' seven inputs, as the renderers ask for them."""
    if stacks is None:
        return tch._fused_inputs(cfg, paths.trim_paths(cfg.num_paths), bs,
                                 ue)
    return tch._polar_fused_inputs(cfg, paths, bs, ue, *stacks)


def _pytorch_prologue(state, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(tch, "_prologue_route", lambda *a: False)
        return _prologue(*state)


def _assert_close(got, want, cfg, exact=False):
    names = ("gry", "grz", "gty", "gtz", "amp", "psi", "omega")
    k0, stride = tch._k_progression(cfg)
    omega0 = want[6] / stride
    atol = {"gry": ULPS * 2 * math.pi * 0.4, "grz": ULPS * 2 * math.pi * 0.4,
            "gty": ULPS * math.pi, "gtz": ULPS * math.pi, "amp": 0.0,
            "psi": ULPS * (math.pi + float((omega0 * k0).abs().max())),
            "omega": 0.0}
    assert len(got) == 7
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.is_contiguous(), name
        if exact:
            torch.testing.assert_close(g, w, rtol=0, atol=0,
                                       equal_nan=True, msg=name)
        else:
            torch.testing.assert_close(g, w, rtol=RTOL, atol=atol[name],
                                       equal_nan=True, msg=name)
        assert torch.isfinite(g).all(), name   # no NaN reaches the trig


def _kernel_args(paths, bs, ue, cfg, stacks):
    """:func:`kp.fused_prologue`'s arguments for a case, as the route
    passes them."""
    paths = paths.trim_paths(cfg.num_paths)
    if stacks is None:
        power, phase, polar = paths.power_dbw[None], paths.phase_deg[None], \
            False
    else:
        power, phase = (x[..., :cfg.num_paths] for x in stacks)
        polar = True
    k0, stride = tch._k_progression(cfg)
    return (paths.delay_s, paths.valid, paths.aoa_el_deg, paths.aoa_az_deg,
            paths.aod_el_deg, paths.aod_az_deg, power, phase, ue.rotation_deg,
            bs.rotation_deg, ue.spacing, bs.spacing, cfg.subcarriers,
            cfg.bandwidth, k0, stride, polar)


# ----------------------------------------------------------------------------
# On the CPU
# ----------------------------------------------------------------------------

def _emulated_launch(inputs, outputs, ints, bandwidth):
    """The kernel's reads and writes at the strides and sizes the wrapper
    passes, on the raw storage: the PyTorch prologue (the route patched
    off) on the views the kernel would index, for the config that the ints
    and the bandwidth describe, written into the outputs."""
    (delay, valid, aoa_el, aoa_az, aod_el, aod_az, power, phase, rot_ue,
     rot_bs, spacing_ue, spacing_bs) = inputs
    u, p, ld, n_pol, pol_stride, pol_ld, rot_ue_ld, rot_bs_ld, n_fft, k0, \
        stride, mask_phase = ints
    rows = lambda x: torch.as_strided(x, (u, p), (ld, 1))
    stack = lambda x: torch.as_strided(x, (n_pol, u, p),
                                       (pol_stride, pol_ld, 1))
    panel = lambda rot, r_ld, spacing: ttypes.AntennaPanel(
        torch.as_strided(rot, (u, 3), (r_ld, 1)) if r_ld else
        torch.as_strided(rot, (3,), (1,)), spacing)
    power, phase = stack(power), stack(phase)
    paths = ttypes.PathData(
        power_dbw=power[0], phase_deg=phase[0], delay_s=rows(delay),
        aoa_az_deg=rows(aoa_az), aoa_el_deg=rows(aoa_el),
        aod_az_deg=rows(aod_az), aod_el_deg=rows(aod_el), valid=rows(valid))
    bs, ue = panel(rot_bs, rot_bs_ld, spacing_bs), panel(rot_ue, rot_ue_ld,
                                                         spacing_ue)
    cfg = ttypes.ChannelConfig(subcarriers=n_fft, bandwidth=bandwidth,
                               selected_subcarriers=(k0, k0 + stride),
                               num_paths=p)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tch, "_prologue_route", lambda *a: False)
        m.setattr(kp, "FALLBACKS", kp.FALLBACKS)       # restored on exit
        want = (tch._polar_fused_inputs(cfg, paths, bs, ue, power, phase)
                if mask_phase else tch._fused_inputs(cfg, paths, bs, ue))
    for out, w in zip(outputs, want):
        out.copy_(w)


def _emulated_kernel(*args):
    """:func:`kp.fused_prologue` on CPU tensors, its checks passed and its
    launch emulated (``_launch`` patched to :func:`_emulated_launch`)."""
    u, p, n_pol = kp._check(args[:1] + args[2:6], args[1], args[6], args[7],
                            args[8:10], args[10:12])
    return kp._kernel(u, p, n_pol, *args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_strides_and_layouts_emulated(name, monkeypatch):
    """The wrapper's launch reads the fields where they lie: trimmed views
    at their row stride, stacks at their slot and row strides, [3] or
    [U, 3] rotations, with the grid's ints and the bandwidth; the PyTorch
    prologue run on what the kernel would read gives the PyTorch
    prologue's outputs on the call's own tensors bit for bit, contiguous."""
    state = _state(name, "cpu", CPU_USERS)
    want = _pytorch_prologue(state, monkeypatch)
    args = _kernel_args(*state)
    monkeypatch.setattr(kp, "_launch", _emulated_launch)
    _assert_close(_emulated_kernel(*args), want, state[3], exact=True)
    if name == "trimmed_view":
        assert not args[0].is_contiguous()     # read in place, not copied


# bad argument: the error it raises
REFUSALS = {"valid_dtype": "valid must be a bool",
            "float64": "float32 tensors",
            "rotation_shape": "rotations must be",
            "zero_slots": "power must be",
            "field_shape": "path fields must be",
            "cpu_tensors": "runs on CUDA tensors"}


@pytest.mark.parametrize("bad", sorted(REFUSALS))
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """Each argument the kernel cannot take raises its own error before a
    launch; well-formed CPU tensors raise too (the kernel runs on a card,
    the route keeps CPU calls on the PyTorch ops)."""
    args = list(_kernel_args(*_state("polar_4", "cpu", CPU_USERS)))
    if bad == "valid_dtype":
        args[1] = args[1].float()
    elif bad == "float64":
        args[0] = args[0].double()
    elif bad == "rotation_shape":
        args[8] = torch.zeros(2, 3)
    elif bad == "zero_slots":
        args[6] = args[6][:0]
    elif bad == "field_shape":
        args[2] = args[2][:, :-1]
    launches = kp.LAUNCHES
    with pytest.raises((TypeError, ValueError), match=REFUSALS[bad]):
        kp.fused_prologue(*args)
    assert kp.LAUNCHES == launches


def _count_kernel(monkeypatch):
    """Patch the card in and count the calls of the kernel's wrapper, whose
    launch is emulated on these CPU tensors (:func:`_emulated_kernel`)."""
    calls = []
    monkeypatch.setattr(tch, "_on_card", lambda dev: True)
    monkeypatch.setattr(kp, "_launch", _emulated_launch)
    monkeypatch.setattr(kp, "fused_prologue",
                        lambda *a: calls.append(a) or _emulated_kernel(*a))
    return calls


def _codebook(b, t, seed=1):
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, t))) / np.sqrt(t)
    return (torch.from_numpy(np.real(w).astype(np.float32)),
            torch.from_numpy(np.imag(w).astype(np.float32)))


def _call(kind, paths, bs, ue, cfg, stacks):
    w = _codebook(6, cfg.n_tx_ant)
    if kind == "render":
        return tch.render_channels_planes(paths, bs, ue, cfg)
    if kind == "beam_gains":
        return tch.render_beam_gains(paths, bs, ue, cfg, *w)
    if kind == "polar_render":
        return tch.render_channels_planes_polar(paths, bs, ue, cfg, *stacks)
    return tch.render_beam_gains_polar(paths, bs, ue, cfg, *stacks, *w)


# name: renderer, case
KINDS = {"render": ("render", "odd_users"),
         "beam_gains": ("beam_gains", "k0_stride"),
         "polar_render": ("polar_render", "polar_4"),
         "polar_render_5_slots": ("polar_render", "polar_5"),
         "polar_beam_gains": ("polar_beam_gains", "polar_2")}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_route_takes_the_kernel_on_a_card(name, monkeypatch):
    """A float32, isotropic, full-FoV call without Doppler or autograd on a
    card takes the kernel, once a call, whatever the renderer and the
    number of polarization slots; on these CPU tensors its emulated launch
    gives the unpatched call's result bit for bit."""
    kind, case = KINDS[name]
    state = _state(case, "cpu", CPU_USERS)
    want = _call(kind, *state)
    calls = _count_kernel(monkeypatch)
    fallbacks = kp.FALLBACKS
    got = _call(kind, *state)
    assert len(calls) == 1 and kp.FALLBACKS == fallbacks
    assert calls[0][-1] == (kind.startswith("polar"))   # mask_phase
    assert torch.equal(got, want)


FALLBACK_CASES = {
    "cpu": ("render", {}),
    "bs_fov": ("render", dict(bs_fov=(120.0, 180.0))),
    "ue_fov": ("polar_render", dict(ue_fov=(180.0, 90.0))),
    "dipole": ("beam_gains", dict(bs_pattern="halfwave-dipole")),
    "doppler": ("render", dict(enable_doppler=True, doppler_times=(0.0,))),
    "float64": ("beam_gains", dict(dtype="complex128")),
}


@pytest.mark.parametrize("name", sorted(FALLBACK_CASES))
def test_route_keeps_the_pytorch_prologue(name, monkeypatch):
    """Angle space (FoV, dipole), Doppler, float64 and the CPU take the
    PyTorch prologue, counted in ``FALLBACKS``, and the kernel is not
    called."""
    kind, change = FALLBACK_CASES[name]
    paths, bs, ue, cfg, stacks = _state(
        "polar_4" if kind.startswith("polar") else "odd_users", "cpu",
        CPU_USERS)
    cfg = cfg.replace(**change)
    if name == "doppler":
        vel = torch.full_like(paths.delay_s, 12.0)
        paths = dataclasses.replace(paths, doppler_vel=vel,
                                    doppler_acc=torch.zeros_like(vel))
    if name == "float64":
        paths = paths._map(lambda x: x.double() if x.is_floating_point()
                           else x)
        bs, ue = (type(x)(x.rotation_deg.double(), x.spacing.double())
                  for x in (bs, ue))
    calls = _count_kernel(monkeypatch) if name != "cpu" else []
    fallbacks = kp.FALLBACKS
    out = _call(kind, paths, bs, ue, cfg, stacks)
    assert torch.isfinite(out).all()
    assert not calls and kp.FALLBACKS == fallbacks + 1


def test_route_keeps_the_pytorch_prologue_under_autograd(monkeypatch):
    """A render whose inputs require grad takes the PyTorch prologue (its
    VJP is the ops'); the same render without grad takes the kernel."""
    paths, bs, ue, cfg, _ = _state("odd_users", "cpu", CPU_USERS)
    leaf = paths.aod_az_deg.detach().requires_grad_(True)
    grad_paths = dataclasses.replace(paths, aod_az_deg=leaf)
    calls = _count_kernel(monkeypatch)
    fallbacks = kp.FALLBACKS
    h = tch.render_channels_planes(grad_paths, bs, ue, cfg)
    h.sum().backward()
    assert not calls and kp.FALLBACKS == fallbacks + 1
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    with torch.no_grad():
        tch.render_channels_planes(grad_paths, bs, ue, cfg)
    assert len(calls) == 1 and kp.FALLBACKS == fallbacks + 1


def test_calibration_step_keeps_the_pytorch_prologue(monkeypatch):
    """The calibration step differentiates through the prologue: every
    render of it takes the PyTorch ops, on a card too."""
    paths, bs, ue, cfg, _ = _state("odd_users", "cpu", 24)
    cfg = cfg.replace(bs_shape=(4, 2), ue_shape=(2, 1),
                      selected_subcarriers=tuple(range(8)), num_paths=6,
                      planes_layout="packed")
    target = tch.render_channels_planes(
        paths, ttypes.AntennaPanel.make((0.0, 0.0, 10.0), device="cpu"),
        ue, cfg)
    params = tsh.init_calib_params(paths, bs, ue)
    calls = _count_kernel(monkeypatch)
    fallbacks = kp.FALLBACKS
    new, loss = tsh.training_step_planes(params, paths, target, cfg,
                                         lr=3e-3)
    assert not calls and kp.FALLBACKS > fallbacks
    assert math.isfinite(float(loss))


@pytest.mark.parametrize("polar", [False, True], ids=["single", "polar"])
def test_cpu_render_planes_unchanged(polar):
    """A CPU render takes the PyTorch prologue, and its planes are the
    render kernel's plain version on the prologue's own ops, bit for bit,
    with nothing launched."""
    paths, bs, ue, cfg, stacks = _state("polar_4" if polar else "trimmed_view",
                                        "cpu", CPU_USERS)
    fallbacks, launches = kp.FALLBACKS, kp.LAUNCHES
    if polar:
        got = tch.render_channels_planes_polar(paths, bs, ue, cfg, *stacks)
    else:
        got = tch.render_channels_planes(paths, bs, ue, cfg)
    assert (kp.FALLBACKS, kp.LAUNCHES) == (fallbacks + 1, launches)
    p = paths.trim_paths(cfg.num_paths)
    valid, gain, *steps = tch._wavevec_steps(cfg, p, bs, ue)
    steps = [torch.where(valid, x.reshape(valid.shape), 0.0) for x in steps]
    if polar:
        pw, ph = (x[..., :cfg.num_paths] for x in stacks)
        p_lin = torch.where(valid, torch.pow(10.0, pw / 10.0), 0.0)
        scalars = tch._fused_path_scalars(cfg, p, valid, p_lin,
                                          torch.where(valid, ph, 0.0))
    else:
        p_lin = torch.where(valid, torch.pow(10.0, p.power_dbw / 10.0), 0.0)
        scalars = tch._fused_path_scalars(cfg, p, valid, p_lin)
    want = kr.fused_render(*steps, *scalars, cfg.ue_shape, cfg.bs_shape,
                           cfg.n_sel_subcarriers, False)
    assert torch.equal(got.reshape(-1), want.reshape(-1))


# ----------------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_pytorch_prologue(cuda, name, monkeypatch):
    """The kernel's seven outputs against the PyTorch prologue on the card,
    one launch and no fallback."""
    state = _state(name, cuda)
    want = _pytorch_prologue(state, monkeypatch)
    launches, fallbacks = kp.LAUNCHES, kp.FALLBACKS
    got = _prologue(*state)
    torch.cuda.synchronize()
    assert (kp.LAUNCHES, kp.FALLBACKS) == (launches + 1, fallbacks)
    _assert_close(got, want, state[3])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["render", "beam_gains", "polar_render"])
def test_cuda_call_through_the_kernel_matches_the_cpu(cuda, kind):
    """One render, beam-gain or dual-polar render call on the card (the
    prologue kernel, then the render or beam-gain kernel) against the same
    call on the CPU (the PyTorch prologue and the plain versions), one
    prologue launch a call."""
    name = {"render": "headline", "beam_gains": "k0_stride",
            "polar_render": "polar_4"}[kind]
    want = _call(kind, *_state(name, "cpu", 300))
    state = _state(name, cuda, 300)
    launches, fallbacks = kp.LAUNCHES, kp.FALLBACKS
    kernels = kr.LAUNCHES + kb.LAUNCHES
    got = _call(kind, *state)
    torch.cuda.synchronize()
    assert (kp.LAUNCHES, kp.FALLBACKS) == (launches + 1, fallbacks)
    assert kr.LAUNCHES + kb.LAUNCHES == kernels + 1
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= CALL_RTOL * scale
