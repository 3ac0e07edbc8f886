"""The fused kernels' prologue: a call's per-path fields in, the seven
per-path inputs of the render and beam-gain kernels out, in one launch.

Kernel: ``csrc/prologue.cu``, hand-written CUDA C++ for Hopper
(``sm_90a``), built with nvcc at first use and called through ctypes.

Source note.

- Replaces no TPU kernel. The JAX package's prologue of its fused
  renderers (``deepmimo_tpu/ops/channel.py``) is plain XLA ops, which its
  compiler fuses. Run as PyTorch ops (``ops/channel.py`` ``_fused_inputs``,
  ``_polar_fused_inputs``, which keep them for the calls the kernel does
  not take) they are ~100 launches a call: 0.79 ms of device time and
  ~2 ms of the host's at the headline (131,072 users x 25 paths, H100).
- What bounds it on an H100: bytes. It reads the paths' 7 float32 fields
  and the bool mask and writes 7 float32 arrays, 57 bytes a path at one
  polarization slot (0.056 ms at the headline at 3.35 TB/s) and 105 at
  four (0.103 ms). Its ~8 sincosf, and a powf and a sqrtf a slot, per path
  are far under the card's FP32 rate.
- What the design does about it: one thread per (user, path), one pass
  over memory, every read and write coalesced, each output written once.
  The fields are read at their row stride (a ``PathData.trim_paths`` view
  needs no copy) and the panels' rotations and spacings on the device
  (no host sync). The arithmetic is the PyTorch prologue's, op for op in
  float32 with each op rounded once and precise ``sincosf``, ``powf`` and
  ``sqrtf``, so the two agree to an ulp or so.

:func:`fused_prologue` launches the kernel on CUDA tensors; the PyTorch
ops in ``ops/channel.py`` are its reference, and ``_prologue_route`` there
decides which calls take it. ``LAUNCHES`` counts the kernel's launches
and ``FALLBACKS`` the prologues that the route left to the PyTorch ops.
"""

from __future__ import annotations

import torch

from . import _build
from ...utils.profiling import span

#: Number of kernel launches (``csrc/prologue.cu``).
LAUNCHES = 0
#: Number of fused-kernel prologues run as PyTorch ops instead
#: (``ops/channel.py`` ``_prologue_route``).
FALLBACKS = 0
#: Largest stride the kernel takes (a C int).
INDEX_LIMIT = 2**31 - 1


def _check(fields, valid, power, phase, rotations, spacings):
    """(U, P, N) of :func:`fused_prologue`'s arguments, or
    TypeError/ValueError."""
    u, p = valid.shape if valid.dim() == 2 else (-1, -1)
    dev = valid.device
    if valid.dtype != torch.bool or valid.dim() != 2:
        raise TypeError(f"valid must be a bool [U, P] tensor; got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if power.dim() != 3 or power.shape[0] < 1:
        raise ValueError(f"power must be [N, U, P] with N >= 1; got "
                         f"{tuple(power.shape)}")
    n_pol = power.shape[0]
    for x in (*fields, power, phase, *rotations, *spacings):
        if x.dtype != torch.float32 or x.device != dev:
            raise TypeError(f"the prologue takes float32 tensors on "
                            f"{dev}; got {x.dtype} on {x.device}")
    for x in fields:
        if tuple(x.shape) != (u, p):
            raise ValueError(f"path fields must be [U={u}, P={p}]; got "
                             f"{tuple(x.shape)}")
    for x in (power, phase):
        if tuple(x.shape) != (n_pol, u, p):
            raise ValueError(f"power and phase must be [N={n_pol}, U={u}, "
                             f"P={p}]; got {tuple(x.shape)}")
    for x in rotations:
        if tuple(x.shape) not in ((3,), (u, 3)):
            raise ValueError(f"rotations must be [3] or [U={u}, 3]; got "
                             f"{tuple(x.shape)}")
    for x in spacings:
        if x.numel() != 1:
            raise ValueError(f"spacings must hold one value; got "
                             f"{tuple(x.shape)}")
    return u, p, n_pol


def _rows(xs):
    """``xs`` as they lie, with their shared (slot and) row stride, when
    all have unit stride along the paths and the same strides; else
    contiguous copies."""
    if not all(x.stride()[:-1] == xs[0].stride()[:-1] and x.stride(-1) == 1
               for x in xs):
        xs = [x.contiguous() for x in xs]
    strides = xs[0].stride()[:-1]
    if max(strides, default=0) > INDEX_LIMIT:
        raise ValueError(f"strides {strides} exceed the kernel's C ints")
    return xs, strides


def _launch(inputs, outputs, ints, bandwidth):
    """One launch of ``prologue_launch`` (the only place that spells its C
    signature) on the outputs' device and current stream: 12 input
    pointers (delay, valid, aoa_el, aoa_az, aod_el, aod_az, power, phase,
    rot_ue, rot_bs, spacing_ue, spacing_bs), 7 output pointers (gry, grz,
    gty, gtz, amp, psi, omega), 12 ints (U, P, the fields' row stride, N,
    the stacks' slot and row strides, the rotations' row strides, n_fft,
    k0, stride, mask_phase) and the bandwidth; counts nothing."""
    dev = outputs[0].device
    with span("dm.kernel.prologue"), torch.cuda.device(dev):
        launch = _build.launcher("prologue", 19, 12, 1)
        rc = launch(*(x.data_ptr() for x in (*inputs, *outputs)), *ints,
                    bandwidth, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prologue launch failed with CUDA error {rc}")


def fused_prologue(delay, valid, aoa_el, aoa_az, aod_el, aod_az, power,
                   phase, rot_ue, rot_bs, spacing_ue, spacing_bs,
                   n_fft: int, bandwidth: float, k0: int, stride: int,
                   mask_phase: bool):
    """The seven per-path inputs of the fused render and beam-gain kernels.

    Args:
        delay, aoa_el, aoa_az, aod_el, aod_az: [U, P] float32 path fields
            (seconds, degrees); valid: [U, P] bool. Views at any strides
            with unit stride along P, ``PathData.trim_paths``' among them.
        power, phase: [N, U, P] float32 power (dBW) and phase (degrees) of
            N >= 1 polarization slots, likewise.
        rot_ue, rot_bs: the panels' rotations (degrees), [3] or [U, 3].
        spacing_ue, spacing_bs: the panels' spacings (wavelengths), one
            element each.
        n_fft, bandwidth: the OFDM grid; k0, stride: the selected
            subcarriers k0 + stride * k.
        mask_phase: take the phase as 0 on invalid paths (stacks that are
            NaN-padded as loaded).

    Returns contiguous float32 gry, grz, gty, gtz [U, P] (zero on invalid
    paths), amp and psi [U, N*P] (pol-major, slot n at columns n*P ..
    n*P + P - 1) and omega [U, P]: ``ops/channel.py`` ``_fused_inputs`` and
    ``_polar_fused_inputs``. Launches the kernel on the current stream (no
    sync); tensors on another device than a CUDA card raise ValueError.
    """
    global LAUNCHES
    fields = (delay, aoa_el, aoa_az, aod_el, aod_az)
    u, p, n_pol = _check(fields, valid, power, phase, (rot_ue, rot_bs),
                         (spacing_ue, spacing_bs))
    if delay.device.type != "cuda":
        raise ValueError(f"the prologue kernel runs on CUDA tensors, not "
                         f"{delay.device}")
    outputs = _kernel(u, p, n_pol, delay, valid, aoa_el, aoa_az, aod_el,
                      aod_az, power, phase, rot_ue, rot_bs, spacing_ue,
                      spacing_bs, n_fft, bandwidth, k0, stride, mask_phase)
    LAUNCHES += u * p > 0
    return outputs


def _kernel(u, p, n_pol, delay, valid, aoa_el, aoa_az, aod_el, aod_az,
            power, phase, rot_ue, rot_bs, spacing_ue, spacing_bs, n_fft,
            bandwidth, k0, stride, mask_phase):
    """:func:`fused_prologue` on checked tensors: the outputs allocated and
    one launch (none without paths), at the inputs' strides."""
    dev = delay.device
    fields, (ld,) = _rows([delay, valid, aoa_el, aoa_az, aod_el, aod_az])
    (power, phase), (pol_stride, pol_ld) = _rows([power, phase])
    rot_ue, rot_bs = rot_ue.contiguous(), rot_bs.contiguous()
    outputs = tuple(torch.empty((u, n * p), dtype=torch.float32,
                                device=dev) for n in (1, 1, 1, 1, n_pol,
                                                      n_pol, 1))
    if u * p:
        _launch((*fields, power, phase, rot_ue, rot_bs, spacing_ue,
                 spacing_bs), outputs,
                (u, p, ld, n_pol, pol_stride, pol_ld,
                 3 * (rot_ue.dim() == 2), 3 * (rot_bs.dim() == 2),
                 int(n_fft), int(k0), int(stride), int(bool(mask_phase))),
                float(bandwidth))
    return outputs
