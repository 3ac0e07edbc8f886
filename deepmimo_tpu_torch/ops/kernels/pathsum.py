"""Fused path sum from materialized array-response planes -> H planes.

Kernel: ``csrc/pathsum.cu``, hand-written CUDA C++ for Hopper
(``sm_90a``), built with nvcc at first use and called through ctypes.

Source note.

- Replaces the TPU kernel ``deepmimo_tpu/ops/pallas/pathsum.py::_kernel``
  (wrapper ``_pallas_call``, public ``fused_path_sum``). It computes
  ``pathsum.py::_reference_impl``, H = (a_rx (x) a_tx) g^T per user with
  g = amp e^{j(psi - omega k_sel[k])} at any selected subcarriers, as
  (hr, hi) [U, R*T, K], regrouped as H[r*T + t] = sum_p atx[t, p]
  (arx[r, p] g[p, k]) so that E is never formed.
- What bounds it on an H100: HBM bytes (the planes read once, H written
  once: 6.0 GB at the headline), with the GEMM's issue and the trig that
  builds its B operand behind.
- What the design does about it: per (user, r) one real GEMM on the
  tensor cores at 3xTF32 (``wgmma``, f32 grade), with the atx planes
  copied as they lie in HBM (``cp.async``, two stages) as A and only
  B = amp arx (x) g built on the chip, by producer warps while the
  consumer warpgroup runs the products of another chunk; persistent
  blocks walk 64 x 64 output tiles in 16-path chunks, so shared memory is
  one constant (:func:`smem_bytes`) whatever the shape. The TPU's
  user/k tiling is not carried over.

:func:`fused_path_sum` is the ``apply`` of :class:`FusedPathSum`: CUDA
tensors launch the kernel or raise, CPU tensors take the plain version
:func:`fused_path_sum_reference`. Its backward is the plain VJP of the
reference, as in the JAX package (the TPU has no backward kernel here).
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ...utils.profiling import span
from .render import INDEX_LIMIT

#: Number of CUDA kernel launches made by :func:`fused_path_sum`.
LAUNCHES = 0

# Tiles of the kernel: paths per chunk, rows (t) and columns (k) per tile,
# A plane row, staged per-path scalars, the GEMM's columns and depth.
_PC, _MT, _NT = 16, 64, 64
_AS = _PC + 4
_SCAL = 5
_N, _K = 2 * _NT, 2 * _PC


def smem_bytes() -> int:
    """Dynamic shared memory of one block, as ``pathsum_smem_bytes`` of
    the kernel computes it: two stages of the B operand's tf32 hi and lo
    planes [2*kNT x 2*kPC], the atx planes [kMT][kAS] (re, im) and the
    chunk's scalars and k_sel. It depends on the tiles only, not on P, R, T
    or K."""
    return 4 * 2 * (2 * _N * _K + 2 * _MT * _AS + _SCAL * _PC + _NT)


def kernel_fits(n_rx: int, n_tx: int, n_k: int, n_paths: int) -> bool:
    """Does the CUDA kernel take R RX and T TX elements, K subcarriers and
    P paths? Shared memory does not grow with the shape, so only the
    kernel's C ints bound it: Q = R*T, K, P and the 64 x 64 output tiles
    per user must each fit in one."""
    if min(n_rx, n_tx, n_k, n_paths) < 1:
        return False
    tiles = n_rx * -(-n_tx // _MT) * -(-n_k // _NT)
    return (n_rx * n_tx <= INDEX_LIMIT and n_k <= INDEX_LIMIT and
            n_paths <= INDEX_LIMIT and tiles <= INDEX_LIMIT)


_NAMES = ("arx_r", "arx_i", "atx_r", "atx_i", "amp", "psi", "omega",
          "k_sel")


def fused_path_sum_reference(arx_r, arx_i, atx_r, atx_i, amp, psi, omega,
                             k_sel) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (``_reference_impl``'s math).

    Args:
        arx_r/arx_i: RX array-response planes [U, R, P].
        atx_r/atx_i: TX array-response planes [U, T, P].
        amp: per-path amplitude [U, P] (0 for invalid/over-FFT paths).
        psi: per-path phase (radians, incl. Doppler) [U, P].
        omega: per-path subcarrier phase slope 2*pi*delay_n/N [U, P].
        k_sel: selected subcarrier indices [K] (float).

    Returns:
        (hr, hi): [U, R*T, K] planes.
    """
    u, r, p = arx_r.shape
    t = atx_r.shape[1]
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :]).reshape(u, r * t, p)
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :]).reshape(u, r * t, p)
    base = psi[..., None] - omega[..., None] * k_sel[None, None, :]
    gr = amp[..., None] * torch.cos(base)
    gi = amp[..., None] * torch.sin(base)

    def mm(a, b):
        return torch.einsum("uqp,upk->uqk", a, b)

    return mm(er, gr) - mm(ei, gi), mm(er, gi) + mm(ei, gr)


def _check_inputs(args):
    arx_r, atx_r, k_sel = args[0], args[2], args[7]
    if arx_r.dim() != 3 or atx_r.dim() != 3 or k_sel.dim() != 1:
        raise ValueError(f"need arx/atx planes [U, R, P] / [U, T, P] and "
                         f"k_sel [K]; got {tuple(arx_r.shape)}, "
                         f"{tuple(atx_r.shape)}, {tuple(k_sel.shape)}")
    u, r, p = arx_r.shape
    t, k = atx_r.shape[1], k_sel.shape[0]
    if min(r, t, p, k) < 1:
        raise ValueError(f"empty axis: R={r} T={t} P={p} K={k}")
    shapes = ((u, r, p), (u, r, p), (u, t, p), (u, t, p), (u, p), (u, p),
              (u, p), (k,))
    for name, x, shape in zip(_NAMES, args, shapes):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != arx_r.device:
            raise ValueError(f"{name} is on {x.device}, arx_r on "
                             f"{arx_r.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return u, r, t, p, k


def _path_sum(args):
    """The forward without autograd: kernel on CUDA, plain on the CPU."""
    global LAUNCHES
    u, r, t, p, k = _check_inputs(args)
    dev = args[0].device
    if dev.type == "cpu":
        return fused_path_sum_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"fused_path_sum runs on CUDA or CPU tensors, not "
                         f"{dev}")
    if not kernel_fits(r, t, k, p):
        raise ValueError(f"shape exceeds the kernel's C-int indices: "
                         f"R={r}, T={t}, K={k}, P={p} (Q, K, P and the "
                         f"64 x 64 tiles per user must each be <= "
                         f"{INDEX_LIMIT})")
    hr = torch.empty((u, r * t, k), dtype=torch.float32, device=dev)
    hi = torch.empty_like(hr)
    with span("dm.kernel.pathsum"), torch.cuda.device(dev):
        fn = _build.launcher("pathsum", 10, 5)
        rc = fn(*(x.data_ptr() for x in args), hr.data_ptr(), hi.data_ptr(),
                u, p, r, t, k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pathsum launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return hr, hi


class FusedPathSum(torch.autograd.Function):
    """The path-sum kernel with the plain VJP of the reference as its
    backward (``pathsum.py:189-195``)."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _path_sum(args)

    @staticmethod
    def backward(ctx, d_hr, d_hi):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(ctx.saved_tensors,
                                         ctx.needs_input_grad)]
            wanted = [x for x in leaves if x.requires_grad]
            hr, hi = fused_path_sum_reference(*leaves)
            grads = iter(torch.autograd.grad(
                (hr, hi), wanted, (d_hr, d_hi), allow_unused=True))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad)


def fused_path_sum(arx_r, arx_i, atx_r, atx_i, amp, psi, omega, k_sel
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused H = sum_p (a_rx x a_tx) * g as (hr, hi) planes [U, R*T, K].

    Inputs as in :func:`fused_path_sum_reference`: float32, contiguous,
    all on one device. Differentiable through :class:`FusedPathSum`.
    """
    return FusedPathSum.apply(arx_r, arx_i, atx_r, atx_i, amp, psi, omega,
                              k_sel)
