"""Fused path->channel render: per-path scalars in, H planes out.

Kernel: ``csrc/render_fwd.cu``, hand-written CUDA C++ for Hopper
(``sm_90a``), built with nvcc at first use and called through ctypes.

Source note.

- Replaces the TPU kernel ``deepmimo_tpu/ops/pallas/render.py::_kernel``
  (with ``_kernel_norx``; wrapper ``_fwd_impl``, public ``fused_render``).
  It computes exactly ``render.py::_reference_impl``: panel responses
  E = a_rx (x) a_tx [Q, P], OFDM gains g = amp e^{j(psi_s - omega k)}
  [S*K, P] and the path sum H = E g^T, per user.
- What bounds it on an H100: the HBM write of H. At the headline
  (131,072 users, P = 25, RX 1x1, TX 8x8, K = 64) H is 4.29 GB per
  dataset, ~1.3 ms at 3.35 TB/s; its 1.07e11 FP32 flops are ~1.6 ms at
  67 TFLOP/s, so FMA throughput is a co-bound. The inputs are ~0.09 GB.
- What the design does about it: one block per user builds E and g once in
  shared memory (the trig runs (Q + S*K)*P times, not Q*S*K*P) and keeps
  every intermediate out of HBM, so H is written exactly once with
  contiguous rows; each thread accumulates a 4 x 4 complex register tile,
  so shared-memory loads stay a quarter of the FMAs. No TPU lane packing,
  hi/lo bf16 split or Chebyshev recurrence is carried over: FP32 FMA is
  exact enough, and trig is direct ``sincosf``.

:func:`fused_render` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it computes the plain PyTorch
version :func:`fused_render_reference`. ``LAUNCHES`` counts kernel launches.
The kernel has no backward: nothing on the forward render path needs one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

#: Number of CUDA kernel launches made by :func:`fused_render`.
LAUNCHES = 0

#: Largest dynamic shared memory a block may opt into on Hopper (bytes).
SMEM_LIMIT = 232_448


def smem_bytes(q: int, sk: int, n_paths: int) -> int:
    """Shared memory of one block: E [P, Q] and g [P, S*K], re and im."""
    return 2 * 4 * n_paths * (q + sk)


def kernel_fits(rx_shape, tx_shape, n_paths: int, n_k: int,
                n_snap: int = 1) -> bool:
    """Does the CUDA kernel take this shape? (Device-independent.)

    The only bound is shared memory: all P paths of one user are staged
    at once, so P <= SMEM_LIMIT / (8 * (Q + S*K)) — 227 paths at the
    headline shape.
    """
    q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
    return 0 < smem_bytes(q, n_snap * n_k, max(n_paths, 1)) <= SMEM_LIMIT


def fused_render_reference(gry, grz, gty, gtz, amp, psi, omega,
                           rx_shape: Tuple[int, int],
                           tx_shape: Tuple[int, int], n_k: int,
                           packed: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``_reference_impl``'s math).

    Args:
        gry/grz, gty/gtz: RX/TX wave-vector phase steps per path [U, P].
        amp: linear amplitude [U, P], or [U, S*P] per snapshot slot.
        psi: phase at subcarrier 0 [U, S*P] (S snapshots along k).
        omega: phase slope per subcarrier step [U, P].
        rx_shape/tx_shape: panel shapes (M1, M2); n_k: subcarriers.
        packed: return [U, Q, 2*S*K] (hr | hi on the minor axis) instead
            of stacked [2, U, Q, S*K].
    """
    u, p = omega.shape
    n_s = psi.shape[1] // p
    n_sa = amp.shape[1] // p

    def response(ky, kz, m1, m2):
        m = torch.arange(m1, dtype=ky.dtype, device=ky.device)
        n = torch.arange(m2, dtype=ky.dtype, device=ky.device)
        ph = (m[None, :, None, None] * ky[:, None, None, :] +
              n[None, None, :, None] * kz[:, None, None, :])
        ph = ph.transpose(1, 2).reshape(u, m1 * m2, p)
        return torch.cos(ph), torch.sin(ph)

    arx_r, arx_i = response(gry, grz, *rx_shape)
    atx_r, atx_i = response(gty, gtz, *tx_shape)
    q = arx_r.shape[1] * atx_r.shape[1]
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :]).reshape(u, q, p)
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :]).reshape(u, q, p)

    ks = torch.arange(n_k, dtype=amp.dtype, device=amp.device)
    base = (psi.reshape(u, n_s, p)[..., None] -
            omega[:, None, :, None] * ks)                    # [u, s, p, k]
    amp_b = amp.reshape(u, n_sa, p)[..., None]
    gr = amp_b * torch.cos(base)
    gi = amp_b * torch.sin(base)

    def mm(a, b):
        return torch.einsum("uqp,uspk->uqsk", a, b).reshape(u, q, n_s * n_k)

    hr = mm(er, gr) - mm(ei, gi)
    hi = mm(er, gi) + mm(ei, gr)
    return torch.cat((hr, hi), dim=-1) if packed else torch.stack((hr, hi))


def _check_inputs(args, rx_shape, tx_shape, n_k):
    names = ("gry", "grz", "gty", "gtz", "amp", "psi", "omega")
    omega = args[-1]
    if omega.dim() != 2:
        raise ValueError(f"omega must be [U, P]; got {tuple(omega.shape)}")
    u, p = omega.shape
    for name, x in zip(names, args):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != omega.device:
            raise ValueError(f"{name} is on {x.device}, omega on "
                             f"{omega.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() != 2 or x.shape[0] != u:
            raise ValueError(f"{name} must be [U={u}, ...]; got "
                             f"{tuple(x.shape)}")
    for name, x in zip(names[:4], args[:4]):
        if x.shape[1] != p:
            raise ValueError(f"{name} must be [U, P={p}]; got "
                             f"{tuple(x.shape)}")
    psi, amp = args[5], args[4]
    if p == 0 or psi.shape[1] % p or psi.shape[1] == 0:
        raise ValueError(f"psi must be [U, S*P] with P={p}; got "
                         f"{tuple(psi.shape)}")
    n_s = psi.shape[1] // p
    if amp.shape[1] not in (p, n_s * p):
        raise ValueError(f"amp must be [U, P] or [U, S*P]; got "
                         f"{tuple(amp.shape)}")
    if n_k < 1 or min(*rx_shape, *tx_shape) < 1:
        raise ValueError(f"bad shapes rx={rx_shape} tx={tx_shape} "
                         f"n_k={n_k}")
    return u, p, n_s, amp.shape[1] // p


def _launcher():
    fn = _build.load_library("render_fwd").render_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_render(gry, grz, gty, gtz, amp, psi, omega,
                 rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                 n_k: int, packed: bool,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused channel render from per-path scalars -> H planes (float32).

    Inputs as in :func:`fused_render_reference`, float32, contiguous, all
    on one device; invalid paths carry zeros. Returns packed
    [U, Q, 2*S*K] or stacked [2, U, Q, S*K], written into ``out`` when it
    is given (it must have that shape, float32, contiguous, same device).

    CUDA tensors launch the kernel on the current stream (no sync) or
    raise; CPU tensors take the plain version.
    """
    global LAUNCHES
    args = (gry, grz, gty, gtz, amp, psi, omega)
    u, p, n_s, n_sa = _check_inputs(args, rx_shape, tx_shape, n_k)
    r1, r2 = (int(x) for x in rx_shape)
    t1, t2 = (int(x) for x in tx_shape)
    q, sk = r1 * r2 * t1 * t2, n_s * n_k
    shape = (u, q, 2 * sk) if packed else (2, u, q, sk)
    dev = omega.device
    if out is not None and (tuple(out.shape) != shape or
                            out.dtype != torch.float32 or
                            out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {shape} tensor "
                         f"on {dev}; got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")

    if dev.type == "cpu":
        h = fused_render_reference(*args, (r1, r2), (t1, t2), n_k, packed)
        return h if out is None else out.copy_(h)
    if dev.type != "cuda":
        raise ValueError(f"fused_render runs on CUDA or CPU tensors, not "
                         f"{dev}")
    if not kernel_fits((r1, r2), (t1, t2), p, n_k, n_s):
        raise ValueError(
            f"shape exceeds the kernel's shared memory: Q={q}, S*K={sk}, "
            f"P={p} needs {smem_bytes(q, sk, p)} > {SMEM_LIMIT} bytes")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(*(x.data_ptr() for x in args), out.data_ptr(), u, p,
                    r1, r2, t1, t2, n_k, n_s, n_sa, int(bool(packed)),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render_fwd launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
