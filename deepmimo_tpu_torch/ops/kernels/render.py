"""Fused path->channel render: per-path scalars in, H planes out, and its
backward.

Kernels: ``csrc/render_fwd.cu`` and ``csrc/render_bwd.cu``, hand-written
CUDA C++ for Hopper (``sm_90a``), built with nvcc at first use and called
through ctypes.

Source note.

- Forward: replaces the TPU kernel
  ``deepmimo_tpu/ops/pallas/render.py::_kernel`` (with ``_kernel_norx``;
  wrapper ``_fwd_impl``, public ``fused_render``). It computes exactly
  ``render.py::_reference_impl``: panel responses E = a_rx (x) a_tx
  [Q, P], OFDM gains g = amp e^{j(psi_s - omega k)} [S*K, P] and the path
  sum H = E g^T, per user.
- Backward: replaces ``render.py::_bwd_kernel`` (with ``_bwd_kernel_norx``;
  wrapper ``_bwd_impl``, VJP rule ``_bwd``): the recompute-on-chip VJP,
  dE = ct . g and dG = ct^T . E chained to the 7 per-path gradients.
- What bounds them on an H100: at the headline (131,072 users, P = 25,
  RX 1x1, TX 8x8, K = 64) the forward writes H once (4.29 GB, ~1.3 ms at
  3.35 TB/s) and the backward reads the cotangent once (the same bytes);
  the forward's 1.07e11 FP32 flops (~1.6 ms at 67 TFLOP/s) and the
  backward's 2.15e11 (~3.2 ms) make FMA throughput the bound of both.
- What the design does about it: one block per user rebuilds E and g in
  shared memory (trig (Q + S*K)*P times per user, not Q*S*K*P) and keeps
  every intermediate out of HBM. The forward accumulates 4 x 4 complex
  register tiles; the backward streams the cotangent through shared
  memory in 64 x 64 tiles and folds each tile's partial dE rows and dG
  columns straight into per-path sums (the chains are linear), so its
  shared memory is constant and it takes every shape the forward takes.
  No TPU lane packing, hi/lo bf16 split or Chebyshev recurrence is carried
  over: FP32 FMA is exact enough, and trig is direct ``sincosf``.

:func:`fused_render` is the ``apply`` of :class:`FusedRender`, a
``torch.autograd.Function``: CUDA tensors launch the forward kernel and,
under autograd, the backward kernel; anything a kernel does not take
raises. CPU tensors take the plain versions :func:`fused_render_reference`
and :func:`fused_render_bwd_reference`. ``LAUNCHES`` and ``BWD_LAUNCHES``
count kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

#: Number of forward kernel launches (``csrc/render_fwd.cu``).
LAUNCHES = 0
#: Number of backward kernel launches (``csrc/render_bwd.cu``).
BWD_LAUNCHES = 0

#: Largest dynamic shared memory a block may opt into on Hopper (bytes).
SMEM_LIMIT = 232_448


def smem_bytes(q: int, sk: int, n_paths: int) -> int:
    """Shared memory of one block: E [P, Q] and g [P, S*K], re and im."""
    return 2 * 4 * n_paths * (q + sk)


def kernel_fits(rx_shape, tx_shape, n_paths: int, n_k: int,
                n_snap: int = 1) -> bool:
    """Do the CUDA kernels take this shape? (Device-independent.)

    The only bound is the forward's shared memory: all P paths of one
    user are staged at once, so P <= SMEM_LIMIT / (8 * (Q + S*K)) — 227
    paths at the headline shape. The backward's shared memory is a
    constant 87 KB, so it takes every shape the forward takes.
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


def _out_shape(u, q, sk, packed):
    return (u, q, 2 * sk) if packed else (2, u, q, sk)


def _check_layout(name, x, shape, dev):
    if (tuple(x.shape) != shape or x.dtype != torch.float32 or
            x.device != dev or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {shape} "
                         f"tensor on {dev}; got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")


def _check_cuda(dev, rx_shape, tx_shape, p, n_k, n_s, what):
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")
    if not kernel_fits(rx_shape, tx_shape, p, n_k, n_s):
        q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
        raise ValueError(
            f"shape exceeds the kernel's shared memory: Q={q}, "
            f"S*K={n_s * n_k}, P={p} needs {smem_bytes(q, n_s * n_k, p)} > "
            f"{SMEM_LIMIT} bytes")


def _render(args, rx_shape, tx_shape, n_k, packed, out):
    """The forward without autograd: kernel on CUDA, plain on the CPU."""
    global LAUNCHES
    u, p, n_s, n_sa = _check_inputs(args, rx_shape, tx_shape, n_k)
    r1, r2 = (int(x) for x in rx_shape)
    t1, t2 = (int(x) for x in tx_shape)
    q, sk = r1 * r2 * t1 * t2, n_s * n_k
    shape = _out_shape(u, q, sk, packed)
    dev = args[-1].device
    if out is not None:
        _check_layout("out", out, shape, dev)
    if dev.type == "cpu":
        h = fused_render_reference(*args, (r1, r2), (t1, t2), n_k, packed)
        return h if out is None else out.copy_(h)
    _check_cuda(dev, (r1, r2), (t1, t2), p, n_k, n_s, "fused_render")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    launch = _build.launcher("render_fwd", 8, 10)
    with torch.cuda.device(dev):
        rc = launch(*(x.data_ptr() for x in args), out.data_ptr(), u, p,
                    r1, r2, t1, t2, n_k, n_s, n_sa, int(bool(packed)),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render_fwd launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def fused_render_bwd_reference(gry, grz, gty, gtz, amp, psi, omega, ct,
                               rx_shape: Tuple[int, int],
                               tx_shape: Tuple[int, int], n_k: int,
                               packed: bool):
    """Plain PyTorch version of the backward kernel: the VJP of
    :func:`fused_render_reference` for cotangent ``ct`` (the forward's
    layout), taken with ``torch.autograd.grad``. Returns the 7 gradients,
    each shaped like its input."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (gry, grz, gty, gtz, amp, psi, omega)]
        h = fused_render_reference(*leaves, rx_shape, tx_shape, n_k, packed)
        return torch.autograd.grad(h, leaves, ct)


def fused_render_bwd(gry, grz, gty, gtz, amp, psi, omega, ct,
                     rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                     n_k: int, packed: bool):
    """Gradients of the 7 inputs of :func:`fused_render` for cotangent
    ``ct``, a contiguous float32 tensor in the forward's output layout.

    CUDA tensors launch the backward kernel on the current stream (no
    sync) or raise; CPU tensors take :func:`fused_render_bwd_reference`.
    """
    global BWD_LAUNCHES
    args = (gry, grz, gty, gtz, amp, psi, omega)
    u, p, n_s, n_sa = _check_inputs(args, rx_shape, tx_shape, n_k)
    r1, r2 = (int(x) for x in rx_shape)
    t1, t2 = (int(x) for x in tx_shape)
    q = r1 * r2 * t1 * t2
    dev = omega.device
    _check_layout("ct", ct, _out_shape(u, q, n_s * n_k, packed), dev)
    if dev.type == "cpu":
        return fused_render_bwd_reference(*args, ct, (r1, r2), (t1, t2),
                                          n_k, packed)
    _check_cuda(dev, (r1, r2), (t1, t2), p, n_k, n_s, "fused_render_bwd")
    grads = [torch.empty_like(x) for x in args]
    launch = _build.launcher("render_bwd", 15, 10)
    with torch.cuda.device(dev):
        rc = launch(*(x.data_ptr() for x in args), ct.data_ptr(),
                    *(g.data_ptr() for g in grads), u, p, r1, r2, t1, t2,
                    n_k, n_s, n_sa, int(bool(packed)),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render_bwd launch failed with CUDA error {rc}")
    BWD_LAUNCHES += 1
    return tuple(grads)


class FusedRender(torch.autograd.Function):
    """The fused render with its backward kernel (the counterpart of the
    JAX ``custom_vjp``). Saves the 7 per-path inputs, never H."""

    @staticmethod
    def forward(ctx, gry, grz, gty, gtz, amp, psi, omega, rx_shape,
                tx_shape, n_k, packed):
        args = (gry, grz, gty, gtz, amp, psi, omega)
        ctx.save_for_backward(*args)
        ctx.meta = (rx_shape, tx_shape, n_k, packed)
        return _render(args, rx_shape, tx_shape, n_k, packed, None)

    @staticmethod
    def backward(ctx, ct):
        # Cotangents of mean/expand arrive strided; the kernel reads dense.
        ct = ct.to(torch.float32).contiguous()
        grads = fused_render_bwd(*ctx.saved_tensors, ct, *ctx.meta)
        return (*grads, None, None, None, None)


def fused_render(gry, grz, gty, gtz, amp, psi, omega,
                 rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                 n_k: int, packed: bool,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused channel render from per-path scalars -> H planes (float32).

    Inputs as in :func:`fused_render_reference`, float32, contiguous, all
    on one device; invalid paths carry zeros. Returns packed
    [U, Q, 2*S*K] or stacked [2, U, Q, S*K], written into ``out`` when it
    is given (it must have that shape, float32, contiguous, same device).

    Differentiable through :class:`FusedRender`. ``out=`` writes in place
    outside autograd, so it raises when an input requires grad.
    CUDA tensors launch the kernels on the current stream (no sync) or
    raise; CPU tensors take the plain versions.
    """
    args = (gry, grz, gty, gtz, amp, psi, omega)
    if out is None:
        return FusedRender.apply(*args, rx_shape, tx_shape, n_k, packed)
    if torch.is_grad_enabled() and any(
            getattr(x, "requires_grad", False) for x in args):
        raise ValueError("fused_render(out=...) cannot record gradients: "
                         "an input requires grad; call it without out=")
    return _render(args, rx_shape, tx_shape, n_k, packed, out)
