"""Fused path->channel render: per-path scalars in, H planes out, and its
backward.

Kernels: ``csrc/render_fwd.cu`` and ``csrc/render_bwd.cu`` (with the shared
header ``csrc/render_tables.cuh``), hand-written CUDA C++ for Hopper
(``sm_90a``), built with nvcc at first use and called through ctypes.

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
  3.35 TB/s) and the backward reads the cotangent once (the same bytes).
  Their 1.07e11 and 2.15e11 flop take 0.65 and 1.3 ms at f32 grade on
  the tensor cores (3 TF32 passes at 495 TFLOP/s), so bytes bound both
  (the backward about equally with its products).
- What the design does about it: each product is a real GEMM per tile
  on the tensor cores in 3xTF32 (each operand split into tf32 hi and lo,
  lo*hi + hi*lo + hi*hi in FP32 accumulators, ~2^-21 relative; no
  one-pass TF32 and no FP32-FMA main loop). The forward has two designs
  behind one launcher, picked by :func:`tensor_core_route` from dtype,
  mode and shape alone: float32 output at f32 grade on panels of 48 rows
  or more (the headline's 8 x 8 among them) runs the path sum as
  warpgroup GEMMs on ``wgmma``
  (``tc::render_fwd_kernel_tc``: E built once per user and row tile and
  kept for every slot and column tile, G by the beam gain's producer,
  2.1 ms at the headline against 4.2); everything else, and the
  backward, runs ``mma.sync`` m16n8k8, as below. ``TC_LAUNCHES`` counts
  the launches of the ``wgmma`` design. Tiles of 64 rows
  x 64 columns and chunks of 32 paths keep shared memory bounded, so the
  kernels take any Q, S*K and P. E and g come from per-tile tables
  (separable panel responses, a fine and a coarse OFDM table, as the TPU
  kernel's ``_panel_er_ei`` and ``_ofdm_tables``): 4x fewer ``sincosf``
  than one per element, all with full range reduction. Both kernels are
  warp-specialised persistent blocks: producer warps stage a tile's
  operands into one of two stages while consumer warps run the mma on
  the other. The forward's operands are split once as they are staged
  and its accumulators go to HBM as 16-byte streaming stores; the
  backward splits the cotangent tile once (both products read it, dG
  transposed) and folds each tile's partial dE rows and dG columns
  straight into per-path sums (the chains are linear), one owner lane
  per path, no atomics.
  No TPU lane packing, bf16 hi/lo concat-dot or Chebyshev recurrence is
  carried over.
- Modes, as the TPU kernels' ``mm_dtype`` and ``out_dtype``:
  ``mm_dtype`` "float32" and "highest" run the 3xTF32 product (at least
  f32 grade; the TPU's "highest" is 6 bf16 passes); "bfloat16" and
  "default" run one pass on operands rounded to bf16 (RNE), accumulated
  in f32, as the TPU kernel's one-pass dot (``_dot_mode``): one TF32
  ``mma.sync`` pass over bf16-rounded values, whose products are exact in
  FP32, so the numbers of a BF16 tensor-core pass. ``out_dtype``
  "bfloat16" stores H in bf16 from the f32 accumulators (the backward
  then takes the cotangent widened to f32).

:func:`fused_render` is the ``apply`` of :class:`FusedRender`, a
``torch.autograd.Function``: CUDA tensors launch the forward kernel and,
under autograd, the backward kernel; anything a kernel does not take
raises. CPU tensors take the plain versions :func:`fused_render_reference`
and :func:`fused_render_bwd_reference`. ``LAUNCHES`` and ``BWD_LAUNCHES``
count kernel launches, ``MODE_LAUNCHES`` and ``BWD_MODE_LAUNCHES`` the
launches of each mode (:func:`mode_key`; the forward's launches that
took the ``wgmma`` design count under "tc" instead, as in ``TC_LAUNCHES``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ...utils.profiling import span

#: Number of forward kernel launches (``csrc/render_fwd.cu``).
LAUNCHES = 0
#: Number of backward kernel launches (``csrc/render_bwd.cu``).
BWD_LAUNCHES = 0
#: Forward and backward launches of each mode, keyed by :func:`mode_key`,
#: the forward's launches of the tensor-core design under "tc" instead.
MODE_LAUNCHES: dict = {}
BWD_MODE_LAUNCHES: dict = {}
#: Forward launches that took the tensor-core design
#: (:func:`tensor_core_route`).
TC_LAUNCHES = 0

#: Product passes of each ``matmul_dtype``: 3xTF32, or one pass on bf16
#: operands.
MM_PASSES = {"float32": 3, "highest": 3, "bfloat16": 1, "default": 1}
#: Output dtypes of the forward.
OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Largest dynamic shared memory a block may opt into on Hopper (bytes).
SMEM_LIMIT = 232_448
#: Largest Q and S*K the kernels index (C ints).
INDEX_LIMIT = 2**31 - 1

# Tiles of the kernels (csrc/render_tables.cuh): paths per chunk, rows
# and columns per tile, fine OFDM table length, plane row.
_PC, _MT, _NT, _L = 32, 64, 64, 8
_ES = _PC + 4


def _table_entries(rx_shape, tx_shape, n_k: int, n_snap: int,
                   backward: bool) -> int:
    """Trig table entries per path of any tile (``panel_cap`` +
    ``ofdm_cap`` of render_tables.cuh; ``table_cap`` of render_bwd.cu,
    whose tiles lie in one slot)."""
    t1 = tx_shape[0]
    q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
    panel = min(t1, _MT) + min(-(-q // t1), (_MT - 1) // t1 + 2)
    k2 = -(-n_k // _L)
    if backward:
        return panel + min(_L, n_k) + min(k2, (_NT - 1) // _L + 2)
    segs = min(n_snap, (_NT - 1) // n_k + 2)
    groups = min(_NT, n_snap * k2, ((_NT - 1) // _L + 2) * segs)
    return panel + min(_L, n_k) + groups


def smem_bytes(rx_shape, tx_shape, n_k: int, n_snap: int = 1,
               backward: bool = False) -> int:
    """Dynamic shared memory of one block of the forward (or backward)
    kernel, as its launcher computes it: two stages of operands (the
    forward's E and g planes split into tf32 hi and lo; the backward's
    split cotangent tile and plain E and U planes), the per-path partial
    sums of the backward, and the staged scalars, tile indices and trig
    tables of each producer team (two in the forward, one in the
    backward). It does not grow with P."""
    tables = 2 * _PC * _table_entries(rx_shape, tx_shape, n_k, n_snap,
                                      backward)
    per_team = tables + 2 * 5 * _PC + _MT + _NT
    if backward:
        stage = 4 * _MT * _NT + 2 * 2 * _MT * _ES + _PC
        floats = 2 * stage + 2 * 2 * _PC * 8 + per_team
    else:
        floats = 4 * 4 * _MT * _ES + 2 * per_team
    return 4 * floats


def kernel_fits(rx_shape, tx_shape, n_paths: int, n_k: int,
                n_snap: int = 1) -> bool:
    """Do the CUDA kernels take this shape? (Device-independent.)

    Both walk P in chunks and Q and S*K in tiles, so shared memory stays
    bounded (219,136 bytes for the backward at the headline, at most
    232,192 at the largest tables, under ``SMEM_LIMIT``) and every P is
    taken. The bounds left are the kernels' C ints: Q and S*K must each
    fit in one.
    """
    dims = (*rx_shape, *tx_shape)
    if n_paths < 1 or n_k < 1 or n_snap < 1 or min(dims) < 1:
        return False
    q = dims[0] * dims[1] * dims[2] * dims[3]
    return (q <= INDEX_LIMIT and n_snap * n_k <= INDEX_LIMIT and
            smem_bytes(rx_shape, tx_shape, n_k, n_snap, backward=True)
            <= SMEM_LIMIT)


def mm_passes(mm_dtype: str) -> int:
    """Product passes of ``mm_dtype`` (:data:`MM_PASSES`); ValueError for
    any other string, as the JAX kernels' ``_dot_mode``."""
    if mm_dtype not in MM_PASSES:
        raise ValueError(
            f"matmul_dtype={mm_dtype!r}: expected one of 'float32' or "
            f"'highest' (3xTF32, f32 grade), 'bfloat16' or 'default' (one "
            f"pass on bf16 operands)")
    return MM_PASSES[mm_dtype]


def mode_key(mm_dtype: str = "float32", out_dtype: str = "float32") -> str:
    """Name of a kernel mode: "f32", or "bf16_mm", "bf16_out" and
    "bf16_mm+bf16_out" for the one-pass product and the bf16 output."""
    parts = (["bf16_mm"] if mm_passes(mm_dtype) == 1 else []) + \
        (["bf16_out"] if out_torch_dtype(out_dtype) == torch.bfloat16
         else [])
    return "+".join(parts) or "f32"


def _count(counts: dict, key: str) -> None:
    counts[key] = counts.get(key, 0) + 1


def out_torch_dtype(out_dtype: str) -> torch.dtype:
    """The torch dtype of ``out_dtype`` (:data:`OUT_DTYPES`); ValueError
    for any other string."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype={out_dtype!r}: expected 'float32' or "
                         f"'bfloat16'")
    return OUT_DTYPES[out_dtype]


def operand_rounding(mm_dtype: str):
    """What a product of ``mm_dtype`` does to its float32 operands in the
    plain versions: nothing (3 passes, f32 grade), or round to bf16 (RNE)
    and back, so that the f32 product that follows is the one-pass
    product's."""
    if mm_passes(mm_dtype) == 3:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).to(x.dtype)


def response(ky, kz, m1: int, m2: int):
    """Panel response planes (cos, sin) [U, M1*M2, P] of phase steps ky,
    kz [U, P], element n*M1 + m at phase m*ky + n*kz."""
    u, p = ky.shape
    m = torch.arange(m1, dtype=ky.dtype, device=ky.device)
    n = torch.arange(m2, dtype=ky.dtype, device=ky.device)
    ph = (m[None, :, None, None] * ky[:, None, None, :] +
          n[None, None, :, None] * kz[:, None, None, :])
    ph = ph.transpose(1, 2).reshape(u, m1 * m2, p)
    return torch.cos(ph), torch.sin(ph)


def ofdm_gains(amp, psi, omega, n_k: int):
    """OFDM gain planes (gr, gi) [U, S, P, K]: amp e^{j(psi_s - omega k)}
    with amp [U, P] or [U, S*P]."""
    u, p = omega.shape
    n_s, n_sa = psi.shape[1] // p, amp.shape[1] // p
    ks = torch.arange(n_k, dtype=amp.dtype, device=amp.device)
    base = (psi.reshape(u, n_s, p)[..., None] -
            omega[:, None, :, None] * ks)                    # [u, s, p, k]
    amp_b = amp.reshape(u, n_sa, p)[..., None]
    return amp_b * torch.cos(base), amp_b * torch.sin(base)


def fused_render_reference(gry, grz, gty, gtz, amp, psi, omega,
                           rx_shape: Tuple[int, int],
                           tx_shape: Tuple[int, int], n_k: int,
                           packed: bool,
                           mm_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the kernel (``_reference_impl``'s math).

    Args:
        gry/grz, gty/gtz: RX/TX wave-vector phase steps per path [U, P].
        amp: linear amplitude [U, P], or [U, S*P] per snapshot slot.
        psi: phase at subcarrier 0 [U, S*P] (S snapshots along k).
        omega: phase slope per subcarrier step [U, P].
        rx_shape/tx_shape: panel shapes (M1, M2); n_k: subcarriers.
        packed: return [U, Q, 2*S*K] (hr | hi on the minor axis) instead
            of stacked [2, U, Q, S*K].
        mm_dtype: the product's operands E and g are rounded to bf16 for
            "bfloat16" and "default" (:func:`operand_rounding`); the
            product itself is float32.
    Returns float32 planes.
    """
    rnd = operand_rounding(mm_dtype)
    u, p = omega.shape
    n_s = psi.shape[1] // p
    arx_r, arx_i = response(gry, grz, *rx_shape)
    atx_r, atx_i = response(gty, gtz, *tx_shape)
    q = arx_r.shape[1] * atx_r.shape[1]
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :]).reshape(u, q, p)
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :]).reshape(u, q, p)
    gr, gi = ofdm_gains(amp, psi, omega, n_k)
    er, ei, gr, gi = rnd(er), rnd(ei), rnd(gr), rnd(gi)

    def mm(a, b):
        return torch.einsum("uqp,uspk->uqsk", a, b).reshape(u, q, n_s * n_k)

    hr = mm(er, gr) - mm(ei, gi)
    hi = mm(er, gi) + mm(ei, gr)
    return torch.cat((hr, hi), dim=-1) if packed else torch.stack((hr, hi))


def _check_inputs(args, rx_shape, tx_shape, n_k,
                  dtypes=(torch.float32,)):
    """(U, P, S, n_sa) of the 7 per-path inputs, all of one dtype among
    ``dtypes``, or TypeError/ValueError."""
    names = ("gry", "grz", "gty", "gtz", "amp", "psi", "omega")
    omega = args[-1]
    if omega.dim() != 2:
        raise ValueError(f"omega must be [U, P]; got {tuple(omega.shape)}")
    u, p = omega.shape
    want = omega.dtype if omega.dtype in dtypes else dtypes[0]
    for name, x in zip(names, args):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != want:
            raise TypeError(f"{name} must be {want} (one of {dtypes}, like "
                            f"omega); got {x.dtype}")
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


def _check_layout(name, x, shape, dev, dtype=torch.float32):
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or
            x.device != dev or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                         f"tensor on {dev}; got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")


def tensor_core_route(rx_shape, tx_shape, mm_dtype: str = "float32",
                      out_dtype: str = "float32") -> bool:
    """Does the forward kernel run its tensor-core design at this shape?

    Float32 output at f32 grade (``mm_dtype`` "float32"/"highest") on
    panels of Q = R*T >= 48 rows. There the tensor-core design took
    0.43-0.99 of the ``mma.sync`` design's time on an H100 at every shape
    measured (Q = 48 to 144, K = 1 to 100, 10 to 40 paths, 1 to 4 slots,
    separable panels or not; tools/render_crossover.py, PERF.md). The
    bf16 modes and the small panels (Q < 48, the quickstart's 8 x 1 among
    them) run the ``mma.sync`` design, as before the tensor-core design
    came. Reads the dtype, the mode and the shape alone;
    :func:`kernel_fits` decides what the kernel takes at all."""
    q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
    return (mm_passes(mm_dtype) == 3 and
            out_torch_dtype(out_dtype) == torch.float32 and q >= 48)


def _check_cuda(dev, rx_shape, tx_shape, p, n_k, n_s, what):
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")
    if not kernel_fits(rx_shape, tx_shape, p, n_k, n_s):
        q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
        raise ValueError(
            f"shape exceeds the kernel's limits: Q={q}, S*K={n_s * n_k}, "
            f"P={p} (Q and S*K must each be <= {INDEX_LIMIT})")


def _launch_fwd(args, out, u, p, r1, r2, t1, t2, n_k, n_s, n_sa, packed,
                passes, out_bf16, tensor_cores):
    """One launch of ``render_fwd_launch`` (the only place that spells its
    C signature) on ``out``'s device and current stream, on the
    tensor-core design if ``tensor_cores`` else on ``mma.sync``; counts
    nothing (:func:`_render` counts the library's launches)."""
    dev = out.device
    with span("dm.kernel.render_fwd"), torch.cuda.device(dev):
        launch = _build.launcher("render_fwd", 8, 13)
        rc = launch(*(x.data_ptr() for x in args), out.data_ptr(), u, p,
                    r1, r2, t1, t2, n_k, n_s, n_sa, int(bool(packed)),
                    passes, int(bool(out_bf16)), int(bool(tensor_cores)),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render_fwd launch failed with CUDA error {rc}")


def _render(args, rx_shape, tx_shape, n_k, packed, out, mm_dtype="float32",
            out_dtype="float32"):
    """The forward without autograd: kernel on CUDA, plain on the CPU."""
    global LAUNCHES, TC_LAUNCHES
    u, p, n_s, n_sa = _check_inputs(args, rx_shape, tx_shape, n_k)
    passes = mm_passes(mm_dtype)
    dtype = out_torch_dtype(out_dtype)
    r1, r2 = (int(x) for x in rx_shape)
    t1, t2 = (int(x) for x in tx_shape)
    q, sk = r1 * r2 * t1 * t2, n_s * n_k
    shape = _out_shape(u, q, sk, packed)
    dev = args[-1].device
    if out is not None:
        _check_layout("out", out, shape, dev, dtype)
    if dev.type == "cpu":
        h = fused_render_reference(*args, (r1, r2), (t1, t2), n_k, packed,
                                   mm_dtype).to(dtype)
        return h if out is None else out.copy_(h)
    _check_cuda(dev, (r1, r2), (t1, t2), p, n_k, n_s, "fused_render")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    tc = tensor_core_route((r1, r2), (t1, t2), mm_dtype, out_dtype)
    _launch_fwd(args, out, u, p, r1, r2, t1, t2, n_k, n_s, n_sa, packed,
                passes, dtype == torch.bfloat16, tc)
    LAUNCHES += 1
    TC_LAUNCHES += tc
    _count(MODE_LAUNCHES, "tc" if tc else mode_key(mm_dtype, out_dtype))
    return out


def fused_render_bwd_reference(gry, grz, gty, gtz, amp, psi, omega, ct,
                               rx_shape: Tuple[int, int],
                               tx_shape: Tuple[int, int], n_k: int,
                               packed: bool, mm_dtype: str = "float32"):
    """Plain PyTorch version of the backward kernel: the VJP of
    :func:`fused_render_reference` for cotangent ``ct`` (the forward's
    layout), written out as the kernel computes it. With c = cr + j ci,
    E = e^{j phi} and g = a U, U = e^{j b}, per slot s:

        dE = c . conj(U) (contract k),   dG = c^T . conj(E) (contract q),
        dphi = sum_s a (E_r dE_i - E_i dE_r),
        damp = sum_k dG_r U_r + dG_i U_i,  w = a (U_r dG_i - U_i dG_r),
        dpsi = sum_k w,  domega = -sum_{s,k} k w,

    and dphi folded over q by each phase step's element index. For
    ``mm_dtype`` "bfloat16"/"default" the two products take c, U and E
    rounded to bf16 (:func:`operand_rounding`); the chains stay f32.
    Returns the 7 gradients, each shaped like its input.
    """
    rnd = operand_rounding(mm_dtype)
    u, p = omega.shape
    n_s, n_sa = psi.shape[1] // p, amp.shape[1] // p
    (r1, r2), (t1, t2) = rx_shape, tx_shape
    t, sk = t1 * t2, n_s * n_k
    q = r1 * r2 * t
    cr, ci = (ct[..., :sk], ct[..., sk:]) if packed else (ct[0], ct[1])
    cr, ci = (rnd(x.reshape(u, q, n_s, n_k)) for x in (cr, ci))
    iq = torch.arange(q, device=omega.device)
    it, ir = iq % t, iq // t
    idx = [(x % m1).to(omega.dtype) for x, m1 in ((it, t1), (ir, r1))]
    idx += [(x // m1).to(omega.dtype) for x, m1 in ((it, t1), (ir, r1))]
    m_t, m_r, n_t, n_r = idx                                 # [Q] each
    phi = (m_t[None, :, None] * gty[:, None] + n_t[None, :, None] * gtz[:, None]
           + m_r[None, :, None] * gry[:, None] +
           n_r[None, :, None] * grz[:, None])                # [u, q, p]
    er, ei = torch.cos(phi), torch.sin(phi)
    ks = torch.arange(n_k, dtype=omega.dtype, device=omega.device)
    b = (psi.reshape(u, n_s, p)[:, :, None, :] -
         omega[:, None, None, :] * ks[:, None])              # [u, s, k, p]
    ur, ui = torch.cos(b), torch.sin(b)
    a = amp.reshape(u, n_sa, p)[:, :, None, :]               # [u, s|1, 1, p]

    def de(x, y):                        # contract k -> [u, q, s, p]
        return torch.einsum("uqsk,uskp->uqsp", x, y)

    def dg(x, y):                        # contract q -> [u, s, k, p]
        return torch.einsum("uqsk,uqp->uskp", x, y)

    urr, uir, err, eir = rnd(ur), rnd(ui), rnd(er), rnd(ei)
    de_r = de(cr, urr) + de(ci, uir)
    de_i = de(ci, urr) - de(cr, uir)
    dphi = (a[:, None, :, 0] * (er[:, :, None] * de_i -
                                ei[:, :, None] * de_r)).sum(2)
    dg_r = dg(cr, err) + dg(ci, eir)
    dg_i = dg(ci, err) - dg(cr, eir)
    damp = (dg_r * ur + dg_i * ui).sum(2)                    # [u, s, p]
    w = a * (ur * dg_i - ui * dg_r)                          # [u, s, k, p]

    def fold(x):
        return torch.einsum("uqp,q->up", dphi, x)

    return (fold(m_r), fold(n_r), fold(m_t), fold(n_t),
            damp.reshape(u, n_s * p) if n_sa > 1 else damp.sum(1),
            w.sum(2).reshape(u, n_s * p),
            -torch.einsum("uskp,k->up", w, ks))


def fused_render_bwd(gry, grz, gty, gtz, amp, psi, omega, ct,
                     rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                     n_k: int, packed: bool, mm_dtype: str = "float32"):
    """Gradients of the 7 inputs of :func:`fused_render` for cotangent
    ``ct``, a contiguous float32 tensor in the forward's output layout,
    with the products of ``mm_dtype`` (:data:`MM_PASSES`).

    CUDA tensors launch the backward kernel on the current stream (no
    sync) or raise; CPU tensors take :func:`fused_render_bwd_reference`.
    """
    global BWD_LAUNCHES
    args = (gry, grz, gty, gtz, amp, psi, omega)
    u, p, n_s, n_sa = _check_inputs(args, rx_shape, tx_shape, n_k)
    passes = mm_passes(mm_dtype)
    r1, r2 = (int(x) for x in rx_shape)
    t1, t2 = (int(x) for x in tx_shape)
    q = r1 * r2 * t1 * t2
    dev = omega.device
    if dev.type != "cpu":
        _check_cuda(dev, (r1, r2), (t1, t2), p, n_k, n_s, "fused_render_bwd")
    _check_layout("ct", ct, _out_shape(u, q, n_s * n_k, packed), dev)
    if dev.type == "cpu":
        return fused_render_bwd_reference(*args, ct, (r1, r2), (t1, t2),
                                          n_k, packed, mm_dtype)
    grads = [torch.empty_like(x) for x in args]
    with span("dm.kernel.render_bwd"), torch.cuda.device(dev):
        launch = _build.launcher("render_bwd", 15, 11)
        rc = launch(*(x.data_ptr() for x in args), ct.data_ptr(),
                    *(g.data_ptr() for g in grads), u, p, r1, r2, t1, t2,
                    n_k, n_s, n_sa, int(bool(packed)), passes,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render_bwd launch failed with CUDA error {rc}")
    BWD_LAUNCHES += 1
    _count(BWD_MODE_LAUNCHES, mode_key(mm_dtype))
    return tuple(grads)


class FusedRender(torch.autograd.Function):
    """The fused render with its backward kernel (the counterpart of the
    JAX ``custom_vjp``). Saves the 7 per-path inputs, never H."""

    @staticmethod
    def forward(ctx, gry, grz, gty, gtz, amp, psi, omega, rx_shape,
                tx_shape, n_k, packed, mm_dtype, out_dtype):
        args = (gry, grz, gty, gtz, amp, psi, omega)
        ctx.save_for_backward(*args)
        ctx.meta = (rx_shape, tx_shape, n_k, packed, mm_dtype)
        return _render(args, rx_shape, tx_shape, n_k, packed, None,
                       mm_dtype, out_dtype)

    @staticmethod
    def backward(ctx, ct):
        # Cotangents of mean/expand arrive strided, and those of a bf16
        # output in bf16; the kernel reads dense float32.
        ct = ct.to(torch.float32).contiguous()
        grads = fused_render_bwd(*ctx.saved_tensors, ct, *ctx.meta)
        return (*grads, None, None, None, None, None, None)


def fused_render(gry, grz, gty, gtz, amp, psi, omega,
                 rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                 n_k: int, packed: bool,
                 out: Optional[torch.Tensor] = None,
                 mm_dtype: str = "float32",
                 out_dtype: str = "float32") -> torch.Tensor:
    """Fused channel render from per-path scalars -> H planes.

    Inputs as in :func:`fused_render_reference`, float32, contiguous, all
    on one device; invalid paths carry zeros. Returns packed
    [U, Q, 2*S*K] or stacked [2, U, Q, S*K] in ``out_dtype`` ("float32"
    or "bfloat16"), written into ``out`` when it is given (it must have
    that shape and dtype, contiguous, same device). ``mm_dtype`` picks the
    product (:data:`MM_PASSES`): "float32"/"highest" 3xTF32,
    "bfloat16"/"default" one pass on bf16 operands; others raise
    ValueError.

    Differentiable through :class:`FusedRender` (the backward runs the
    same ``mm_dtype``). ``out=`` writes in place outside autograd, so it
    raises when an input requires grad. CUDA tensors launch the kernels on
    the current stream (no sync) or raise; CPU tensors take the plain
    versions.
    """
    args = (gry, grz, gty, gtz, amp, psi, omega)
    if out is None:
        return FusedRender.apply(*args, rx_shape, tx_shape, n_k, packed,
                                 mm_dtype, out_dtype)
    if torch.is_grad_enabled() and any(
            getattr(x, "requires_grad", False) for x in args):
        raise ValueError("fused_render(out=...) cannot record gradients: "
                         "an input requires grad; call it without out=")
    return _render(args, rx_shape, tx_shape, n_k, packed, out, mm_dtype,
                   out_dtype)
