"""Fused beam-gain maps: per-path scalars and a codebook in,
G = |conj(W) . H|^2 out, without H.

Kernel: ``csrc/beamgain.cu``, hand-written CUDA C++ for Hopper
(``sm_90a``), built with nvcc at first use and called through ctypes.

Source note.

- Replaces the TPU kernel ``deepmimo_tpu/ops/pallas/beamgain.py::_bg_kernel``
  (with ``_bg_kernel_norx``; wrapper ``_fused_beam_gain_impl``, public
  ``fused_beam_gain``). It computes exactly ``beam_gain_reference``: the
  codebook folds into the path sum, eb = conj(W) a_tx [B, P], E = a_rx (x)
  eb [R*B, P], and G = |E g^T|^2 [R*B, S*K] per user, rows r-major
  (q = r*B + b).
- What bounds it on an H100: operations. At the headline (131,072 users,
  P = 25, T = 64, R = 1, K = 64) with 16 beams the fold and the path sum
  are 2 x 102,400 FP32 FMA per user: 0.81 ms at 67 TFLOP/s, 0.33 ms at
  3xTF32 on the tensor cores' nominal 495 TFLOP/s; the output is 0.54 GB,
  0.16 ms at 3.35 TB/s. With 64 beams each product is four times that:
  3.2 ms as FP32 FMA, 1.67 ms at 3xTF32 (P padded to 32).
- What the design does about it: three designs, one launcher, picked by
  :func:`tensor_core_route` from dtype, mode and shape alone.

  - SIMT (float64, the bf16 mode, codebooks under :data:`TC_MIN_BEAMS`
    beams, panels past :data:`TC_WIDE_MAX_TX` elements, and the shapes at
    which it is the faster: small panels or few paths with few beams, as
    the quickstart's 8 x 1 panel at 32 beams): the products are small
    per user and mma.sync TF32 runs at half its nominal rate on these
    shapes, so they run as FP32 FMA, and the instructions issued beside
    them are what the design cuts. Persistent blocks of up to 8 warps, one
    warp per user at a time and no block barrier after conj(W) is staged
    once per block (the wrapper interleaves it as [T, B, 2], one small op
    per call); paths in chunks of 32, lane = path, so shared memory does
    not grow with P; separable trig tables (a_tx from 8 + T2 sincosf, g
    from 8 fine and 8 coarse per slot), 32 sincosf per path at the
    headline; register tiles in which each 16-byte shared load feeds 8 or
    more FMA.
  - Tensor cores (float32 at f32 grade, from :data:`TC_MIN_BEAMS` beams
    and panels of up to :data:`TC_MAX_TX` elements, where the cost models,
    fitted on an H100, give it the smaller time):
    per user and 64-beam tile, the fold and the path sum as chained real
    GEMMs on ``wgmma`` at 3xTF32, conj(W) split once per block into shared
    memory, a_tx and g built by producer warps from separable trig tables,
    E passed from the fold's accumulators to the path sum's A operands in
    registers, |y|^2 formed in registers; one block per SM.
    ``TC_LAUNCHES`` counts its launches. At the headline with 64 beams it
    takes 3.3 ms to the SIMT design's 7.4 ms; with the products on the
    tensor cores, the producers' work and the products contend for the
    SM.
  - Wide tensor cores (float32 at f32 grade, from :data:`TC_MIN_BEAMS`
    beams, panels of :data:`TC_MAX_TX` + 1 to :data:`TC_WIDE_MAX_TX`
    elements, where the cost models give it the smaller time, and every
    such shape past the SIMT design's shared memory): a 64-beam codebook
    tile at T = 256 would take 256 KB in its four 3xTF32 planes, and
    re-read per user from L2 it would move 1 MB a user. So the tile is 32
    beams, whose real and imaginary rows make the products' 64 rows, and
    it stays in shared memory (128 KB at T = 256) for every user the
    block takes with it, while a_tx passes through in slices of 32
    elements; the path sum takes E as the real form [[Er, -Ei], [Ei, Er]]
    straight from the fold's accumulators. Counted under
    ``MODE_LAUNCHES["tc_wide"]``.

  The TPU's lane packing, hi/lo split, ``pltpu.roll`` reassembly and VMEM
  budget (``pick_user_tile_bg``, ``vmem_estimate_bg``, ``pad_store``) are
  not carried over; :func:`beam_gain_fits` is the SIMT design's
  shared-memory bound, widened by what the tensor-core designs take.
- Modes, as the TPU kernel's ``mm_dtype``: "float32" and "highest" keep
  every product f32 grade; "bfloat16" and "default" round the path sum's
  operands, E = a_rx (x) eb and g, to bf16 (RNE) before its FP32 FMAs,
  as the TPU kernel rounds them for its one-pass dot (``beamgain.py:132-
  135``). The codebook fold stays f32 grade in every mode: the TPU kernel
  runs it at HIGHEST for "float32", and at DEFAULT for the others, which
  is one pass on the TPU but f32 in the interpret mode the port is held
  against on the CPU.
- Scalar type: float64 inputs (complex128 configs, which the JAX package
  sends to the same TPU kernel) run the kernel's float64 instantiation,
  every product and sincos in FP64, at "float32" and "highest" only. Its
  complex buffers are twice the bytes, so :func:`smem_bytes` halves the
  codebook it takes (T*B <= 14,240).

:func:`fused_beam_gain` is the ``apply`` of :class:`FusedBeamGain`: CUDA
tensors launch the kernel or raise, CPU tensors take the plain version
:func:`beam_gain_reference`. Its backward is the VJP of the plain version,
recomputed, as in the JAX package (which has no backward kernel here).
``LAUNCHES`` counts kernel launches, ``MODE_LAUNCHES`` those of each mode
(:func:`beam_gain_mode`: "f32", "bf16_mm" or "f64", whether the SIMT or
the tensor-core design ran; "tc_wide" for the wide tensor-core design in
place of its mode) and ``TC_LAUNCHES`` those of the tensor-core design.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ...utils.profiling import span
from .render import (SMEM_LIMIT, _check_inputs, _check_layout, _count,
                     mm_passes, mode_key, ofdm_gains, operand_rounding,
                     response)

#: Number of CUDA kernel launches made by :func:`fused_beam_gain`.
LAUNCHES = 0
#: Launches of each mode, keyed by ``render.mode_key``.
MODE_LAUNCHES: dict = {}
#: Launches that took the tensor-core design (:func:`tensor_core_route`).
TC_LAUNCHES = 0

#: The launcher's design codes (``mode`` of ``beamgain_launch``): the SIMT
#: design in float32, with bf16 path-sum operands and in float64, keyed as
#: ``MODE_LAUNCHES``, and the tensor-core designs.
DESIGNS = {"f32": 0, "bf16_mm": 1, "f64": 2, "tc": 3, "tc_wide": 4}

#: Fewest beams that take the tensor-core design: 16 beams fill a quarter
#: of its 64-row tile.
TC_MIN_BEAMS = 32
#: Most TX elements (T) whose codebook tile the tensor-core design stages.
TC_MAX_TX = 64
#: Most TX elements of the wide tensor-core design: its 32-beam codebook
#: tile in two 3xTF32 planes (512 T bytes), two a_tx slices and two g
#: stages fill 227 KB of shared memory at T = 256 (229,376 bytes).
TC_WIDE_MAX_TX = 256

#: What the kernel takes, for the messages of the shapes it refuses.
TAKES = (f"the kernel takes T*B <= 28,768 in float32 (14,240 in float64), "
         f"and any number of beams in float32 at f32 grade (matmul_dtype "
         f"'float32' or 'highest') up to T = {TC_WIDE_MAX_TX} TX elements")

_MAX_WARPS = 8          # warps per block
_PITCH = 18             # complex entries per row of a warp's two buffers


def smem_bytes(rx_shape, tx_shape, n_beams: int, n_paths: int,
               n_k: int, f64: bool = False) -> int:
    """Shared memory of one block (mirrors ``plan`` in
    ``csrc/beamgain.cu``): conj(W) [T, B] complex, rounded up to 16 bytes,
    then per warp two [chunk, 18] complex buffers (E of one 16-row tile and
    the OFDM tables of one 64-column tile); a complex entry is 8 bytes, 16
    with ``f64``. The chunk is 32 paths, or 8 when a codebook leaves no
    room for one warp of 32; then as many warps as fit, at most 8. Neither
    the paths, the RX elements, the subcarriers nor the slots count; past
    the bound it returns the bytes of one warp of 8 paths, which do not
    fit."""
    del rx_shape, n_paths, n_k
    t = tx_shape[0] * tx_shape[1]
    ce = 16 if f64 else 8
    cw = 16 * -(-t * n_beams * ce // 16)
    for chunk in (32, 8):
        per_warp = 2 * ce * chunk * _PITCH
        if cw + per_warp <= SMEM_LIMIT:
            return cw + min(_MAX_WARPS, (SMEM_LIMIT - cw) // per_warp) * \
                per_warp
    return cw + 2 * ce * 8 * _PITCH


def _tensor_cores_take(tx_shape, n_beams: int, mm_dtype: str,
                       dtype: torch.dtype) -> bool:
    """Float32 at f32 grade, at least :data:`TC_MIN_BEAMS` beams and at
    most :data:`TC_WIDE_MAX_TX` TX elements: a shape one of the
    tensor-core designs takes, with any number of beams, paths, RX
    elements, subcarriers and slots."""
    return (mm_passes(mm_dtype) == 3 and dtype == torch.float32 and
            n_beams >= TC_MIN_BEAMS and
            tx_shape[0] * tx_shape[1] <= TC_WIDE_MAX_TX)


def beam_gain_fits(rx_shape, tx_shape, n_beams: int, n_paths: int,
                   n_k: int, f64: bool = False,
                   mm_dtype: str = "float32") -> bool:
    """Does the CUDA kernel take this shape? (Device-independent.)

    The SIMT design's bound is its block's shared memory
    (:func:`smem_bytes` <= 227 KB), which holds conj(W) and one warp:
    T*B <= 28,768 (up to 449 beams of an 8 x 8 panel), 14,240 in float64
    (``f64``), with any number of paths, RX elements, subcarriers and
    slots. Past it, float32 at f32 grade (``mm_dtype`` "float32" or
    "highest") with at most :data:`TC_WIDE_MAX_TX` TX elements runs on the
    tensor cores, with any number of beams (16x16 panels with their
    256-beam grid among them); float64 and the one-pass bf16 mode do not.
    """
    if min(*rx_shape, *tx_shape, n_beams, n_paths, n_k) < 1:
        return False
    if smem_bytes(rx_shape, tx_shape, n_beams, n_paths, n_k,
                  f64) <= SMEM_LIMIT:
        return True
    return _tensor_cores_take(tx_shape, n_beams, mm_dtype,
                              torch.float64 if f64 else torch.float32)


def _simt_ns(r, t, b, k, p, s) -> float:
    """The SIMT design's time per user on an H100, in ns, fitted to the
    crossover (PERF.md): per 16-beam row tile of one RX element, the fold
    (0.80 + 0.094 T) and per slot and 64-column tile the path sum
    (1.23 + 0.224 P); past one chunk of 32 paths both for every chunk,
    slot and column tile, 1.86 times slower. Past 64 TX elements 1.27
    times that with one chunk (0.95 with more) and the plan's 8 warps a
    block, (8 / warps)^0.6 times more with fewer, and 36 times more where
    it takes chunks of 8 paths (:func:`smem_bytes`; T = 72 to 256,
    PERF.md)."""
    tiles, n_kt, n_ch = r * -(-b // 16), -(-k // 64), -(-p // 32)
    fold = 0.80 + 0.094 * t
    if n_ch == 1:
        ns = tiles * (fold + s * n_kt * (1.23 + 0.224 * p))
    else:
        ns = tiles * s * n_kt * n_ch * 1.86 * (fold + 1.23 + 0.224 * 32)
    if t <= TC_MAX_TX:
        return ns
    cw = 16 * -(-t * b * 8 // 16)
    warps = max(0, min(_MAX_WARPS,
                       (SMEM_LIMIT - cw) // (2 * 8 * 32 * _PITCH)))
    return ns * (1.27 if n_ch == 1 else 0.95) * (
        (_MAX_WARPS / warps) ** 0.6 if warps else 36.0)


def _tc_ns(r, tx_shape, b, k, p, s) -> float:
    """The tensor-core designs' time per user on an H100, in ns, fitted to
    the crossover (PERF.md). Up to :data:`TC_MAX_TX` TX elements, per
    64-beam tile, the fold (6.7 for T <= 32, 10.7 for 8-wide panels of
    more, else 14.2) and 13.6 per RX element, slot and 64-column tile;
    past one chunk of 32 paths both for every chunk, RX element, slot and
    column tile. The paths of a chunk cost the same whatever their number.
    Past it (the wide design), per 32-beam tile the fold in slices of 32
    TX elements (:func:`_tc_wide_ns`)."""
    t = tx_shape[0] * tx_shape[1]
    tiles, n_ch = -(-b // 64), -(-p // 32)
    steps = r * s * -(-k // 64)
    if t > TC_MAX_TX:
        return _tc_wide_ns(t, -(-b // 32), steps, n_ch)
    fold = 6.7 if t <= 32 else 10.7 if tx_shape[0] == 8 else 14.2
    if n_ch == 1:
        return tiles * (fold + steps * 13.6)
    return tiles * steps * n_ch * (fold + 13.6)


def _tc_wide_ns(t, tiles, steps, n_ch) -> float:
    """The wide tensor-core design's time per user on an H100, in ns,
    fitted to the crossover (PERF.md): per 32-beam tile the fold, 3.85 per
    slice of 32 TX elements, with 11.7 for the tile's first RX element,
    slot and 64-column tile and 21.1 for each other (there g's producers
    set the pace); past one chunk of 32 paths the fold and 11.7 for every
    chunk, RX element, slot and column tile."""
    fold = 3.85 * -(-t // 32)
    if n_ch == 1:
        return tiles * (fold + 11.7 + 21.1 * (steps - 1))
    return tiles * steps * n_ch * (fold + 11.7)


def tensor_core_route(rx_shape, tx_shape, n_beams: int, n_k: int,
                      n_paths: int, n_s: int, mm_dtype: str = "float32",
                      dtype: torch.dtype = torch.float32) -> bool:
    """Does a shape that the kernel takes run a tensor-core design?

    Float32 at f32 grade (``mm_dtype`` "float32"/"highest"), at least
    :data:`TC_MIN_BEAMS` beams, at most :data:`TC_WIDE_MAX_TX` TX
    elements, and either a shape past the SIMT design's shared memory or
    one at which the tensor cores' time per user is the smaller by the
    designs' cost models (:func:`_tc_ns`, :func:`_simt_ns`), fitted to
    their times on an H100 (:data:`TC_MAX_TX` TX elements or fewer: the
    tensor-core design, 80 points of 27 shapes; more: its wide design).
    Everything else (float64, the one-pass bf16 mode, small codebooks,
    panels past :data:`TC_WIDE_MAX_TX`, small panels with few beams or
    paths) runs the SIMT design. :func:`beam_gain_fits` decides what the
    kernel takes at all; this only picks the design.
    """
    if not _tensor_cores_take(tx_shape, n_beams, mm_dtype, dtype):
        return False
    r, t = rx_shape[0] * rx_shape[1], tx_shape[0] * tx_shape[1]
    if smem_bytes(rx_shape, tx_shape, n_beams, n_paths, n_k) > SMEM_LIMIT:
        return True
    return _tc_ns(r, tx_shape, n_beams, n_k, n_paths, n_s) < _simt_ns(
        r, t, n_beams, n_k, n_paths, n_s)


def beam_gain_design(rx_shape, tx_shape, n_beams: int, n_k: int,
                     n_paths: int, n_s: int, mm_dtype: str = "float32",
                     dtype: torch.dtype = torch.float32) -> str:
    """The key of :data:`DESIGNS` that a shape the kernel takes runs:
    "tc" or "tc_wide" where :func:`tensor_core_route` takes the tensor
    cores (by the panel's TX elements), else the SIMT design's mode
    (:func:`beam_gain_mode`)."""
    if tensor_core_route(rx_shape, tx_shape, n_beams, n_k, n_paths, n_s,
                         mm_dtype, dtype):
        t = tx_shape[0] * tx_shape[1]
        return "tc" if t <= TC_MAX_TX else "tc_wide"
    return beam_gain_mode(mm_dtype, dtype)


def beam_gain_mode(mm_dtype: str = "float32",
                   dtype: torch.dtype = torch.float32) -> str:
    """Key of ``MODE_LAUNCHES``: ``render.mode_key`` in float32, "f64" for
    the float64 instantiation (which runs "float32"/"highest" only;
    ValueError for a one-pass ``mm_dtype``)."""
    if dtype != torch.float64:
        return mode_key(mm_dtype)
    if mm_passes(mm_dtype) != 3:
        raise ValueError(f"matmul_dtype={mm_dtype!r}: the float64 beam-gain "
                         f"kernel has no bf16 mode; use 'float32'")
    return "f64"


def codebook_gain(wr, wi, hr, hi) -> torch.Tensor:
    """|conj(W) . H|^2 over the antenna axis: codebook planes wr/wi [B, T]
    and channel planes hr/hi [..., T, K] -> [..., B, K]."""
    def fold(w, x):
        return torch.einsum("bt,...tk->...bk", w, x)

    # conj(w) . h: re = wr.hr + wi.hi, im = wr.hi - wi.hr
    yr = fold(wr, hr) + fold(wi, hi)
    yi = fold(wr, hi) - fold(wi, hr)
    return yr * yr + yi * yi


def beam_gain_reference(gry, grz, gty, gtz, amp, psi, omega, wr, wi,
                        rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                        n_k: int, mm_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the kernel (``beam_gain_reference``'s
    function), factored as the kernel factors it: the codebook fold
    eb = conj(W) a_tx (f32), E = a_rx (x) eb, y = E g^T and G = |y|^2. For
    ``mm_dtype`` "bfloat16"/"default" the path sum's operands E and g are
    rounded to bf16 (:func:`..render.operand_rounding`), as the kernel
    rounds them.

    Args:
        gry..omega: the 7 per-path inputs of the fused render.
        wr/wi: codebook planes [B, T]; conj(w) is applied here, matching
            ``np.abs(H @ W.conj().T)**2``.

    Returns:
        G [U, R*B, S*K] in the inputs' dtype, rows r-major.
    """
    rnd = operand_rounding(mm_dtype)
    u, p = omega.shape
    n_s = psi.shape[1] // p
    atx_r, atx_i = response(gty, gtz, *tx_shape)             # [u, T, p]
    arx_r, arx_i = response(gry, grz, *rx_shape)             # [u, R, p]

    def fold(w, x):
        return torch.einsum("bt,utp->ubp", w, x)

    # conj(w) . a_tx: re = wr.ar + wi.ai, im = wr.ai - wi.ar
    ebr = fold(wr, atx_r) + fold(wi, atx_i)
    ebi = fold(wr, atx_i) - fold(wi, atx_r)
    er = (arx_r[:, :, None] * ebr[:, None] -
          arx_i[:, :, None] * ebi[:, None]).reshape(u, -1, p)
    ei = (arx_r[:, :, None] * ebi[:, None] +
          arx_i[:, :, None] * ebr[:, None]).reshape(u, -1, p)
    gr, gi = ofdm_gains(amp, psi, omega, n_k)               # [u, s, p, k]
    er, ei, gr, gi = rnd(er), rnd(ei), rnd(gr), rnd(gi)

    def mm(a, b):
        return torch.einsum("uqp,uspk->uqsk", a, b).reshape(
            u, a.shape[1], n_s * n_k)

    yr = mm(er, gr) - mm(ei, gi)
    yi = mm(er, gi) + mm(ei, gr)
    return yr * yr + yi * yi


def _check_codebook(wr, wi, tx_shape, dev, dtype):
    t = tx_shape[0] * tx_shape[1]
    for name, w in (("wr", wr), ("wi", wi)):
        if not isinstance(w, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if w.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} like omega; got "
                            f"{w.dtype}")
        if w.device != dev:
            raise ValueError(f"{name} is on {w.device}, omega on {dev}")
        if not w.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if w.dim() != 2 or w.shape[1] != t or w.shape[0] < 1 or \
                w.shape != wr.shape:
            raise ValueError(f"{name} must be [B, T={t}] like wr; got "
                             f"{tuple(w.shape)}")
    return wr.shape[0]


def _launch(args, wr, wi, out, u, p, r1, r2, t1, t2, n_b, n_k, n_s, n_sa,
            design):
    """One launch of ``beamgain_launch`` (the only place that spells its C
    signature) on ``out``'s device and current stream, of the design with
    code ``design`` (:data:`DESIGNS`); counts nothing (:func:`_beam_gain`
    counts the library's launches)."""
    dev = out.device
    with span("dm.codebook"):
        cw = torch.stack((wr.t(), wi.t().neg()), -1)    # conj(W), [T, B, 2]
    with span("dm.kernel.beam_gain"), torch.cuda.device(dev):
        launch = _build.launcher("beamgain", 9, 11)
        rc = launch(*(x.data_ptr() for x in args), cw.data_ptr(),
                    out.data_ptr(), u, p, r1, r2, t1, t2, n_b, n_k, n_s,
                    n_sa, design, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beamgain launch failed with CUDA error {rc}")


def _beam_gain(args, wr, wi, rx_shape, tx_shape, n_k, out,
               mm_dtype="float32"):
    """The forward without autograd: kernel on CUDA, plain on the CPU."""
    global LAUNCHES, TC_LAUNCHES
    u, p, n_s, n_sa = _check_inputs(args, rx_shape, tx_shape, n_k,
                                    (torch.float32, torch.float64))
    dtype = args[-1].dtype
    f64 = dtype == torch.float64
    mode = beam_gain_mode(mm_dtype, dtype)
    r1, r2 = (int(x) for x in rx_shape)
    t1, t2 = (int(x) for x in tx_shape)
    dev = args[-1].device
    n_b = _check_codebook(wr, wi, (t1, t2), dev, dtype)
    shape = (u, r1 * r2 * n_b, n_s * n_k)
    if out is not None:
        _check_layout("out", out, shape, dev, dtype)
    if dev.type == "cpu":
        g = beam_gain_reference(*args, wr, wi, (r1, r2), (t1, t2), n_k,
                                mm_dtype)
        return g if out is None else out.copy_(g)
    if dev.type != "cuda":
        raise ValueError(f"fused_beam_gain runs on CUDA or CPU tensors, not "
                         f"{dev}")
    if not beam_gain_fits((r1, r2), (t1, t2), n_b, p, n_k, f64, mm_dtype):
        raise ValueError(
            f"shape exceeds the kernel's shared memory: R={r1 * r2}, "
            f"T={t1 * t2}, B={n_b}, K={n_k}, P={p}, {dtype}, matmul_dtype "
            f"{mm_dtype!r} needs "
            f"{smem_bytes((r1, r2), (t1, t2), n_b, p, n_k, f64)} > "
            f"{SMEM_LIMIT} bytes; {TAKES}")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    design = beam_gain_design((r1, r2), (t1, t2), n_b, n_k, p, n_s,
                              mm_dtype, dtype)
    _launch(args, wr, wi, out, u, p, r1, r2, t1, t2, n_b, n_k, n_s, n_sa,
            DESIGNS[design])
    LAUNCHES += 1
    TC_LAUNCHES += design == "tc"
    _count(MODE_LAUNCHES, "tc_wide" if design == "tc_wide" else mode)
    return out


class FusedBeamGain(torch.autograd.Function):
    """The beam-gain kernel with the VJP of the plain version, recomputed
    at f32 grade whatever the forward's ``mm_dtype``, as its backward
    (``beamgain.py:323-330``)."""

    @staticmethod
    def forward(ctx, gry, grz, gty, gtz, amp, psi, omega, wr, wi, rx_shape,
                tx_shape, n_k, mm_dtype):
        args = (gry, grz, gty, gtz, amp, psi, omega)
        ctx.save_for_backward(*args, wr, wi)
        ctx.meta = (rx_shape, tx_shape, n_k)
        return _beam_gain(args, wr, wi, rx_shape, tx_shape, n_k, None,
                          mm_dtype)

    @staticmethod
    def backward(ctx, ct):
        needs = ctx.needs_input_grad[:9]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(ctx.saved_tensors, needs)]
            g = beam_gain_reference(*leaves, *ctx.meta)
            grads = iter(torch.autograd.grad(
                g, [x for x in leaves if x.requires_grad], ct,
                allow_unused=True))
        return (*(next(grads) if need else None for need in needs),
                None, None, None, None)


def fused_beam_gain(gry, grz, gty, gtz, amp, psi, omega, wr, wi,
                    rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                    n_k: int, out: Optional[torch.Tensor] = None,
                    mm_dtype: str = "float32") -> torch.Tensor:
    """Beam-gain maps G [U, R*B, S*K] from per-path scalars and a codebook,
    in the inputs' dtype (float32, or float64 for the kernel's float64
    instantiation).

    Inputs as in :func:`..render.fused_render` (all float32 or all
    float64, contiguous, one device, invalid paths zeroed; psi [U, S*P],
    amp [U, P] or [U, S*P]), plus the codebook planes ``wr``/``wi`` [B, T]
    of the same dtype. ``out``, when given, must be a contiguous tensor of
    that shape and dtype on the same device; the result is written into
    it. ``mm_dtype`` "bfloat16"/"default" rounds the path sum's operands
    to bf16 (float32 only); "float32"/"highest" keep full grade; others
    raise ValueError.

    Differentiable through :class:`FusedBeamGain` (gradients reach the
    codebook and the 7 per-path inputs). ``out=`` writes in place outside
    autograd, so it raises when an input requires grad. CUDA tensors launch
    the kernel on the current stream (no sync) or raise; CPU tensors take
    the plain version.
    """
    args = (gry, grz, gty, gtz, amp, psi, omega)
    if out is None:
        return FusedBeamGain.apply(*args, wr, wi, rx_shape, tx_shape, n_k,
                                   mm_dtype)
    if torch.is_grad_enabled() and any(
            getattr(x, "requires_grad", False) for x in (*args, wr, wi)):
        raise ValueError("fused_beam_gain(out=...) cannot record gradients: "
                         "an input requires grad; call it without out=")
    return _beam_gain(args, wr, wi, rx_shape, tx_shape, n_k, out, mm_dtype)
