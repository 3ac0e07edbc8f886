"""Beam-gain maps of the PyTorch port vs the JAX package.

The plain version of the beam-gain kernel and its autograd Function against
JAX's ``beam_gain_reference`` and its Pallas kernel in interpret mode,
``render_beam_gains`` on one state from ``state_from_numpy``,
``Dataset.compute_beam_gains`` end to end, the refused receive filter, the
route between the kernel's two designs and the tensor-core design's
layouts emulated in float32, and — on a CUDA card only — both designs
of the CUDA kernel vs its plain version.
Tolerance 3e-5 * max|G| (tests/test_beamgain.py's kernel bound), 3e-4 *
max|g| for gradients.

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_beamgain.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepmimo_tpu_torch as dmt
from deepmimo_tpu_torch.ops import channel as tch
from deepmimo_tpu_torch.ops import types as ttypes
from deepmimo_tpu_torch.ops.kernels import beamgain as kb

from oracle import make_synthetic_paths

torch.set_num_threads(1)
RTOL = 3e-5
GRAD_RTOL = 3e-4
# One-pass bf16 path sums, relative to max|G| (no JAX bound exists; bf16
# rounds each operand by up to 2^-9, and |y|^2 doubles the relative error).
BF16_RTOL = 1e-2

# name: (rx_shape, tx_shape, B, K, U, P, S, per-slot amp)
CASES = {
    "headline": ((1, 1), (8, 8), 16, 64, 12, 25, 1, False),
    "multi_rx": ((2, 1), (4, 2), 8, 16, 12, 25, 1, False),
    "three_slots": ((1, 1), (4, 4), 4, 8, 12, 25, 3, True),
    "many_paths": ((1, 1), (4, 4), 4, 8, 10, 72, 1, False),
}


def _scalars(u, p, n_s, per_slot, seed=0):
    """tests/test_beamgain.py's recipe, numpy; a per-slot amp on request."""
    rng = np.random.RandomState(seed)
    mk = lambda lo, hi, n: rng.uniform(lo, hi, (u, n)).astype(np.float32)
    return [mk(-3, 3, p), mk(-3, 3, p), mk(-3, 3, p), mk(-3, 3, p),
            mk(0, 1e-2, (n_s if per_slot else 1) * p),
            mk(-3, 3, n_s * p), mk(0, 6, p)]


def _codebook(b, t, seed=1):
    """A non-symmetric complex codebook: a sign slip in the fold's
    imaginary part shows."""
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, t))) / np.sqrt(t)
    return np.real(w).astype(np.float32), np.imag(w).astype(np.float32)


def _case(name, seed=0):
    rx, tx, b, k, u, p, s, per_slot = CASES[name]
    return (_scalars(u, p, s, per_slot, seed),
            _codebook(b, tx[0] * tx[1], seed + 1), rx, tx, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_reference_and_kernel(name):
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.beamgain import (beam_gain_reference,
                                                  fused_beam_gain)

    arrs, (wr, wi), rx, tx, k = _case(name)
    jargs = [jnp.asarray(a) for a in (*arrs, wr, wi)]
    want_ref = np.asarray(beam_gain_reference(*jargs, rx, tx, k))
    want_k = np.asarray(fused_beam_gain(*jargs, rx, tx, k, user_tile=8,
                                        interpret=True))
    targs = [torch.from_numpy(a) for a in (*arrs, wr, wi)]
    for got in (kb.fused_beam_gain(*targs, rx, tx, k),
                kb.beam_gain_reference(*targs, rx, tx, k)):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want_ref.shape
        for want in (want_ref, want_k):
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=RTOL * want.max())


@pytest.mark.parametrize("mm", ["bfloat16", "default", "highest"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_modes_match_jax_kernel(name, mm):
    """The plain version in each matmul_dtype against the TPU kernel in the
    same mode, in interpret mode (where "default" and "highest" are f32),
    and the one-pass mode against the f32 plain version."""
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.beamgain import fused_beam_gain

    arrs, (wr, wi), rx, tx, k = _case(name, seed=6)
    jargs = [jnp.asarray(a) for a in (*arrs, wr, wi)]
    want = np.asarray(fused_beam_gain(*jargs, rx, tx, k, user_tile=8,
                                      interpret=True, mm_dtype=mm))
    targs = [torch.from_numpy(a) for a in (*arrs, wr, wi)]
    got = kb.fused_beam_gain(*targs, rx, tx, k, mm_dtype=mm)
    f32 = kb.beam_gain_reference(*targs, rx, tx, k)
    tol = RTOL if mm == "highest" else BF16_RTOL
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol * want.max())
    np.testing.assert_allclose(got.numpy(), f32.numpy(),
                               atol=tol * want.max())
    if mm == "bfloat16":
        assert float((got - f32).abs().max()) > RTOL * want.max()
        with pytest.raises(ValueError, match="matmul_dtype"):
            kb.fused_beam_gain(*targs, rx, tx, k, mm_dtype="half")


def test_plain_matches_numpy_fold_of_the_channel():
    """|H @ W^H|^2 in float64 numpy from the render's own H: conj(W), not
    W, and rows r-major."""
    from deepmimo_tpu_torch.ops.kernels.render import fused_render_reference

    arrs, (wr, wi), rx, tx, k = _case("multi_rx", seed=4)
    targs = [torch.from_numpy(a) for a in arrs]
    h = fused_render_reference(*targs, rx, tx, k, packed=False).double()
    u, r, t = arrs[0].shape[0], rx[0] * rx[1], tx[0] * tx[1]
    hc = (h[0] + 1j * h[1]).numpy().reshape(u, r, t, -1)
    w = wr.astype(np.float64) + 1j * wi
    want = np.abs(np.einsum("bt,urtk->urbk", w.conj(), hc)) ** 2
    got = kb.fused_beam_gain(*targs, torch.from_numpy(wr),
                             torch.from_numpy(wi), rx, tx, k)
    np.testing.assert_allclose(got.numpy(), want.reshape(u, -1, k),
                               atol=RTOL * want.max())
    wrong = np.abs(np.einsum("bt,urtk->urbk", w, hc)) ** 2
    assert np.abs(got.numpy() - wrong.reshape(u, -1, k)).max() > \
        0.1 * want.max()


@pytest.mark.parametrize("name", ["headline", "multi_rx", "three_slots"])
def test_gradients_match_jax(name):
    import jax
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.beamgain import fused_beam_gain

    arrs, (wr, wi), rx, tx, k = _case(name, seed=2)
    u = arrs[0].shape[0]
    q = rx[0] * rx[1] * wr.shape[0]
    n_s = arrs[5].shape[1] // arrs[6].shape[1]
    cot = np.random.RandomState(3).uniform(-1, 1, (u, q, n_s * k)).astype(
        np.float32)
    wrt = {"gty": 2, "amp": 4, "wr": 7, "wi": 8}

    def loss(*a):
        return jnp.vdot(cot, fused_beam_gain(*a, rx, tx, k, user_tile=8,
                                             interpret=True))

    want = jax.grad(loss, argnums=tuple(wrt.values()))(
        *[jnp.asarray(a) for a in (*arrs, wr, wi)])
    leaves = [torch.from_numpy(a).requires_grad_(i in wrt.values())
              for i, a in enumerate((*arrs, wr, wi))]
    g = kb.fused_beam_gain(*leaves, rx, tx, k)
    assert type(g.grad_fn) is kb.FusedBeamGain._backward_cls
    (g * torch.from_numpy(cot)).sum().backward()
    for (name_, i), w in zip(wrt.items(), want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaves[i].grad.numpy(), w,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name_)
    assert all(x.grad is None for i, x in enumerate(leaves)
               if i not in wrt.values())


def test_cpu_wrapper_uses_plain_version_and_writes_out():
    arrs, w, rx, tx, k = _case("headline", seed=5)
    targs = [torch.from_numpy(a) for a in (*arrs, *w)]
    before = kb.LAUNCHES
    ref = kb.beam_gain_reference(*targs, rx, tx, k)
    out = torch.full_like(ref, float("nan"))
    got = kb.fused_beam_gain(*targs, rx, tx, k, out=out)
    assert got is out and torch.equal(out, ref)
    assert kb.LAUNCHES == before        # no kernel launch on the CPU
    targs[7].requires_grad_(True)
    with pytest.raises(ValueError, match="gradients"):
        kb.fused_beam_gain(*targs, rx, tx, k, out=out)


@pytest.mark.parametrize("bad", ["float64", "codebook_width", "wi_shape",
                                 "strided_codebook", "out_shape", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    arrs, w, rx, tx, k = _case("multi_rx", seed=6)
    args = [torch.from_numpy(a) for a in (*arrs, *w)]
    kw = {}
    if bad == "float64":
        args[8] = args[8].double()
    elif bad == "codebook_width":
        args[7], args[8] = args[7][:, :-1], args[8][:, :-1]
    elif bad == "wi_shape":
        args[8] = args[8][:-1]
    elif bad == "strided_codebook":
        args[7] = torch.cat([args[7], args[7]], 1)[:, ::2]
    elif bad == "out_shape":
        kw["out"] = torch.empty(12, 16, 15)
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        kb.fused_beam_gain(*args, rx, tx, k, **kw)


def test_beam_gain_fits_is_the_shared_memory_bound():
    # headline: conj(W) 64x16 (8,192 bytes) and 8 warps of two 32 x 18
    # complex buffers (9,216 bytes each)
    assert kb.smem_bytes((1, 1), (8, 8), 16, 25, 64) == 81_920
    # neither paths, RX elements, subcarriers nor slots enter the bound
    for p in (1, 350, 351, 100_000):
        assert kb.beam_gain_fits((1, 1), (8, 8), 16, p, 64)
        assert kb.smem_bytes((4, 4), (8, 8), 16, p, 4096) == 81_920
    # odd T*B rounds up to 16 bytes: 80 complex -> 640 bytes, 8 warps
    assert kb.smem_bytes((2, 2), (4, 4), 5, 100, 17) == 640 + 8 * 9_216
    # T = 256, B = 64: 131,072 bytes of codebook and 10 warps' room -> 8
    assert kb.smem_bytes((1, 1), (16, 16), 64, 39, 256) == \
        131_072 + 8 * 9_216
    # a codebook that leaves no room for a warp of 32 paths: chunks of 8
    # (two 8 x 18 complex buffers, 2,304 bytes per warp)
    assert kb.smem_bytes((1, 1), (8, 8), 440, 25, 64) == 225_280 + 3 * 2_304
    # the SIMT plan: conj(W) and one warp of 8, T*B <= 28,768; past it the
    # one-pass bf16 mode is refused
    bf16 = dict(mm_dtype="bfloat16")
    assert kb.beam_gain_fits((1, 1), (8, 8), 449, 25, 64, **bf16)
    assert kb.smem_bytes((1, 1), (8, 8), 449, 25, 64) == 229_888 + 2_304
    assert not kb.beam_gain_fits((1, 1), (8, 8), 450, 25, 64, **bf16)
    assert not kb.beam_gain_fits((1, 1), (8, 8), 450, 25, 64,
                                 mm_dtype="default")
    assert kb.smem_bytes((1, 1), (8, 8), 450, 25, 64) > 232_448
    # float32 at f32 grade past it: the tensor cores, up to T = 256 with
    # any number of beams (the 16x16 panel's 256-beam grid among them)
    assert kb.TC_WIDE_MAX_TX == 256
    for mm in ("float32", "highest"):
        assert kb.beam_gain_fits((1, 1), (8, 8), 450, 25, 64, mm_dtype=mm)
        assert kb.beam_gain_fits((2, 2), (16, 16), 256, 100, 1024,
                                 mm_dtype=mm)
        assert kb.beam_gain_fits((1, 1), (16, 16), 4096, 25, 64,
                                 mm_dtype=mm)
    assert not kb.beam_gain_fits((1, 1), (16, 16), 256, 25, 64, **bf16)
    # past the wide bound the SIMT plan alone: T = 288
    assert kb.beam_gain_fits((1, 1), (16, 18), 99, 25, 64)
    assert not kb.beam_gain_fits((1, 1), (16, 18), 100, 25, 64)
    assert not kb.beam_gain_fits((1, 1), (8, 8), 0, 25, 64)
    assert not kb.beam_gain_fits((1, 1), (8, 8), 16, 0, 64)


def test_float64_shared_memory_bound():
    """The float64 instantiation's complex entries are 16 bytes, so conj(W)
    and the warps' buffers take twice the bytes: T*B <= 14,240; the tensor
    cores take no float64."""
    f64 = dict(f64=True)
    # headline: conj(W) 64 x 16 (16,384 bytes), 8 warps of 18,432
    assert kb.smem_bytes((1, 1), (8, 8), 16, 25, 64, **f64) == \
        16_384 + 8 * 18_432
    # the last codebook with room for one warp of 32 paths, then chunks
    # of 8 (4,608 bytes per warp)
    assert kb.smem_bytes((1, 1), (8, 8), 209, 25, 64, **f64) == 232_448
    assert kb.smem_bytes((1, 1), (8, 8), 215, 25, 64, **f64) == \
        220_160 + 2 * 4_608
    # odd T*B needs no rounding: every entry is 16 bytes
    assert kb.smem_bytes((2, 2), (4, 4), 5, 100, 17, **f64) == \
        1_280 + 8 * 18_432
    assert kb.beam_gain_fits((1, 1), (8, 8), 222, 25, 64, **f64)
    assert not kb.beam_gain_fits((1, 1), (8, 8), 223, 25, 64, **f64)
    assert not kb.beam_gain_fits((1, 1), (16, 16), 256, 25, 64, **f64)
    assert kb.beam_gain_fits((1, 1), (8, 8), 223, 25, 64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_float64_matches_numpy_fold_and_jax_kernel(name):
    """Float64 inputs (complex128 configs) through the wrapper, whose CPU
    route is the plain version in float64: |conj(W) H|^2 in float64 numpy
    from the float64 render of the same scalars within 1e-9 * max|G|, and
    JAX's Pallas kernel in interpret mode on the same float64 inputs
    within RTOL (it returns float32)."""
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.beamgain import fused_beam_gain

    from deepmimo_tpu_torch.ops.kernels.render import fused_render_reference

    arrs, w, rx, tx, k = _case(name, seed=7)
    a64 = [a.astype(np.float64) for a in (*arrs, *w)]
    targs = [torch.from_numpy(a) for a in a64]
    before = kb.LAUNCHES
    got = kb.fused_beam_gain(*targs, rx, tx, k)
    assert kb.LAUNCHES == before and got.dtype == torch.float64
    assert torch.equal(got, kb.beam_gain_reference(*targs, rx, tx, k))
    h = fused_render_reference(*targs[:7], rx, tx, k, packed=False)
    assert h.dtype == torch.float64
    u, r, t = arrs[0].shape[0], rx[0] * rx[1], tx[0] * tx[1]
    hc = (h[0] + 1j * h[1]).numpy().reshape(u, r, t, -1)
    wc = a64[7] + 1j * a64[8]
    want = (np.abs(np.einsum("bt,urtk->urbk", wc.conj(), hc)) ** 2
            ).reshape(u, -1, hc.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-9 * want.max())
    jk = np.asarray(fused_beam_gain(*(jnp.asarray(a) for a in a64), rx, tx,
                                    k, user_tile=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), jk, rtol=0,
                               atol=RTOL * want.max())


def test_float64_refuses_bf16_and_mixed_dtypes():
    arrs, w, rx, tx, k = _case("multi_rx", seed=8)
    args = [torch.from_numpy(a).double() for a in (*arrs, *w)]
    assert kb.beam_gain_mode("float32", torch.float64) == "f64"
    assert kb.beam_gain_mode("highest", torch.float64) == "f64"
    assert kb.beam_gain_mode("bfloat16", torch.float32) == "bf16_mm"
    with pytest.raises(ValueError, match="bf16"):
        kb.fused_beam_gain(*args, rx, tx, k, mm_dtype="bfloat16")
    out32 = torch.empty(12, 16, 16)
    with pytest.raises(ValueError, match="float64"):
        kb.fused_beam_gain(*args, rx, tx, k, out=out32)
    args[3] = args[3].float()
    with pytest.raises(TypeError, match="gtz"):
        kb.fused_beam_gain(*args, rx, tx, k)


def test_float64_beyond_shared_memory_plain_on_cpu_raises_on_card(
        monkeypatch):
    """complex128 beam gains take the float64 instantiation, whose bound is
    T*B <= 14,240: 223 beams of an 8 x 8 panel run the plain version on
    CPU tensors and raise on the card (device check patched); 222 beams
    take the kernel wrapper."""
    _, (pd, bs, ue, cfg) = _state("isotropic")
    cfg = cfg.replace(dtype="complex128")
    wr, wi = (torch.from_numpy(x) for x in _codebook(223, 64))
    assert not tch.beam_gain_eligible(cfg, 223)
    assert tch.beam_gain_eligible(cfg, 222)
    assert tch.beam_gain_eligible(cfg.replace(dtype="complex64"), 223)
    xla = cfg.replace(backend="xla")
    want = tch.render_beam_gains(pd, bs, ue, xla, wr, wi)
    assert want.dtype == torch.float64 and torch.isfinite(want).all()
    assert torch.equal(tch.render_beam_gains(pd, bs, ue, cfg, wr, wi), want)
    monkeypatch.setattr(tch, "_on_card", lambda dev: True)
    # the prologue kernel cannot run on these CPU tensors: its PyTorch ops
    monkeypatch.setattr(tch, "_prologue_route", lambda *a: False)
    with pytest.raises(ValueError, match="complex128"):
        tch.render_beam_gains(pd, bs, ue, cfg, wr, wi)
    calls = []
    real = kb.fused_beam_gain
    monkeypatch.setattr(kb, "fused_beam_gain", lambda *a, **kw: (
        calls.append((a[0].dtype, kw["mm_dtype"])), real(*a, **kw))[1])
    got = tch.render_beam_gains(pd, bs, ue, cfg.replace(
        matmul_dtype="bfloat16"), wr[:222], wi[:222])
    assert calls == [(torch.float64, "float32")]
    assert torch.equal(got, tch.render_beam_gains(pd, bs, ue, xla,
                                                  wr[:222], wi[:222]))


def _old_smem_bytes(rx_shape, tx_shape, n_beams, n_paths, n_k):
    """The one-block-per-user kernel's shared memory, as it was: conj(W)
    [T, B], a_tx [T, P] sharing its space with one slot's g [P, K], E
    [P, R*B] and, when R > 1, a_rx [P, R]."""
    r = rx_shape[0] * rx_shape[1]
    t = tx_shape[0] * tx_shape[1]
    return 2 * 4 * (t * n_beams + n_paths * max(t, n_k) +
                    n_paths * r * n_beams + (n_paths * r if r > 1 else 0))


def test_beam_gain_fits_admits_every_shape_the_old_bound_took():
    """Every (R, T, B, K, P) that the one-block-per-user kernel took is
    taken; the sweep includes, for each panel, the widest codebook that the
    old bound admits at one path (where conj(W) fills the block)."""
    limit = 232_448
    rxs = [(1, 1), (2, 1), (2, 2), (4, 4), (1, 64)]
    txs = [(1, 1), (3, 5), (4, 4), (8, 8), (16, 4), (16, 16), (1, 128),
           (32, 32), (2, 1000)]
    beams = [1, 5, 16, 64, 113, 200, 320, 449, 1000]
    ks = [1, 17, 64, 256, 1024, 30_000]
    paths = [1, 25, 39, 100, 350, 351, 1000]
    n_old = 0
    for rx in rxs:
        for tx in txs:
            t = tx[0] * tx[1]
            b_max = max((b for b in range(1, limit // (8 * t) + 1)
                         if _old_smem_bytes(rx, tx, b, 1, 1) <= limit),
                        default=1)
            for b in beams + [b_max]:
                for k in ks:
                    for p in paths:
                        if _old_smem_bytes(rx, tx, b, p, k) > limit:
                            continue
                        n_old += 1
                        assert kb.beam_gain_fits(rx, tx, b, p, k), \
                            (rx, tx, b, k, p)
    assert n_old > 1000
    # and more: 351 paths at the headline, 320 beams
    assert _old_smem_bytes((1, 1), (8, 8), 16, 351, 64) > limit
    assert kb.beam_gain_fits((1, 1), (8, 8), 16, 351, 64)
    assert kb.beam_gain_fits((1, 1), (8, 8), 320, 25, 64)


def _factored_beam_gain(gry, grz, gty, gtz, amp, psi, omega, wr, wi,
                        rx_shape, tx_shape, n_k):
    """The kernel's trig in float32 plain torch: a_tx from ey[m % 8] and
    one phasor per (n, block of 8 m), g from fine[k % 8] and
    coarse[s, k // 8], a_rx per element; then the fold and the path sum."""
    def ph(x):
        return torch.polar(torch.ones_like(x), x)

    u, p = omega.shape
    n_s, n_sa = psi.shape[1] // p, amp.shape[1] // p
    (r1, r2), (t1, t2) = rx_shape, tx_shape
    m = torch.arange(t1, dtype=torch.float32)
    ey = ph(gty[..., None] * (m % 8))                         # [U, P, t1]
    blk = ph(gty[..., None] * (m - m % 8))
    ez = ph(gtz[..., None] * torch.arange(t2, dtype=torch.float32))
    a_tx = ((ez[..., :, None] * blk[..., None, :]) *
            ey[..., None, :]).reshape(u, p, t2 * t1)          # t = n t1 + m
    mr = torch.arange(r1 * r2)
    a_rx = ph(gry[..., None] * (mr % r1).float() +
              grz[..., None] * (mr // r1).float())            # [U, P, R]
    cw = torch.complex(wr, -wi)                               # conj(W)
    eb = torch.einsum("upt,bt->upb", a_tx, cw)
    e = (a_rx[..., :, None] * eb[..., None, :]).reshape(u, p, -1)
    k = torch.arange(n_k, dtype=torch.float32)
    fine = ph(-omega[..., None] * (k % 8))
    out = []
    for s in range(n_s):
        a_s = amp[:, (s if n_sa > 1 else 0) * p:][:, :p]
        coarse = a_s[..., None] * ph(psi[:, s * p:(s + 1) * p, None] -
                                     omega[..., None] * (k - k % 8))
        y = torch.einsum("upq,upk->uqk", e, fine * coarse)
        out.append(y.real ** 2 + y.imag ** 2)
    return torch.cat(out, -1)


@pytest.mark.parametrize("tx, n_s", [((8, 8), 4), ((16, 4), 1)],
                         ids=["headline_polar", "t1_16"])
def test_factored_trig_holds_in_float32(tx, n_s):
    """The kernel's separable trig (design of csrc/beamgain.cu) in float32
    against the plain version in float64, with per-slot amp and delays up
    to chip_smoke.make_data's 4e-6 s: omega * k reaches ~31 rad."""
    u, p, b, k = 64, 25, 16, 64
    rng = np.random.RandomState(12)
    mk = lambda lo, hi, n: rng.uniform(lo, hi, (u, n)).astype(np.float32)
    arrs = [mk(-np.pi, np.pi, p) for _ in range(4)] + [
        mk(0, 1e-4, n_s * p), mk(-np.pi, np.pi, n_s * p),
        mk(0, 2 * np.pi * 40 / 512, p)]
    w = _codebook(b, tx[0] * tx[1], seed=13)
    f32 = [torch.from_numpy(a) for a in (*arrs, *w)]
    got = _factored_beam_gain(*f32, (1, 1), tx, k)
    want = kb.beam_gain_reference(*(x.double() for x in f32), (1, 1), tx, k)
    assert float(arrs[6].max()) * (k - 1) > 30
    assert tuple(got.shape) == tuple(want.shape) == (u, b, n_s * k)
    scale = float(want.max())
    assert float((got.double() - want).abs().max()) <= RTOL * scale


# ----------------------------------------------------------------------------
# The tensor-core design: its route and its factoring, emulated
# ----------------------------------------------------------------------------

def _simt_smem_bytes(t, n_beams, f64):
    """The SIMT plan's shared memory as it stood when the tensor-core design
    came in (``plan`` in csrc/beamgain.cu): the route must not move it."""
    ce = 16 if f64 else 8
    cw = 16 * -(-t * n_beams * ce // 16)
    for chunk in (32, 8):
        per_warp = 2 * ce * chunk * 18
        if cw + per_warp <= 232_448:
            return cw + min(8, (232_448 - cw) // per_warp) * per_warp
    return cw + 2 * ce * 8 * 18


# Both designs' ms at 131,072 users on an H100 (NVIDIA H100 80GB HBM3,
# 700 W; deepmimo_tpu_torch/tools/beamgain_crossover.py):
# (rx_shape, tx_shape, K, P, S, B): (SIMT, tensor cores)
CROSSOVER_MS = {
    ((1, 1), (8, 8), 64, 25, 1, 16): (1.8362, 3.2694),
    ((1, 1), (8, 8), 64, 25, 1, 32): (3.5873, 3.2503),
    ((1, 1), (8, 8), 64, 25, 1, 64): (7.2729, 3.3208),
    ((1, 1), (8, 8), 64, 25, 1, 128): (18.0126, 6.6450),
    ((1, 1), (8, 1), 1, 25, 1, 32): (2.1450, 2.6376),
    ((1, 1), (8, 1), 1, 25, 1, 64): (4.1769, 2.6630),
    ((1, 1), (8, 1), 64, 25, 1, 32): (2.1524, 2.6372),
    ((1, 1), (8, 1), 64, 25, 1, 64): (4.1683, 2.7519),
    ((1, 1), (4, 4), 1, 25, 1, 32): (2.3569, 2.7334),
    ((1, 1), (4, 4), 16, 25, 1, 32): (2.4167, 2.7516),
    ((1, 1), (4, 4), 64, 25, 1, 32): (2.4297, 2.7438),
    ((1, 1), (4, 4), 64, 25, 1, 64): (4.7912, 2.8406),
    ((1, 1), (8, 4), 64, 25, 1, 32): (2.7858, 2.6546),
    ((1, 1), (16, 4), 64, 25, 1, 32): (3.7247, 3.6432),
    ((1, 1), (16, 4), 64, 25, 1, 64): (7.2893, 3.6461),
    ((1, 1), (8, 8), 1, 25, 1, 32): (3.5899, 3.2672),
    ((1, 1), (8, 8), 8, 25, 1, 32): (3.6677, 3.2722),
    ((1, 1), (8, 8), 100, 25, 1, 32): (5.3216, 4.9375),
    ((1, 1), (8, 8), 100, 25, 1, 64): (10.6874, 4.9704),
    ((1, 1), (8, 8), 64, 10, 1, 32): (2.7593, 3.1913),
    ((1, 1), (8, 8), 64, 10, 1, 64): (5.5983, 3.2038),
    ((1, 1), (8, 8), 64, 40, 1, 32): (13.3831, 5.9771),
    ((1, 1), (8, 8), 64, 40, 4, 32): (53.2652, 22.9438),
    ((2, 2), (8, 8), 64, 25, 1, 32): (14.9919, 8.7145),
    ((2, 1), (8, 1), 1, 25, 1, 32): (4.2642, 4.7804),
    ((2, 1), (8, 1), 1, 25, 1, 64): (8.4546, 4.8126),
    ((1, 1), (1, 1), 64, 25, 1, 32): (1.9630, 2.7482),
    ((1, 1), (1, 1), 64, 25, 1, 64): (3.8535, 2.8291),
    ((1, 1), (2, 2), 64, 5, 1, 64): (1.8354, 2.5832),
    ((1, 1), (8, 1), 1, 10, 1, 32): (1.2977, 2.5149),
    ((1, 1), (8, 1), 1, 10, 1, 96): (3.7679, 5.0536),
    ((1, 1), (8, 1), 1, 40, 1, 32): (12.3595, 4.7960),
    ((1, 1), (8, 1), 64, 25, 4, 64): (14.6332, 7.9288),
    ((1, 1), (4, 4), 64, 25, 1, 40): (3.7580, 2.7602),
    ((2, 2), (4, 4), 100, 9, 2, 32): (16.2464, 28.0757),
    ((2, 2), (4, 4), 100, 9, 2, 64): (32.8432, 29.2434),
    ((2, 2), (4, 4), 100, 9, 2, 128): (66.4077, 58.4409),
    ((1, 1), (3, 5), 17, 37, 3, 32): (35.1556, 14.2919),
    ((1, 1), (8, 1), 1, 25, 1, 48): (3.1217, 2.6004),
    ((1, 1), (8, 1), 1, 25, 1, 96): (6.1980, 5.2742),
    # past 64 TX elements the tensor cores' wide design (fitted on the
    # t72, t128, t256 and two-slot shapes, the rest held out)
    ((1, 1), (9, 8), 64, 25, 1, 32): (4.0283, 3.2512),
    ((1, 1), (9, 8), 64, 25, 1, 64): (7.9858, 6.4577),
    ((1, 1), (9, 8), 64, 25, 1, 128): (19.6927, 12.8642),
    ((1, 1), (9, 8), 64, 25, 1, 256): (39.8591, 25.5214),
    ((1, 1), (16, 8), 64, 25, 1, 32): (5.3862, 3.5566),
    ((1, 1), (16, 8), 64, 25, 1, 64): (12.7664, 7.0631),
    ((1, 1), (16, 8), 64, 25, 1, 100): (22.6608, 14.0408),
    ((1, 1), (16, 8), 64, 25, 1, 128): (26.5155, 14.0590),
    ((1, 1), (16, 8), 64, 25, 1, 224): (1499.5035, 24.3946),
    ((1, 1), (16, 16), 64, 25, 1, 32): (10.4732, 5.5669),
    ((1, 1), (16, 16), 64, 25, 1, 64): (20.4740, 11.0908),
    ((1, 1), (16, 16), 64, 25, 1, 100): (65.7467, 21.9402),
    ((1, 1), (16, 16), 64, 25, 1, 112): (1345.8605, 21.9679),
    ((1, 1), (12, 8), 64, 40, 1, 32): (12.8873, 5.7493),
    ((1, 1), (12, 8), 64, 40, 1, 64): (34.4211, 11.4159),
    ((1, 1), (12, 8), 64, 40, 1, 128): (69.1006, 22.7008),
    ((2, 1), (16, 8), 64, 25, 2, 32): (14.5140, 11.8344),
    ((2, 1), (16, 8), 64, 25, 2, 64): (34.9796, 23.4599),
    ((2, 1), (16, 8), 64, 25, 2, 128): (70.7814, 46.8880),
    ((1, 1), (16, 16), 16, 25, 1, 32): (10.3906, 5.5417),
    ((1, 1), (16, 16), 16, 25, 1, 64): (20.5816, 11.0259),
    ((1, 1), (16, 16), 16, 25, 1, 112): (1344.8131, 21.9318),
    ((1, 1), (16, 12), 64, 10, 1, 32): (7.4461, 4.5546),
    ((1, 1), (16, 12), 64, 10, 1, 64): (14.6255, 8.9766),
    ((1, 1), (16, 12), 64, 10, 1, 128): (53.5337, 17.9449),
}

# The wide design's ms alone where the SIMT design's shared memory does
# not take the shape: (rx_shape, tx_shape, K, P, S, B): ms.
CROSSOVER_WIDE_ONLY_MS = {
    ((1, 1), (16, 8), 64, 25, 1, 256): 27.7270,
    ((1, 1), (16, 16), 64, 25, 1, 128): 21.8264,
    ((1, 1), (16, 16), 64, 25, 1, 256): 43.6105,
}


@pytest.mark.parametrize("dtype, mm", [
    (torch.float32, "float32"), (torch.float32, "highest"),
    (torch.float32, "bfloat16"), (torch.float32, "default"),
    (torch.float64, "float32"), (torch.float64, "highest")])
def test_tensor_core_route_sweep(dtype, mm):
    """The route depends on dtype, mode and shape alone: only float32 at
    f32 grade, B >= TC_MIN_BEAMS and T <= TC_WIDE_MAX_TX may take the
    tensor cores (T <= 64 their first design, more the wide one), every
    such shape past the SIMT plan does, and of the others the shapes at
    which they are faster on the card: at every shape of CROSSOVER_MS
    where one design is more than 10% faster, the route picks it.
    smem_bytes stays the SIMT plan's, and beam_gain_fits is that plan's
    bound widened by the tensor cores' shapes: the route only picks the
    design of a shape that the kernel takes."""
    f64 = dtype == torch.float64
    f32_grade = dtype == torch.float32 and mm in ("float32", "highest")
    n_routed = 0
    n_wide = 0
    for tx in [(1, 1), (3, 5), (4, 4), (8, 8), (16, 4), (9, 8), (16, 16),
               (16, 18)]:
        t = tx[0] * tx[1]
        for b in (1, 16, 48, kb.TC_MIN_BEAMS - 1, kb.TC_MIN_BEAMS, 65, 100,
                  215, 256, 449, 450):
            gate = f32_grade and b >= kb.TC_MIN_BEAMS and t <= 256
            for rx in [(1, 1), (2, 1), (2, 2)]:
                for k in (1, 17, 64, 100):
                    for p in (1, 16, 25, 40):
                        simt = kb.smem_bytes(rx, tx, b, p, k) <= 232_448
                        for n_s in (1, 4):
                            route = kb.tensor_core_route(rx, tx, b, k, p,
                                                         n_s, mm, dtype)
                            assert route in (False, True)
                            assert gate or not route, (tx, b, rx, k, p, n_s)
                            assert route or simt or not gate
                            design = kb.beam_gain_design(rx, tx, b, k, p,
                                                         n_s, mm, dtype)
                            assert design == (
                                ("tc" if t <= 64 else "tc_wide") if route
                                else kb.beam_gain_mode(mm, dtype))
                            n_routed += route and kb.beam_gain_fits(
                                rx, tx, b, p, k, f64, mm)
                            n_wide += design == "tc_wide"
                        smem = kb.smem_bytes(rx, tx, b, p, k, f64)
                        assert smem == _simt_smem_bytes(t, b, f64)
                        fits = kb.beam_gain_fits(rx, tx, b, p, k, f64, mm)
                        assert fits == (smem <= 232_448 or gate)
    assert (n_routed > 0) == (n_wide > 0) == f32_grade
    assert kb.TC_MAX_TX == 64 and kb.TC_MIN_BEAMS == 32
    assert kb.TC_WIDE_MAX_TX == 256
    for (rx, tx, k, p, n_s, b), (simt, tc) in CROSSOVER_MS.items():
        route = kb.tensor_core_route(rx, tx, b, k, p, n_s, mm, dtype)
        if not f32_grade or b < kb.TC_MIN_BEAMS:
            assert not route
        elif tc * 1.1 < simt:
            assert route, (rx, tx, k, p, n_s, b)
        elif simt * 1.1 < tc:
            assert not route, (rx, tx, k, p, n_s, b)
    with pytest.raises(ValueError, match="matmul_dtype"):
        kb.tensor_core_route((1, 1), (8, 8), 64, 64, 25, 1, "half", dtype)


def test_wide_cost_model_follows_the_crossover():
    """The wide design's cost model (``_tc_ns`` past 64 TX elements)
    within 15% of its measured ms at every point of the crossover, so
    that the route's margins hold; and the SIMT model past 64 TX elements
    within 35% where the SIMT design ran (its plan of fewer warps and
    chunks of 8 paths counted)."""
    ms_per_ns = 131_072 / 1e6
    points = {**{key: tc for key, (_, tc) in CROSSOVER_MS.items()},
              **CROSSOVER_WIDE_ONLY_MS}
    n = 0
    for (rx, tx, k, p, n_s, b), ms in points.items():
        t = tx[0] * tx[1]
        if t <= kb.TC_MAX_TX:
            continue
        n += 1
        r = rx[0] * rx[1]
        model = kb._tc_ns(r, tx, b, k, p, n_s) * ms_per_ns
        assert abs(model / ms - 1) < 0.15, (tx, b, model, ms)
        if (rx, tx, k, p, n_s, b) in CROSSOVER_MS:
            simt = CROSSOVER_MS[(rx, tx, k, p, n_s, b)][0]
            model = kb._simt_ns(r, t, b, k, p, n_s) * ms_per_ns
            assert abs(model / simt - 1) < 0.35, (tx, b, model, simt)
    assert n == 28


def _tf32(x):
    """rna(x) to tf32 on float32 bits (render_tables.cuh tf32_rna)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """lo.hi + hi.lo + hi.hi in float32: the kernel's 3xTF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tensor_core_emulation(gry, grz, gty, gtz, amp, psi, omega, wr, wi,
                           rx_shape, tx_shape, n_k, slip=None):
    """The tensor-core design's factoring in plain float32 torch, laid out
    as csrc/beamgain.cu lays it out: per 64-beam tile, chunk of 32 paths and
    tile of 64 subcarriers, the fold as D1 = Re conj(W) . X and D2 =
    Im conj(W) . X with X's columns 8 J + 2 e + h = part h of a_tx of path
    4 J + e; Er and Ei gathered from each warpgroup thread's accumulators
    into the path sum's A fragments (column blocks 2 ks and 2 ks + 1 make
    k-step ks); D3 = Er . G and D4 = Ei . G with G's columns 8 j + 2 t + c
    = part c of g at subcarrier 16 (j / 4) + 4 t + j % 4, so that a thread
    holds four adjacent subcarriers; every product 3xTF32. ``slip`` plants
    a fault: "depth" swaps the fragments' a[1] and a[2], "conj" folds W
    instead of conj(W)."""
    from deepmimo_tpu_torch.ops.kernels.render import response

    u, p = omega.shape
    n_s, n_sa = psi.shape[1] // p, amp.shape[1] // p
    (r1, r2), (t1, t2) = rx_shape, tx_shape
    t_, r_, b_ = t1 * t2, r1 * r2, wr.shape[0]
    t8 = 8 * -(-t_ // 8)
    atx_r, atx_i = response(gty, gtz, t1, t2)               # [u, T, p]
    arx_r, arx_i = response(gry, grz, r1, r2)               # [u, R, p]
    w_, g_, t4_ = torch.meshgrid(torch.arange(4), torch.arange(8),
                                 torch.arange(4), indexing="ij")
    ra, tt = (16 * w_ + g_).reshape(-1), t4_.reshape(-1)     # 128 threads
    n = torch.arange(128)                  # path-sum columns 8 j + 2 t + c
    kl_n = 16 * (n >> 5) + 4 * ((n & 7) >> 1) + ((n >> 3) & 3)
    c_n = n & 1
    out = torch.zeros(u, r_ * b_, n_s * n_k)
    sign = 1.0 if slip == "conj" else -1.0

    def acc(dd, j, h, c):                  # the thread's d[4 j + 2 h + c]
        return dd[:, ra + 8 * h, 8 * j + 2 * tt + c]

    for b0 in range(0, b_, 64):
        nb = min(64, b_ - b0)
        cr, ci = torch.zeros(64, t8), torch.zeros(64, t8)
        cr[:nb, :t_] = wr[b0:b0 + nb]
        ci[:nb, :t_] = sign * wi[b0:b0 + nb]
        for r in range(r_):
            for s in range(n_s):
                for k0 in range(0, n_k, 64):
                    d3 = d4 = 0
                    for p0 in range(0, p, 32):
                        ok = (p0 + torch.arange(32) < p).float()
                        pc = torch.clamp(p0 + torch.arange(32), max=p - 1)
                        x = torch.zeros(u, t8, 64)
                        x[:, :t_, 0::2] = atx_r[:, :, pc] * ok
                        x[:, :t_, 1::2] = atx_i[:, :, pc] * ok
                        d1, d2 = _mm3(cr, x), _mm3(ci, x)    # [u, 64, 64]
                        ar, ai = torch.zeros(u, 64, 32), torch.zeros(u, 64, 32)
                        for ks in range(4):
                            for i in range(4):
                                src = 3 - i if slip == "depth" and \
                                    i in (1, 2) else i
                                j, h = 2 * ks + src // 2, src % 2
                                rows = ra + 8 * (i % 2)
                                cols = 8 * ks + tt + 4 * (i // 2)
                                ar[:, rows, cols] = acc(d1, j, h, 0) - \
                                    acc(d2, j, h, 1)
                                ai[:, rows, cols] = acc(d1, j, h, 1) + \
                                    acc(d2, j, h, 0)
                        am = amp[:, (s if n_sa > 1 else 0) * p:][:, pc] * ok
                        cre, cim = am * arx_r[:, r, pc], am * arx_i[:, r, pc]
                        ph = psi[:, s * p:][:, pc, None] - \
                            omega[:, pc, None] * \
                            (k0 + torch.arange(64, dtype=torch.float32))
                        vr, vi = torch.cos(ph), torch.sin(ph)
                        gr = cre[..., None] * vr - cim[..., None] * vi
                        gi = cre[..., None] * vi + cim[..., None] * vr
                        gm = torch.where(c_n == 0, gr[:, :, kl_n],
                                         gi[:, :, kl_n])     # [u, 32, 128]
                        d3 = d3 + _mm3(ar, gm)
                        d4 = d4 + _mm3(ai, gm)
                    for h in range(2):
                        rows = ra + 8 * h
                        for j in range(16):
                            kl = 16 * (j >> 2) + 4 * tt + (j & 3)
                            yr = acc(d3, j, h, 0) - acc(d4, j, h, 1)
                            yi = acc(d3, j, h, 1) + acc(d4, j, h, 0)
                            keep = (b0 + rows < b_) & (k0 + kl < n_k)
                            out[:, (r * b_ + b0 + rows)[keep],
                                (s * n_k + k0 + kl)[keep]] = \
                                (yr * yr + yi * yi)[:, keep]
    return out


# name: (rx_shape, tx_shape, B, K, U, P, S, per-slot amp)
TC_EMU_CASES = {
    "cell": ((1, 1), (8, 8), 64, 64, 3, 25, 1, False),
    "ragged_odd_panel": ((1, 1), (3, 5), 70, 17, 2, 37, 1, False),
    "two_rx_slots": ((2, 1), (4, 4), 64, 100, 2, 9, 2, True),
    "two_chunks": ((1, 1), (8, 8), 64, 64, 2, 40, 1, False),
}


@pytest.mark.parametrize("name", sorted(TC_EMU_CASES))
def test_tensor_core_factoring_emulated(name):
    """The tensor-core design's layouts and signs, emulated in float32 at
    3xTF32, against the plain version in float64 within RTOL; a planted
    slip of the depth order or of the conjugate misses it by far."""
    rx, tx, b, k, u, p, s, per_slot = TC_EMU_CASES[name]
    arrs = [torch.from_numpy(a) for a in _scalars(u, p, s, per_slot,
                                                  seed=21)]
    wr, wi = (torch.from_numpy(x) for x in _codebook(b, tx[0] * tx[1], 22))
    want = kb.beam_gain_reference(*(x.double() for x in (*arrs, wr, wi)),
                                  rx, tx, k)
    scale = float(want.max())
    got = _tensor_core_emulation(*arrs, wr, wi, rx, tx, k)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= RTOL * scale
    for slip in ("depth", "conj"):
        bad = _tensor_core_emulation(*arrs, wr, wi, rx, tx, k, slip=slip)
        assert float((bad.double() - want).abs().max()) > 0.05 * scale


def _wide_launch_emulated(args, wr, wi, out, u, p, r1, r2, t1, t2, n_b, n_k,
                          n_s, n_sa, design, slip=None):
    """The wide tensor-core design's tile plan in plain float32 torch, at
    the sizes the wrapper launches it with, laid out as csrc/beamgain.cu
    (namespace tcw) lays it out: items of one user and a tile of 32 beams,
    taken by a grid of blocks in turn, each block staging a tile's
    conj(W) (rows 16 v + g + 8 h: part h of beam 8 v + g) once for the
    users it takes with it; per item, path chunk and output tile the fold
    D = conj(W) . X summed over slices of 32 TX elements (X's columns
    8 J + 2 e + h: part h of a_tx of path 4 J + e); each warpgroup
    thread's A fragment of path-sum k-step j, (Er, Ei, -Ei, Er) from its
    own accumulators; g's depths 8 j + d + 4 c (part c of path 4 j + d)
    and columns 8 j + kl (subcarrier 16 (j / 2) + 2 (j % 2) + 4 (kl / 2)
    + kl % 2); |y|^2 from rows ra and ra + 8 stored as four adjacent
    subcarriers; every product 3xTF32. ``slip`` plants a fault: "depth"
    swaps the fragments' a[1] and a[2], "conj" folds W instead of
    conj(W), "slice" drops the last slice of a_tx."""
    from deepmimo_tpu_torch.ops.kernels.render import response

    gry, grz, gty, gtz, amp, psi, omega = args
    assert design == kb.DESIGNS["tc_wide"]
    t_, r_ = t1 * t2, r1 * r2
    n_sl = -(-t_ // 32)
    cw = torch.stack((wr.t(), wi.t().neg()), -1)     # as the wrapper passes
    if slip == "conj":
        cw = torch.stack((wr.t(), wi.t()), -1)
    atx_r, atx_i = response(gty, gtz, t1, t2)               # [u, T, p]
    arx_r, arx_i = response(gry, grz, r1, r2)               # [u, R, p]
    w_, g_, t4_ = torch.meshgrid(torch.arange(4), torch.arange(8),
                                 torch.arange(4), indexing="ij")
    v_, g_, tt = w_.reshape(-1), g_.reshape(-1), t4_.reshape(-1)
    ra = 16 * v_ + g_                                       # 128 threads
    m = torch.arange(64)
    row_beam, row_part = 8 * (m >> 4) + (m & 7), (m >> 3) & 1
    n = torch.arange(64)
    x_path, x_part = 4 * (n >> 3) + ((n & 7) >> 1), n & 1
    dep = torch.arange(64)
    g_path, g_part = 4 * (dep >> 3) + (dep & 3), (dep >> 2) & 1
    g_col = 16 * (n >> 4) + 2 * ((n >> 3) & 1) + 4 * ((n & 7) >> 1) + \
        (n & 1)
    n_bt, n_kt, n_ch = -(-n_b // 32), -(-n_k // 64), -(-p // 32)
    grid = 5
    for blk in range(grid):
        items = torch.arange(blk, n_bt * u, grid)
        for bt in items.div(u, rounding_mode="floor").unique().tolist():
            users = (items[items // u == bt] - bt * u)
            b0 = 32 * bt
            a = torch.zeros(64, 32 * n_sl)                  # conj(W) staged
            keep = b0 + row_beam < n_b
            bb = torch.clamp(b0 + row_beam, max=n_b - 1)
            a[:, :t_] = torch.where(keep[:, None],
                                    cw[:, bb, 0].t() * (row_part == 0)[:, None]
                                    + cw[:, bb, 1].t() * (row_part == 1)[:,
                                                                         None],
                                    torch.zeros(()))
            for r in range(r_):
                for s in range(n_s):
                    for k0 in range(0, n_k, 64):
                        y = 0
                        for c in range(n_ch):
                            pc = torch.clamp(32 * c + x_path, max=p - 1)
                            ok = (32 * c + x_path < p).float()
                            x = torch.zeros(len(users), 32 * n_sl, 64)
                            x[:, :t_] = torch.where(
                                x_part == 0, atx_r[users][:, :, pc],
                                atx_i[users][:, :, pc]) * ok
                            d = 0
                            for sl in range(n_sl - (slip == "slice")):
                                z = slice(32 * sl, 32 * sl + 32)
                                d = d + _mm3(a[:, z], x[:, z])
                            a2 = torch.zeros(len(users), 64, 64)
                            for j in range(8):
                                c0, c1 = 8 * j + 2 * tt, 8 * j + 2 * tt + 1
                                er = d[:, ra, c0] - d[:, ra + 8, c1]
                                ei = d[:, ra, c1] + d[:, ra + 8, c0]
                                frag = [er, ei, -ei, er]
                                if slip == "depth":
                                    frag = [er, -ei, ei, er]
                                a2[:, ra, 8 * j + tt] = frag[0]
                                a2[:, ra + 8, 8 * j + tt] = frag[1]
                                a2[:, ra, 8 * j + tt + 4] = frag[2]
                                a2[:, ra + 8, 8 * j + tt + 4] = frag[3]
                            pg = torch.clamp(32 * c + g_path, max=p - 1)
                            okg = (32 * c + g_path < p).float()
                            am = amp[users][:, (s if n_sa > 1 else 0) * p:][
                                :, pg] * okg
                            ca_r = am * arx_r[users][:, r, pg]
                            ca_i = am * arx_i[users][:, r, pg]
                            kk = (k0 + g_col).float()
                            ph = psi[users][:, s * p:][:, pg, None] - \
                                omega[users][:, pg, None] * kk
                            vr, vi = torch.cos(ph), torch.sin(ph)
                            gr = ca_r[..., None] * vr - ca_i[..., None] * vi
                            gi = ca_r[..., None] * vi + ca_i[..., None] * vr
                            gm = torch.where((g_part == 1)[:, None], gi, gr)
                            y = y + _mm3(a2, gm)             # [users, 64, 64]
                        for i in range(4):
                            for q in range(4):
                                j, cc = 2 * i + (q >> 1), q & 1
                                col = 8 * j + 2 * tt + cc
                                yr, yi = y[:, ra, col], y[:, ra + 8, col]
                                kl = 16 * i + 4 * tt + q
                                b = b0 + 8 * v_ + g_
                                ok2 = (b < n_b) & (k0 + kl < n_k)
                                out[users[:, None], (r * n_b + b)[ok2],
                                    (s * n_k + k0 + kl)[ok2]] = \
                                    (yr * yr + yi * yi)[:, ok2]
    return out


# name: (rx_shape, tx_shape, B, K, U, P, S, per-slot amp)
WIDE_EMU_CASES = {
    "cell": ((1, 1), (16, 16), 256, 64, 3, 25, 1, False),
    "t72_ragged": ((1, 1), (9, 8), 70, 17, 7, 37, 1, False),
    "t128_rx_slots": ((2, 1), (16, 8), 40, 100, 2, 9, 2, True),
}


@pytest.mark.parametrize("name", sorted(WIDE_EMU_CASES))
def test_wide_design_tile_plan_emulated(name):
    """The wide design's tile plan (tiles of 32 beams staged per block for
    the users it takes, slices of 32 TX elements, path chunks and output
    tiles), its layouts and signs, emulated in float32 at 3xTF32 at the
    sizes the wrapper launches it with, against the plain version in
    float64 whole within RTOL; a planted slip of the depth order, of the
    conjugate or of a slice misses it by far."""
    rx, tx, b, k, u, p, s, per_slot = WIDE_EMU_CASES[name]
    arrs = [torch.from_numpy(a) for a in _scalars(u, p, s, per_slot,
                                                  seed=31)]
    wr, wi = (torch.from_numpy(x) for x in _codebook(b, tx[0] * tx[1], 32))
    want = kb.beam_gain_reference(*(x.double() for x in (*arrs, wr, wi)),
                                  rx, tx, k)
    scale = float(want.max())
    n_sa = arrs[4].shape[1] // p
    assert kb.beam_gain_design(rx, tx, b, k, p, s) in ("tc_wide", "f32")

    def launch(slip=None):
        out = torch.full(want.shape, float("nan"))
        return _wide_launch_emulated(arrs, wr, wi, out, u, p, *rx, *tx, b,
                                     k, s, n_sa, kb.DESIGNS["tc_wide"], slip)

    got = launch()
    assert not torch.isnan(got).any()
    assert float((got.double() - want).abs().max()) <= RTOL * scale
    for slip in ("depth", "conj", "slice"):
        bad = launch(slip)
        assert float((bad.double() - want).abs().max()) > 0.05 * scale


# ----------------------------------------------------------------------------
# render_beam_gains and the dataset entry point
# ----------------------------------------------------------------------------

U = 16
BASE = dict(bs_shape=(8, 8), ue_shape=(1, 1), subcarriers=512,
            selected_subcarriers=tuple(range(64)), bandwidth=10e6,
            num_paths=25, backend="fused", planes_layout="packed")
STATES = {
    "isotropic": {},
    "bs_fov": dict(bs_fov=(120.0, 90.0)),
    "mimo_dipole_xla": dict(bs_shape=(4, 2), ue_shape=(2, 1),
                            ue_pattern="halfwave-dipole", backend="xla",
                            selected_subcarriers=tuple(range(2, 34, 2))),
}


def _leaves(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _state(name, seed=11):
    import jax.numpy as jnp
    from deepmimo_tpu.ops import types as jtypes

    d = make_synthetic_paths(n_ue=U, max_paths=25, seed=seed)
    jpaths = jtypes.PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], dtype=jnp.float32)
    jbs = jtypes.AntennaPanel.make((5.0, -10.0, 20.0))
    jue = jtypes.AntennaPanel.make((0.0, 10.0, -5.0))
    jcfg = jtypes.ChannelConfig(**{**BASE, **STATES[name]})
    tstate = ttypes.state_from_numpy(_leaves(jpaths), _leaves(jbs),
                                     _leaves(jue), dataclasses.asdict(jcfg),
                                     device="cpu")
    return (jpaths, jbs, jue, jcfg), tstate


@pytest.mark.parametrize("name", sorted(STATES))
def test_render_beam_gains_matches_jax(name):
    import jax.numpy as jnp
    from deepmimo_tpu.ops import channel as jch

    jstate, (pd, bs, ue, cfg) = _state(name)
    wr, wi = _codebook(6, cfg.n_tx_ant, seed=9)
    assert tch.beam_gain_eligible(cfg, 6) == \
        jch.beam_gain_eligible(jstate[3], 6)
    want = np.asarray(jch.render_beam_gains(*jstate, jnp.asarray(wr),
                                            jnp.asarray(wi)))
    got = tch.render_beam_gains(pd, bs, ue, cfg, torch.from_numpy(wr),
                                torch.from_numpy(wi))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=RTOL * want.max())
    out = torch.full_like(got, float("nan"))
    assert tch.render_beam_gains(pd, bs, ue, cfg, wr, wi, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("change", [
    dict(rx_filter=True), dict(freq_domain=False),
    dict(selected_subcarriers=(0, 1, 3)),
], ids=["rx_filter", "time_domain", "non_arithmetic"])
def test_render_beam_gains_refuses(change):
    _, (pd, bs, ue, cfg) = _state("isotropic")
    wr, wi = _codebook(4, 64)
    with pytest.raises(ValueError, match="rx_filter" if "rx_filter" in change
                       else "frequency domain"):
        tch.render_beam_gains(pd, bs, ue, cfg.replace(**change), wr, wi)


@pytest.mark.parametrize("polar", [False, True], ids=["single", "polar"])
def test_beyond_shared_memory_plain_on_cpu_raises_on_card(polar,
                                                          monkeypatch):
    """450 beams at the headline exceed the SIMT design's shared memory
    (conj(W) and one warp), and the one-pass bf16 mode does not run on the
    tensor cores: the fused backend runs the plain version on CPU tensors
    and refuses card tensors (the device check patched here); backend "xla"
    runs the plain version on either. At f32 grade the tensor cores take
    them."""
    _, (pd, bs, ue, cfg) = _state("isotropic")
    assert tch.beam_gain_eligible(cfg, 450)
    cfg = cfg.replace(matmul_dtype="bfloat16")
    wr, wi = (torch.from_numpy(x) for x in _codebook(450, 64))
    assert not tch.beam_gain_eligible(cfg, 450)
    assert tch.beam_gain_eligible(cfg, 449)
    assert tch.beam_gain_eligible(cfg, 16)
    fn, pol = tch.render_beam_gains, ()
    if polar:
        rng = np.random.RandomState(4)
        fn = tch.render_beam_gains_polar
        pol = (torch.from_numpy(np.float32(rng.uniform(-120, -70,
                                                       (4, U, 25)))),
               torch.from_numpy(np.float32(rng.uniform(-180, 180,
                                                       (4, U, 25)))))
    xla = cfg.replace(backend="xla")
    want = fn(pd, bs, ue, xla, *pol, wr, wi)
    assert torch.isfinite(want).all()
    assert torch.equal(fn(pd, bs, ue, cfg, *pol, wr, wi), want)
    monkeypatch.setattr(tch, "_on_card", lambda dev: True)
    # the prologue kernel cannot run on these CPU tensors: its PyTorch ops
    monkeypatch.setattr(tch, "_prologue_route", lambda *a: False)
    with pytest.raises(ValueError, match="shared memory.*'float32'"):
        fn(pd, bs, ue, cfg, *pol, wr, wi)
    assert torch.equal(fn(pd, bs, ue, xla, *pol, wr, wi), want)
    before = kb.LAUNCHES                # 16 beams fit: the kernel wrapper,
    got = fn(pd, bs, ue, cfg, *pol, wr[:16], wi[:16])     # plain on the CPU
    assert kb.LAUNCHES == before
    assert torch.equal(got, fn(pd, bs, ue, xla, *pol, wr[:16], wi[:16]))


@pytest.fixture
def port_on_cpu():
    """The port renders on the CPU here (its config default is "cuda")."""
    old = dict(dmt.config.items())
    dmt.config.set("device", "cpu")
    yield
    for k, v in old.items():
        dmt.config.set(k, v)


def _data(seed=3, n_ue=40, max_paths=12):
    d = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed)
    d.pop("n_valid")
    d["rx_pos"] = np.zeros((n_ue, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    return d


def _params(pkg, ue_shape=(1, 1), **kw):
    c = pkg.consts
    p = pkg.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([8, 8])
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 15, -30])
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_SHAPE] = np.array(ue_shape)
    p[c.PARAMSET_NUM_PATHS] = 12
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(64)
    for k, v in kw.items():
        p[c.PARAMSET_OFDM][k] = v
    return p


def _bench_codebook(b=16, t=64, seed=5):
    """benchmarks/run_beamgain_bench.py's codebook: random phase / 8."""
    rng = np.random.RandomState(seed)
    return np.exp(1j * rng.uniform(-np.pi, np.pi, (b, t))) / 8.0


@pytest.mark.parametrize("ue_shape", [(1, 1), (2, 1)])
def test_compute_beam_gains_matches_jax(port_on_cpu, ue_shape):
    import deepmimo_tpu as dm

    w = _bench_codebook()
    want = dm.Dataset(_data()).compute_beam_gains(_params(dm, ue_shape),
                                                  codebook=w)
    ds = dmt.Dataset(_data())
    got = ds.compute_beam_gains(_params(dmt, ue_shape), codebook=w)
    r = ue_shape[0] * ue_shape[1]
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (40, r, 16, 64)
    np.testing.assert_allclose(got, want, atol=RTOL * want.max())
    tup = ds.compute_beam_gains(_params(dmt, ue_shape),
                                codebook=(w.real, w.imag))
    np.testing.assert_array_equal(tup, got)


def test_compute_beam_gains_device_layout_and_out_reuse(port_on_cpu):
    import deepmimo_tpu as dm

    w = _bench_codebook()
    want = np.asarray(dm.Dataset(_data()).compute_beam_gains(
        _params(dm), codebook=w, to_device=True))
    ds = dmt.Dataset(_data())
    params = _params(dmt)
    g = ds.compute_beam_gains(params, codebook=w, to_device=True)
    assert isinstance(g, torch.Tensor) and tuple(g.shape) == (40, 16, 64)
    np.testing.assert_allclose(g.numpy(), want, atol=RTOL * want.max())
    first = g.clone()
    ptr = g.data_ptr()
    for _ in range(3):                  # serving loop: one buffer
        g = ds.compute_beam_gains(params, codebook=w, to_device=True, out=g)
        assert g.data_ptr() == ptr and torch.equal(g, first)
    wrong = torch.zeros(40, 2, 64)
    g2 = ds.compute_beam_gains(params, codebook=w, to_device=True, out=wrong)
    assert g2.data_ptr() != wrong.data_ptr() and torch.equal(g2, first)
    assert not wrong.any()


def test_compute_beam_gains_codebook_errors_and_rx_filter(port_on_cpu):
    ds = dmt.Dataset(_data())
    w = _bench_codebook()
    with pytest.raises(ValueError, match="codebook"):
        ds.compute_beam_gains(_params(dmt), codebook=w[:, :32])
    with pytest.raises(ValueError, match="codebook"):
        ds.compute_beam_gains(_params(dmt), codebook=w[0])
    with pytest.raises(ValueError, match="requires a codebook"):
        ds.compute_beam_gains(_params(dmt))
    with pytest.raises(ValueError, match="rx_filter"):
        ds.compute_beam_gains(_params(dmt, rx_filter=1), codebook=w)


def test_compute_beam_gains_wide_panel_matches_benchmark_reference(
        port_on_cpu, monkeypatch):
    """A 16x16 panel with its 256-beam codebook (64 users, 8 subcarriers):
    the route takes the kernel wrapper (the wide tensor-core design on a
    card; its plain version on these CPU tensors), and the maps equal the
    benchmark's plain float64 reference (chipbench/reference/channels.py
    beam_gains, which forms H) within RTOL * max|G|."""
    from chipbench.reference import channels as ref

    d = _data(seed=9, n_ue=64, max_paths=12)
    w = _bench_codebook(b=256, t=256, seed=6)
    params = _params(dmt)
    c = dmt.consts
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([16, 16])
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = np.array([0, 0, 0])
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(8)
    cfg, _, _ = params.to_config(64, device="cpu")
    assert tch.beam_gain_eligible(cfg, 256)
    assert kb.beam_gain_design(cfg.ue_shape, cfg.bs_shape, 256, 8,
                               cfg.num_paths, 1) == "tc_wide"
    calls = []
    real = kb.fused_beam_gain
    monkeypatch.setattr(kb, "fused_beam_gain", lambda *a, **kw: (
        calls.append(tuple(a[7].shape)), real(*a, **kw))[1])
    got = dmt.Dataset(dict(d)).compute_beam_gains(params, codebook=w)
    assert calls == [(256, 256)]
    assert got.shape == (64, 1, 256, 8) and got.dtype == np.float32
    cp = dict(bs_antenna=dict(shape=[16, 16], spacing=0.5,
                              rotation=[0, 0, 0],
                              radiation_pattern="isotropic"),
              ue_antenna=dict(shape=[1, 1], spacing=0.5, rotation=[0, 0, 0],
                              radiation_pattern="isotropic"),
              ofdm=dict(subcarriers=512,
                        selected_subcarriers=list(range(8)),
                        bandwidth=float(params[c.PARAMSET_OFDM][
                            c.PARAMSET_OFDM_BANDWIDTH]), rx_filter=0),
              num_paths=12, freq_domain=1, enable_doppler=0,
              enable_dual_polar=0)
    p = ref.paths_to_tensors({k: v for k, v in d.items()
                              if k not in ("rx_pos", "tx_pos")},
                             slice(0, 64), "cpu")
    want = ref.beam_gains(p, cp, w).numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * want.max())


# ----------------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain fold in FP32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


# name: (rx_shape, tx_shape, B, K, U, P, S, per-slot amp) on the card
CUDA_CASES = {
    "headline": ((1, 1), (8, 8), 16, 64, 12 * 257, 25, 1, False),
    "multi_rx": ((2, 1), (4, 2), 8, 16, 12 * 257, 25, 1, False),
    "four_chunks": ((2, 2), (4, 4), 5, 17, 1031, 100, 3, False),
    "polar_slots": ((1, 1), (8, 8), 16, 64, 2053, 25, 4, True),
    "one_user": ((1, 1), (8, 8), 16, 64, 1, 25, 1, False),
    # more users than one round of the grid's warps, not a multiple of 8;
    # T1 = 16 (two blocks of 8), two chunks (K stays 64: with omega up to
    # 6 rad per subcarrier, float32 phases past ~400 rad lose the bound)
    "ragged_round": ((1, 1), (16, 4), 16, 64, 132 * 16 + 13, 39, 1, False),
    "chunks_of_8": ((1, 1), (8, 8), 440, 64, 37, 20, 2, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain_version(cuda, name):
    rx, tx, b, k, u, p, s, per_slot = CUDA_CASES[name]
    arrs = _scalars(u, p, s, per_slot, seed=4)
    w = _codebook(b, tx[0] * tx[1], seed=5)
    args = [torch.from_numpy(a).to(cuda) for a in (*arrs, *w)]
    before = kb.LAUNCHES
    got = kb.fused_beam_gain(*args, rx, tx, k)
    want = kb.beam_gain_reference(*args, rx, tx, k)
    torch.cuda.synchronize()
    assert kb.LAUNCHES == before + 1
    scale = float(want.max())
    assert float((got - want).abs().max()) <= RTOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_kernel_one_pass_matches_plain_version(cuda, name):
    """The kernel's one-pass bf16 path sum against its plain version in the
    same mode (operands from its own trig, so a bf16 rounding may fall the
    other way: the mode's bound)."""
    rx, tx, b, k, u, p, s, per_slot = CUDA_CASES[name]
    arrs = _scalars(u, p, s, per_slot, seed=4)
    w = _codebook(b, tx[0] * tx[1], seed=5)
    args = [torch.from_numpy(a).to(cuda) for a in (*arrs, *w)]
    before = kb.LAUNCHES
    got = kb.fused_beam_gain(*args, rx, tx, k, mm_dtype="bfloat16")
    want = kb.beam_gain_reference(*args, rx, tx, k, "bfloat16")
    torch.cuda.synchronize()
    assert kb.LAUNCHES == before + 1
    assert float((got - want).abs().max()) <= BF16_RTOL * float(want.max())


# the float64 instantiation at the card shapes its shared memory takes
# (chunks_of_8's 440 beams do not), and its own chunk-of-8 plan
CUDA_F64_CASES = {**{k: v for k, v in CUDA_CASES.items()
                     if k != "chunks_of_8"},
                  "chunks_of_8_f64": ((1, 1), (8, 8), 215, 64, 37, 20, 2,
                                      True)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_F64_CASES))
def test_cuda_float64_kernel_matches_plain_version(cuda, name):
    """The float64 instantiation against the plain version in float64,
    within 1e-9 * max|G|, one launch counted under "f64"."""
    rx, tx, b, k, u, p, s, per_slot = CUDA_F64_CASES[name]
    arrs = _scalars(u, p, s, per_slot, seed=4)
    w = _codebook(b, tx[0] * tx[1], seed=5)
    args = [torch.from_numpy(a).double().to(cuda) for a in (*arrs, *w)]
    before = kb.LAUNCHES, kb.MODE_LAUNCHES.get("f64", 0)
    got = kb.fused_beam_gain(*args, rx, tx, k)
    want = kb.beam_gain_reference(*args, rx, tx, k)
    torch.cuda.synchronize()
    assert (kb.LAUNCHES, kb.MODE_LAUNCHES["f64"]) == (before[0] + 1,
                                                      before[1] + 1)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-9 * float(want.max())


@pytest.mark.gpu
def test_cuda_dataset_serving_loop_reuses_out(cuda):
    """config['device'] is "cuda" while the tensors report cuda:0: out=
    must still be reused, with one kernel launch per call."""
    old = dmt.config.get("device")
    dmt.config.set("device", "cuda")
    try:
        ds = dmt.Dataset(_data(n_ue=300))
        w = _bench_codebook()
        g = ds.compute_beam_gains(_params(dmt), codebook=w, to_device=True)
        first, ptr = g.clone(), g.data_ptr()
        before = kb.LAUNCHES
        for _ in range(2):
            g = ds.compute_beam_gains(_params(dmt), codebook=w,
                                      to_device=True, out=g)
        torch.cuda.synchronize()
        assert kb.LAUNCHES == before + 2
        assert g.data_ptr() == ptr and torch.equal(g, first)
    finally:
        dmt.config.set("device", old)


@pytest.mark.gpu
def test_cuda_beyond_shared_memory_raises(cuda):
    """450 beams at the headline exceed the SIMT design's shared memory,
    and the one-pass bf16 mode does not run on the tensor cores: on the
    card compute_beam_gains raises, with no launch, instead of forming H
    for the plain version; 449 beams with 351 paths launch the kernel."""
    old = dmt.config.get("device"), dmt.config.get("matmul_dtype")
    dmt.config.set("device", "cuda")
    dmt.config.set("matmul_dtype", "bfloat16")
    try:
        ds = dmt.Dataset(_data(n_ue=8, max_paths=351))
        params = _params(dmt)
        params[dmt.consts.PARAMSET_NUM_PATHS] = 351
        w = _bench_codebook(b=450)
        before = kb.LAUNCHES
        with pytest.raises(ValueError, match="shared memory"):
            ds.compute_beam_gains(params, codebook=w, to_device=True)
        assert kb.LAUNCHES == before
        g = ds.compute_beam_gains(params, codebook=w[:449], to_device=True)
        torch.cuda.synchronize()
        assert kb.LAUNCHES == before + 1
        assert tuple(g.shape) == (8, 449, 64) and \
            bool(torch.isfinite(g).all())
    finally:
        dmt.config.set("device", old[0])
        dmt.config.set("matmul_dtype", old[1])


@pytest.mark.gpu
def test_cuda_smem_bytes_is_the_kernels_own(cuda):
    """smem_bytes mirrors the launcher's arithmetic (csrc/beamgain.cu
    exports it)."""
    import ctypes

    from deepmimo_tpu_torch.ops.kernels import _build
    fn = _build.load_library("beamgain").beamgain_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for f64 in (False, True):
        for tx in [(1, 1), (3, 5), (8, 8), (16, 16), (32, 32)]:
            for b in (1, 5, 16, 64, 113, 209, 215, 222, 223, 320, 440, 449,
                      450, 1000):
                t = tx[0] * tx[1]
                want = kb.smem_bytes((1, 1), tx, b, 25, 64, f64)
                assert fn(t, b, int(f64)) == (
                    want if want <= 232_448 else 0), (tx, b, f64)


# name: (rx_shape, tx_shape, B, K, U, P, S, per-slot amp): shapes that the
# tensor-core design takes
CUDA_TC_CASES = {
    "cell": ((1, 1), (8, 8), 64, 64, 12 * 257, 25, 1, False),
    "ragged_beams": ((1, 1), (8, 8), 100, 64, 1031, 25, 1, False),
    "two_rx": ((2, 1), (8, 8), 64, 64, 1031, 25, 1, False),
    "four_slots": ((1, 1), (8, 8), 64, 64, 1031, 25, 4, True),
    "three_chunks": ((1, 1), (8, 8), 64, 64, 1031, 40, 1, False),
    "ragged_cols": ((1, 1), (8, 8), 64, 100, 1031, 25, 1, False),
    "one_user": ((1, 1), (8, 8), 64, 64, 1, 25, 1, False),
    "ragged_users": ((1, 1), (8, 8), 64, 64, 132 * 16 + 13, 25, 1, False),
    # T <= 32 (four fold k-steps), a panel that is not 8 wide, several
    # chunks, scalar stores (K % 4 != 0), three slots
    "odd_panel_chunks": ((1, 1), (3, 5), 70, 17, 1031, 37, 3, False),
    # four RX elements, two slots with per-slot amp, a ragged column tile,
    # 9 paths
    "small_panel_rx_slots": ((2, 2), (4, 4), 64, 100, 1031, 9, 2, True),
    # the quickstart panel (BS 8x1) and one subcarrier
    "quickstart": ((1, 1), (8, 1), 64, 1, 1031, 25, 1, False),
    # T = 64 on a panel that is not 8 wide
    "wide_rows": ((1, 1), (16, 4), 64, 64, 1031, 25, 1, False),
}


def _cuda_run(cuda, shape, dtype=torch.float32):
    """The kernel and its plain version on the card; the launch counters'
    steps (LAUNCHES, TC_LAUNCHES), and MODE_LAUNCHES["tc_wide"]'s."""
    rx, tx, b, k, u, p, s, per_slot = shape
    arrs = _scalars(u, p, s, per_slot, seed=4)
    w = _codebook(b, tx[0] * tx[1], seed=5)
    args = [torch.from_numpy(a).to(dtype).to(cuda) for a in (*arrs, *w)]
    before = kb.LAUNCHES, kb.TC_LAUNCHES, kb.MODE_LAUNCHES.get("tc_wide", 0)
    got = kb.fused_beam_gain(*args, rx, tx, k)
    want = kb.beam_gain_reference(*args, rx, tx, k)
    torch.cuda.synchronize()
    steps = kb.LAUNCHES - before[0], kb.TC_LAUNCHES - before[1]
    assert kb.MODE_LAUNCHES.get("tc_wide", 0) - before[2] == 0
    return got, want, steps


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_TC_CASES))
def test_cuda_tensor_core_design_matches_plain_version(cuda, name):
    """The tensor-core design (one launch, counted in TC_LAUNCHES) against
    the plain version within RTOL * max|G|."""
    got, want, steps = _cuda_run(cuda, CUDA_TC_CASES[name])
    assert steps == (1, 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= RTOL * float(want.max())


@pytest.mark.gpu
@pytest.mark.parametrize("name, shape, dtype", [
    ("below_threshold", ((1, 1), (8, 8), kb.TC_MIN_BEAMS - 1, 64, 1031, 25,
                         1, False), torch.float32),
    ("float64", ((1, 1), (8, 8), 64, 64, 1031, 25, 1, False),
     torch.float64),
    # T = 288, past both tensor-core designs' staged codebooks; chunks of 8
    # paths in the SIMT plan
    ("wide_panel", ((1, 1), (16, 18), 99, 64, 37, 20, 2, True),
     torch.float32),
    # the quickstart panel at 32 beams, and a small panel with few paths:
    # the SIMT design is the faster there
    ("quickstart_32", ((1, 1), (8, 1), 32, 1, 1031, 25, 1, False),
     torch.float32),
    ("few_paths", ((2, 2), (4, 4), 32, 100, 1031, 9, 2, True),
     torch.float32)])
def test_cuda_simt_design_keeps_other_shapes(cuda, name, shape, dtype):
    """Shapes off the tensor-core route run the SIMT design: one launch,
    TC_LAUNCHES unmoved, within its bound (1e-9 in float64)."""
    got, want, steps = _cuda_run(cuda, shape, dtype)
    assert steps == (1, 0)
    tol = 1e-9 if dtype == torch.float64 else RTOL
    assert float((got - want).abs().max()) <= tol * float(want.max())


# name: (rx_shape, tx_shape, B, K, U, P, S, per-slot amp): the wide
# tensor-core design, T from 72 to 256, beams from 32 to 256, one and two
# path chunks, 1 and 4 RX elements and slots, ragged users
CUDA_WIDE_CASES = {
    "cell": ((1, 1), (16, 16), 256, 64, 12 * 257, 25, 1, False),
    "t72_b32": ((1, 1), (9, 8), 32, 64, 1031, 25, 1, False),
    "t72_b100_chunks": ((1, 1), (9, 8), 100, 64, 1031, 40, 1, False),
    "t128_b100": ((1, 1), (16, 8), 100, 64, 132 * 16 + 13, 25, 1, False),
    "t128_b256_rx_slots": ((2, 2), (16, 8), 256, 64, 517, 25, 4, True),
    "t128_b32_chunks_slots": ((1, 1), (8, 16), 32, 100, 1031, 40, 4,
                              True),
    "t256_b32": ((1, 1), (16, 16), 32, 64, 1031, 25, 1, False),
    "t256_b100_rx": ((2, 2), (16, 16), 100, 64, 1031, 25, 1, False),
    "t256_b256_chunks_rx": ((2, 2), (16, 16), 256, 17, 261, 40, 1, False),
    "t256_b256_slots": ((1, 1), (16, 16), 256, 64, 1031, 40, 4, True),
    "one_user": ((1, 1), (16, 16), 256, 64, 1, 25, 1, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_WIDE_CASES))
def test_cuda_wide_design_matches_plain_version(cuda, name):
    """The wide tensor-core design, launched as the wrapper launches it,
    against the plain version within RTOL * max|G|; where the route takes
    it (past the SIMT plan, the cell among them), fused_beam_gain runs it
    in one launch counted under MODE_LAUNCHES["tc_wide"] alone."""
    rx, tx, b, k, u, p, s, per_slot = CUDA_WIDE_CASES[name]
    arrs = _scalars(u, p, s, per_slot, seed=4)
    w = _codebook(b, tx[0] * tx[1], seed=5)
    args = [torch.from_numpy(a).to(cuda) for a in (*arrs, *w)]
    want = kb.beam_gain_reference(*args, rx, tx, k)
    got = torch.full_like(want, float("nan"))
    n_sa = args[4].shape[1] // p
    kb._launch(args[:7], args[7], args[8], got, u, p, *rx, *tx, b, k, s,
               n_sa, kb.DESIGNS["tc_wide"])
    torch.cuda.synchronize()
    scale = float(want.max())
    assert float((got - want).abs().max()) <= RTOL * scale
    design = kb.beam_gain_design(rx, tx, b, k, p, s)
    if kb.smem_bytes(rx, tx, b, p, k) > 232_448 or name == "cell":
        assert design == "tc_wide"
    if design == "tc_wide":
        before = (kb.LAUNCHES, kb.TC_LAUNCHES, dict(kb.MODE_LAUNCHES))
        routed = kb.fused_beam_gain(*args, rx, tx, k)
        torch.cuda.synchronize()
        assert (kb.LAUNCHES - before[0], kb.TC_LAUNCHES - before[1]) == \
            (1, 0)
        assert kb.MODE_LAUNCHES["tc_wide"] == \
            before[2].get("tc_wide", 0) + 1
        assert kb.MODE_LAUNCHES.get("f32", 0) == before[2].get("f32", 0)
        assert torch.equal(routed, got)


@pytest.mark.gpu
def test_cuda_dataset_wide_panel_on_the_tensor_cores(cuda):
    """compute_beam_gains at a 16x16 panel with its 256-beam codebook on
    the card: no ValueError, one wide-design launch a call, the same maps
    as on the CPU (the plain version) within RTOL * max|G|."""
    w = _bench_codebook(b=256, t=256)
    params = _params(dmt)
    params[dmt.consts.PARAMSET_ANT_BS][dmt.consts.PARAMSET_ANT_SHAPE] = \
        np.array([16, 16])
    old = dmt.config.get("device")
    try:
        dmt.config.set("device", "cpu")
        want = dmt.Dataset(_data(n_ue=300)).compute_beam_gains(
            params, codebook=w, to_device=True)
        dmt.config.set("device", "cuda")
        before = kb.MODE_LAUNCHES.get("tc_wide", 0)
        got = dmt.Dataset(_data(n_ue=300)).compute_beam_gains(
            params, codebook=w, to_device=True)
        torch.cuda.synchronize()
    finally:
        dmt.config.set("device", old)
    assert kb.MODE_LAUNCHES["tc_wide"] == before + 1
    assert tuple(got.shape) == tuple(want.shape) == (300, 256, 64)
    err = float((got.cpu() - want).abs().max())
    assert err <= RTOL * float(want.max())
