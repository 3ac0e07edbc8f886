"""Backward of the port's fused render: the plain VJP and the autograd
Function against the JAX backward kernel (Pallas in interpret mode) and
its XLA VJP, the repaired autograd graph, exact zeros on masked paths, and
— on a CUDA card only — the CUDA backward kernel vs its plain version.

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_grad.py``.
"""

import numpy as np
import pytest
import torch

from deepmimo_tpu_torch.ops.kernels import render as kr

torch.set_num_threads(1)
GTOL = 3e-4      # relative to max|g|: the bound of tests/test_pallas.py
# One-pass bf16 products, relative to max|g| (no JAX bound exists; bf16
# rounds each operand by up to 2^-9, see tests/test_torch_render.py).
BF16_GTOL = 1e-2

U, P, K = 20, 13, 16
# name: (rx_shape, tx_shape, S, per-slot amp, packed); the first five are
# the shapes of the JAX backward test (tests/test_pallas.py:239-243).
CASES = {
    "single_rx": ((1, 1), (8, 8), 1, False, False),
    "full_rx": ((2, 2), (4, 2), 1, False, False),
    "two_slots": ((1, 2), (2, 4), 2, False, False),
    "packed": ((1, 1), (4, 4), 1, False, True),
    "packed_two_slots": ((2, 1), (2, 2), 2, False, True),
    "per_slot_amp": ((2, 1), (2, 2), 4, True, True),
    # Q = 15, S*K = 51 and P = 37: off every tile size and the k-step.
    "odd_panel": ((1, 1), (3, 5), 3, True, False),
}
SIZES = {"odd_panel": (37, 17)}     # (P, K) of the cases that differ


def _pk(name):
    return SIZES.get(name, (P, K))


def _inputs(rx, tx, s, per_slot, packed, u=U, seed=11, p=P, k=K):
    rng = np.random.RandomState(seed)
    mk = lambda lo, hi, *sh: rng.uniform(lo, hi, sh).astype(np.float32)
    args = [mk(-3, 3, u, p) for _ in range(4)] + [
        mk(0, 1e-3, u, (s if per_slot else 1) * p), mk(-3, 3, u, s * p),
        mk(0, 6, u, p)]
    q = rx[0] * rx[1] * tx[0] * tx[1]
    ct = mk(-1, 1, u, q, 2 * s * k) if packed else mk(-1, 1, 2, u, q, s * k)
    return args, ct


def _close(got, want, tol=GTOL):
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * np.abs(w).max() + 1e-30)


def _jax_grads(name, args, ct, mm_dtype="float32"):
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas import render as R

    rx, tx, _, _, packed = CASES[name]
    k = _pk(name)[1]
    jargs = [jnp.asarray(a) for a in args]
    kernel = R._bwd_impl(*jargs, jnp.asarray(ct), rx, tx, k, 8, True,
                         mm_dtype, packed)
    xla = R._bwd_xla(rx, tx, k, packed, jargs, jnp.asarray(ct))
    return kernel, xla


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_reference_matches_jax(name):
    rx, tx, s, per_slot, packed = CASES[name]
    p, k = _pk(name)
    args, ct = _inputs(rx, tx, s, per_slot, packed, p=p, k=k)
    got = kr.fused_render_bwd_reference(
        *[torch.from_numpy(a) for a in args], torch.from_numpy(ct), rx, tx,
        k, packed)
    kernel, xla = _jax_grads(name, args, ct)
    _close(got, kernel)
    _close(got, xla)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_backward_matches_jax_kernel(name):
    rx, tx, s, per_slot, packed = CASES[name]
    p, k = _pk(name)
    args, ct = _inputs(rx, tx, s, per_slot, packed, seed=12, p=p, k=k)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h = kr.fused_render(*leaves, rx, tx, k, packed)
    h.backward(torch.from_numpy(ct))
    kernel, _ = _jax_grads(name, args, ct)
    _close([x.grad for x in leaves], kernel)
    if per_slot:
        assert leaves[4].grad.shape == (U, s * p)      # damp per slot


@pytest.mark.parametrize("mm", ["bfloat16", "default", "highest"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_modes_match_jax(name, mm):
    """The plain backward in each matmul_dtype against the TPU backward
    kernel in the same mode (interpret mode: "default" and "highest" are
    f32 there) and against the f32 XLA VJP."""
    rx, tx, s, per_slot, packed = CASES[name]
    p, k = _pk(name)
    args, ct = _inputs(rx, tx, s, per_slot, packed, seed=13, p=p, k=k)
    got = kr.fused_render_bwd(
        *[torch.from_numpy(a) for a in args], torch.from_numpy(ct), rx, tx,
        k, packed, mm)
    kernel, xla = _jax_grads(name, args, ct, mm)
    tol = GTOL if kr.MM_PASSES[mm] == 3 else BF16_GTOL
    _close(got, kernel, tol)
    _close(got, xla, tol)


@pytest.mark.parametrize("mode", ["bf16_mm", "bf16_out"])
def test_function_modes_match_jax_grad(mode):
    """torch.autograd through the port's fused render against jax.grad
    through the JAX one, in the one-pass and the bf16-output modes, on one
    loss: the gradient flows through a bf16 output (its cotangent is
    widened to f32, tests/test_pallas.py:548-560)."""
    import jax
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas import render as R

    mm = "bfloat16" if mode == "bf16_mm" else "float32"
    out_dtype = "bfloat16" if mode == "bf16_out" else "float32"
    rx, tx, s, per_slot, packed = CASES["per_slot_amp"]
    args, _ = _inputs(rx, tx, s, per_slot, packed, seed=14)

    def jloss(a):
        h = R.fused_render(*a, rx, tx, K, 8, True, mm, packed, out_dtype)
        return jnp.sum(h.astype(jnp.float32) ** 2)

    want = jax.grad(jloss)(tuple(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h = kr.fused_render(*leaves, rx, tx, K, packed, mm_dtype=mm,
                        out_dtype=out_dtype)
    assert h.dtype == kr.OUT_DTYPES[out_dtype]
    h.float().square().sum().backward()
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)
    _close([x.grad for x in leaves], want, BF16_GTOL)


def test_output_carries_the_ports_function():
    """The repair: the fused render is differentiable on every device (the
    CUDA wrapper used to return a tensor with no grad_fn)."""
    rx, tx, s, per_slot, packed = CASES["packed"]
    args, _ = _inputs(rx, tx, s, per_slot, packed)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h = kr.fused_render(*leaves, rx, tx, K, packed)
    assert type(h.grad_fn) is kr.FusedRender._backward_cls
    h.mean().backward()            # a stride-0 cotangent, made dense
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    assert any(float(x.grad.abs().max()) > 0 for x in leaves)


def test_out_under_grad_raises():
    rx, tx, s, per_slot, packed = CASES["packed"]
    args, _ = _inputs(rx, tx, s, per_slot, packed)
    ts = [torch.from_numpy(a) for a in args]
    out = kr.fused_render(*ts, rx, tx, K, packed)
    ts[5].requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        kr.fused_render(*ts, rx, tx, K, packed, out=out)
    with torch.no_grad():
        assert kr.fused_render(*ts, rx, tx, K, packed, out=out) is out


def test_bwd_wrapper_checks_the_cotangent():
    rx, tx, s, per_slot, packed = CASES["packed"]
    args, ct = _inputs(rx, tx, s, per_slot, packed)
    ts = [torch.from_numpy(a) for a in args]
    before = kr.BWD_LAUNCHES
    got = kr.fused_render_bwd(*ts, torch.from_numpy(ct), rx, tx, K, packed)
    assert kr.BWD_LAUNCHES == before      # no kernel launch on the CPU
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in ts]
    for bad in (torch.from_numpy(ct)[:-1], torch.from_numpy(ct).double(),
                torch.from_numpy(ct).transpose(0, 1)):
        with pytest.raises(ValueError):
            kr.fused_render_bwd(*ts, bad, rx, tx, K, packed)


def _masked_state(backend):
    from deepmimo_tpu_torch.ops.types import (AntennaPanel, ChannelConfig,
                                              PathData)
    from oracle import make_synthetic_paths

    d = make_synthetic_paths(n_ue=12, max_paths=8, seed=33)
    paths = PathData.from_numpy(
        d["power"], d["phase"], d["delay"], d["aoa_az"], d["aoa_el"],
        d["aod_az"], d["aod_el"], device="cpu")
    cfg = ChannelConfig(bs_shape=(4, 2), ue_shape=(2, 1), subcarriers=64,
                        selected_subcarriers=tuple(range(8)), num_paths=8,
                        backend=backend)
    return paths, AntennaPanel.make((5, 10, 20), device="cpu"), \
        AntennaPanel.make(device="cpu"), cfg


@pytest.mark.parametrize("route", ["planes_fused", "planes_xla",
                                   "complex_xla", "complex_pallas"])
def test_masked_paths_get_exact_zero_gradients(route):
    """Padded path slots get gradients of exactly 0, not NaN
    (tests/test_gradients.py:118)."""
    import dataclasses
    from deepmimo_tpu_torch.ops.channel import (render_channels,
                                                render_channels_planes)

    kind, backend = route.split("_")
    paths, bs, ue, cfg = _masked_state(backend)
    fields = ("power_dbw", "phase_deg", "delay_s", "aoa_az_deg",
              "aoa_el_deg", "aod_az_deg", "aod_el_deg")
    leaves = {f: getattr(paths, f).clone().requires_grad_(True)
              for f in fields}
    p = dataclasses.replace(paths, **leaves)
    if kind == "planes":
        h = render_channels_planes(p, bs, ue, cfg)
        loss = (h * torch.linspace(-1, 1, h.numel()).reshape(h.shape)).sum()
    else:
        h = render_channels(p, bs, ue, cfg)
        loss = (h * h.conj()).real.sum()
    loss.backward()
    invalid = ~paths.valid
    assert bool(invalid.any())
    for f in fields:
        g = leaves[f].grad
        assert bool(torch.isfinite(g).all()), f
        assert bool((g[invalid] == 0).all()), f
        assert float(g[~invalid].abs().max()) > 0, f


# ----------------------------------------------------------------------------
# The tensor-core design: its factoring, emulated
# ----------------------------------------------------------------------------

def _tf32_rna(x):
    """cvt.rna.tf32.f32 on float32 numbers (render_tables.cuh tf32_rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """lo.hi + hi.lo + hi.hi in float32: the kernels' 3xTF32 product."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tensor_core_bwd_emulation(gry, grz, gty, gtz, amp, psi, omega, ct,
                               rx_shape, tx_shape, n_k, packed):
    """The tensor-core design's factoring in plain float32 torch, laid out
    as csrc/render_bwd.cu lays it out: per path chunk of 32, slot, tile of
    64 rows and step of 32 subcarriers, D3 = cr . B and D4 = ci . B at
    3xTF32, B's column 2 l + c part c of U = e^{j(psi - omega k)} of path
    l and column 64 + 2 l + c that of k U, its depths the subcarriers in
    the order of the consumers' fragments; then per row tile the fold of
    z = conj(E) dE and zk = conj(E) dEk over the rows, in place of the
    contraction over q: damp = Re z, dpsi = a Im z, domega = -a Im zk,
    and dphi = a Im z weighted by each row's panel indices."""
    u, p = omega.shape
    n_s, n_sa = psi.shape[1] // p, amp.shape[1] // p
    (r1, r2), (t1, t2) = rx_shape, tx_shape
    t, sk = t1 * t2, n_s * n_k
    q = r1 * r2 * t
    cr, ci = (ct[..., :sk], ct[..., sk:]) if packed else (ct[0], ct[1])
    rows, chunks, kpad = -(-q // 64) * 64, -(-p // 32) * 32, -(-n_k // 32) * 32
    pad = torch.nn.functional.pad
    cr, ci = (pad(x.reshape(u, q, n_s, n_k), (0, kpad - n_k, 0, 0, 0,
                                               rows - q)) for x in (cr, ci))
    iq = torch.arange(rows)
    tq, rq = iq % t, iq // t
    wt = torch.stack([tq % t1, tq // t1, rq % r1, rq // r1]).float()
    sc = [pad(x, (0, chunks - p)) for x in (gty, gtz, gry, grz)]
    phi = sum(w[None, :, None] * x[:, None] for w, x in zip(wt, sc))
    er = torch.where(iq[None, :, None] < q, torch.cos(phi), 0)
    ei = torch.where(iq[None, :, None] < q, torch.sin(phi), 0)
    om = pad(omega, (0, chunks - p))
    ps = pad(psi.reshape(u, n_s, p), (0, chunks - p))
    a = pad(amp.reshape(u, n_sa, p), (0, chunks - p))
    # depth d of a step: core column m = d // 4 holds k = 16 (m // 4) +
    # m % 4 + 4 (d % 4)
    d = torch.arange(32)
    order = 16 * (d // 16) + (d // 4) % 4 + 4 * (d % 4)
    outs = [torch.zeros(u, chunks) for _ in range(7)]
    damp_s = torch.zeros(u, n_s, chunks)
    dpsi = torch.zeros(u, n_s, chunks)
    for c0 in range(0, chunks, 32):
        pc = slice(c0, c0 + 32)
        for s in range(n_s):
            for r0 in range(0, rows, 64):
                rr = slice(r0, r0 + 64)
                d3 = d4 = 0
                for k0 in range(0, kpad, 32):
                    ks = k0 + order
                    kf = ks.float()[None, :, None]
                    b = ps[:, s, None, pc] - om[:, None, pc] * kf
                    ok = (ks < n_k)[None, :, None]
                    ur = torch.where(ok, torch.cos(b), 0)
                    ui = torch.where(ok, torch.sin(b), 0)
                    B = torch.zeros(u, 32, 128)
                    B[..., 0:64:2], B[..., 1:64:2] = ur, ui
                    B[..., 64::2], B[..., 65::2] = kf * ur, kf * ui
                    d3 = d3 + _mm3(cr[:, rr, s, ks], B)
                    d4 = d4 + _mm3(ci[:, rr, s, ks], B)
                der = d3[..., 0:64:2] + d4[..., 1:64:2]
                dei = d4[..., 0:64:2] - d3[..., 1:64:2]
                dkr = d3[..., 64::2] + d4[..., 65::2]
                dki = d4[..., 64::2] - d3[..., 65::2]
                e_r, e_i = er[:, rr, pc], ei[:, rr, pc]
                zi = e_r * dei - e_i * der
                damp_s[:, s, pc] += (e_r * der + e_i * dei).sum(1)
                dpsi[:, s, pc] += zi.sum(1)
                am = a[:, s if n_sa > 1 else 0, pc]
                outs[6][:, pc] -= am * (e_r * dki - e_i * dkr).sum(1)
                for i, w in enumerate((wt[2], wt[3], wt[0], wt[1])):
                    outs[i][:, pc] += am * (w[rr, None] * zi).sum(1)
            dpsi[:, s, pc] *= a[:, s if n_sa > 1 else 0, pc]
    damp = damp_s[..., :p].reshape(u, n_s * p) if n_sa > 1 else \
        damp_s.sum(1)[:, :p]
    return (*[x[:, :p] for x in outs[:4]], damp,
            dpsi[..., :p].reshape(u, n_s * p), outs[6][:, :p])


# name: (rx_shape, tx_shape, S, per-slot amp, packed, P, K)
TC_CASES = {
    "headline": ((1, 1), (8, 8), 1, False, True, 25, 64),
    "two_row_tiles": ((2, 1), (8, 8), 1, False, False, 25, 16),
    "ragged_columns": ((1, 1), (8, 8), 1, False, True, 25, 100),
    "two_chunks_slots": ((1, 1), (8, 6), 2, True, True, 37, 20),
    "ragged_rows_rx": ((2, 2), (4, 5), 3, True, False, 11, 8),
    "k1": ((1, 1), (8, 8), 1, False, True, 25, 1),
    "many_chunks": ((1, 1), (8, 8), 1, False, True, 227, 64),
    "q48_6x8_stacked": ((1, 1), (6, 8), 2, True, False, 25, 64),
    "q80_k17": ((1, 1), (5, 16), 2, False, True, 25, 17),
    "q144_k100": ((1, 1), (8, 18), 1, False, True, 25, 100),
}


@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_tensor_core_bwd_factoring_matches_plain_version(name):
    """The tensor-core design's tiles, column order and fold, emulated on
    the CPU, within GTOL of the plain version: two row tiles, ragged
    column steps, K = 1, two and eight path chunks (P = 227), per-slot
    amplitudes, ragged row tiles (Q = 48, 80, 144, a 2 x 2 RX panel over
    three slots), both layouts."""
    rx, tx, s, per_slot, packed, p, k = TC_CASES[name]
    args, ct = _inputs(rx, tx, s, per_slot, packed, u=3, seed=21, p=p, k=k)
    ts = [torch.from_numpy(x) for x in args]
    ct = torch.from_numpy(ct)
    got = _tensor_core_bwd_emulation(*ts, ct, rx, tx, k, packed)
    want = kr.fused_render_bwd_reference(*ts, ct, rx, tx, k, packed)
    _close(got, want)


def test_cpu_bwd_launches_nothing():
    """CPU tensors take the plain backward: no launch counter moves."""
    rx, tx, s, per_slot, packed = CASES["single_rx"]
    args, ct = _inputs(rx, tx, s, per_slot, packed, u=3)
    before = kr.BWD_LAUNCHES, dict(kr.BWD_MODE_LAUNCHES)
    kr.fused_render_bwd(*[torch.from_numpy(a) for a in args],
                        torch.from_numpy(ct), rx, tx, K, packed)
    assert (kr.BWD_LAUNCHES, kr.BWD_MODE_LAUNCHES) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _cuda_bwd(cuda, rx, tx, s, per_slot, packed, p, k, u, seed):
    """The backward at f32 grade through :func:`fused_render_bwd`, one
    launch counted under "tc" (the tensor-core design), and the plain
    version, on the card."""
    args, ct = _inputs(rx, tx, s, per_slot, packed, u=u, seed=seed, p=p,
                       k=k)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    ct = torch.from_numpy(ct).to(cuda)
    kr.BWD_MODE_LAUNCHES.clear()
    got = kr.fused_render_bwd(*ts, ct, rx, tx, k, packed)
    want = kr.fused_render_bwd_reference(*ts, ct, rx, tx, k, packed)
    torch.cuda.synchronize()
    assert kr.BWD_MODE_LAUNCHES == {"tc": 1}
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_bwd_kernel_matches_plain_version(cuda, name):
    rx, tx, s, per_slot, packed = CASES[name]
    p, k = _pk(name)
    got, want = _cuda_bwd(cuda, rx, tx, s, per_slot, packed, p, k,
                          U * 257, 4)
    _close([g.cpu() for g in got], [w.cpu() for w in want])


# name: (rx_shape, tx_shape, S, per-slot amp, packed, P, K, U): panels of
# 48 to 144 rows, past one row tile, K = 1 and ragged column steps, both
# layouts, per-slot amplitudes.
CUDA_TC_CASES = {
    "headline": ((1, 1), (8, 8), 1, False, True, 25, 64, 4111),
    "q48_k1": ((1, 1), (8, 6), 1, False, True, 25, 1, 2053),
    "q48_6x8_stacked": ((1, 1), (6, 8), 2, True, False, 25, 64, 1031),
    "q144_k100": ((1, 1), (8, 18), 1, False, True, 25, 100, 1031),
    "q144_rx2_k1": ((2, 1), (8, 9), 1, False, False, 13, 1, 1031),
    "q128_p40_s3": ((2, 1), (8, 8), 3, True, True, 40, 20, 517),
    "q80_k17": ((1, 1), (5, 16), 2, False, True, 25, 17, 1031),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_TC_CASES))
def test_cuda_bwd_matches_plain_version_at_panel_shapes(cuda, name):
    rx, tx, s, per_slot, packed, p, k, u = CUDA_TC_CASES[name]
    got, want = _cuda_bwd(cuda, rx, tx, s, per_slot, packed, p, k, u, 6)
    _close([g.cpu() for g in got], [w.cpu() for w in want])


@pytest.mark.gpu
@pytest.mark.parametrize("mm, key", [("float32", "tc"),
                                     ("bfloat16", "bf16_mm")])
def test_cuda_headline_step_counts_its_design(cuda, mm, key):
    """An f32-grade backward at the headline panel runs the tensor-core
    design, counted once under "tc"; the one-pass bf16 mode runs mma.sync,
    counted under its own key."""
    rx, tx, k = (1, 1), (8, 8), 64
    args, _ = _inputs(rx, tx, 1, False, True, seed=9, p=25, k=k)
    leaves = [torch.from_numpy(a).to(cuda).requires_grad_(True)
              for a in args]
    kr.BWD_MODE_LAUNCHES.clear()
    h = kr.fused_render(*leaves, rx, tx, k, True, mm_dtype=mm)
    h.square().mean().backward()
    torch.cuda.synchronize()
    assert kr.BWD_MODE_LAUNCHES == {key: 1}
    want = kr.fused_render_bwd_reference(
        *[x.detach() for x in leaves], (2 * h / h.numel()).detach(), rx, tx,
        k, True, mm)
    _close([x.grad.cpu() for x in leaves], [w.cpu() for w in want],
           GTOL if key == "tc" else BF16_GTOL)


@pytest.mark.gpu
def test_cuda_autograd_goes_through_both_kernels(cuda):
    rx, tx, s, per_slot, packed = CASES["packed_two_slots"]
    args, _ = _inputs(rx, tx, s, per_slot, packed, seed=5)
    leaves = [torch.from_numpy(a).to(cuda).requires_grad_(True)
              for a in args]
    fwd, bwd = kr.LAUNCHES, kr.BWD_LAUNCHES
    h = kr.fused_render(*leaves, rx, tx, K, packed)
    assert type(h.grad_fn) is kr.FusedRender._backward_cls
    h.square().mean().backward()
    torch.cuda.synchronize()
    assert (kr.LAUNCHES, kr.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    want = kr.fused_render_bwd_reference(
        *[x.detach() for x in leaves], (2 * h / h.numel()).detach(), rx, tx,
        K, packed)
    _close([x.grad.cpu() for x in leaves], [w.cpu() for w in want])


@pytest.mark.gpu
def test_cuda_bwd_raises_on_what_the_kernel_does_not_take(cuda):
    # The kernels tile Q, S*K and P, so a 4x4 x 16x16 panel (Q = 4096),
    # whose E alone would not fit in shared memory at once, is taken;
    # what is left is a Q past the kernels' C ints.
    rx, tx = (4, 4), (16, 16)
    args, ct = _inputs(rx, tx, 1, False, False, u=2)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    ct = torch.from_numpy(ct).to(cuda)
    got = kr.fused_render_bwd(*ts, ct, rx, tx, K, False)
    _close([g.cpu() for g in got], [w.cpu() for w in
           kr.fused_render_bwd_reference(*ts, ct, rx, tx, K, False)])
    with pytest.raises(ValueError, match="kernel's limits"):
        kr.fused_render_bwd(*ts, ct, (1 << 16, 1), (1 << 16, 1), K, False)


@pytest.mark.gpu
def test_cuda_bwd_walks_many_path_chunks(cuda):
    """P = 227, the most a kernel staging all of a user's paths at once
    fits at the headline panel: 8 chunks of 32 paths, the last ragged."""
    rx, tx = (1, 1), (8, 8)
    got, want = _cuda_bwd(cuda, rx, tx, 1, False, True, 227, 64, 4 * U, 8)
    _close([g.cpu() for g in got], [w.cpu() for w in want])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_bwd_kernel_one_pass_matches_plain_version(cuda, name):
    """The backward kernel's one-pass bf16 mode against its plain version
    in the same mode."""
    rx, tx, s, per_slot, packed = CASES[name]
    p, k = _pk(name)
    args, ct = _inputs(rx, tx, s, per_slot, packed, u=U * 257, seed=4, p=p,
                       k=k)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    ct = torch.from_numpy(ct).to(cuda)
    before = kr.BWD_LAUNCHES
    got = kr.fused_render_bwd(*ts, ct, rx, tx, k, packed, "bfloat16")
    want = kr.fused_render_bwd_reference(*ts, ct, rx, tx, k, packed,
                                         "bfloat16")
    torch.cuda.synchronize()
    assert kr.BWD_LAUNCHES == before + 1
    _close([g.cpu() for g in got], [w.cpu() for w in want], BF16_GTOL)


@pytest.mark.gpu
def test_cuda_bwd_one_pass_walks_many_path_chunks(cuda):
    """P = 227 (8 chunks of 32 paths) in the one-pass mode."""
    rx, tx = (1, 1), (8, 8)
    args, ct = _inputs(rx, tx, 1, False, True, u=4 * U, seed=8, p=227, k=64)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    ct = torch.from_numpy(ct).to(cuda)
    got = kr.fused_render_bwd(*ts, ct, rx, tx, 64, True, "bfloat16")
    want = kr.fused_render_bwd_reference(*ts, ct, rx, tx, 64, True,
                                         "bfloat16")
    _close([g.cpu() for g in got], [w.cpu() for w in want], BF16_GTOL)
