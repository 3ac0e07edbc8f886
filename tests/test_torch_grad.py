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
def test_cuda_bwd_kernel_matches_plain_version(cuda, name):
    rx, tx, s, per_slot, packed = CASES[name]
    p, k = _pk(name)
    args, ct = _inputs(rx, tx, s, per_slot, packed, u=U * 257, seed=4, p=p,
                       k=k)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    ct = torch.from_numpy(ct).to(cuda)
    before = kr.BWD_LAUNCHES
    got = kr.fused_render_bwd(*ts, ct, rx, tx, k, packed)
    want = kr.fused_render_bwd_reference(*ts, ct, rx, tx, k, packed)
    torch.cuda.synchronize()
    assert kr.BWD_LAUNCHES == before + 1
    _close([g.cpu() for g in got], [w.cpu() for w in want])


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
    args, ct = _inputs(rx, tx, 1, False, True, u=4 * U, seed=8, p=227, k=64)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    ct = torch.from_numpy(ct).to(cuda)
    got = kr.fused_render_bwd(*ts, ct, rx, tx, 64, True)
    want = kr.fused_render_bwd_reference(*ts, ct, rx, tx, 64, True)
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
