"""Path-sum kernel of the PyTorch port: plain version and autograd Function
against the JAX kernel (Pallas in interpret mode) and its XLA reference,
ragged U and K, a non-arithmetic subcarrier selection, more than one path
chunk, gradients, the kernel's shape envelope, and — on a CUDA card only —
the CUDA kernel vs its plain version, also past the shared-memory bound of
the kernel that staged all P paths of a user at once.

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_pathsum.py``.
"""

import numpy as np
import pytest
import torch

from deepmimo_tpu_torch.ops.kernels import pathsum as kp
from deepmimo_tpu_torch.ops.kernels.render import INDEX_LIMIT, SMEM_LIMIT

torch.set_num_threads(1)
ATOL = 1e-5      # absolute, as tests/test_pallas.py:25-55 (|H| ~ 1-10)
RTOL = 3e-5      # kernel vs plain on the card, relative to max|H|

# name: (U, R, T, P, k_sel)
CASES = {
    "base": (12, 2, 8, 5, np.arange(9)),
    "ragged_u_k": (7, 2, 8, 5, np.arange(5)),
    "non_arithmetic": (9, 1, 4, 7, np.array([0, 3, 4, 10, 17, 18])),
    "single_antenna": (5, 1, 1, 3, np.array([2])),
    # three 16-path chunks and a full 64-row tile
    "two_chunks": (3, 2, 64, 40, np.arange(11)),
}

# Shapes whose 8 P (Q + K) bytes exceed SMEM_LIMIT (the old kernel staged
# E and g of all P paths in shared memory): (U, R, T, P, k_sel). A 16 x 16
# BS at 1,024 non-arithmetic subcarriers of 2,048, and 300 paths at the
# headline panel. Card only: the JAX kernel in interpret mode is slow here.
WIDE_CASES = {
    "wide_bs": (300, 1, 256, 25, np.sort(np.random.RandomState(1).choice(
        2048, 1024, replace=False))),
    "many_paths": (400, 1, 64, 300, np.arange(64)),
}


def _inputs(u, r, t, p, k_sel, seed=0):
    """The JAX test's recipe (tests/test_pallas.py:16-22), numpy."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    return [f32(u, r, p), f32(u, r, p), f32(u, t, p), f32(u, t, p),
            f32(u, p), f32(u, p),
            rng.uniform(0, 6, (u, p)).astype(np.float32),
            np.asarray(k_sel, np.float32)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel_and_reference(name):
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.pathsum import (_reference_impl,
                                                 fused_path_sum)

    args = _inputs(*CASES[name])
    jargs = [jnp.asarray(a) for a in args]
    want_k = fused_path_sum(*jargs, user_tile=4, k_tile=4, interpret=True)
    want_r = _reference_impl(*jargs)
    for fn in (kp.fused_path_sum, kp.fused_path_sum_reference):
        got = fn(*[torch.from_numpy(a) for a in args])
        u, r, t, _, k_sel = CASES[name]
        for g, wk, wr in zip(got, want_k, want_r):
            assert tuple(g.shape) == (u, r * t, len(k_sel))
            np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=ATOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(wr), atol=ATOL)


@pytest.mark.parametrize("name", ["base", "non_arithmetic"])
def test_gradients_match_jax(name):
    import jax
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.pathsum import fused_path_sum

    args = _inputs(*CASES[name], seed=3)
    u, r, t, _, k_sel = CASES[name]
    cot = (np.ones((u, r * t, len(k_sel)), np.float32),
           0.5 * np.ones((u, r * t, len(k_sel)), np.float32))

    def loss(*a):
        hr, hi = fused_path_sum(*a, user_tile=4, k_tile=4, interpret=True)
        return jnp.vdot(cot[0], hr) + jnp.vdot(cot[1], hi)

    want = jax.grad(loss, argnums=tuple(range(7)))(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.from_numpy(a).requires_grad_(i < 7)
              for i, a in enumerate(args)]
    hr, hi = kp.fused_path_sum(*leaves)
    assert type(hr.grad_fn) is kp.FusedPathSum._backward_cls
    ((hr * torch.from_numpy(cot[0])).sum() +
     (hi * torch.from_numpy(cot[1])).sum()).backward()
    for x, w in zip(leaves[:7], want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-4)
    assert leaves[7].grad is None


def test_cpu_wrapper_uses_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(*CASES["base"])]
    before = kp.LAUNCHES
    got = kp.fused_path_sum(*args)
    want = kp.fused_path_sum_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kp.LAUNCHES == before        # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["float64", "strided", "amp_shape",
                                 "k_sel_2d", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = [torch.from_numpy(a) for a in _inputs(*CASES["base"])]
    if bad == "float64":
        args[4] = args[4].double()
    elif bad == "strided":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "amp_shape":
        args[4] = args[4][:, :-1].contiguous()
    elif bad == "k_sel_2d":
        args[7] = args[7][None]
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        kp.fused_path_sum(*args)


def test_kernel_fits_past_the_old_shared_memory_bound():
    # One block's shared memory is one constant: two stages of the split B
    # operand, the atx rows and the scalars, whatever P, R, T and K; two
    # blocks fit on an SM.
    assert kp.smem_bytes() == 87_168 <= SMEM_LIMIT // 2
    # Every shape the kernel staging all P paths of a user at once took
    # (8 P (Q + K) bytes of shared memory) is taken, and more.
    n_old = 0
    for r, t in ((1, 1), (1, 2), (2, 1), (1, 8), (4, 4), (1, 15), (2, 8),
                 (1, 64), (4, 64), (1, 256), (1, 1024), (16, 256)):
        for k in (1, 6, 16, 17, 64, 1024, 4096):
            for p in (1, 5, 25, 37, 40, 100, 227, 300, 1000):
                if 8 * p * (r * t + k) <= SMEM_LIMIT:
                    n_old += 1
                    assert kp.kernel_fits(r, t, k, p), (r, t, k, p)
    assert n_old > 100
    for u, r, t, p, k_sel in WIDE_CASES.values():
        assert 8 * p * (r * t + len(k_sel)) > SMEM_LIMIT
        assert kp.kernel_fits(r, t, len(k_sel), p)
    assert kp.kernel_fits(1, 1, 1, 100_000)
    # What is left: C-int indices and empty axes.
    assert kp.kernel_fits(1, INDEX_LIMIT, 64, INDEX_LIMIT)
    assert not kp.kernel_fits(2, 2**30, 64, 25)
    assert not kp.kernel_fits(1, 64, INDEX_LIMIT + 1, 25)
    assert not kp.kernel_fits(1, 2**20, 2**24, 25)      # 2**32 tiles
    assert not kp.kernel_fits(1, 64, 64, 0)
    assert not kp.kernel_fits(1, 64, 0, 25)


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
def test_cuda_kernel_matches_plain_version(cuda, name):
    u, r, t, p, k_sel = CASES[name]
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(u * 257, r, t, p, k_sel, seed=4)]
    before = kp.LAUNCHES
    got = kp.fused_path_sum(*args)
    want = kp.fused_path_sum_reference(*args)
    torch.cuda.synchronize()
    assert kp.LAUNCHES == before + 1
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= RTOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_cuda_kernel_past_the_old_shared_memory_bound(cuda, name):
    u, r, t, p, k_sel = WIDE_CASES[name]
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(u, r, t, p, k_sel, seed=5)]
    before = kp.LAUNCHES
    got = kp.fused_path_sum(*args)
    want = kp.fused_path_sum_reference(*args)
    torch.cuda.synchronize()
    assert kp.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == (u, r * t, len(k_sel))
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= RTOL * scale


@pytest.mark.gpu
def test_cuda_smem_bytes_is_the_kernels_own(cuda):
    """smem_bytes mirrors the launcher's constant (csrc/pathsum.cu exports
    it)."""
    import ctypes

    from deepmimo_tpu_torch.ops.kernels import _build
    fn = _build.load_library("pathsum").pathsum_smem_bytes
    fn.argtypes = []
    fn.restype = ctypes.c_longlong
    assert fn() == kp.smem_bytes()
