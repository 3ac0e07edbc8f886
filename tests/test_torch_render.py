"""Fused render kernel of the PyTorch port: plain version vs the JAX
kernel (Pallas in interpret mode) and its XLA reference, the wrapper's
dispatch and checks, and — on a CUDA card only — the CUDA kernel vs its
plain version.

JAX is imported only inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest -m gpu --noconftest tests/test_torch_render.py``.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from deepmimo_tpu_torch.ops.kernels import _build
from deepmimo_tpu_torch.ops.kernels import render as kr

torch.set_num_threads(1)
RTOL = 3e-5      # relative to max|H|: the kernel's bound in test_pallas.py
# bf16 output against f32 planes: JAX's own bound (test_pallas.py:536-537).
BF16_OUT_RTOL = 2 ** -7
# One-pass bf16 products, relative to max|H|. The JAX package has no bound
# for them: bf16 rounds each operand by up to 2^-9 (unit roundoff), so a
# term of the path sum by ~2^-8, and the TPU's one-pass render measured
# 2.9e-3 against float64 (deepmimo_tpu/ops/pallas/render.py:213-215);
# 1e-2 leaves room for the sum over paths.
BF16_MM_RTOL = 1e-2
# mode: (mm_dtype, out_dtype, tolerance against the f32 JAX kernel)
MODES = {
    "bf16_mm": ("bfloat16", "float32", BF16_MM_RTOL),
    "default_mm": ("default", "float32", BF16_MM_RTOL),
    "highest_mm": ("highest", "float32", RTOL),
    "bf16_out": ("float32", "bfloat16", BF16_OUT_RTOL),
}

# name: (rx_shape, tx_shape, U, K, S, per-slot amp, packed)
CASES = {
    "headline": ((1, 1), (8, 8), 16, 64, 1, False, True),
    "mimo": ((2, 2), (4, 2), 16, 16, 1, False, False),
    "ragged_u": ((2, 2), (4, 2), 13, 64, 1, False, True),
    "two_slots": ((1, 1), (4, 4), 16, 32, 2, True, True),
    "two_slots_stacked": ((2, 1), (2, 2), 11, 16, 2, False, False),
    # Q = 15, S*K = 51 and P = 37: off every tile size and the k-step.
    "odd_panel": ((1, 1), (3, 5), 13, 17, 3, True, False),
}
P = 25
PATHS = {"odd_panel": 37}       # P of the cases that do not use P


def _inputs(u, s, per_slot, seed=0, p=P):
    """Per-path scalars at the main path's ranges; invalid paths zeroed."""
    rng = np.random.RandomState(seed)
    valid = (np.arange(p)[None, :] <
             rng.randint(1, p + 1, size=(u, 1))).astype(np.float32)

    def mk(lo, hi, reps=1):
        x = rng.uniform(lo, hi, (u, reps * p)).astype(np.float32)
        return x * np.tile(valid, (1, reps))

    return ([mk(-np.pi, np.pi) for _ in range(4)] +
            [mk(0, 1e-4, s if per_slot else 1), mk(-np.pi, np.pi, s),
             mk(0, 2 * np.pi * 40 / 512)])


def _stacked(h, packed, sk):
    """Kernel layout -> stacked [2, U, Q, S*K] numpy."""
    h = np.asarray(h)
    return np.stack((h[..., :sk], h[..., sk:])) if packed else h


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_reference(name):
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.render import _reference_impl

    rx, tx, u, k, s, per_slot, packed = CASES[name]
    arrs = _inputs(u, s, per_slot, p=PATHS.get(name, P))
    want = np.stack([np.asarray(x) for x in _reference_impl(
        *[jnp.asarray(a) for a in arrs], rx, tx, k)])
    got = kr.fused_render_reference(*[torch.from_numpy(a) for a in arrs],
                                    rx, tx, k, packed)
    q = rx[0] * rx[1] * tx[0] * tx[1]
    assert tuple(got.shape) == ((u, q, 2 * s * k) if packed
                                else (2, u, q, s * k))
    np.testing.assert_allclose(_stacked(got, packed, s * k), want,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_kernel_interpret(name):
    """Against the TPU kernel itself, run in interpret mode on the CPU."""
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.render import fused_render

    rx, tx, u, k, s, per_slot, packed = CASES[name]
    arrs = _inputs(u, s, per_slot, seed=1, p=PATHS.get(name, P))
    want = fused_render(*[jnp.asarray(a) for a in arrs], rx, tx, k,
                        user_tile=8, interpret=True, packed=packed)
    got = kr.fused_render(*[torch.from_numpy(a) for a in arrs], rx, tx, k,
                          packed)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["headline", "two_slots_stacked",
                                  "odd_panel"])
def test_modes_match_jax_kernel_interpret(name, mode):
    """Each mode of the port's plain version against the TPU kernel in the
    same mode, run in interpret mode on the CPU (where JAX's "default" and
    "highest" are f32), and against the f32 kernel."""
    import jax.numpy as jnp
    from deepmimo_tpu.ops.pallas.render import fused_render

    mm, out_dtype, tol = MODES[mode]
    rx, tx, u, k, s, per_slot, packed = CASES[name]
    arrs = _inputs(u, s, per_slot, seed=8, p=PATHS.get(name, P))
    jargs = [jnp.asarray(a) for a in arrs]
    want32 = np.asarray(fused_render(*jargs, rx, tx, k, user_tile=8,
                                     interpret=True, packed=packed))
    want = np.asarray(fused_render(
        *jargs, rx, tx, k, user_tile=8, interpret=True, mm_dtype=mm,
        packed=packed, out_dtype=out_dtype)).astype(np.float32)
    got = kr.fused_render(*[torch.from_numpy(a) for a in arrs], rx, tx, k,
                          packed, mm_dtype=mm, out_dtype=out_dtype)
    assert got.dtype == kr.OUT_DTYPES[out_dtype]
    assert tuple(got.shape) == want.shape
    scale = np.abs(want32).max()
    got = got.float().numpy()
    np.testing.assert_allclose(got, want32, atol=tol * scale)
    np.testing.assert_allclose(got, want, atol=tol * scale)
    if mode == "bf16_out":          # both round the same f32 sums
        np.testing.assert_allclose(got, want, atol=2 ** -8 * scale)


def test_one_pass_rounds_the_operands_not_the_result():
    """The plain one-pass product rounds E and g to bf16 and multiplies in
    f32 (JAX's preferred_element_type=f32): it is off the f32 product by
    more than f32 noise, within the bf16 bound, and its output stays f32."""
    rx, tx, u, k, s, per_slot, packed = CASES["headline"]
    args = [torch.from_numpy(a) for a in _inputs(u, s, per_slot, seed=9)]
    h32 = kr.fused_render_reference(*args, rx, tx, k, packed)
    h16 = kr.fused_render_reference(*args, rx, tx, k, packed, "bfloat16")
    assert h16.dtype == torch.float32
    err = float((h16 - h32).abs().max())
    scale = float(h32.abs().max())
    assert RTOL * scale < err <= BF16_MM_RTOL * scale
    assert torch.equal(
        h16, kr.fused_render_reference(*args, rx, tx, k, packed, "default"))
    assert torch.equal(
        h32, kr.fused_render_reference(*args, rx, tx, k, packed, "highest"))


@pytest.mark.parametrize("call", ["fused_render", "reference",
                                  "out_dtype"])
def test_unknown_modes_raise(call):
    rx, tx, u, k, s, per_slot, packed = CASES["headline"]
    args = [torch.from_numpy(a) for a in _inputs(u, s, per_slot, seed=2)]
    with pytest.raises(ValueError, match="matmul_dtype|out_dtype"):
        if call == "fused_render":
            kr.fused_render(*args, rx, tx, k, packed, mm_dtype="tf32")
        elif call == "reference":
            kr.fused_render_reference(*args, rx, tx, k, packed, "float16")
        else:
            kr.fused_render(*args, rx, tx, k, packed, out_dtype="float16")


def test_cpu_wrapper_uses_plain_version_and_writes_out():
    rx, tx, u, k, s, per_slot, packed = CASES["headline"]
    args = [torch.from_numpy(a) for a in _inputs(u, s, per_slot, seed=2)]
    before = kr.LAUNCHES
    ref = kr.fused_render_reference(*args, rx, tx, k, packed)
    out = torch.full_like(ref, float("nan"))
    got = kr.fused_render(*args, rx, tx, k, packed, out=out)
    assert got is out and torch.equal(out, ref)
    assert torch.equal(kr.fused_render(*args, rx, tx, k, packed), ref)
    assert kr.LAUNCHES == before        # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["float64", "strided", "short_row",
                                 "amp_width", "out_shape", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rx, tx, u, k = (1, 1), (4, 2), 6, 16
    args = [torch.from_numpy(a) for a in _inputs(u, 1, False, seed=3)]
    kw = {}
    if bad == "float64":
        args[0] = args[0].double()
    elif bad == "strided":
        args[2] = torch.cat([args[2], args[2]], 1)[:, ::2]
    elif bad == "short_row":
        args[3] = args[3][:, :-1].contiguous()
    elif bad == "amp_width":
        args[4] = torch.cat([args[4]] * 3, 1)
    elif bad == "out_shape":
        kw["out"] = torch.empty(u, 8, 2 * k + 1)
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        kr.fused_render(*args, rx, tx, k, True, **kw)


def test_kernel_fits_is_the_shared_memory_bound():
    # Tiles and path chunks bound shared memory whatever P: the headline
    # takes 167,424 bytes forward and 219,136 backward, the largest tables
    # 221,696 and 232,192, under the 232,448 a block may opt into.
    assert kr.smem_bytes((1, 1), (8, 8), 64) == 167_424
    assert kr.smem_bytes((1, 1), (8, 8), 64, backward=True) == 219_136
    assert kr.smem_bytes((1, 1), (8, 8), 64, 1, True) == \
        kr.smem_bytes((1, 1), (8, 8), 64, 4, True)
    worst = max(kr.smem_bytes(rx, (t1, 3), k, s, bwd)
                for rx in ((1, 1), (2, 2)) for t1 in (1, 3, 8, 63, 64, 65)
                for k in (1, 7, 8, 17, 64, 1000) for s in (1, 3, 100)
                for bwd in (False, True))
    assert worst <= kr.SMEM_LIMIT
    # Every shape a kernel staging all P paths of a user at once took
    # (8 P (Q + S*K) bytes of shared memory) is taken, and more.
    for rx, tx, n_s in (((1, 1), (8, 8), 1), ((2, 2), (8, 8), 4),
                        ((2, 2), (4, 2), 1), ((1, 1), (3, 5), 3)):
        q = rx[0] * rx[1] * tx[0] * tx[1]
        for k in (16, 17, 64):
            for p in (1, 25, 37, 100, 227, 500):
                if 8 * p * (q + n_s * k) <= kr.SMEM_LIMIT:
                    assert kr.kernel_fits(rx, tx, p, k, n_s)
    assert kr.kernel_fits((1, 1), (8, 8), 25, 64)
    assert kr.kernel_fits((1, 1), (8, 8), 227, 64)
    assert kr.kernel_fits((1, 1), (8, 8), 228, 64)
    assert kr.kernel_fits((4, 4), (16, 16), 25, 64)
    assert kr.kernel_fits((2, 2), (8, 8), 25, 64, n_snap=4)
    # What is left: C-int indices and empty shapes.
    assert not kr.kernel_fits((1 << 16, 1), (1 << 16, 1), 25, 64)
    assert not kr.kernel_fits((1, 1), (8, 8), 0, 64)
    assert not kr.kernel_fits((1, 1), (8, 8), 25, 0)


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on float32 numbers: add half an ulp of the 10-bit
    mantissa, then drop the 13 low bits."""
    bits = torch.as_tensor(x, dtype=torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_three_tf32_passes_hold_the_kernel_tolerance():
    """Why the kernels split each operand: on the headline-shaped real GEMM
    of one user ([Er | Ei] (Q x 2P) times [[Gr, Gi], [-Gi, Gr]] (2P x 2SK),
    Q = 64, 2P = 50, 2SK = 128) lo*hi + hi*lo + hi*hi stays within the
    kernel's 3e-5 max|H| of a float64 product, and one TF32 pass does not."""
    rx, tx, u, k, s, per_slot, _ = CASES["headline"]
    gry, grz, gty, gtz, amp, psi, omega = (
        torch.from_numpy(a).double() for a in _inputs(u, s, per_slot, 6))
    m = torch.arange(8, dtype=torch.float64)
    ph = (m[None, None, :, None] * gty[:, None, None] +         # [u, n, m, P]
          m[None, :, None, None] * gtz[:, None, None]).reshape(u, 64, P)
    ang = psi[:, None, :] - omega[:, None, :] * torch.arange(
        k, dtype=torch.float64)[:, None]                        # [u, K, P]
    gr, gi = amp[:, None] * torch.cos(ang), amp[:, None] * torch.sin(ang)
    a = torch.cat((torch.cos(ph), torch.sin(ph)), -1)           # [u, 64, 2P]
    b = torch.cat((torch.cat((gr, gi), 1), torch.cat((-gi, gr), 1)),
                  2).transpose(1, 2)                            # [u, 2P, 2SK]
    assert a.shape[1:] == (64, 50) and b.shape[1:] == (50, 128)
    want = a @ b
    a32, b32 = a.float(), b.float()
    a_hi, b_hi = _tf32_rna(a32), _tf32_rna(b32)
    a_lo, b_lo = _tf32_rna(a32 - a_hi), _tf32_rna(b32 - b_hi)
    one = a_hi.double() @ b_hi.double()
    three = (a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
             + one)
    scale = float(want.abs().max())
    assert float((three - want).abs().max()) <= RTOL * scale
    assert float((one - want).abs().max()) > RTOL * scale


def test_build_is_keyed_by_source_hash():
    src, lib, log = _build._paths("render_fwd")
    assert src.endswith("render_fwd.cu") and lib.startswith(_build.BUILD_DIR)
    assert _build._paths("render_fwd") == (src, lib, log)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int render_fwd_launch' in text
    # accurate trig only: omega*k reaches ~31 rad at the headline
    assert "__sincosf" not in text
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)


# kernel: (pointer parameters, int parameters) of its extern "C" launcher
# before the stream, and the wrapper that alone spells that signature.
LAUNCH_ABI = {
    "render_fwd": ((8, 13, 0), "render.py"),
    "render_bwd": ((15, 11, 0), "render.py"),
    "beamgain": ((9, 11, 0), "beamgain.py"),
    "pathsum": ((10, 5, 0), "pathsum.py"),
    "prologue": ((19, 12, 1), "prologue.py"),
}


def _python_sources():
    """The port's Python files and ``chip_smoke.py``, as (path, text)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = glob.glob(os.path.join(root, "deepmimo_tpu_torch", "**",
                                   "*.py"), recursive=True)
    paths.append(os.path.join(root, "chip_smoke.py"))
    for path in sorted(paths):
        with open(path) as f:
            yield path, f.read()


@pytest.mark.parametrize("kernel", sorted(LAUNCH_ABI))
def test_launch_signature_is_written_once_in_its_wrapper(kernel):
    """The C signature of ``<kernel>_launch`` (pointers, ints, floats,
    then the stream) is spelled by exactly one ``_build.launcher`` call, in
    the kernel's wrapper under ``ops/kernels/``, with the counts of the
    source; no other Python file names the symbol or sets argtypes."""
    (n_ptr, n_int, n_float), wrapper = LAUNCH_ABI[kernel]
    src = os.path.join(_build.CSRC_DIR, f"{kernel}.cu")
    with open(src) as f:
        text = f.read()
    sig = re.search(r'extern "C" int ' + kernel + r"_launch\((.*?)\)\s*\{",
                    text, re.S)
    assert sig, f'no extern "C" int {kernel}_launch in {src}'
    params = [" ".join(x.split()) for x in sig.group(1).split(",")]
    assert params[-1] == "void* stream", params[-1]
    ptrs = [x for x in params[:-1] if "*" in x]
    ints = [x for x in params[:-1] if x.startswith("int ")]
    floats = [x for x in params[:-1] if x.startswith("float ")]
    assert len(ptrs) + len(ints) + len(floats) == len(params) - 1, params
    assert params[:-1] == ptrs + ints + floats, \
        "pointers come before the ints, the ints before the floats"
    assert (len(ptrs), len(ints), len(floats)) == (n_ptr, n_int, n_float)

    sites, named = [], []
    for path, body in _python_sources():
        calls = re.findall(r"launcher\(\s*(\S+?)\s*,\s*(\S+?)\s*,"
                           r"\s*(\S+?)\s*(?:,\s*(\S+?)\s*)?\)", body)
        sites += [(path, c) for c in calls if c[0] in (f'"{kernel}"',
                                                       f"'{kernel}'")]
        if os.path.basename(path) != "_build.py" and re.search(
                r"_launch[\"']|[\"']_launch|argtypes.*_launch|"
                + kernel + r"_launch\b.*argtypes", body):
            named.append(path)
    assert len(sites) == 1, sites
    path, (_, ptr_arg, int_arg, float_arg) = sites[0]
    assert path == os.path.join(os.path.dirname(os.path.abspath(
        kr.__file__)), wrapper)
    assert (int(ptr_arg), int(int_arg), int(float_arg or 0)) == \
        (n_ptr, n_int, n_float)
    assert not named, named


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
    rx, tx, u, k, s, per_slot, packed = CASES[name]
    u *= 257                              # several blocks, ragged
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(u, s, per_slot, seed=4, p=PATHS.get(name, P))]
    before = kr.LAUNCHES
    got = kr.fused_render(*args, rx, tx, k, packed)
    ref = kr.fused_render_reference(*args, rx, tx, k, packed)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == before + 1
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= RTOL * scale


@pytest.mark.gpu
def test_cuda_kernel_walks_many_path_chunks(cuda):
    """P = 227, the most a kernel staging all of a user's paths at once
    fits at the headline panel: 8 chunks of 32 paths, the last ragged."""
    rx, tx, u, k, s, per_slot, packed = CASES["headline"]
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(4 * u, s, per_slot, seed=7, p=227)]
    got = kr.fused_render(*args, rx, tx, k, packed)
    ref = kr.fused_render_reference(*args, rx, tx, k, packed)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= RTOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16_mm", "bf16_out", "bf16_both"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_modes_match_plain_version(cuda, name, mode):
    """The one-pass and bf16-output modes of the kernel against its plain
    version in the same mode. The kernel's operands come from trig tables,
    so they can round across a bf16 boundary that the plain version's do
    not: the bound is the modes' own, not the f32 kernel's."""
    mm = "float32" if mode == "bf16_out" else "bfloat16"
    out_dtype = "float32" if mode == "bf16_mm" else "bfloat16"
    rx, tx, u, k, s, per_slot, packed = CASES[name]
    u *= 257
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(u, s, per_slot, seed=4, p=PATHS.get(name, P))]
    before = kr.LAUNCHES
    got = kr.fused_render(*args, rx, tx, k, packed, mm_dtype=mm,
                          out_dtype=out_dtype)
    ref = kr.fused_render_reference(*args, rx, tx, k, packed, mm)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == before + 1
    assert got.dtype == kr.OUT_DTYPES[out_dtype]
    tol = BF16_MM_RTOL if mm == "bfloat16" else BF16_OUT_RTOL
    scale = float(ref.abs().max())
    assert float((got.float() - ref).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16_mm", "bf16_out"])
def test_cuda_kernel_modes_walk_many_path_chunks(cuda, mode):
    """P = 227 (8 chunks of 32 paths) in each bf16 mode."""
    mm = "bfloat16" if mode == "bf16_mm" else "float32"
    out_dtype = "bfloat16" if mode == "bf16_out" else "float32"
    rx, tx, u, k, s, per_slot, packed = CASES["headline"]
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(4 * u, s, per_slot, seed=7, p=227)]
    got = kr.fused_render(*args, rx, tx, k, packed, mm_dtype=mm,
                          out_dtype=out_dtype)
    ref = kr.fused_render_reference(*args, rx, tx, k, packed, mm)
    torch.cuda.synchronize()
    tol = BF16_MM_RTOL if mm == "bfloat16" else BF16_OUT_RTOL
    assert float((got.float() - ref).abs().max()) <= \
        tol * float(ref.abs().max())


@pytest.mark.gpu
def test_cuda_bf16_planes_reach_the_host(cuda):
    """planes_out_dtype "bfloat16" through Dataset.compute_channels on the
    card: one launch into a reused bf16 out=, the host channel from it,
    and the streamed blocks (bf16 pinned buffers, half the bytes of f32)
    equal to it, within 2^-7 of the f32 channel."""
    import deepmimo_tpu_torch as dmt
    from deepmimo_tpu_torch.ops.channel import unpack_planes_np
    from oracle import make_synthetic_paths

    old = dict(dmt.config.items())
    try:
        dmt.config.set("device", "cuda")
        d = make_synthetic_paths(n_ue=300, max_paths=12, seed=5)
        d.pop("n_valid")
        d["rx_pos"] = np.zeros((300, 3), np.float32)
        d["tx_pos"] = np.zeros((1, 3), np.float32)
        ds = dmt.Dataset(d)
        params = dmt.ChannelGenParameters()
        c = dmt.consts
        params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([8, 8])
        params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(64)
        params[c.PARAMSET_NUM_PATHS] = 12
        f32 = ds.compute_channels(params)
        dmt.config.set("planes_out_dtype", "bfloat16")
        h = ds.compute_channels(params, to_device=True)
        assert h.dtype == torch.bfloat16 and h.is_cuda
        again = ds.compute_channels(params, to_device=True, out=h)
        assert again.data_ptr() == h.data_ptr()
        cfg, _, _ = params.to_config(300)
        single = ds.compute_channels(params)
        assert single.dtype == np.complex64
        np.testing.assert_array_equal(single, unpack_planes_np(h, cfg))
        dmt.config.set("max_device_output_bytes", h.numel() * 2 - 1)
        dmt.config.set("user_block", 100)
        before = kr.LAUNCHES
        streamed = ds.compute_channels(params)
        assert kr.LAUNCHES == before + 3
        np.testing.assert_array_equal(streamed, single)
        np.testing.assert_allclose(single, f32,
                                   atol=BF16_OUT_RTOL * np.abs(f32).max())
    finally:
        for k, v in old.items():
            dmt.config.set(k, v)


# ----------------------------------------------------------------------------
# The tensor-core design: its route and its factoring, emulated
# ----------------------------------------------------------------------------

# Both designs' ms at 131,072 users on an H100 (NVIDIA H100 80GB HBM3,
# 700 W; deepmimo_tpu_torch/tools/render_crossover.py), f32 at f32 grade:
# (rx_shape, tx_shape, K, P, S): (mma.sync, tensor cores)
CROSSOVER_MS = {
    ((1, 1), (8, 1), 1, 25, 1): (2.4119, 1.8218),
    ((1, 1), (8, 1), 64, 25, 1): (3.4171, 1.8398),
    ((1, 1), (4, 4), 1, 25, 1): (2.4717, 2.5855),
    ((1, 1), (4, 4), 64, 25, 1): (3.5318, 2.7042),
    ((1, 1), (8, 4), 1, 25, 1): (2.6709, 1.8940),
    ((1, 1), (8, 4), 64, 25, 1): (3.9236, 2.0839),
    ((1, 1), (8, 6), 64, 25, 1): (4.0028, 2.0122),
    ((1, 1), (6, 8), 1, 25, 1): (2.6309, 2.5954),
    ((1, 1), (6, 8), 64, 25, 1): (3.9943, 2.6830),
    ((1, 1), (8, 7), 64, 25, 1): (4.1242, 2.0023),
    ((1, 1), (8, 8), 1, 25, 1): (2.9502, 1.9132),
    ((1, 1), (8, 8), 16, 25, 1): (2.8819, 1.8862),
    ((1, 1), (8, 8), 64, 25, 1): (4.2195, 2.0004),
    ((1, 1), (8, 8), 100, 25, 1): (8.0436, 3.9646),
    ((1, 1), (8, 8), 64, 10, 1): (3.5959, 2.0180),
    ((1, 1), (8, 8), 64, 40, 1): (7.2598, 3.6273),
    ((1, 1), (8, 8), 64, 25, 4): (16.8427, 7.3083),
    ((1, 1), (4, 16), 64, 25, 1): (4.5689, 2.5589),
    ((1, 1), (4, 16), 1, 25, 1): (3.0291, 2.6633),
    ((2, 2), (4, 4), 64, 25, 1): (4.7792, 2.5589),
    ((2, 2), (4, 4), 1, 25, 1): (3.2930, 2.6281),
    ((1, 1), (8, 9), 1, 25, 1): (5.3719, 3.8212),
    ((1, 1), (8, 9), 64, 25, 1): (7.6858, 3.9164),
    ((1, 1), (8, 10), 64, 25, 1): (7.7657, 3.9232),
    ((1, 1), (5, 16), 1, 25, 1): (5.7788, 5.1407),
    ((1, 1), (8, 12), 64, 25, 1): (8.2164, 3.9563),
    ((1, 1), (8, 14), 64, 25, 1): (8.2676, 4.1682),
    ((2, 1), (8, 8), 1, 25, 1): (5.8809, 3.8358),
    ((2, 1), (8, 8), 64, 25, 1): (8.6181, 4.0983),
    ((2, 1), (8, 9), 1, 25, 1): (7.9942, 5.7236),
    ((1, 1), (8, 18), 64, 25, 1): (11.6565, 5.8928),
}
ROUTE_MODES = [("float32", "float32"), ("highest", "float32"),
               ("bfloat16", "float32"), ("default", "float32"),
               ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("mm, out_dtype", ROUTE_MODES)
def test_tensor_core_route_sweep(mm, out_dtype):
    """The route depends on dtype, mode and shape alone: only float32
    output at f32 grade may take the tensor cores, on panels of 48 rows or
    more. At every shape of CROSSOVER_MS that it sends to the tensor cores
    they were no slower on the card, and every shape of 48 rows or more
    where they were more than 10% faster goes to them; the small panels of
    the quickstart and its like (Q = 8, 16, 32) stay on mma.sync at K = 1
    and 64 alike."""
    f32 = mm in ("float32", "highest") and out_dtype == "float32"
    for r in ((1, 1), (2, 1), (2, 2)):
        for tx in ((1, 1), (8, 1), (4, 4), (3, 5), (8, 4), (8, 6), (6, 8),
                   (8, 8), (4, 16), (8, 9), (8, 10), (8, 12), (16, 8),
                   (16, 16)):
            q = r[0] * r[1] * tx[0] * tx[1]
            route = kr.tensor_core_route(r, tx, mm, out_dtype)
            assert route in (False, True)
            assert route == (f32 and q >= 48), (r, tx)
    for (rx, tx, k, p, s), (mma, tc) in CROSSOVER_MS.items():
        route = kr.tensor_core_route(rx, tx, mm, out_dtype)
        q = rx[0] * rx[1] * tx[0] * tx[1]
        assert route == (f32 and q >= 48), (rx, tx, k, p, s)
        if route:
            assert tc <= mma, (rx, tx, k, p, s)
        if f32 and q >= 48 and tc * 1.1 < mma:
            assert route, (rx, tx, k, p, s)
    for k in (1, 64):
        for q, tx in ((8, (8, 1)), (16, (4, 4)), (32, (8, 4)), (64, (8, 8))):
            assert kr.tensor_core_route((1, 1), tx, mm, out_dtype) == \
                (f32 and q == 64), (q, k)
        assert kr.tensor_core_route((2, 1), (8, 8), mm, out_dtype) == f32
    with pytest.raises(ValueError, match="matmul_dtype"):
        kr.tensor_core_route((1, 1), (8, 8), "half")
    with pytest.raises(ValueError, match="out_dtype"):
        kr.tensor_core_route((1, 1), (8, 8), "float32", "half")


def test_tensor_core_route_reads_only_dtype_mode_and_shape():
    """No setting or environment variable enters the pick: the route's
    arguments are the panel shapes, the mode and the output dtype."""
    import inspect
    assert list(inspect.signature(kr.tensor_core_route).parameters) == [
        "rx_shape", "tx_shape", "mm_dtype", "out_dtype"]
    src = inspect.getsource(kr.tensor_core_route)
    assert "config" not in src and "environ" not in src


def test_cpu_render_launches_nothing():
    """CPU tensors take the plain version: neither launch counter moves."""
    rx, tx, u, k, s, per_slot, packed = CASES["headline"]
    args = [torch.from_numpy(a) for a in _inputs(u, s, per_slot)]
    before = kr.LAUNCHES, kr.TC_LAUNCHES, dict(kr.MODE_LAUNCHES)
    kr.fused_render(*args, rx, tx, k, packed)
    assert (kr.LAUNCHES, kr.TC_LAUNCHES, dict(kr.MODE_LAUNCHES)) == before


def _mm3(a, b):
    """lo.hi + hi.lo + hi.hi in float32: the kernel's 3xTF32 product."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tensor_core_emulation(gry, grz, gty, gtz, amp, psi, omega, rx_shape,
                           tx_shape, n_k, packed):
    """The tensor-core design's factoring in plain float32 torch, laid out
    as csrc/render_fwd.cu lays it out: per tile of 64 rows, path chunk of
    32 and 64 subcarriers of one slot, D3 = Er . G and D4 = Ei . G at
    3xTF32 with G's columns in tc_operands.cuh's order (column 8 j + 2 t +
    c is part c of subcarrier 16 (j / 4) + 4 t + j % 4), H = D3(re) -
    D4(im) + j (D3(im) + D4(re)) read back from those columns."""
    u, p = omega.shape
    n_s, n_sa = psi.shape[1] // p, amp.shape[1] // p
    arx_r, arx_i = kr.response(gry, grz, *rx_shape)
    atx_r, atx_i = kr.response(gty, gtz, *tx_shape)
    q = arx_r.shape[1] * atx_r.shape[1]
    er = (arx_r[:, :, None] * atx_r[:, None] -
          arx_i[:, :, None] * atx_i[:, None]).reshape(u, q, p)
    ei = (arx_r[:, :, None] * atx_i[:, None] +
          arx_i[:, :, None] * atx_r[:, None]).reshape(u, q, p)
    rows, chunks = -(-q // 64) * 64, -(-p // 32) * 32
    er = torch.nn.functional.pad(er, (0, chunks - p, 0, rows - q))
    ei = torch.nn.functional.pad(ei, (0, chunks - p, 0, rows - q))
    gr, gi = kr.ofdm_gains(amp, psi, omega, n_k)          # [u, s, p, k]
    n_kt = -(-n_k // 64)
    gr = torch.nn.functional.pad(gr, (0, 64 * n_kt - n_k, 0, chunks - p))
    gi = torch.nn.functional.pad(gi, (0, 64 * n_kt - n_k, 0, chunks - p))
    j, t, c = torch.meshgrid(torch.arange(16), torch.arange(4),
                             torch.arange(2), indexing="ij")
    sub = (16 * (j // 4) + 4 * t + j % 4).reshape(-1)    # column -> k
    part = c.reshape(-1)
    col = (8 * j + 2 * t + c).reshape(-1)
    h = torch.zeros(2, u, rows, n_s, 64 * n_kt)
    for s in range(n_s):
        for kt in range(n_kt):
            ks = 64 * kt + sub
            g = torch.where(part == 0, gr[:, s][..., ks], gi[:, s][..., ks])
            G = torch.zeros(u, chunks, 128)
            G[..., col] = g
            for r0 in range(0, rows, 64):
                d3 = d4 = 0
                for p0 in range(0, chunks, 32):
                    b = G[:, p0:p0 + 32]
                    d3 = d3 + _mm3(er[:, r0:r0 + 64, p0:p0 + 32], b)
                    d4 = d4 + _mm3(ei[:, r0:r0 + 64, p0:p0 + 32], b)
                re, im = col[part == 0], col[part == 1]
                kk = 64 * kt + sub[part == 0]
                h[0, :, r0:r0 + 64, s, kk] = d3[..., re] - d4[..., im]
                h[1, :, r0:r0 + 64, s, kk] = d3[..., im] + d4[..., re]
    h = h[:, :, :q, :, :n_k].reshape(2, u, q, n_s * n_k)
    return torch.cat((h[0], h[1]), -1) if packed else h


@pytest.mark.parametrize("name, shape", [
    ("headline", ((1, 1), (8, 8), 64, 1, False, True, 25)),
    ("two_row_tiles", ((2, 1), (8, 8), 16, 1, False, False, 25)),
    ("ragged_columns", ((1, 1), (8, 8), 100, 1, False, True, 25)),
    ("two_chunks_slots", ((1, 1), (8, 6), 20, 2, True, True, 37)),
    ("ragged_rows", ((1, 1), (8, 12), 8, 3, True, False, 11))])
def test_tensor_core_factoring_matches_plain_version(name, shape):
    """The tensor-core design's tiles, column order and H assembly,
    emulated on the CPU, within the kernel's RTOL of the plain version:
    two row tiles, a ragged column tile, two path chunks with per-slot
    amplitudes, a ragged row tile over three slots, both layouts."""
    rx, tx, k, s, per_slot, packed, p = shape
    args = [torch.from_numpy(a) for a in _inputs(5, s, per_slot, seed=3,
                                                   p=p)]
    got = _tensor_core_emulation(*args, rx, tx, k, packed)
    want = kr.fused_render_reference(*args, rx, tx, k, packed)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= \
        RTOL * float(want.abs().max())


# name: (rx_shape, tx_shape, U, K, S, per-slot amp, packed, P)
CUDA_TC_CASES = {
    "headline": ((1, 1), (8, 8), 4111, 64, 1, False, True, 25),
    "four_slots": ((1, 1), (8, 8), 2053, 64, 4, True, True, 25),
    "p37": ((1, 1), (8, 8), 2053, 64, 1, False, True, 37),
    "p40_two_slots": ((1, 1), (8, 8), 2053, 64, 2, True, True, 40),
    "rx2_q128": ((2, 1), (8, 8), 2053, 64, 1, False, True, 25),
    "sk100": ((1, 1), (8, 8), 1031, 100, 1, False, True, 25),
    "u1": ((1, 1), (8, 8), 1, 64, 1, False, True, 25),
    "u2125": ((1, 1), (8, 8), 2125, 64, 1, False, True, 25),
    "stacked": ((1, 1), (8, 8), 2053, 64, 2, False, False, 25),
    # off the separable 8-wide panel; K = 17: scalar stores
    "panel_4x16_k17": ((1, 1), (4, 16), 1031, 17, 3, True, True, 25),
    "q96_ragged_rows": ((1, 1), (8, 12), 1031, 64, 1, False, True, 25),
    # past the first tile by 8 rows; off the separable panel at K = 1
    "q72_ragged_rows": ((1, 1), (8, 9), 1031, 64, 1, False, True, 25),
    "panel_5x16_k1": ((1, 1), (5, 16), 1031, 1, 1, False, True, 25),
}


def _cuda_run(cuda, shape, mm="float32", out_dtype="float32"):
    """The kernel and its plain version on the card, with the launch
    counters' steps (LAUNCHES, TC_LAUNCHES)."""
    rx, tx, u, k, s, per_slot, packed, p = shape
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(u, s, per_slot, seed=4, p=p)]
    before = kr.LAUNCHES, kr.TC_LAUNCHES
    got = kr.fused_render(*args, rx, tx, k, packed, mm_dtype=mm,
                          out_dtype=out_dtype)
    want = kr.fused_render_reference(*args, rx, tx, k, packed, mm)
    torch.cuda.synchronize()
    steps = kr.LAUNCHES - before[0], kr.TC_LAUNCHES - before[1]
    return got, want, steps


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_TC_CASES))
def test_cuda_tensor_core_design_matches_plain_version(cuda, name):
    """The tensor-core design (one launch, counted in TC_LAUNCHES and
    under MODE_LAUNCHES["tc"] alone) against the plain version within
    RTOL * max|H|."""
    modes = dict(kr.MODE_LAUNCHES)
    got, want, steps = _cuda_run(cuda, CUDA_TC_CASES[name])
    assert steps == (1, 1)
    modes["tc"] = modes.get("tc", 0) + 1
    assert kr.MODE_LAUNCHES == modes
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= \
        RTOL * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name, shape, mm, out_dtype, tol", [
    ("quickstart", ((1, 1), (8, 1), 1031, 1, 1, False, True, 25),
     "float32", "float32", RTOL),
    ("panel_4x4", ((1, 1), (4, 4), 1031, 64, 1, False, True, 25),
     "float32", "float32", RTOL),
    ("panel_8x4", ((1, 1), (8, 4), 1031, 64, 2, True, False, 25),
     "float32", "float32", RTOL),
    ("headline_bf16_mm", ((1, 1), (8, 8), 1031, 64, 1, False, True, 25),
     "bfloat16", "float32", BF16_MM_RTOL),
    ("headline_bf16_out", ((1, 1), (8, 8), 1031, 64, 1, False, True, 25),
     "float32", "bfloat16", BF16_OUT_RTOL)])
def test_cuda_mma_design_keeps_other_shapes(cuda, name, shape, mm,
                                            out_dtype, tol):
    """Small panels and the bf16 modes stay on the mma.sync design: one
    launch, TC_LAUNCHES unmoved and counted under its mode's key, within
    the mode's bound."""
    modes = dict(kr.MODE_LAUNCHES)
    got, want, steps = _cuda_run(cuda, shape, mm, out_dtype)
    assert steps == (1, 0)
    key = kr.mode_key(mm, out_dtype)
    modes[key] = modes.get(key, 0) + 1
    assert kr.MODE_LAUNCHES == modes
    assert float((got.float() - want).abs().max()) <= \
        tol * float(want.abs().max())
