"""Ablations and phase counters of the render kernels on the card.

Run from the repository root on a machine with an H100 and nvcc:

    python3 deepmimo_tpu_torch/tools/ablate.py

It builds patched copies of ``csrc/render_fwd.cu`` and ``csrc/render_bwd.cu``
under ``build/ablate/`` (one nvcc each, in parallel), times each at the
headline shape (131,072 users, P = 25, RX 1x1, TX 8x8, K = 64, packed) with
CUDA events, and reads clock64 counters that the patches add, in cycles
per tile and warp: the consumers waiting for a full stage, in their
products, and after them (stores, or the folds' reduction); the producers
(each group, in the forward) in their tables, waiting for an empty stage,
and building the stage (planes, and the backward's ct split).

Variants: as built; ``nomma``, the consumers' mma replaced by a use of
their operands; ``noprod``, the producers' tables and planes left out;
``fasttrig``, ``__sincosf`` in the tables; ``noloads``, constants in place
of the tables' psi and amp loads. It also builds and runs
``tools/mma_peak.cu``, the rate of independent mma.sync m16n8k8 TF32
products on the card. The copies compute wrong results; their times split
the time of the real kernels and are no measurement of them. The patches
match the sources' text: an edit there that breaks one stops the script.
"""
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs                                     # noqa: E402
from deepmimo_tpu_torch.ops.kernels import _build           # noqa: E402

OUT = "build/ablate"
TOOLS = os.path.dirname(os.path.abspath(__file__))

INCLUDE = '#include "render_tables.cuh"\n'
PROF = [(INCLUDE, INCLUDE +
         "__device__ unsigned long long g_prof[16];\n"
         'extern "C" int prof_read(unsigned long long* h) {\n'
         "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n"
         "}\n"
         'extern "C" int prof_zero() {\n'
         "  unsigned long long z[16] = {};\n"
         "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
         "}\n")]


def add_counters(first, names):
    """The counters in `names` added to g_prof[first ...] by lane 0 of
    each warp."""
    return "  if ((threadIdx.x & 31) == 0) {" + "".join(
        f" atomicAdd(&g_prof[{first + i}], (unsigned long long){n});"
        for i, n in enumerate(names)) + " }"


def producer_patches(sync, tables, empty, full, last):
    """clock64 counters around a producer loop, given the text of its first
    barrier, its tables barrier, its empty-stage wait, its full-stage
    arrive and its last line: g_prof[0..3] and the tile count g_prof[8]."""
    loop = "  int n = 0;\n  for (; it.u < s.U; ++n) {"
    return [
        (loop, "  long long pw = 0, pt = 0, pe = 0, pp_ = 0;\n" + loop),
        ("    cp_async_wait_all();\n" + sync,
         "    long long t0 = clock64();\n    cp_async_wait_all();\n" + sync +
         "    long long t1 = clock64(); pw += t1 - t0;\n"),
        (tables, tables + "    long long t2 = clock64(); pt += t2 - t1;\n"),
        (empty, empty + "    long long t3 = clock64(); pe += t3 - t2;\n"),
        (full, "    pp_ += clock64() - t3;\n" + full),
        (last, last + "\n" + add_counters(0, ("pw", "pt", "pe", "pp_")) +
         add_counters(8, ("n",))),
    ]


def consumer_patches(start, full, empty, end):
    """clock64 counters in a consumer loop, given the text that starts
    it, its full-stage wait, its empty-stage arrive and the text that ends
    it: g_prof[4..6] and the tile count g_prof[7]."""
    return [
        (start, "  long long cf = 0, cm = 0, cs_ = 0, ci = 0;\n" + start),
        (full, "    long long c0 = clock64();\n" + full +
         "    long long c1 = clock64(); cf += c1 - c0; ++ci;\n"),
        (empty, "    long long c2 = clock64(); cm += c2 - c1;\n" + empty),
        (end, "    cs_ += clock64() - c2;\n" + end.replace(
            "  }\n}", "  }\n" + add_counters(4, ("cf", "cm", "cs_", "ci")) +
            "\n}", 1)),
    ]


FWD_PRODUCERS = producer_patches(
    "    bar_sync(kGroupBar + g, kGroup);   // scalars landed; tables free\n",
    "    bar_sync(kGroupBar + g, kGroup);   // tables ready\n",
    "    if (n > 0) bar_sync(kEmpty + g, kHandoff);   // stage g consumed\n",
    "    bar_arrive(kFull + g, kHandoff);   // stage g full\n",
    "  if (n > 0) bar_sync(kEmpty + g, kHandoff);     // the last release")
BWD_PRODUCERS = producer_patches(
    "    bar_sync(kProdBar, kProducers);    // scalars landed; tables free\n",
    "    bar_sync(kProdBar, kProducers);    // tables ready\n",
    "    if (n > 1) bar_sync(kEmpty + b, kHandoff);   // stage b consumed\n",
    "    bar_arrive(kFull + b, kHandoff);   // stage b full\n",
    "  if (n > 0) bar_sync(kEmpty + ((n - 1) & 1), kHandoff);")
FWD_CONSUMERS = consumer_patches(
    "  float acc[2][4][4];        // [m-tile]",
    "    bar_sync(kFull + b, kHandoff);    // stage b holds this tile's "
    "operands\n",
    "    bar_arrive(kEmpty + b, kHandoff);  // stage b may be refilled\n",
    "    it = nx;\n  }\n}\n\ntemplate <int kPasses, typename OutT>")
BWD_CONSUMERS = consumer_patches(
    "  Item it{static_cast<int>(blockIdx.x), 0, 0, 0, 0};\n"
    "  for (int b = 0; it.u < s.U; b ^= 1) {",
    "    bar_sync(kFull + b, kHandoff);    // stage b holds this tile\n",
    "    bar_arrive(kEmpty + b, kHandoff);  // stage b may be refilled\n",
    "    it = next_item(s, it);\n  }\n}\n\n}  // namespace")
FWD_NOMMA = [("        mma3<kPasses>(acc, a, b4, m1 ? 2 : 1, 4);",
              "        acc[0][0][0] += __uint_as_float(a[0][0].hi ^ "
              "b4[3][1].lo);")]
FWD_NOPROD = [("    build_tables(tm, s, tl, it.u, it.p0, scal + (n & 1) * "
               "kScal * kPC, psi,\n                 amp, tab, row_ix, "
               "col_ix);", ""),
              ("    build_planes<kES, kPasses>(tm, tl, imin(kPC, s.P - it.p0), "
               "tab, row_ix,\n                               col_ix, e_pl, "
               "g_pl);", "")]
BWD_NOMMA = [("        mma3<kPasses>(acc, a, bf, m1 ? 2 : 1, n_nt);",
              "        acc[0][0][0] += __uint_as_float(a[0][0].hi ^ "
              "bf[3][1].lo);")]
BWD_NOPROD = [("    build_tables(tm, s, tl, u, it.p0, scal + (n & 1) * kScal "
               "* kPC, psi,\n                 nullptr, tab, row_ix, "
               "col_ix);\n", ""),
              ("    build_planes<kES, kPasses>(tm, tl, np, tab, row_ix, col_ix, "
               "st.e, st.w);\n", "")]
# Producer-side copies: full-range sincosf replaced by the fast intrinsic;
# the coarse entries' psi and amp loads replaced by constants.
FAST_TRIG = [("  sincosf(ph, &s, &c);                // full range reduction",
              "  __sincosf(ph, &s, &c);")]
NO_LOADS = [("        ph[i] = __ldg(psi + (u * s.S + sl) * s.P + p) -",
             "        ph[i] = 1.5f -"),
            ("          a[i] = __ldg(amp + u * s.n_sa * s.P + (s.n_sa > 1 ? "
             "sl * s.P : 0) +\n                       p);",
             "          a[i] = 1e-4f;")]
FWD = PROF + FWD_PRODUCERS + FWD_CONSUMERS
BWD = PROF + BWD_PRODUCERS + BWD_CONSUMERS
# name, kernel, patches of the kernel, patches of render_tables.cuh
VARIANTS = [
    ("fwd", "render_fwd", FWD, []),
    ("fwd_nomma", "render_fwd", FWD + FWD_NOMMA, []),
    ("fwd_noprod", "render_fwd", FWD + FWD_NOPROD, []),
    ("fwd_fasttrig", "render_fwd", FWD, FAST_TRIG),
    ("fwd_noloads", "render_fwd", FWD, NO_LOADS),
    ("bwd", "render_bwd", BWD, []),
    ("bwd_nomma", "render_bwd", BWD + BWD_NOMMA, []),
    ("bwd_noprod", "render_bwd", BWD + BWD_NOPROD, []),
    ("bwd_fasttrig", "render_bwd", BWD, FAST_TRIG),
    ("bwd_noloads", "render_bwd", BWD, NO_LOADS),
]


def patched(path, patches, name):
    with open(path) as f:
        src = f.read()
    for old, new in patches:
        assert old in src, (name, old[:60])
        src = src.replace(old, new)
    return src


def build(item):
    """One directory per variant: its kernel and header copies, its .so."""
    name, kernel, patches, header_patches = item
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for src, fix in ((kernel + ".cu", patches),
                     ("render_tables.cuh", header_patches)):
        with open(os.path.join(d, src), "w") as f:
            f.write(patched(os.path.join(_build.CSRC_DIR, src), fix, name))
    lib = os.path.join(d, kernel + ".so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o",
                        lib, os.path.join(d, kernel + ".cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    return name, kernel, lib


def mma_peak():
    exe = f"{OUT}/mma_peak"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-I", _build.CSRC_DIR, "-o", exe,
                    os.path.join(TOOLS, "mma_peak.cu")], check=True)
    print(subprocess.run([exe], capture_output=True, text=True,
                         check=True).stdout, end="")


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    mma_peak()
    u, p, k = cs.CHUNK, cs.MAX_PATHS, cs.N_SC
    args = cs._render_inputs(torch, u, p, 1, 1, seed=3)
    out = torch.empty((u, 64, 2 * k), device="cuda")
    ct = torch.rand((u, 64, 2 * k), device="cuda") * 2 - 1
    grads = [torch.empty_like(a) for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    for name, kernel, lib in built:
        dll = ctypes.CDLL(lib)
        fn = getattr(dll, kernel + "_launch")
        fwd = kernel == "render_fwd"
        # the f32 modes: 3 passes (and float32 H in the forward)
        modes = (3, 0) if fwd else (3,)
        fn.argtypes = [ctypes.c_void_p] * (8 if fwd else 15) + \
            [ctypes.c_int] * (10 + len(modes)) + [ctypes.c_void_p]
        ptrs = [a.data_ptr() for a in args] + (
            [out.data_ptr()] if fwd else
            [ct.data_ptr()] + [g.data_ptr() for g in grads])

        def call():
            fn(*ptrs, u, p, 1, 1, 8, 8, k, 1, 1, 1, *modes, stream)
        ms = cs.event_ms(torch, call, reps=10)
        dll.prof_zero()
        call()
        torch.cuda.synchronize()
        v = (ctypes.c_ulonglong * 16)()
        dll.prof_read(v)
        line = f"{name:11s} {ms:.4f} ms; consumer cycles per tile: " \
            f"full-wait {v[4] / v[7]:.0f}, products {v[5] / v[7]:.0f}, " \
            f"after {v[6] / v[7]:.0f}"
        if v[8]:
            line += (f"; producer: tables {v[1] / v[8]:.0f}, empty-wait "
                     f"{v[2] / v[8]:.0f}, planes {v[3] / v[8]:.0f}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
