"""Ablations and phase counters of the path-sum kernel on the card.

Run from the repository root on a machine with an H100 and nvcc:

    python3 deepmimo_tpu_torch/tools/ablate_pathsum.py [TREE ...]

For each source tree (a directory holding ``pathsum.cu`` and
``render_tables.cuh``; by default this checkout's ``csrc/``) it builds the
kernel and patched copies of it under ``build/ablate_pathsum/`` (one nvcc
each, in parallel), checks the kernel against its plain version and times
every copy at the headline shape (131,072 users, P = 25, R = 1, T = 64,
K = 64) with CUDA events, in turns. The copies read clock64 counters, in
cycles per chunk and warp: the consumers waiting for their atx stage, for
a full B stage, in their products, and after them (stores); the
producers waiting for their scalars, for an empty B stage, and building
B. Variants: ``counters`` (the kernel with the counters), ``noproducts``
(the products replaced by a use of their operands), ``nostore``,
``nob`` (B left unbuilt) and ``producers`` (the consumers only wait on
the barriers). The patched copies compute wrong results; their times
split the kernel's time and are no measurement of it. It takes the
kernel as committed and its mma.sync predecessor (commit bfeb8ec); the
patches match their text, and an edit that breaks one stops the script.
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
from deepmimo_tpu_torch.ops.kernels import pathsum as kp    # noqa: E402

OUT = "build/ablate_pathsum"

INCLUDE = '#include "render_tables.cuh"\n'
COUNTERS = (INCLUDE + "__device__ unsigned long long g_prof[16];\n"
            'extern "C" int prof_read(unsigned long long* h) {\n'
            "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n"
            "}\n"
            'extern "C" int prof_zero() {\n'
            "  unsigned long long z[16] = {};\n"
            "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
            "}\n")

P_WAIT = ("  for (; it.u < a.U; ++n) {\n    const int s = n & 1;\n"
          "    render::cp_async_wait_all();\n")
P_SCAL = ("    render::bar_sync(kProdBar, kProducers);   "
          "// scalars of item n landed\n")
P_EMPTY = ("    if (n >= 2) render::bar_sync(kEmpty + s, kThreads);   "
           "// B[s] consumed\n")
P_FULL = ("    render::bar_arrive(kFull + s, kThreads);               "
          "// B[s] built\n")
P_END = "    render::bar_sync(kEmpty + (m & 1), kThreads);\n"
C_DECL = ("  float d[64];     // n-tile nt = 4 h + 2 c + j: d[4 nt .. 4 nt + 3]\n",
          "  float acc[1][16][4];\n")
C_TOP = ("    render::cp_async_wait_all();\n    render::bar_sync(kConsBar, "
         "kConsumers);   // A of item n landed\n")
C_FULL = "    render::bar_sync(kFull + s, kThreads);    // B of item n built\n"
C_EMPTY = "    render::bar_arrive(kEmpty + s, kThreads); // B[s] may be rebuilt\n"
C_END = "    it = nx;\n  }\n}\n\n}  // namespace"
PRODUCTS = (
    ("      wgmma_tf32(d, al[ks], dh + step);     // lo . hi\n"
     "      wgmma_tf32(d, ah[ks], dl + step);     // hi . lo\n"
     "      wgmma_tf32(d, ah[ks], dh + step);     // hi . hi\n",
     "      d[ks] += __uint_as_float(al[ks][0] ^ ah[ks][3]);\n"),
    ("        render::mma3(acc, af, bf, 1, n_n);",
     "        acc[0][0][0] += __uint_as_float(af[0][0].hi ^ bf[7][1].lo);"))
STORES = ("    if (a.P - it.p0 <= kPC) {",
          "    if (a.P - it.p0 <= kPC && 16 * warp < rows) {")
BUILD = ("    build_b(scal_st + s * kScalFloats, bh, bh + kBPlane);\n",
         "    build_b(a, it, scal_st + s * kScalFloats, b_st + s * kNT * kBS);\n")
COPY_A = "    if (nx.u < a.U) issue_a(a, nx, a_st + (s ^ 1) * kAPlanes);\n"


def add_counters(first, names):
    """The counters in `names` added to g_prof[first ...] by lane 0 of
    each warp."""
    return "  if ((threadIdx.x & 31) == 0) {" + "".join(
        f" atomicAdd(&g_prof[{first + i}], (unsigned long long){n});"
        for i, n in enumerate(names)) + " }\n"


def one_of(src, options):
    """The first of `options` that the source holds (its generation)."""
    for text in options:
        if text in src:
            return text
    raise AssertionError(f"none of {[t[:50] for t in options]} in source")


def counter_patches(src):
    """clock64 counters: producers g_prof[0..3], consumers g_prof[4..8]."""
    decl = one_of(src, C_DECL)
    return [
        (INCLUDE, COUNTERS),
        (P_WAIT, P_WAIT.replace(
            "    render::cp_async_wait_all();\n",
            "    long long q0 = clock64();\n    render::cp_async_wait_all();\n")
         .replace("  for (;", "  long long pa = 0, pe = 0, pb = 0;\n  for (;")),
        (P_SCAL, P_SCAL + "    long long q1 = clock64(); pa += q1 - q0;\n"),
        (P_EMPTY, P_EMPTY + "    long long q2 = clock64(); pe += q2 - q1;\n"),
        (P_FULL, "    pb += clock64() - q2;\n" + P_FULL),
        (P_END, P_END + add_counters(0, ("pa", "pe", "pb", "n"))),
        (decl, decl + "  long long ct = 0, cf = 0, cm = 0, cs_ = 0, ci = 0;\n"),
        (C_TOP, "    long long c0 = clock64();\n" + C_TOP +
         "    long long c1 = clock64(); ct += c1 - c0; ++ci;\n"),
        (C_FULL, C_FULL + "    long long c2 = clock64(); cf += c2 - c1;\n"),
        (C_EMPTY, "    long long c3 = clock64(); cm += c3 - c2;\n" + C_EMPTY),
        (C_END, "    cs_ += clock64() - c3;\n" + C_END.replace(
            "  }\n}\n\n}", "  }\n" + add_counters(
                4, ("ct", "cf", "cm", "cs_", "ci")) + "}\n\n}", 1)),
    ]


def variants(src):
    """name -> patches of the kernel source."""
    prod_old, prod_new = next(p for p in PRODUCTS if p[0] in src)
    store = one_of(src, STORES)
    no_products = [(prod_old, prod_new)]
    no_stores = [(store, store.replace("if (", "if (a.U < 0 && "))]
    counted = counter_patches(src)
    return {
        "kernel": [],
        "counters": counted,
        "noproducts": counted + no_products,
        "nostore": counted + no_stores,
        "nob": counted + [(one_of(src, BUILD), "")],
        "producers": counted + no_products + no_stores + [(COPY_A, "")],
    }


def build(item):
    tag, tree, name, patches = item
    d = os.path.join(OUT, tag, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(tree, "pathsum.cu")) as f:
        src = f.read()
    for old, new in patches:
        assert old in src, (tag, name, old[:60])
        src = src.replace(old, new, 1)
    with open(os.path.join(d, "pathsum.cu"), "w") as f:
        f.write(src)
    with open(os.path.join(tree, "render_tables.cuh")) as f, \
            open(os.path.join(d, "render_tables.cuh"), "w") as g:
        g.write(f.read())
    lib = os.path.join(d, "pathsum.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o",
                        lib, os.path.join(d, "pathsum.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    regs = [line.split(":", 1)[1].strip() for line in
            (p.stdout + p.stderr).splitlines() if "registers" in line]
    return tag, name, lib, regs


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    trees = sys.argv[1:] or [_build.CSRC_DIR]
    items = []
    for i, tree in enumerate(trees):
        with open(os.path.join(tree, "pathsum.cu")) as f:
            src = f.read()
        tag = f"{i}_{os.path.basename(os.path.normpath(tree))}"
        items += [(tag, tree, name, patches)
                  for name, patches in variants(src).items()]
    with ThreadPoolExecutor(len(items)) as pool:
        built = list(pool.map(build, items))
    torch.backends.cuda.matmul.allow_tf32 = False
    u, p, k = cs.CHUNK, cs.MAX_PATHS, cs.N_SC
    args = cs._pathsum_inputs(torch, u, p, 1, 64, list(range(k)), seed=3)
    want = kp.fused_path_sum_reference(*args)
    hr, hi = torch.empty_like(want[0]), torch.empty_like(want[1])
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for tag, name, lib, regs in built:
        dll = ctypes.CDLL(lib)
        fn = dll.pathsum_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        ptrs = [a.data_ptr() for a in args] + [hr.data_ptr(), hi.data_ptr()]
        call = (lambda fn=fn, ptrs=ptrs:
                fn(*ptrs, u, p, 1, 64, k, stream))
        if name == "kernel":
            call()
            torch.cuda.synchronize()
            err = max(float((hr - want[0]).abs().max()),
                      float((hi - want[1]).abs().max()))
            scale = max(float(w.abs().max()) for w in want)
            print(f"{tag} kernel: {regs}; rel err vs plain "
                  f"{err / scale:.2e}", flush=True)
            assert err <= cs.KERNEL_RTOL * scale
        calls.append((tag, name, dll, call))
    for rep in range(2):
        for tag, name, dll, call in (calls if rep == 0 else calls[::-1]):
            ms = cs.event_ms(torch, call, reps=10)
            line = f"{tag} {name:10s} {ms:.4f} ms"
            if name != "kernel":
                dll.prof_zero()
                call()
                torch.cuda.synchronize()
                v = (ctypes.c_ulonglong * 16)()
                dll.prof_read(v)
                line += (f"; consumer cycles per chunk: atx-wait "
                         f"{v[4] / v[8]:.0f}, full-wait {v[5] / v[8]:.0f}, "
                         f"products {v[6] / v[8]:.0f}, after "
                         f"{v[7] / v[8]:.0f}; producer: scalar-wait "
                         f"{v[0] / v[3]:.0f}, empty-wait {v[1] / v[3]:.0f},"
                         f" build {v[2] / v[3]:.0f}")
            print(line, flush=True)


if __name__ == "__main__":
    main()
