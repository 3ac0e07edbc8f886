"""Same-process A/B of the f32 kernels of two trees, and their SASS.

Run from the repository root on a machine with an H100 and nvcc:

    python3 deepmimo_tpu_torch/tools/ab_kernels.py OTHER_TREE

OTHER_TREE is the root of another checkout, e.g. the parent commit
unpacked with ``git archive`` under ``build/``. For ``render_fwd``,
``render_bwd`` and ``beamgain`` it builds both trees' sources with nvcc into
``build/ab_kernels/``, dumps their SASS with ``cuobjdump`` and reports, for
each kernel function of the other tree, the function of this tree whose
instructions are the same (addresses stripped), if any. Then it times the
f32 mode of each kernel from both builds at the headline shape of
``chip_smoke.py`` (131,072 users, P = 25, RX 1x1, TX 8x8, K = 64, packed;
16 beams) with CUDA events, in 6 rounds of 30 launches, the order of the
two builds alternating, and prints every round and the medians. A source
whose launcher takes the mode arguments (``passes``, ``out_bf16``,
``bf16``) is called with the f32 values; an older one without them.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs                                     # noqa: E402
from deepmimo_tpu_torch.ops.kernels import _build           # noqa: E402

OUT = "build/ab_kernels"
KERNELS = ("render_fwd", "render_bwd", "beamgain")
# the launchers' f32 mode arguments, and the word that shows they exist
MODE_ARGS = {"render_fwd": ("int passes", (3, 0)),
             "render_bwd": ("int passes", (3,)),
             "beamgain": ("int bf16", (0,))}


def build(tree, tag, kernel):
    csrc = os.path.join(tree, "deepmimo_tpu_torch", "csrc")
    lib = os.path.join(OUT, f"{tag}_{kernel}.so")
    src = os.path.join(csrc, kernel + ".cu")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", lib, src], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    with open(src) as f:
        word, args = MODE_ARGS[kernel]
        modes = args if word in f.read() else ()
    return lib, modes


def sass(lib):
    """{function name: its instructions without addresses}."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name].append(" ".join(
                re.sub(r"/\*[0-9a-f]+\*/", "", line).split()))
    return {k: "\n".join(v) for k, v in out.items()}


def launcher(lib, kernel, modes, args, out, ct, grads, cw):
    fn = getattr(ctypes.CDLL(lib), kernel + "_launch")
    n_ptr = {"render_fwd": 8, "render_bwd": 15, "beamgain": 9}[kernel]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + \
        [ctypes.c_int] * (10 + len(modes)) + [ctypes.c_void_p]
    ptrs = [a.data_ptr() for a in args]
    u, p, k = cs.CHUNK, cs.MAX_PATHS, cs.N_SC
    if kernel == "render_fwd":
        ptrs.append(out.data_ptr())
        ints = (u, p, 1, 1, 8, 8, k, 1, 1, 1)
    elif kernel == "render_bwd":
        ptrs += [ct.data_ptr()] + [g.data_ptr() for g in grads]
        ints = (u, p, 1, 1, 8, 8, k, 1, 1, 1)
    else:
        ptrs += [cw.data_ptr(), out.data_ptr()]
        ints = (u, p, 1, 1, 8, 8, cs.BG_BEAMS, k, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: fn(*ptrs, *ints, *modes, stream)


def main():
    other = sys.argv[1]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    u, p, k = cs.CHUNK, cs.MAX_PATHS, cs.N_SC
    args = cs._render_inputs(torch, u, p, 1, 1, seed=len("headline"))
    out = torch.empty((u, 64, 2 * k), device="cuda")
    ct = torch.rand((u, 64, 2 * k), device="cuda") * 2 - 1
    grads = [torch.empty_like(a) for a in args]
    wr, wi = cs._planes_on_card(torch, cs.codebook(cs.BG_BEAMS, 64, seed=8))
    cw = torch.stack((wr.t(), wi.t().neg()), -1).contiguous()
    for kernel in KERNELS:
        builds = {tag: build(tree, tag, kernel)
                  for tag, tree in (("other", other), ("this", "."))}
        mine = sass(builds["this"][0])
        for name, code in sass(builds["other"][0]).items():
            same = [n for n, c in mine.items() if c == code]
            print(f"[sass] {kernel}: other {name} ({code.count(chr(10)) + 1}"
                  f" instructions) == this {same[0] if same else 'none'}",
                  flush=True)
        calls = {tag: launcher(lib, kernel, modes, args, out, ct, grads, cw)
                 for tag, (lib, modes) in builds.items()}
        ms = {tag: [] for tag in calls}
        for rnd in range(6):
            for tag in (("other", "this") if rnd % 2 == 0 else
                        ("this", "other")):
                ms[tag].append(cs.event_ms(torch, calls[tag], reps=30))
        for tag, v in ms.items():
            print(f"[time] {kernel} f32 {tag}: "
                  f"{', '.join('%.4f' % x for x in v)} ms; median "
                  f"{sorted(v)[len(v) // 2]:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
