"""The forward render kernel's two designs against each other on the card.

Run from the repository root on a machine with an H100 and nvcc:

    python3 deepmimo_tpu_torch/tools/render_crossover.py [name ...]

Builds ``csrc/render_fwd.cu`` and prints the ptxas report of its
tensor-core kernels. Then, at 131,072 users and each shape of ``SHAPES``
(or those named), it times the ``mma.sync`` design and the tensor-core
design (``render._launch_fwd``'s ``tensor_cores`` flag) in float32 at f32
grade with CUDA events, in rounds of launches whose order alternates,
whatever ``tensor_core_route`` would pick, and prints each design's
median ms, their ratio and the route's pick. These timings set
``ops/kernels/render.py``'s route. The card's name and power limit are
printed first. The tests hold both designs to the plain version
(``tests/test_torch_render.py``).
"""
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs                                     # noqa: E402
from deepmimo_tpu_torch.ops.kernels import _build           # noqa: E402
from deepmimo_tpu_torch.ops.kernels import render as kr     # noqa: E402

MMA, TC = False, True
USERS = cs.CHUNK
# name: rx_shape, tx_shape, K, P, S (per-slot amp when S > 1)
SHAPES = {
    "q8_k1": ((1, 1), (8, 1), 1, 25, 1),
    "q8_k64": ((1, 1), (8, 1), 64, 25, 1),
    "q16_k1": ((1, 1), (4, 4), 1, 25, 1),
    "q16_k64": ((1, 1), (4, 4), 64, 25, 1),
    "q32_k1": ((1, 1), (8, 4), 1, 25, 1),
    "q32_k64": ((1, 1), (8, 4), 64, 25, 1),
    "q48_k64": ((1, 1), (8, 6), 64, 25, 1),
    "q48_6x8_k1": ((1, 1), (6, 8), 1, 25, 1),
    "q48_6x8_k64": ((1, 1), (6, 8), 64, 25, 1),
    "q56_k64": ((1, 1), (8, 7), 64, 25, 1),
    "q64_k1": ((1, 1), (8, 8), 1, 25, 1),
    "q64_k16": ((1, 1), (8, 8), 16, 25, 1),
    "q64_k64": ((1, 1), (8, 8), 64, 25, 1),
    "q64_k100": ((1, 1), (8, 8), 100, 25, 1),
    "q64_p10": ((1, 1), (8, 8), 64, 10, 1),
    "q64_p40": ((1, 1), (8, 8), 64, 40, 1),
    "q64_s4": ((1, 1), (8, 8), 64, 25, 4),
    "q64_4x16": ((1, 1), (4, 16), 64, 25, 1),
    "q64_4x16_k1": ((1, 1), (4, 16), 1, 25, 1),
    "q64_rx4": ((2, 2), (4, 4), 64, 25, 1),
    "q64_rx4_k1": ((2, 2), (4, 4), 1, 25, 1),
    "q72_k1": ((1, 1), (8, 9), 1, 25, 1),
    "q72_k64": ((1, 1), (8, 9), 64, 25, 1),
    "q80_k64": ((1, 1), (8, 10), 64, 25, 1),
    "q80_5x16_k1": ((1, 1), (5, 16), 1, 25, 1),
    "q96_k64": ((1, 1), (8, 12), 64, 25, 1),
    "q112_k64": ((1, 1), (8, 14), 64, 25, 1),
    "q128_k1": ((2, 1), (8, 8), 1, 25, 1),
    "q128_k64": ((2, 1), (8, 8), 64, 25, 1),
    "q144_k1": ((2, 1), (8, 9), 1, 25, 1),
    "q144_k64": ((1, 1), (8, 18), 64, 25, 1),
}


def time_shape(name, rounds=5, reps=10):
    rx, tx, k, p, s = SHAPES[name]
    args = cs._render_inputs(torch, USERS, p, s, s, seed=len(name))
    q = rx[0] * rx[1] * tx[0] * tx[1]
    out = torch.empty((USERS, q, 2 * s * k), device="cuda")
    ms = {MMA: [], TC: []}
    for rnd in range(rounds):
        for design in ((MMA, TC) if rnd % 2 else (TC, MMA)):
            ms[design].append(cs.event_ms(torch, lambda: kr._launch_fwd(
                args, out, USERS, p, *rx, *tx, k, s, s, True, passes=3,
                out_bf16=False, tensor_cores=design), reps=reps))
    mma, tc = (statistics.median(ms[d]) for d in (MMA, TC))
    route = kr.tensor_core_route(rx, tx)
    print(f"[crossover] {name}: rx={rx} tx={tx} Q={q} K={k} P={p} S={s} "
          f"mma.sync {mma:.4f} ms, tensor cores {tc:.4f} ms, ratio "
          f"{mma / tc:.3f}; route: {'tensor cores' if route else 'mma.sync'}",
          flush=True)
    del out, args
    torch.cuda.empty_cache()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load_library("render_fwd")
    for line in _build.build_log("render_fwd").splitlines():
        if ("kernel_tc" in line or "registers" in line or "spill" in line
                or "C7520" in line):
            print("[ptxas]", line.strip(), flush=True)
    for name in sys.argv[1:] or SHAPES:
        time_shape(name)


if __name__ == "__main__":
    main()
