"""The beam-gain kernel's SIMT and tensor-core designs against each other
on the card.

Run from the repository root on a machine with an H100 and nvcc:

    python3 deepmimo_tpu_torch/tools/beamgain_crossover.py [name ...]

Builds ``csrc/beamgain.cu`` and prints the ptxas report of its kernels.
Then, at 131,072 users and each shape of ``SHAPES`` (or those named), it
times the SIMT design in float32 and the tensor-core design that takes
the panel (``beamgain.DESIGNS``: "tc" up to 64 TX elements, "tc_wide" past
it) with CUDA events at each of the shape's beam counts, in rounds of
launches whose order alternates, whatever ``tensor_core_route`` would
pick, and prints each design's median ms, their ratio and the route's
pick; where the SIMT design's shared memory does not take the shape, the
tensor cores alone. These timings set
``ops/kernels/beamgain.py``'s route. The card's name and power limit are
printed first. The tests hold both designs to
the plain version (``tests/test_torch_beamgain.py``).
"""
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs                                     # noqa: E402
from deepmimo_tpu_torch.ops.kernels import _build           # noqa: E402
from deepmimo_tpu_torch.ops.kernels import beamgain as kb   # noqa: E402

SIMT = kb.DESIGNS["f32"]
USERS = cs.CHUNK
# name: rx_shape, tx_shape, K, P, S, n_sa, beams. The route's cost models
# were fitted to the first 27 and checked on the next 4; the wide
# design's (T > 64) to the "t72", "t128" and "t256" shapes and checked on
# the rest.
SHAPES = {
    "headline": ((1, 1), (8, 8), 64, 25, 1, 1, (16, 32, 48, 64, 128)),
    "quickstart": ((1, 1), (8, 1), 1, 25, 1, 1, (32, 48, 64, 80, 96, 128)),
    "t8_k64": ((1, 1), (8, 1), 64, 25, 1, 1, (32, 64, 128)),
    "t16_k1": ((1, 1), (4, 4), 1, 25, 1, 1, (32, 64, 128)),
    "t16_k16": ((1, 1), (4, 4), 16, 25, 1, 1, (32, 64, 128)),
    "t16": ((1, 1), (4, 4), 64, 25, 1, 1, (32, 64, 128)),
    "t32": ((1, 1), (8, 4), 64, 25, 1, 1, (32, 64, 128)),
    "t64_16x4": ((1, 1), (16, 4), 64, 25, 1, 1, (32, 64)),
    "k1": ((1, 1), (8, 8), 1, 25, 1, 1, (32, 64, 128)),
    "k8": ((1, 1), (8, 8), 8, 25, 1, 1, (32, 64, 128)),
    "k16": ((1, 1), (8, 8), 16, 25, 1, 1, (32, 64, 128)),
    "k32": ((1, 1), (8, 8), 32, 25, 1, 1, (32, 64, 128)),
    "k100": ((1, 1), (8, 8), 100, 25, 1, 1, (32, 64)),
    "p10": ((1, 1), (8, 8), 64, 10, 1, 1, (32, 64)),
    "p40": ((1, 1), (8, 8), 64, 40, 1, 1, (32, 64, 128)),
    "p40_s4": ((1, 1), (8, 8), 64, 40, 4, 4, (32, 64, 128)),
    "rx4": ((2, 2), (8, 8), 64, 25, 1, 1, (32, 64)),
    "rx2_k1": ((2, 1), (8, 1), 1, 25, 1, 1, (32, 64)),
    "t1": ((1, 1), (1, 1), 64, 25, 1, 1, (32, 64, 128)),
    "t4_p5": ((1, 1), (2, 2), 64, 5, 1, 1, (32, 64, 128)),
    "t8_p10": ((1, 1), (8, 1), 1, 10, 1, 1, (32, 64, 96, 128)),
    "t8_p40": ((1, 1), (8, 1), 1, 40, 1, 1, (32, 64)),
    "t8_s4": ((1, 1), (8, 1), 64, 25, 4, 4, (32, 64)),
    "t16_b48": ((1, 1), (4, 4), 64, 25, 1, 1, (40, 48, 56)),
    "few_paths": ((2, 2), (4, 4), 100, 9, 2, 2, (32, 64, 128)),
    "odd_panel": ((1, 1), (3, 5), 17, 37, 3, 1, (32, 70)),
    "p40_b16": ((1, 1), (8, 8), 64, 40, 1, 1, (16,)),
    "rx2_s2": ((2, 1), (8, 8), 64, 16, 2, 2, (32, 64)),
    "t12_p20": ((1, 1), (4, 3), 32, 20, 1, 1, (32, 48, 64, 96)),
    "p33": ((1, 1), (8, 8), 64, 33, 1, 1, (32, 64)),
    "t2_k256": ((1, 1), (2, 1), 256, 25, 1, 1, (32, 64, 128)),
    "t72": ((1, 1), (9, 8), 64, 25, 1, 1, (32, 64, 128, 256)),
    "t128": ((1, 1), (16, 8), 64, 25, 1, 1, (32, 64, 100, 128, 224, 256)),
    "t256": ((1, 1), (16, 16), 64, 25, 1, 1, (32, 64, 100, 112, 128, 256)),
    "t96_p40": ((1, 1), (12, 8), 64, 40, 1, 1, (32, 64, 128)),
    "t128_rx2_s2": ((2, 1), (16, 8), 64, 25, 2, 2, (32, 64, 128)),
    "t256_k16": ((1, 1), (16, 16), 16, 25, 1, 1, (32, 64, 112)),
    "t192_p10": ((1, 1), (16, 12), 64, 10, 1, 1, (32, 64, 128)),
}


def time_shape(name, rounds=5, reps=10):
    rx, tx, k, p, s, n_sa, beams = SHAPES[name]
    args = cs._render_inputs(torch, USERS, p, s, n_sa, seed=len(name))
    t = tx[0] * tx[1]
    tc_key = "tc" if t <= kb.TC_MAX_TX else "tc_wide"
    tc_code = kb.DESIGNS[tc_key]
    for b in beams:
        w = cs._planes_on_card(torch, cs.codebook(b, t, seed=b))
        out = torch.empty((USERS, rx[0] * rx[1] * b, s * k), device="cuda")
        designs = [tc_code] + ([SIMT] if kb.smem_bytes(rx, tx, b, p, k) <=
                               kb.SMEM_LIMIT else [])
        ms = {d: [] for d in designs}
        for rnd in range(rounds):
            for design in (designs[::-1] if rnd % 2 else designs):
                ms[design].append(cs.event_ms(torch, lambda: kb._launch(
                    args, *w, out, USERS, p, *rx, *tx, b, k, s, n_sa,
                    design), reps=reps))
        tc = statistics.median(ms[tc_code])
        simt = statistics.median(ms[SIMT]) if SIMT in ms else None
        route = kb.beam_gain_design(rx, tx, b, k, p, s)
        print(f"[crossover] {name} B={b}: rx={rx} tx={tx} K={k} P={p} S={s}"
              f" SIMT " + (f"{simt:.4f} ms" if simt else "(does not fit)") +
              f", tensor cores [{tc_key}] {tc:.4f} ms, ratio " +
              (f"{simt / tc:.3f}" if simt else "-") +
              f"; route: {route}; models (ns a user) SIMT "
              f"{kb._simt_ns(rx[0] * rx[1], t, b, k, p, s):.1f}, "
              f"tensor cores {kb._tc_ns(rx[0] * rx[1], tx, b, k, p, s):.1f}",
              flush=True)
        del w, out
        torch.cuda.empty_cache()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load_library("beamgain")
    for line in _build.build_log("beamgain").splitlines():
        if "beamgain" in line or "registers" in line or "spill" in line:
            print("[ptxas]", line.strip(), flush=True)
    for name in sys.argv[1:] or SHAPES:
        time_shape(name)


if __name__ == "__main__":
    main()
