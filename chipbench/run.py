"""Run one cell of the benchmark once.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with a CUDA card. The cell, its
configuration and its traffic mix are found by name in ``BENCHMARK.json``.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``); the numbers compared against the plain reference, each
beside its limit, are the last lines of standard error. Without a card, or
with fewer cards than the cell asks for, it prints no result and exits
non-zero.
"""

import time

T_START = time.perf_counter()       # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)
    from chipbench.harness.main import main
    sys.exit(main(sys.argv[1:], T_START, ROOT))
