"""Does ``chip_smoke.profile_cell`` fall back to CUDA events when the
profiler records no device event?

Run on a CUDA card from the repository root:

    python3 deepmimo_tpu_torch/tools/profile_fallback.py

Profiles a 4096 x 4096 float32 matmul once as it is, which must leave
``chip_smoke.PROFILE_EMPTY`` empty, and once with every profiler cycle
made to report no event, which must print the CUDA-event window and name
the cell in ``PROFILE_EMPTY``. Prints ``fallback ok``.
"""
import contextlib
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.profiler  # noqa: E402

import chip_smoke as cs  # noqa: E402


class _NoEvents:
    """A profiler's face with every event dropped."""

    def events(self):
        return []

    def step(self):
        pass


def main():
    a = torch.randn(4096, 4096, device="cuda")
    calls = [lambda: a @ a]
    cs.profile_cell(torch, "matmul", calls)
    assert cs.PROFILE_EMPTY == [], cs.PROFILE_EMPTY
    real = torch.profiler.profile

    @contextlib.contextmanager
    def emptied(*args, **kw):
        with real(*args, **kw):
            yield _NoEvents()

    torch.profiler.profile = emptied
    try:
        cs.profile_cell(torch, "matmul emptied", calls)
    finally:
        torch.profiler.profile = real
    assert cs.PROFILE_EMPTY == ["matmul emptied"], cs.PROFILE_EMPTY
    print("fallback ok")


if __name__ == "__main__":
    main()
