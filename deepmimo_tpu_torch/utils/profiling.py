"""Profiling and tracing: stage timers, ``torch.profiler`` traces, and a
roofline helper for the channel renderer on the card.

Counterpart of ``deepmimo_tpu/utils/profiling.py``, with the same names:
``StageTimer`` ends each stage with ``torch.cuda.synchronize()`` (once CUDA
is initialised in the process), ``xla_trace`` writes a TensorBoard-readable
``torch.profiler`` trace of host and CUDA activity, ``annotate`` is a named
range in it (``torch.profiler.record_function``), and
``renderer_roofline`` defaults to the H100's peaks.

``annotate`` records only while a ``torch.profiler`` runs (``xla_trace``,
or any other profiler), into the same trace and on the same clock as the
CUDA kernels and copies; otherwise it is one shared null context: no
allocation, no torch op, no device sync. The port marks its own layer
boundaries with it, under the name ``span``:

- ``dm.entry``: ``Dataset.compute_channels`` / ``compute_beam_gains``
  from entry to the render call (validation, ``to_config``, the cached
  path data, the codebook);
- ``dm.h2d``: one host-to-device upload (a small tensor, a whole
  ``PathData``, or one of a dual-polar dataset's two polarization
  stacks);
- ``dm.prologue``: the fused kernels' per-path inputs: one launch of the
  prologue kernel (``ops/kernels/prologue.py``, counted in its
  ``LAUNCHES``), or the ~100 small ops enqueued before a launch where its
  route keeps them (angle space, Doppler, float64, the CPU, autograd;
  counted in its ``FALLBACKS``);
- ``dm.polar``: inside ``dm.prologue`` of a dual-polar render or beam
  gain, the per-polarization part (the power and phase stacks trimmed and,
  in the kernel, laid pol-major on the render's slot axis; as ops, made
  linear, masked and laid out);
- ``dm.kernel.<name>``: the host side of one launch of a hand-written
  kernel (``render_fwd``, ``render_bwd``, ``beam_gain``, ``pathsum``,
  ``prologue``);
- ``dm.d2h``: the copy of a result from a card to the host, its wait for
  the device included (streamed: each block's copy enqueued, and the wait
  for it);
- ``dm.unpack``: the host unpack of planes or gains into numpy;
- ``dm.calib.forward`` (with ``dm.calib.loss`` inside it),
  ``dm.calib.backward``, ``dm.calib.update``: a calibration step's stages.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

# H100 SXM: HBM3 peak, and f32-grade products on the tensor cores (3 TF32
# passes at 495 TFLOP/s: hi*hi + hi*lo + lo*hi), the rule of the render
# kernels.
H100_HBM_GBPS = 3350.0
H100_F32_GRADE_TFLOPS = 495.0 / 3


@dataclass
class StageTimer:
    """Hierarchical wall-clock stage timer with device sync.

    Usage::

        timer = StageTimer()
        with timer.stage("load"):
            ...
        with timer.stage("render"):
            h = ds.compute_channels(params, to_device=True)
        timer.report()

    With ``sync`` (the default) a stage ends with
    ``torch.cuda.synchronize()`` when CUDA has been initialised in the
    process, so it times the device work it launched; a process that never
    initialised CUDA has none pending.
    """

    sync: bool = True
    records: List = field(default_factory=list)
    _stack: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            try:
                if self.sync and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            finally:
                self.records.append((full, time.perf_counter() - t0))
                self._stack.pop()

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self, printer=print) -> None:
        printer("Stage timings:")
        for name, total in sorted(self.totals().items()):
            depth = name.count("/")
            printer(f"  {'  ' * depth}{name.split('/')[-1]:30s} "
                    f"{total * 1e3:10.2f} ms")


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Trace the block's host and CUDA activity with ``torch.profiler``
    into ``logdir`` as a TensorBoard-readable ``*.pt.trace.json`` (the name
    is the JAX package's, so user code ports unchanged)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


_NO_RANGE = contextlib.nullcontext()


def annotate(name: str):
    """Named range visible in ``xla_trace`` traces: ``record_function``
    while a profiler records (``torch.autograd._profiler_enabled()``), else
    one shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


#: The port's name for :func:`annotate` at its own layer boundaries.
span = annotate


def renderer_roofline(n_ue: int, n_rx_ant: int, n_tx_ant: int, n_sc: int,
                      n_paths: int, n_time: int = 1,
                      hbm_gbps: float = H100_HBM_GBPS,
                      mxu_tflops: float = H100_F32_GRADE_TFLOPS
                      ) -> Dict[str, float]:
    """Speed-of-light accounting for the channel renderer on one card.

    Returns flops, bytes, arithmetic intensity, and the compute/memory
    bound times (seconds). Complex multiply-add = 8 real flops; H output
    = complex64 (8 bytes per value), inputs 7 float32 per path.
    ``mxu_tflops`` is the product rate at f32 grade.
    """
    q = n_rx_ant * n_tx_ant
    flops = 8.0 * n_ue * q * n_paths * n_sc * n_time
    h_bytes = 8.0 * n_ue * q * n_sc * n_time
    in_bytes = 4.0 * n_ue * n_paths * 7
    bytes_total = h_bytes + in_bytes
    t_mem = bytes_total / (hbm_gbps * 1e9)
    t_flop = flops / (mxu_tflops * 1e12)
    return {
        "flops": flops,
        "bytes": bytes_total,
        "intensity_flops_per_byte": flops / bytes_total,
        "t_memory_bound_s": t_mem,
        "t_compute_bound_s": t_flop,
        "t_speed_of_light_s": max(t_mem, t_flop),
        "users_per_s_sol": n_ue / max(t_mem, t_flop),
    }
