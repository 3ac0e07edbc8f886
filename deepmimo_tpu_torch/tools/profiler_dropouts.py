"""How often does a torch.profiler cycle see no device time, before and
after an xla_trace (as in chip_smoke phase 5i) in the process?

Run on a CUDA card from the repository root:

    python3 deepmimo_tpu_torch/tools/profiler_dropouts.py

Profiles the dual-polar channels and beam gains of chip_smoke's phase 5f
at the headline width, 25 cycles each (as ``chip_smoke.profile_cell``
does), before any ``xla_trace``, after one, and after two, and prints
the count of cycles that recorded no device event.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

import chip_smoke as cs  # noqa: E402
import deepmimo_tpu_torch as dmt  # noqa: E402
from deepmimo_tpu_torch.utils.profiling import annotate, xla_trace  # noqa


def n_spans(calls):
    """Device events of the active cycle of one ``profile_cell``-style
    profile of ``calls``."""
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for call in calls:
                call()
            torch.cuda.synchronize()
            prof.step()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA"
               and e.time_range.end > e.time_range.start)


def main():
    d = cs.make_data(cs.CHUNK, cs.MAX_PATHS, seed=7)
    d.update(cs.make_pol_data(d))
    d["rx_pos"] = np.zeros((cs.CHUNK, 3), np.float32)
    d["tx_pos"] = np.zeros((1, 3), np.float32)
    ds = dmt.Dataset(d)
    params = cs.make_params(dmt)
    params[dmt.consts.PARAMSET_POLAR_EN] = 1
    w = cs.codebook(cs.BG_BEAMS, 64, seed=76)
    h = ds.compute_channels(params, to_device=True)
    g = ds.compute_beam_gains(params, codebook=w, to_device=True)
    ch = [lambda: ds.compute_channels(params, to_device=True, out=h)]
    bg = [lambda: ds.compute_beam_gains(params, codebook=w,
                                        to_device=True, out=g)]
    single = cs.make_params(dmt)
    sds = dmt.Dataset({k: d[k] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el",
        "rx_pos", "tx_pos")})
    hs = sds.compute_channels(single, to_device=True)
    torch.cuda.synchronize()

    def rounds(tag, n):
        empty = {"ch": 0, "bg": 0}
        for _ in range(n):
            for name, calls in (("ch", ch), ("bg", bg)):
                if n_spans(calls) == 0:
                    empty[name] += 1
        print(f"[exp] {tag}: empty cycles of {n}: {empty}", flush=True)

    t0 = time.time()
    rounds("A before any xla_trace", 25)
    tdir = tempfile.mkdtemp()
    with xla_trace(tdir):
        with annotate("dm.serve"):
            sds.compute_channels(single, to_device=True, out=hs)
            torch.cuda.synchronize()
    print("[exp] trace files", os.listdir(tdir), flush=True)
    rounds("B after one xla_trace", 25)
    with xla_trace(tempfile.mkdtemp()):
        sds.compute_channels(single, to_device=True, out=hs)
        torch.cuda.synchronize()
    rounds("C after two xla_traces", 25)
    print("[exp] seconds", time.time() - t0, flush=True)


if __name__ == "__main__":
    main()
