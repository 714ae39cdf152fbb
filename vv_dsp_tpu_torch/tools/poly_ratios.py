"""Time the per-phase polyphase kernel at chip_smoke.py's five ratios, for
this checkout or another, on one NVIDIA GPU.

    python vv_dsp_tpu_torch/tools/poly_ratios.py [--tree DIR]

For 4/3, 2/1, 1/2, 3/4 and 7/5 on (16, 479232 cut to a multiple of down),
N(0, 1) from seed 0: resample_poly_kernel's time (CUDA events, the median
of 10 runs of back-to-back calls of about 2 ms over their count, after two
warm-up calls, as chip_smoke.py's cuda_ms), the kernel's own device time
(torch.profiler over 20 calls: the poly_kernel events' mean duration
over those the trace holds; where the call's time exceeds it, the host's time to make
a call holds the back-to-back runs), the host's time to make a call (50
calls, not synchronized) and its error against float64
scipy.signal.resample_poly, as a fraction of max |y|. --tree DIR imports
vv_dsp_tpu_torch from DIR (a `git archive` of another commit, say), so
that two trees can be timed in turns on one card; run as a file, not
with -m, so that this checkout's package is not imported first. Prints
one line a ratio, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

RATIOS = ((4, 3), (2, 1), (1, 2), (3, 4), (7, 5))


def cuda_ms(torch, fn, reps: int = 10) -> float:
    def run(calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for _ in range(2):
        fn()
    once = run(1)
    calls = 1 if once >= 0.2 else min(200, math.ceil(2.0 / once))
    return statistics.median(run(calls) for _ in range(reps))


def device_ms(torch, fn, calls: int = 20) -> float:
    """The poly_kernel events' device time per call under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # over the events the trace holds, which may miss some of the calls
    ev = [e for e in prof.key_averages() if "poly_kernel" in e.key]
    n = sum(e.count for e in ev)
    return sum(e.device_time_total for e in ev) / 1e3 / n if n else math.nan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    from scipy import signal as ss
    if not torch.cuda.is_available():
        raise SystemExit("poly_ratios: no CUDA device")
    import vv_dsp_tpu_torch
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    tree = Path(vv_dsp_tpu_torch.__file__).resolve().parents[1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    x = np.random.default_rng(0).standard_normal((16, 479232))
    dev = torch.device("cuda", 0)
    label = tree.name
    for up, down in RATIOS:
        x64 = x[:, :x.shape[1] // down * down]
        xv = torch.as_tensor(x64, dtype=torch.float32, device=dev)
        got = fk.resample_poly_kernel(xv, up, down).double().cpu().numpy()
        want = ss.resample_poly(x64.astype(np.float32).astype(np.float64),
                                up, down, axis=-1)
        rel = np.abs(got - want).max() / np.abs(want).max()
        call = lambda: fk.resample_poly_kernel(xv, up, down)
        ms, dev_ms = cuda_ms(torch, call), device_ms(torch, call)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        host_ms = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        print(f"poly_ratios [{label}] {up}/{down} {tuple(xv.shape)}: "
              f"{ms:.4f} ms a call, kernel {dev_ms:.4f} ms (profiler), "
              f"host {host_ms:.4f} ms to make a call, {rel:.3e} of max|y| "
              f"from float64 scipy")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
