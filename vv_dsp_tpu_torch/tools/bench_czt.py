"""CZT micro-bench (counterpart of vv_dsp_tpu/tools/bench_czt.py, parity
with tools/bench_czt.c): ``bench_czt [N [M [iters]]] [--cpu]``, prints the
average ms of one call and the peak output bin of a bin-centered tone.

On the card the iterations are timed with CUDA events after one warm-up
call (device time); on the CPU with ``time.perf_counter``."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from vv_dsp_tpu_torch.ops import czt as czt_mod
from vv_dsp_tpu_torch.tools import _cli


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if len(argv) > 0 else 1024
    m = int(argv[1]) if len(argv) > 1 else 1024
    iters = int(argv[2]) if len(argv) > 2 else 10
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    t = np.arange(n, dtype=np.float64)
    x = torch.as_tensor(np.sin(2 * math.pi * 37.0 * t / n),
                        dtype=torch.float32, device=dev)
    w = complex(math.cos(-2 * math.pi / m), math.sin(-2 * math.pi / m))

    def fn():
        return czt_mod.czt(x, m, w, 1.0 + 0.0j)

    out = fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        avg_ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        avg_ms = (time.perf_counter() - t0) / iters * 1e3
    print("CZT bench: N=%d M=%d iters=%d avg=%.3f ms" % (n, m, iters, avg_ms))
    mag = np.abs(_cli.host(out))
    print("Peak bin: %d" % int(np.argmax(mag)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
