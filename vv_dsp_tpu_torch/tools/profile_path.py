"""Where the device time of the port's main path goes, on one NVIDIA GPU.

    python -m vv_dsp_tpu_torch.tools.profile_path [--calls 20]

Runs NorthStarChain on (16, 479232) at its default tiers and at f32,
STFT(1024, 256).process(x, rfft=False) on (16, 480000), SpectralGate() and
the STFT 1024/256 roundtrip (process(x, rfft=True) -> reconstruct) on
(16, 479232), each ``calls`` times back to back under torch.profiler. For
each it prints, per call:

- wall: host time of the loop, synchronized at its end;
- busy: the union of the trace's kernel, memcpy and memset intervals, so
  nested annotation ranges are not counted twice;
- idle: the device's idle share, 1 - busy / wall;
- each kernel's device time and launch count.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(fn, calls: int):
    """(wall seconds, device events of the chrome trace) of `calls` calls of
    fn, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall, [e for e in events if e.get("cat") in DEVICE_CATS]


def busy_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals (us)."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def report(name: str, fn, calls: int) -> None:
    wall, events = device_events(fn, calls)
    wall_ms = wall * 1e3 / calls
    busy_ms = busy_us(events) / 1e3 / calls
    print(f"== {name}: wall {wall_ms:.4f} ms/call, device busy "
          f"{busy_ms:.4f} ms/call, idle share {1 - busy_ms / wall_ms:.4f}")
    per = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        per[e["name"]][0] += e["dur"]
        per[e["name"]][1] += 1
    for kname, (dur, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"  {dur / 1e3 / calls:9.4f} ms/call  x{n / calls:g}  "
              f"{kname[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: no CUDA device")
    from vv_dsp_tpu_torch.models import NorthStarChain, SpectralGate
    from vv_dsp_tpu_torch.ops.stft import STFT

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.standard_normal((16, 479232)),
                         dtype=torch.float32, device=dev)
    xs = torch.as_tensor(rng.standard_normal((16, 480000)),
                         dtype=torch.float32, device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    chain = NorthStarChain(device=dev)
    chain_f32 = NorthStarChain(head_algorithm="f32", stft_algorithm="f32",
                               device=dev)
    plan = STFT(1024, 256)
    gate = SpectralGate(device=dev)
    n = xc.shape[-1]
    report("chain [bf16x3]", lambda: chain(xc), args.calls)
    report("chain [f32]", lambda: chain_f32(xc), args.calls)
    report("stft 1024/256", lambda: plan.process(xs, rfft=False), args.calls)
    report("SpectralGate 1024/256", lambda: gate(xc), args.calls)
    report("roundtrip 1024/256", lambda: plan.reconstruct(
        plan.process(xc, rfft=True), n, rfft=True), args.calls)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
