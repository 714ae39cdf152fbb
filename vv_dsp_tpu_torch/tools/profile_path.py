"""Where the device time of the port's main path goes, on one NVIDIA GPU.

    python -m vv_dsp_tpu_torch.tools.profile_path [--calls 20]

Runs NorthStarChain on (16, 479232) at its default tiers and at f32,
STFT(1024, 256).process(x, rfft=False) on (16, 480000), SpectralGate() and
the STFT 1024/256 roundtrip (process(x, rfft=True) -> reconstruct) on
(16, 479232), STFT(1024, 256).power on (16, 480000) (the packed power
kernel), and the full-nfft paths: STFT(128, 32).power,
MFCCFrontend(128, 32, 26 mels, 13 MFCCs, 8 kHz) and SpectralGate(128, 32)
on (16, 479232) and STFT(512, 8).process on (16, 480000), two- and
one-sided,
and the staged NorthStarChain(fused_head=False), fir_apply_best at 16
taps and resample_poly_kernel (the per-phase kernel) at 4/3 and 3/4 on
(16, 479232), and the last three kernels' paths: stft_power_dft
at 1024/256 on (16, 480000), the STFT 128/32 roundtrip on (16, 479232),
and istft_stockham and stft_gate_packed at 1024/256 on the COLA-padded
(16, 480768) input (the inverse of its one-sided spectrum), and
STFT(1024, 256).spectrogram on (16, 480000), and the analysis and
streaming tier, which launches none of the port's kernels: iir_apply of a
4th-order Butterworth (the block state-space path) and the Hilbert
envelope on (16, 479232), each ``calls`` times back to back under
torch.profiler, and StreamingNorthStar over (16, 491520) in blocks of
1,536 and 24,576 samples, twice each, and on 8 shards of one card (a 1x8
mesh) the sharded chain with fused and with staged halos, the sharded
SpectralGate, IIR, FIR at 1,024 taps and resampler at 4/3 on
(16, 479232), five times each. For each it prints, per call:

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
    from vv_dsp_tpu_torch.models import (MFCCFrontend, NorthStarChain,
                                         SpectralGate)
    from vv_dsp_tpu_torch.ops.filter_kernels import (fir_apply_best,
                                                     resample_poly_kernel)
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
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
    report("power 1024/256", lambda: plan.power(xs), args.calls)
    small, dense = STFT(128, 32), STFT(512, 8)
    front = MFCCFrontend(128, 32, 26, 13, 8000.0, device=dev)
    gate128 = SpectralGate(128, 32, device=dev)
    report("power 128/32", lambda: small.power(xc), args.calls)
    report("MFCCFrontend 128/32", lambda: front(xc), args.calls)
    report("SpectralGate 128/32", lambda: gate128(xc), args.calls)
    report("stft 512/8", lambda: dense.process(xs, rfft=False), args.calls)
    report("stft 512/8 one-sided", lambda: dense.process(xs, rfft=True),
           args.calls)
    staged = NorthStarChain(fused_head=False, device=dev)
    h16 = design_lowpass_np(16, 0.3)
    report("chain, staged head", lambda: staged(xc), args.calls)
    report("fir_apply_best 16 taps", lambda: fir_apply_best(h16, xc),
           args.calls)
    for up, down in ((4, 3), (3, 4)):
        report(f"resample_poly_kernel {up}/{down}",
               lambda: resample_poly_kernel(xc, up, down), args.calls)
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.window import get_window_np
    report("stft_power_dft 1024/256", lambda: sk.stft_power_dft(
        xs, 1024, 256), args.calls)
    report("roundtrip 128/32", lambda: small.reconstruct(
        small.process(xc, rfft=True), n, rfft=True), args.calls)
    xp = torch.nn.functional.pad(xc, (768, 768))
    win, w64 = plan.win(dev), get_window_np("hann", 1024)
    half = plan.process(xp, rfft=True)
    norm = ik.ola_norm(w64, 256, half.shape[1], xp.shape[1], dev)
    report("istft_stockham 1024/256", lambda: stk.istft_stockham(
        half, 1024, 256, xp.shape[1], win, norm, rfft=True), args.calls)
    periodic = ik.periodic_norm(w64, 256, xp.shape[1], dev)
    report("stft_gate_packed 1024/256", lambda: ik.stft_gate_packed(
        xp, 1024, 256, 0.1, win, periodic), args.calls)
    report("spectrogram 1024/256", lambda: plan.spectrogram(xs), args.calls)
    from vv_dsp_tpu_torch.models import StreamingNorthStar
    from vv_dsp_tpu_torch.ops import hilbert, iir
    sos = iir.butter_sos(4, 0.2)
    report("iir_butter4 (block state-space path)",
           lambda: iir.iir_apply(sos, xc), args.calls)
    report("hilbert_envelope", lambda: hilbert.envelope(xc), args.calls)
    stream = StreamingNorthStar()
    xst = torch.as_tensor(rng.standard_normal((16, 491520)),
                          dtype=torch.float32, device=dev)
    for block in (1536, 24576):
        report(f"streaming_north_star_block{block}, a call of "
               f"{491520 // block} blocks", lambda: stream.process_blocks(
                   stream.init((16,), device=dev), xst, block), 2)
    from vv_dsp_tpu_torch import parallel as par
    mesh = par.make_mesh(1, 8, devices=[dev] * 8)
    h1024 = design_lowpass_np(1024, 0.3)
    for name, fn in (
            ("chain", lambda: chain.apply_sharded(xc, mesh)),
            ("chain, staged halos",
             lambda: chain.apply_sharded(xc, mesh, fuse_halos=False)),
            ("SpectralGate", lambda: gate.apply_sharded(xc, mesh)),
            ("iir_butter4", lambda: par.iir_apply_sharded(sos, xc, mesh)),
            ("fir 1024 taps", lambda: par.fir_apply_sharded(h1024, xc,
                                                            mesh)),
            ("resample_poly 4/3",
             lambda: par.resample_poly_sharded(xc, 4, 3, mesh))):
        report(f"sharded {name}, 1x8 shards on one card", fn, 5)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
