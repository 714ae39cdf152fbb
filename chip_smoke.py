"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from vv_dsp_tpu_torch/csrc,
   failing if ptxas spills in any instance of the two tensor-core kernels
   (csrc/upfirdn.cu, csrc/dft_power.cu);
3. kernels: each kernel of the path against its plain PyTorch version on
   the card, at the shapes the main path gives it (the MFCC kernel at the
   chain's and at MFCCFrontend's geometry), within its tolerance,
   with CUDA-event times of both, of one PyTorch library call computing
   the same function where there is one, and the bound reckoned from the
   shapes. The full-nfft kernels are held the same way at the shapes
   their entry points give them (power, mel/MFCC and the fused gate at
   128/32 on (16, 479232), the spectrum at 512/8 on (16, 480000), with the
   packed spectrum kernel timed on that input), and at one geometry of
   the other kind each on 2 channels (1024/8 for power, mel and gate;
   128/32 and 2048/16 for the spectrum). The two spectrum kernels share
   the register-resident FFT of csrc/fft_reg.cuh: the packed one is also
   held at the ends of its range on 2 channels (256/64, 4096/1024), and
   each main-path row of the two prints kernel, torch.stft and bound ms,
   the bound's share and the registers ptxas gave the kernel (build.log).
   The two tensor-core kernels print the same row (kernel and bound ms,
   the bound's share, ptxas's figures): the banded upfirdn at each tier at
   the chain head, each against its own tier's bound (f32 the lesser of
   its float32 FMAs on the CUDA cores and its six bf16 products), and the
   windowed-DFT power with its byte bound, the product form's floor (six
   bf16 products at 989 TFLOP/s) and the rate its products ran at.
   On 2 channels the upfirdn also takes the layouts the chain head does
   not: the fused head at 8/7 (B's slice in column blocks), 16,384 taps
   (B streamed in depth chunks) and 1/1000 (A's rows copied).
   The direct FIR at 16 taps and the per-phase
   resampler at 4/3 on (16, 479232), with the banded upfirdn kernel timed
   beside the resampler, then on 2 channels at taps 1, 7, 129, n < taps
   and ratios 2/1, 1/2, 3/4, 7/5. The windowed-DFT power at 1024/256 on
   (16, 480000), with the packed power kernel timed beside it, then on 2
   channels at 2048/512, 1024/1024, n < nfft, 384/128, 640/128, 1536/512
   and 4096/128; the full-nfft inverse at
   1024/256 on the COLA-padded input's (16, 1876, 513) one-sided spectrum
   (the packed inverse timed beside it), on a non-Hermitian (16, 1876,
   1024) spectrum with all bins inverted, and at 128/32 on (16, 14974,
   65); the packed fused gate at 1024/256 on the COLA-padded (16, 480768)
   input at threshold 0, on the tone probe and at the gate's threshold
   (SpectralGate's split pair timed beside it). Then tier probes, inputs
   on which a kernel must match the plain version at its own tier and land
   beyond the limit against another tier (the controls);
4. slice: through the public entry points, each with every launch counter
   zeroed just before it and read just after, NorthStarChain on
   (16, 479232), STFT(1024, 256).process on (16, 480000), SpectralGate() on
   (16, 479232), the natural-order and the packed STFT 1024/256 roundtrips
   on (16, 479232), STFT(1024, 256).power on (16, 480000),
   MFCCFrontend() on (16, 479232), then the full-nfft paths:
   STFT(128, 32).power, MFCCFrontend(128, 32, 26 mels, 13 MFCCs, 8 kHz)
   and SpectralGate(128, 32) on (16, 479232), and STFT(512, 8).process
   two- and one-sided on (16, 480000); then the filter and resample entry
   points on (16, 479232): NorthStarChain(fused_head=False),
   fir_apply_best at 16, 64, 256 and 1024 taps, resample_poly_best at 2/1,
   1/2, 4/3 and 160/147, resample_multistage at 160/147 and
   resample_poly_kernel at 4/3; then stft_power_dft at 1024/256 on
   (16, 480000), the STFT 128/32 roundtrip on (16, 479232), istft_stockham
   at 1024/256 in both forms and stft_gate_packed at 1024/256 on the
   COLA-padded input, and STFT(1024, 256).spectrogram on (16, 480000);
   each path's launch counts equal to the
   kernels it must run, output shapes, finite values, float64 numpy/scipy
   oracles on 2 channels (SpectralGate on a probe input whose every bin
   lies far from the threshold, and the packed fused gate on the same
   probe), the staged chain against the fused one, the roundtrips and
   both inverses against their input; then the throughput of each row.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing neither, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHANNELS = 16
N_CHAIN = 479232
N_STFT = 480000
NFFT, HOP = 1024, 256          # the STFT row, the roundtrips and the gate
GATE_T = 0.1                   # SpectralGate's default threshold
REPS = 10
BATCH_BELOW_MS = 0.2
# H100 SXM peaks (NVIDIA's data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# Limits, as fractions of the plain version's max |value| unless named
# otherwise; PERF.md gives the readings each was set from.
UPFIRDN_TOL = 1e-5      # same products, another float32 summation order
# float32 FFT noise in the log of low-energy mel bands: at f32 the plain
# version (cuFFT) sits 8.5e-4 and the kernel 4.1e-4 from a float64 oracle
# on this input, so the two differ by up to ~1.2e-3 (2.4e-6 of scale)
MFCC_TOL = 5e-6
SPECTRUM_TOL = 5e-5     # the FFT-class parity contract
POWER_TOL = 5e-5        # the FFT-class parity contract, of max power
# of max|y| on samples more than nfft from either end, and of the plain
# version's max |y * norm| before the norm (tests/test_pallas_fft.py's pin)
ISTFT_TOL = 5e-6
UPFIRDN_PROBE_TOL = 2.5e-7
MFCC_PROBE_TOL = 2.5e-6  # of sum_b |dct[q, b]| (|log mel_b| + 1)
ORACLE_TOL = 5e-5       # the reference's parity contract, of max |value|
ROUNDTRIP_TOL = 3e-5    # absolute, tests/test_pallas_fft.py's identity pin
# the full-nfft kernels: 5e-5 (the FFT-class contract) for the spectrum,
# power and mel energies, MFCC_TOL for MFCCs, and for the fused gate 5e-6 of
# scale on the samples SpectralGate keeps, at threshold 0 on dense input and
# at GATE_T on the tone probe (ISTFT_TOL's pin)
STOCKHAM_TOL = 5e-5
GATE_TOL = 5e-6
# a fused gate on dense input at GATE_T: a bin within float32 noise of the
# threshold may flip between the kernel's FFT and the plain version's, and
# one flip moves at most one frame's nfft samples; the readings are 0 and 1
# samples (PERF.md), a broken mask or peak moves millions
GATE_FLIPS_FRAMES = 1
SMALL = (128, 32)              # the 128-point frames of the full-nfft paths
DENSE = (512, 8)               # the hop-8 spectrum row
# the filter and resample entry points (benchmarks/run_suite.py's rows):
# design_lowpass(taps, 0.3) filters, resample_poly's ratios on the input cut
# to a multiple of down
FIR_TAPS = (16, 64, 256, 1024)
RATIOS = ((2, 1), (1, 2), (4, 3), (160, 147))
# the direct FIR against fir_apply (cuDNN conv1d): the JAX package's FIR
# tolerance (tests/test_pallas.py:22); the per-phase resampler against
# resample_poly and float64 scipy: 1e-5, over 10x its readings (PERF.md)
FIR_TOL = 2e-5
POLY_TOL = 1e-5
STAGED_TOL = 1e-4       # staged against fused chain (tests/test_models.py)
# the windowed-DFT power against its plain version (tests/test_pallas.py's
# pin), of max power; the full-nfft inverse on samples more than nfft from
# either end (ISTFT_TOL) and on all samples (tests/test_pallas_fft.py's
# pins); the packed fused gate at threshold 0 returns its input to 3e-5
# absolute on the retained samples (tests/test_tpu_hardware.py's pin)
DFT_POWER_TOL = 1e-5
ISTFT_ALL_TOL = 1e-2


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    print(smi)
    return card


def import_port():
    """The port package of this checkout (not an installed copy)."""
    sys.path.insert(0, HERE)
    import vv_dsp_tpu_torch
    pkg = os.path.dirname(os.path.abspath(vv_dsp_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"chip_smoke: vv_dsp_tpu_torch at {pkg} is not "
                         f"this checkout's")
    return vv_dsp_tpu_torch


def build_phase() -> list[str]:
    """Build the kernels; returns build.log's lines (ptxas -v)."""
    from vv_dsp_tpu_torch import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {os.path.relpath(lib_path, HERE)}")
    log = (lib_path.parent / "build.log").read_text().splitlines()
    for line in log:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    spills = tensor_core_spills(log)
    if spills:
        raise SystemExit(f"chip_smoke: tensor-core kernel instances spill: "
                         f"{spills}")
    return log


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of one fn() call on the current stream (CUDA
    events), after two warm-up calls. A call shorter than BATCH_BELOW_MS
    is timed as a run of back-to-back calls of about 2 ms over their
    count, so that the host's time to launch it is not read as device
    time."""
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
    calls = 1 if once >= BATCH_BELOW_MS else min(200, math.ceil(2.0 / once))
    return statistics.median(run(calls) for _ in range(reps))


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that as a fraction of max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / want.abs().max().item()


def bound(nbytes: float, flops: float, flop_rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": float(max(t_bytes, t_ops)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_of(log: list[str], tag: str) -> dict:
    """Registers, spill stores and static shared memory of the entry
    function whose mangled name contains tag, as build.log (nvcc -Xptxas
    -v) gives them; {} if there is none."""
    found, got = False, {}
    for line in log:
        if "Compiling entry function" in line:
            if found:
                break
            found = tag in line
        elif found:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill stores", r"(\d+) bytes spill stores"),
                             ("static smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    got[key] = int(m.group(1))
    return got if found else {}


def usage_text(log: list[str], tag: str) -> str:
    got = ptxas_of(log, tag)
    if not got:
        return f"{tag}: not in build.log"
    return (f"{got.get('registers')} registers, "
            f"{got.get('spill stores')} bytes spill stores, "
            f"{got.get('static smem', 0)} bytes static shared memory")


def ptxas_usage(log: list[str], kernel: str, n: int, onesided: bool) -> str:
    """ptxas's figures of one instance of a spectrum kernel template
    <N, ONESIDED>."""
    return usage_text(log, f"{kernel}ILi{n}ELb{int(onesided)}E")


def tensor_core_spills(log: list[str]) -> list[str]:
    """Instances of the two tensor-core kernels (csrc/upfirdn.cu,
    csrc/dft_power.cu) that spill, by mangled name."""
    spills, name = [], None
    for line in log:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("upfirdn_mma_kernel" in name
                       or "dft_power_kernel" in name):
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                spills.append(name)
    return spills


def redesign_line(name, label, r, log, kernel, n, onesided, smem) -> None:
    """The redesigned spectrum kernels' row: kernel, torch.stft and bound
    ms, the bound's share of the kernel time, and what ptxas gave it."""
    print(f"  redesign {name} [{label}]: kernel {r['ms']:.4f} ms, torch.stft "
          f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of the "
          f"bound {r['bound_ms'] / r['ms']:.3f}; build.log: "
          f"{ptxas_usage(log, kernel, n, onesided)}; dynamic shared memory "
          f"{smem} bytes a block (the launcher's request)")


def upfirdn_instance(up, down, taps_pp, offset, tier) -> tuple[str, int]:
    """The csrc/upfirdn.cu instance <ALG, NT, MT, FLUSH> a launch runs, as
    its mangled-name tag, and its dynamic shared memory: the host plan's
    (ops/mma_plan.py upfirdn_plan), which the launcher follows."""
    from vv_dsp_tpu_torch import config
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    p = mp.upfirdn_plan(up, down, taps_pp, offset, tier)
    tag = (f"upfirdn_mma_kernelILi{config.ALGORITHMS.index(tier)}"
           f"ELi{p.n_tiles}ELi{p.m_tiles}ELb{int(p.flush > 0)}E")
    return tag, p.smem


def mma_line(name, label, ms, bound_ms, bound_by, log, tag, smem) -> None:
    """A tensor-core kernel's row: kernel and bound ms, the bound's share
    of the kernel time, and what ptxas gave the instance."""
    print(f"  tensor cores {name} [{label}]: kernel {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), share of the bound "
          f"{bound_ms / ms:.3f}; build.log: {usage_text(log, tag)}; "
          f"dynamic shared memory {smem} bytes a block")


def fr_smem(n: int, packed: bool) -> int:
    """Dynamic shared memory of a register-resident spectrum block: the
    twiddle table, wk (packed) and two exchange buffers of 2048 points."""
    from vv_dsp_tpu_torch.ops import fft_plan
    return 8 * (fft_plan.pass_offsets(n)[-1] + (n + 1 if packed else 0)
                + 2 * 2048)


def fft_flops(frames: int, nfft: int) -> float:
    """Operations of one real nfft-point FFT per frame (2.5 N log2 N)."""
    return frames * 2.5 * nfft * np.log2(nfft)


def mel_bound(x, out, front) -> dict:
    """The fused STFT -> mel -> log -> DCT front end's bound: the signal
    read and the features written once; per frame a real FFT, the powers,
    the mel products over the filterbank's nonzero weights and the DCT."""
    nfft, n_mels = front.nfft, front.mel_fb.shape[0]
    frames = out.shape[0] * out.shape[1]
    return bound(4 * (x.numel() + out.numel()),
                 fft_flops(frames, nfft) + frames * (
                     3 * (nfft // 2 + 1) + 2 * int((front.mel_fb != 0).sum())
                     + 2 * n_mels * out.shape[2]), F32_FLOP_PER_S)


def impulses(n: int, period: int, first: int, seed: int) -> torch.Tensor:
    """(CHANNELS, n) zeros with N(0, 1) impulses at first + i*period."""
    x = np.zeros((CHANNELS, n), np.float32)
    pos = np.arange(first, n, period)
    x[:, pos] = np.random.default_rng(seed).standard_normal(
        (CHANNELS, len(pos)))
    return torch.as_tensor(x, device="cuda")


def tier_probes(head, mfcc_args, failed: list) -> None:
    """Tier identity, at the main path's shapes. On the dense input the
    tiers' gap is of the size of float32 summation (upfirdn) or FFT (MFCC)
    noise, so it cannot show which tier a kernel computed. These inputs make
    the two versions form the same products at one tier:
    - upfirdn: one impulse per 1500 samples, more than the 1044 taps of a
      phase, so every output is a single product;
    - MFCC: one impulse per 2048 samples, so every 2048-sample frame holds
      one impulse and has a flat power spectrum (no low-energy bins).
    Each same-tier pair must agree within the probe's limit, and each
    control (a kernel tier held against another plain tier) must not."""
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf

    def judge(name, k_tier, p_tier, reading, limit, unit):
        control = k_tier != p_tier
        ok = (reading >= limit) if control else (reading < limit)
        kind = "control" if control else "check"
        print(f"tier probe {name} {kind}: kernel {k_tier} vs plain {p_tier}: "
              f"{reading:.3e} {unit} (limit {limit:g}; "
              f"{'must exceed' if control else 'must stay below'}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} tier probe, kernel {k_tier} vs plain "
                          f"{p_tier}")

    up, down, offset, n_out, taps = head
    xp = impulses(N_CHAIN, 1500, 700, 1)
    pairs = [("f32", "f32"), ("bf16x3", "bf16x3"), ("bf16", "bf16"),
             ("f32", "bf16x3")]
    for k_tier, p_tier in pairs:
        got = uf.upfirdn_banded(xp, taps, up, down, offset, n_out, k_tier)
        want = uf.upfirdn_tall(xp, taps, up, down, offset, n_out, p_tier)
        judge("upfirdn_banded", k_tier, p_tier, rel_err(got, want)[1],
              UPFIRDN_PROBE_TOL, "of max|y|")

    nfft, hop, window, mel_fb, _, dct, log_eps = mfcc_args
    plain_args = (nfft, hop, window, mel_fb, dct, log_eps)
    yp = impulses(n_out, nfft, nfft // 2, 2)
    mel = sk.stft_mfcc_plain(yp, nfft, hop, window, mel_fb, None, log_eps,
                             "f32")
    # each element's scale: sum_b |dct[q, b]| (|log mel_b| + 1)
    scale = (torch.log(mel + log_eps).abs() + 1) @ dct.abs().T
    pairs = [("f32", "f32"), ("bf16x3", "bf16x3"), ("f32", "bf16x3"),
             ("bf16", "f32")]
    for k_tier, p_tier in pairs:
        got = sk.stft_mfcc(yp, *mfcc_args, k_tier)
        want = sk.stft_mfcc_plain(yp, *plain_args, p_tier)
        reading = ((got - want).abs() / scale).max().item()
        judge("stft_mfcc", k_tier, p_tier, reading, MFCC_PROBE_TOL,
              "of the element's scale")


def record(name, label, got, want, tol, fast, plain, failed: list,
           edge: int = 0) -> dict:
    """A kernel against its plain version as a fraction of the plain
    version's max |value| (on samples more than `edge` from either end),
    with both times."""
    if edge:
        got, want = got[..., edge:-edge], want[..., edge:-edge]
    err, rel = rel_err(got, want)
    ok = rel < tol
    ms, plain_ms = cuda_ms(fast), cuda_ms(plain)
    torch.cuda.synchronize()
    where = f" more than {edge} samples from the ends" if edge else ""
    print(f"kernel {name} [{label}]: max_abs_err {err:.3e}, {rel:.3e} of "
          f"scale{where} (tol {tol:g}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"{name} [{label}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(xc, xs, chain, front, front128, log: list[str]) -> dict:
    """Each kernel against its plain version at the main path's shapes
    (the MFCC kernel at the chain's and at MFCCFrontend's geometry)."""
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    from vv_dsp_tpu_torch.ops.stft import STFT

    gcd = np.gcd(chain.up, chain.down)
    up, down = chain.up // gcd, chain.down // gcd
    h = np.asarray(chain.fir_coeffs, np.float64)
    _, offset = rs._fused_fir_resample_filter(tuple(h), up, down)
    n_out = -(-N_CHAIN * up // down)
    taps = chain.head_taps
    results, failed = {}, []

    def tier_gap(name, got, want, p_tier):
        print(f"  dense-input tier gap, not a check: {name} kernel vs plain "
              f"{p_tier}: {rel_err(got, want)[1]:.3e} of scale")

    # each tier's bound: its bf16 products (1, 3 or 6 a tap) at the tensor
    # cores' rate; f32 also as float32 FMAs on the CUDA cores, the lesser
    # of the two bounding it
    c = xc.shape[0]
    io = 4 * (xc.numel() + c * n_out + taps.numel())
    macs = c * n_out * taps.shape[1]
    tier_bounds = {
        "f32": min((bound(io, 2 * macs, F32_FLOP_PER_S),
                    bound(io, 6 * 2 * macs, BF16_FLOP_PER_S)),
                   key=lambda b: b["bound_ms"]),
        "bf16x3": bound(io, 3 * 2 * macs, BF16_FLOP_PER_S),
        "bf16": bound(io, 2 * macs, BF16_FLOP_PER_S)}
    tier_ms = {}
    for tier in ("f32", "bf16x3", "bf16"):
        fast = lambda: uf.upfirdn_banded(xc, taps, up, down, offset, n_out,
                                         tier)
        plain = lambda: uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                        tier)
        got = fast()
        r = record("upfirdn_banded", tier, got, plain(), UPFIRDN_TOL, fast,
                   plain, failed)
        tier_ms[tier] = r["ms"]
        b = tier_bounds[tier]
        mma_line("upfirdn_banded", f"chain head, {tier}", r["ms"],
                 b["bound_ms"], b["bound_by"], log,
                 *upfirdn_instance(up, down, taps.shape[1], offset, tier))
        if tier == "f32":
            tier_gap("upfirdn_banded f32", got,
                     uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                     "bf16x3"), "bf16x3")
        if tier == chain.head_algorithm:
            results["upfirdn_banded"] = r
    results["upfirdn_banded"].update(tier_bounds[chain.head_algorithm])
    results["upfirdn_banded"].update(
        {f"{t}_ms": v for t, v in tier_ms.items()})
    results["upfirdn_banded"].update(
        {f"{t}_bound_ms": b["bound_ms"] for t, b in tier_bounds.items()})
    print("  upfirdn_banded at the chain head: "
          + "; ".join(f"{t} {tier_ms[t]:.4f} ms against a "
                      f"{tier_bounds[t]['bound_ms']:.4f} ms bound"
                      for t in tier_ms)
          + f" (the kernels line carries {chain.head_algorithm}, the "
          f"chain's tier; most launches run f32)")
    results["upfirdn_banded"]["library_ms"] = None
    print("  upfirdn_banded library call: none (no single PyTorch call "
          "computes a polyphase upfirdn; conv1d would need the signal "
          "zero-stuffed first)")
    # the layouts the chain head does not take, on 2 x 48000: B's slice cut
    # into column blocks (the fused head at 8/7), streamed in depth chunks
    # (16,384 taps) and A's rows copied (1/1000); the plain version in
    # frames of 8 where its own would hold a taps_pp-squared matrix
    x2 = xc[:2, :48000].contiguous()
    g87, off87 = rs._fused_fir_resample_filter(tuple(h), 8, 7)
    for label, g, u, d, off, tier, group in (
            ("fused head 8/7", g87, 8, 7, off87, "bf16x3", None),
            ("16384 taps 1/1", design_lowpass_np(16384, 0.3), 1, 1, 0,
             "f32", 8),
            ("21 taps 1/1000", design_lowpass_np(21, 0.0009), 1, 1000, 10,
             "f32", None)):
        tab = uf.polyphase_table(g, u, xc.device)
        n2 = -(-x2.shape[1] * u // d)
        fast = lambda: uf.upfirdn_banded(x2, tab, u, d, off, n2, tier)
        plain = lambda: uf.upfirdn_tall(x2, tab, u, d, off, n2, tier, group)
        p = mp.upfirdn_plan(u, d, tab.shape[1], off, tier)
        record("upfirdn_banded", f"{label}, {tier}, 2 x 48000: "
               f"{p.col_blocks} column blocks, {p.k_pad // p.k_chunk} "
               f"depth chunks, A pitch {p.a_pitch}, flush {p.flush}",
               fast(), plain(), UPFIRDN_TOL, fast, plain, failed)
    y = uf.upfirdn_banded(xc, taps, up, down, offset, n_out, "f32")
    mfcc_args = (chain.nfft, chain.hop, chain.window, chain.mel_fb,
                 chain.mel_bands, chain.dct_lift, 1e-10)
    plain_args = mfcc_args[:4] + mfcc_args[5:]
    for tier in ("f32", "bf16x3"):
        fast = lambda: sk.stft_mfcc(y, *mfcc_args, tier)
        plain = lambda: sk.stft_mfcc_plain(y, *plain_args, tier)
        got = fast()
        r = record("stft_mfcc", tier, got, plain(), MFCC_TOL, fast, plain,
                   failed)
        if tier == "f32":
            tier_gap("stft_mfcc f32", got,
                     sk.stft_mfcc_plain(y, *plain_args, "bf16x3"), "bf16x3")
        if tier == chain.stft_algorithm:
            results["stft_mfcc"] = r
    tier_gap("stft_mfcc bf16", sk.stft_mfcc(y, *mfcc_args, "bf16"),
             sk.stft_mfcc_plain(y, *plain_args, "f32"), "f32")
    results["stft_mfcc"].update(mel_bound(y, got, chain))
    results["stft_mfcc"]["library_ms"] = None
    print("  stft_mfcc library call: none (no single PyTorch call computes "
          "STFT -> mel -> log -> DCT)")
    # MFCCFrontend's geometry (1024/256, 26 mels, 13 MFCCs, f32) on xc
    front_args = (front.nfft, front.hop, front.window, front.mel_fb,
                  front.mel_bands, front.dct_lift, 1e-10, "f32")
    front_plain = front_args[:4] + front_args[5:]
    fast = lambda: sk.stft_mfcc(xc, *front_args)
    plain = lambda: sk.stft_mfcc_plain(xc, *front_plain)
    got = fast()
    r = record("stft_mfcc", "MFCCFrontend f32", got, plain(), MFCC_TOL,
               fast, plain, failed)
    r.update(mel_bound(xc, got, front))
    print(f"  stft_mfcc [MFCCFrontend f32] bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})")
    results["stft_mfcc"].update({f"frontend_{k}": v for k, v in r.items()})

    win = STFT(NFFT, HOP).win(xs.device)
    for onesided in (False, True):
        fast = lambda: sk.stft_spectrum(xs, NFFT, HOP, win, onesided)
        plain = lambda: sk.stft_spectrum_plain(xs, NFFT, HOP, win, onesided)
        got = fast()
        r = record("stft_spectrum", "onesided" if onesided else "two-sided",
                   got, plain(), SPECTRUM_TOL, fast, plain, failed)
        # torch.stft drops the zero-padded tail frame, so it gets the
        # signal padded by hop (outside the timed call); it writes
        # (c, bins, frames)
        xs_pad = torch.nn.functional.pad(xs, (0, HOP))
        lib = lambda: torch.stft(xs_pad, NFFT, HOP, window=win, center=False,
                                 onesided=onesided, return_complex=True)
        assert lib().shape == (c, got.shape[2], got.shape[1])
        r["library_ms"] = cuda_ms(lib)
        r.update(bound(4 * xs.numel() + 8 * got.numel(),
                       fft_flops(c * got.shape[1], NFFT), F32_FLOP_PER_S))
        print(f"  torch.stft (layout c, bins, frames): "
              f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        redesign_line("stft_spectrum", f"{NFFT}/{HOP} "
                      f"{'one' if onesided else 'two'}-sided", r, log,
                      "stft_spectrum_kernel", NFFT // 2, onesided,
                      fr_smem(NFFT // 2, True))
        if not onesided:
            results["stft_spectrum"] = r
        else:
            results["stft_spectrum"].update(
                {f"onesided_{k}": v for k, v in r.items()})
    # the ends of the packed kernel's range, N = 128 and 2048, on 2 channels
    for nfft, hop in ((256, 64), (4096, 1024)):
        w = STFT(nfft, hop).win(xs.device)
        for onesided in (False, True):
            fast = lambda: sk.stft_spectrum(xs[:2], nfft, hop, w, onesided)
            plain = lambda: sk.stft_spectrum_plain(xs[:2], nfft, hop, w,
                                                   onesided)
            record("stft_spectrum", f"{nfft}/{hop} "
                   f"{'one' if onesided else 'two'}-sided, 2 ch", fast(),
                   plain(), SPECTRUM_TOL, fast, plain, failed)

    fast = lambda: sk.stft_power(xs, NFFT, HOP, win)
    plain = lambda: sk.stft_power_plain(xs, NFFT, HOP, win)
    got = fast()
    r = record("stft_power", "f32", got, plain(), POWER_TOL, fast, plain,
               failed)
    r.update(bound(4 * (xs.numel() + got.numel()),
                   fft_flops(c * got.shape[1], NFFT), F32_FLOP_PER_S))
    r["library_ms"] = None
    print("  stft_power library call: none (torch.stft writes the complex "
          "spectrum; the power takes another pass)")
    results["stft_power"] = r

    results.update(istft_phase(xc, win, failed))
    results.update(stockham_phase(xc, xs, front128, failed, log))
    results.update(filter_phase(xc, failed))
    results["stft_power_dft"] = dft_power_phase(xs, win, failed, log)
    results["istft_stockham"] = istft_stockham_phase(xc, win, failed)
    results["stft_gate_packed"] = gate_packed_phase(xc, win, failed)
    tier_probes((up, down, offset, n_out, taps), mfcc_args, failed)
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return results


def istft_phase(xc, win, failed: list) -> dict:
    """The inverse kernel on SpectralGate's shape: the one-sided spectrum
    of the COLA-padded (16, 479232) input, (16, 1876, 513), back to
    (16, 480768) samples; without the gate (STFT.reconstruct) and with it
    (SpectralGate). The plain version is fed the kernel's own forward
    spectrum, so both gate the same bins."""
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops.window import get_window_np

    xp = torch.nn.functional.pad(xc, (NFFT - HOP, NFFT - HOP))
    c, n_pad = xp.shape
    spec = sk.stft_spectrum(xp, NFFT, HOP, win, True)
    nf = spec.shape[1]
    norm = ik.ola_norm(get_window_np("hann", NFFT), HOP, nf, n_pad, xp.device)
    out = {}
    for gate in (None, GATE_T):
        fast = lambda: ik.istft(spec, NFFT, HOP, n_pad, win, norm, gate)
        plain = lambda: ik.istft_plain(spec, NFFT, HOP, n_pad, win, norm, gate)
        got, want = fast(), plain()
        label = "no gate" if gate is None else f"gate {gate:g}"
        pre_rel = rel_err(got * norm, want * norm)[1]
        print(f"  istft [{label}] before the norm, full length: "
              f"{pre_rel:.3e} of scale (tol {ISTFT_TOL:g}) "
              f"{'ok' if pre_rel < ISTFT_TOL else 'FAIL'}")
        if not pre_rel < ISTFT_TOL:
            failed.append(f"istft [{label}] before the norm")
        if not torch.equal(got, fast()):
            failed.append(f"istft [{label}] differs between two runs")
        r = record("istft", label, got, want, ISTFT_TOL, fast, plain, failed,
                   edge=NFFT)
        out["istft" if gate is None else "istft_gated"] = r
        if gate is None:
            ungated = got
    p2 = spec.real * spec.real + spec.imag * spec.imag
    level = GATE_T ** 2 * p2.amax(-1, keepdim=True)
    near = int((((p2 - level).abs() <= 1e-5 * level) & (level > 0)).sum())
    print(f"  dense-input bins within 1e-5 (relative) of the gate's "
          f"threshold (frames of zeros left out): {near} of {p2.numel()}")
    r = out["istft"]
    r["gated_ms"] = out.pop("istft_gated")["ms"]
    r.update(bound(8 * spec.numel() + 4 * (c * n_pad + n_pad),
                   fft_flops(c * nf, NFFT) + c * nf * 2 * NFFT,
                   F32_FLOP_PER_S))
    try:
        lib = lambda: torch.istft(spec.transpose(1, 2), NFFT, HOP, window=win,
                                  center=False, length=n_pad)
        y = lib()
    except RuntimeError as e:
        r["library_ms"] = None
        print(f"  istft library call: none, torch.istft refuses: "
              f"{str(e).splitlines()[0][:200]}")
    else:
        r["library_ms"] = cuda_ms(lib)
        err = rel_err(y[:, NFFT:-NFFT], ungated[:, NFFT:-NFFT])[1]
        print(f"  torch.istft: {r['library_ms']:.4f} ms, {err:.3e} of scale "
              f"from the kernel on the interior")
    print(f"  istft bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def stockham_phase(xc, xs, front128, failed: list, log: list[str]) -> dict:
    """The full-nfft kernels against their plain versions: power, mel/MFCC
    and the fused gate at 128/32 on (16, 479232), the spectrum at 512/8 on
    (16, 480000) (the shapes their entry points give them), and each at one
    geometry of the other kind on 2 channels."""
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.mel import _mel_constants
    from vv_dsp_tpu_torch.ops.stft import STFT

    def io(got, x) -> str:
        return (f"2 ch: {4 * x.numel() / 1e6:.2f} MB in, "
                f"{got.element_size() * got.numel() / 1e6:.2f} MB out")

    out = {}
    c, dev = xc.shape[0], xc.device
    x2 = xs[:2]                  # 2 x 480000 samples, 3.84 MB
    win128, win1024 = STFT(*SMALL).win(dev), STFT(1024, 8).win(dev)

    fast = lambda: stk.stft_power_stockham(xc, *SMALL, win128)
    plain = lambda: stk.stft_power_stockham_plain(xc, *SMALL, win128)
    got = fast()
    r = record("stft_power_stockham", "128/32", got, plain(), STOCKHAM_TOL,
               fast, plain, failed)
    r.update(bound(4 * (xc.numel() + got.numel()),
                   fft_flops(c * got.shape[1], SMALL[0]), F32_FLOP_PER_S))
    r["library_ms"] = None
    print(f"  stft_power_stockham bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); library call: none (torch.stft writes the "
          f"complex spectrum; the power takes another pass)")
    out["stft_power_stockham"] = r
    fast = lambda: stk.stft_power_stockham(x2, 1024, 8, win1024)
    plain = lambda: stk.stft_power_stockham_plain(x2, 1024, 8, win1024)
    got = fast()
    record("stft_power_stockham", f"1024/8, {io(got, x2)}", got, plain(),
           STOCKHAM_TOL, fast, plain, failed)

    mel_args = (front128.window, front128.mel_fb, front128.mel_bands,
                front128.dct_lift)
    fast = lambda: stk.stft_mel_stockham(xc, *SMALL, *mel_args)
    plain = lambda: stk.stft_mel_stockham_plain(
        xc, *SMALL, front128.window, front128.mel_fb, front128.dct_lift)
    got = fast()
    r = record("stft_mel_stockham", "MFCCFrontend 128/32", got, plain(),
               MFCC_TOL, fast, plain, failed)
    r.update(mel_bound(xc, got, front128))
    r["library_ms"] = None
    print(f"  stft_mel_stockham bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); library call: none (no single PyTorch call "
          f"computes STFT -> mel -> log -> DCT)")
    out["stft_mel_stockham"] = r
    w, fb, bands = _mel_constants(1024, 40, 16000.0, 0.0, 8000.0, "htk",
                                  "hann", None, dev)
    fast = lambda: stk.stft_mel_stockham(x2, 1024, 8, w, fb, bands)
    plain = lambda: stk.stft_mel_stockham_plain(x2, 1024, 8, w, fb)
    got = fast()
    record("stft_mel_stockham", f"40 mel energies 1024/8, {io(got, x2)}",
           got, plain(), STOCKHAM_TOL, fast, plain, failed)

    out["stft_gate_stockham"] = gate_phase(xc, x2, failed)

    dense_win = STFT(*DENSE).win(dev)
    for onesided in (False, True):
        label = f"512/8 {'one' if onesided else 'two'}-sided"
        fast = lambda: stk.stft_spectrum_stockham(xs, *DENSE, dense_win,
                                                  onesided)
        plain = lambda: stk.stft_spectrum_stockham_plain(xs, *DENSE,
                                                         dense_win, onesided)
        got = fast()
        r = record("stft_spectrum_stockham", label, got, plain(),
                   STOCKHAM_TOL, fast, plain, failed)
        packed = lambda: sk.stft_spectrum(xs, *DENSE, dense_win, onesided)
        r["packed_ms"] = cuda_ms(packed)
        xs_pad = torch.nn.functional.pad(xs, (0, DENSE[1]))
        lib = lambda: torch.stft(xs_pad, *DENSE, window=dense_win,
                                 center=False, onesided=onesided,
                                 return_complex=True)
        assert lib().shape == (c, got.shape[2], got.shape[1])
        r["library_ms"] = cuda_ms(lib)
        r.update(bound(4 * xs.numel() + 8 * got.numel(),
                       fft_flops(c * got.shape[1], DENSE[0]), F32_FLOP_PER_S))
        faster = ("full-nfft" if r["ms"] < r["packed_ms"] else "packed")
        print(f"  [{label}] packed stft_spectrum kernel {r['packed_ms']:.4f} "
              f"ms ({faster} is faster); torch.stft (layout c, bins, frames) "
              f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        redesign_line("stft_spectrum_stockham", label, r, log,
                      "stockham_spectrum_kernel", DENSE[0], onesided,
                      fr_smem(DENSE[0], False))
        if not onesided:
            out["stft_spectrum_stockham"] = r
        else:
            out["stft_spectrum_stockham"].update(
                {f"onesided_{k}": v for k, v in r.items()})
    win2048 = STFT(2048, 16).win(dev)
    for geo, w in ((SMALL, win128), ((2048, 16), win2048)):
        for onesided in (False, True):
            fast = lambda: stk.stft_spectrum_stockham(x2, *geo, w, onesided)
            plain = lambda: stk.stft_spectrum_stockham_plain(x2, *geo, w,
                                                             onesided)
            got = fast()
            record("stft_spectrum_stockham",
                   f"{geo[0]}/{geo[1]} {'one' if onesided else 'two'}-sided, "
                   f"{io(got, x2)}", got, plain(), STOCKHAM_TOL, fast, plain,
                   failed)
    return out


def gate_phase(xc, x2, failed: list) -> dict:
    """The fused gate kernel on SpectralGate(128, 32)'s padded (16, 479424)
    input: at threshold 0 on the dense input (a pure roundtrip; the run's
    kernel row), at GATE_T on the tone probe, and at GATE_T on the dense
    input, where bins near the threshold may flip between two FFTs (the
    count of differing samples must stay within GATE_FLIPS_FRAMES frames);
    then threshold 0 at 1024/8 (q = 128) on 2 channels."""
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.framing import stft_num_frames
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    def padded(x, nfft, hop):
        pad = nfft - hop
        xp = torch.nn.functional.pad(x, (pad, pad))
        n_pad = xp.shape[-1]
        norm = ik.ola_norm(get_window_np("hann", nfft), hop,
                           stft_num_frames(n_pad, nfft, hop), n_pad, x.device)
        return xp, norm, STFT(nfft, hop).win(x.device), pad

    xp, norm, win, pad = padded(xc, *SMALL)
    probe = torch.as_tensor(gate_probe(N_CHAIN, 3, SMALL[0], (10, 25, 45)),
                            device=xc.device)
    pp, _, _, _ = padded(probe, *SMALL)
    r = None
    for label, x, t, edge in (("128/32, threshold 0", xp, 0.0, pad),
                              ("128/32 tone probe, threshold 0.1", pp, GATE_T,
                               2 * pad)):
        fast = lambda: stk.stft_gate_stockham(x, *SMALL, win, norm, t)
        plain = lambda: stk.stft_gate_stockham_plain(x, *SMALL, win, norm, t)
        got, want = fast(), plain()
        if not torch.equal(got, fast()):
            failed.append(f"stft_gate_stockham [{label}] differs between two "
                          f"runs")
        pre_rel = rel_err(got * norm, want * norm)[1]
        print(f"  stft_gate_stockham [{label}] before the norm, full length: "
              f"{pre_rel:.3e} of scale (tol {GATE_TOL:g}) "
              f"{'ok' if pre_rel < GATE_TOL else 'FAIL'}")
        if not pre_rel < GATE_TOL:
            failed.append(f"stft_gate_stockham [{label}] before the norm")
        rr = record("stft_gate_stockham", label, got, want, GATE_TOL, fast,
                    plain, failed, edge=edge)
        if r is None:
            r = rr
    got = stk.stft_gate_stockham(xp, *SMALL, win, norm, GATE_T)
    want = stk.stft_gate_stockham_plain(xp, *SMALL, win, norm, GATE_T)
    far = ((got - want).abs() > GATE_TOL * want.abs().max()).sum().item()
    flips_ok = far <= GATE_FLIPS_FRAMES * SMALL[0]
    print(f"  stft_gate_stockham dense input at threshold {GATE_T:g}: {far} "
          f"of {got.numel()} samples differ by more than {GATE_TOL:g} of "
          f"scale (bins near the threshold; limit "
          f"{GATE_FLIPS_FRAMES * SMALL[0]}) {'ok' if flips_ok else 'FAIL'}")
    if not flips_ok:
        failed.append("stft_gate_stockham dense input at threshold "
                      f"{GATE_T:g}: {far} samples differ")
    r["gated_ms"] = cuda_ms(lambda: stk.stft_gate_stockham(
        xp, *SMALL, win, norm, GATE_T))
    c, n_pad = xp.shape
    nf = stft_num_frames(n_pad, *SMALL)
    r.update(bound(4 * (2 * xp.numel() + n_pad),
                   2 * fft_flops(c * nf, SMALL[0]) + c * nf * 4 * SMALL[0],
                   F32_FLOP_PER_S))
    r["library_ms"] = None
    print(f"  stft_gate_stockham gated {r['gated_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); library call: none (no "
          f"single PyTorch call computes STFT -> per-frame gate -> ISTFT)")
    xq, norm_q, win_q, pad_q = padded(x2, 1024, 8)
    fast = lambda: stk.stft_gate_stockham(xq, 1024, 8, win_q, norm_q, 0.0)
    plain = lambda: stk.stft_gate_stockham_plain(xq, 1024, 8, win_q, norm_q,
                                                 0.0)
    record("stft_gate_stockham", f"1024/8, threshold 0, 2 ch: "
           f"{4 * xq.numel() / 1e6:.2f} MB each way", fast(), plain(),
           GATE_TOL, fast, plain, failed, edge=pad_q)
    return r


def filter_phase(xc, failed: list) -> dict:
    """The direct FIR and the per-phase resampler against their plain
    versions at the shapes fir_apply_best and resample_poly_kernel give
    them: fir_direct at 16 taps and poly_kernel at 4/3 on (16, 479232), each
    with its library call (F.conv1d; the strided conv1d of the conv-form
    upfirdn plus its transpose), cuDNN's TF32 off, and the banded upfirdn
    kernel timed beside poly_kernel on the same input; then 2-channel checks
    at other taps, n < taps and other ratios."""
    import torch.nn.functional as F
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np

    assert not torch.backends.cudnn.allow_tf32, "cuDNN TF32 must be off"
    c, n = xc.shape
    dev = xc.device
    out = {}
    taps = FIR_TAPS[0]
    h = design_lowpass_np(taps, 0.3)
    fast = lambda: fk.fir_direct(h, xc)
    plain = lambda: fk.fir_direct_plain(h, xc)
    got = fast()
    if not torch.equal(got, fast()):
        failed.append("fir_direct differs between two runs")
    r = record("fir_direct", f"{taps} taps", got, plain(), FIR_TOL, fast,
               plain, failed)
    w = torch.as_tensor(h[::-1].copy(), dtype=torch.float32,
                        device=dev).reshape(1, 1, taps)
    xpad = F.pad(xc[:, None], (taps - 1, 0))
    lib = lambda: F.conv1d(xpad, w)
    lib_err = rel_err(lib()[:, 0], got)[1]
    r["library_ms"] = cuda_ms(lib)
    r.update(bound(4 * (2 * xc.numel() + taps), 2 * xc.numel() * taps,
                   F32_FLOP_PER_S))
    print(f"  F.conv1d (cuDNN, TF32 off) on the left-padded input: "
          f"{r['library_ms']:.4f} ms, {lib_err:.3e} of scale from the "
          f"kernel; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    out["fir_direct"] = r

    up, down = 4, 3
    hr = rs._resample_poly_filter(up, down)
    off, n_out = (len(hr) - 1) // 2, -(-n * up // down)
    table = uf.polyphase_table(hr, up, dev)
    fast = lambda: fk.resample_poly_kernel(xc, up, down)
    plain = lambda: fk.resample_poly_plain(xc, up, down)
    got = fast()
    if not torch.equal(got, fast()):
        failed.append("poly_kernel differs between two runs")
    r = record("poly_kernel", f"{up}/{down}", got, plain(), POLY_TOL, fast,
               plain, failed)
    banded = lambda: uf.upfirdn_banded(xc, table, up, down, off, n_out,
                                       "f32")
    banded_err = rel_err(banded(), got)[1]
    r["banded_ms"] = cuda_ms(banded)
    wc, c_lo = rs._upfirdn_conv_plan(tuple(hr), up, down, off)
    frames = -(-n_out // up)
    pad_l = max(0, -c_lo)
    pad_r = max(0, (frames - 1) * down + c_lo + wc.shape[1] - n)
    xb = F.pad(xc[:, None], (pad_l, pad_r))[..., c_lo + pad_l:].contiguous()
    wt = torch.as_tensor(wc, dtype=torch.float32, device=dev)[:, None]
    lib = lambda: F.conv1d(xb, wt, stride=down)[..., :frames].transpose(
        1, 2).reshape(c, frames * up)
    lib_err = rel_err(lib()[:, :n_out], got)[1]
    r["library_ms"] = cuda_ms(lib)
    r.update(bound(4 * (xc.numel() + c * n_out + table.numel()),
                   2 * c * n_out * table.shape[1], F32_FLOP_PER_S))
    faster = "poly_kernel" if r["ms"] < r["banded_ms"] else "upfirdn_banded"
    print(f"  upfirdn_banded (f32) on the same input: {r['banded_ms']:.4f} ms "
          f"({faster} is faster), {banded_err:.3e} of scale from the kernel; "
          f"strided F.conv1d (cuDNN, TF32 off) + transpose: "
          f"{r['library_ms']:.4f} ms, {lib_err:.3e} of scale; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    out["poly_kernel"] = r

    x2 = xc[:2].contiguous()
    for taps, xv in ((1, x2), (7, x2), (129, x2),
                     (129, x2[:, :100].contiguous())):
        h = design_lowpass_np(taps, 0.3) if taps > 1 else np.array([0.5])
        fast = lambda: fk.fir_direct(h, xv)
        plain = lambda: fk.fir_direct_plain(h, xv)
        record("fir_direct", f"{taps} taps, 2 x {xv.shape[1]}", fast(),
               plain(), FIR_TOL, fast, plain, failed)
    for up, down in ((2, 1), (1, 2), (3, 4), (7, 5)):
        xv = x2[:, :n // down * down].contiguous()
        fast = lambda: fk.resample_poly_kernel(xv, up, down)
        plain = lambda: fk.resample_poly_plain(xv, up, down)
        record("poly_kernel", f"{up}/{down}, 2 x {xv.shape[1]}", fast(),
               plain(), POLY_TOL, fast, plain, failed)
    return out


def dft_power_phase(xs, win, failed: list, log: list[str]) -> dict:
    """stft_power_dft at 1024/256 on (16, 480000), with the packed power
    kernel on the same input; then 2 channels at 2048/512, 1024/1024,
    n < nfft, 384/128, 640/128, 1536/512 and 4096/128 (depth 4,096)."""
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    from vv_dsp_tpu_torch.ops import stft_kernels as sk

    fast = lambda: sk.stft_power_dft(xs, NFFT, HOP)
    plain = lambda: sk.stft_power_dft_plain(xs, NFFT, HOP)
    got = fast()
    r = record("stft_power_dft", "1024/256", got, plain(), DFT_POWER_TOL,
               fast, plain, failed)
    r["packed_ms"] = cuda_ms(lambda: sk.stft_power(xs, NFFT, HOP, win))
    c, nf, bins = got.shape
    # the function's bound, as stft_power's (the same function on the same
    # input); the DFT product's 2 * 2 * nfft operations a bin are the
    # kernel's algorithm, read as its achieved rate
    r.update(bound(4 * (xs.numel() + got.numel()),
                   fft_flops(c * nf, NFFT), F32_FLOP_PER_S))
    # the product form's floor: six bf16 products of 2 * 2 * nfft
    # operations a bin at the tensor cores' rate
    gemm_flop = 2 * 2 * c * nf * NFFT * bins
    r["product_floor_ms"] = 6 * gemm_flop / BF16_FLOP_PER_S * 1e3
    r["tensor_tflop_per_s"] = 6 * gemm_flop / r["ms"] / 1e9
    r["library_ms"] = None
    print(f"  stft_power_dft: packed stft_power kernel on the same input "
          f"{r['packed_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); the product form's floor, six products of "
          f"{gemm_flop / 1e9:.2f} GFLOP at 989 TFLOP/s, "
          f"{r['product_floor_ms']:.4f} ms; its bf16 products ran at "
          f"{r['tensor_tflop_per_s']:.1f} TFLOP/s; library call: none "
          f"(torch.stft writes the complex spectrum; the power takes "
          f"another pass)")
    plan = mp.dft_plan(NFFT, HOP)
    mma_line("stft_power_dft", "1024/256", r["ms"], r["bound_ms"],
             r["bound_by"], log,
             f"dft_power_kernelILb{int(plan.tiles > 1)}E", plan.smem)
    x2 = xs[:2]
    for nfft, hop, xv in ((2048, 512, x2), (1024, 1024, x2),
                          (2048, 512, x2[:, :1500].contiguous()),
                          (384, 128, x2), (640, 128, x2), (1536, 512, x2),
                          (4096, 128, x2)):
        fast = lambda: sk.stft_power_dft(xv, nfft, hop)
        plain = lambda: sk.stft_power_dft_plain(xv, nfft, hop)
        record("stft_power_dft", f"{nfft}/{hop}, 2 x {xv.shape[1]}", fast(),
               plain(), DFT_POWER_TOL, fast, plain, failed)
    return r


def istft_stockham_phase(xc, win, failed: list) -> dict:
    """istft_stockham at 1024/256 on the one-sided spectrum of the
    COLA-padded (16, 479232) input, (16, 1876, 513), with the packed
    inverse kernel on the same spectrum; on a non-Hermitian (16, 1876,
    1024) spectrum with rfft=False (all bins inverted); and at 128/32 on
    the one-sided (16, 14974, 65) spectrum of the input."""
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    xp = torch.nn.functional.pad(xc, (NFFT - HOP, NFFT - HOP))
    half = sk.stft_spectrum(xp, NFFT, HOP, win, True)
    c, nf, _ = half.shape
    gen = torch.Generator(device=xc.device).manual_seed(5)
    full = torch.complex(*(torch.randn((c, nf, NFFT), generator=gen,
                                       device=xc.device) for _ in range(2)))
    win128 = STFT(*SMALL).win(xc.device)
    small = stk.stft_spectrum_stockham(xc, *SMALL, win128, True)
    r = None
    for label, spec, nfft, hop, w, rfft in (
            ("1024/256 rfft=True", half, NFFT, HOP, win, True),
            ("1024/256 rfft=False, non-Hermitian", full, NFFT, HOP, win,
             False),
            ("128/32 rfft=True", small, *SMALL, win128, True)):
        n_out = (spec.shape[1] - 1) * hop + nfft
        norm = ik.ola_norm(get_window_np("hann", nfft), hop, spec.shape[1],
                           n_out, xc.device)
        fast = lambda: stk.istft_stockham(spec, nfft, hop, n_out, w, norm,
                                          rfft)
        plain = lambda: stk.istft_stockham_plain(spec, nfft, hop, n_out, w,
                                                 norm, rfft)
        got, want = fast(), plain()
        if not torch.equal(got, fast()):
            failed.append(f"istft_stockham [{label}] differs between two "
                          f"runs")
        all_rel = rel_err(got, want)[1]
        print(f"  istft_stockham [{label}] all samples: {all_rel:.3e} of "
              f"scale (tol {ISTFT_ALL_TOL:g}) "
              f"{'ok' if all_rel < ISTFT_ALL_TOL else 'FAIL'}")
        if not all_rel < ISTFT_ALL_TOL:
            failed.append(f"istft_stockham [{label}] all samples")
        rr = record("istft_stockham", label, got, want, ISTFT_TOL, fast,
                    plain, failed, edge=nfft)
        rr.update(bound(spec.element_size() * spec.numel()
                        + 4 * (got.numel() + n_out),
                        fft_flops(c * spec.shape[1], nfft)
                        + c * spec.shape[1] * 2 * nfft, F32_FLOP_PER_S))
        print(f"  istft_stockham [{label}] bound {rr['bound_ms']:.4f} ms "
              f"({rr['bound_by']})")
        if r is None:
            r = rr
            r["packed_ms"] = cuda_ms(lambda: ik.istft(spec, nfft, hop, n_out,
                                                      w, norm))
            print(f"  packed istft kernel on the same spectrum: "
                  f"{r['packed_ms']:.4f} ms")
        elif rfft:
            r.update({f"small_{k}": v for k, v in rr.items()})
        else:
            r.update({f"full_{k}": v for k, v in rr.items()})
    r["library_ms"] = None
    print("  istft_stockham library call: none (torch.istft refuses the Hann "
          "window at center=False: its overlap-add is 0 at sample 0)")
    return r


def gate_packed_phase(xc, win, failed: list) -> dict:
    """stft_gate_packed at 1024/256 on the COLA-padded (16, 480768) input:
    threshold 0 (a pure roundtrip, the input back on the retained
    samples), GATE_T on the 1024/256 tone probe at the same shape, and
    GATE_T on the dense input (the run's row; bins near the threshold may
    flip between two FFTs, so the count of differing samples must stay
    within GATE_FLIPS_FRAMES frames), with SpectralGate's split pair
    (spectrum kernel, gated inverse kernel) timed on the same input."""
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops.framing import stft_num_frames
    from vv_dsp_tpu_torch.ops.window import get_window_np

    pad = NFFT - HOP
    xp = torch.nn.functional.pad(xc, (pad, pad))
    c, n_pad = xp.shape
    norm = ik.periodic_norm(get_window_np("hann", NFFT), HOP, n_pad,
                            xc.device)
    probe = torch.as_tensor(gate_probe(N_CHAIN, 3, channels=c),
                            device=xc.device)
    pp = torch.nn.functional.pad(probe, (pad, pad))
    for label, x, t in (("threshold 0", xp, 0.0),
                        (f"tone probe, {c} ch, threshold {GATE_T:g}", pp,
                         GATE_T)):
        fast = lambda: ik.stft_gate_packed(x, NFFT, HOP, t, win, norm)
        plain = lambda: ik.stft_gate_packed_plain(x, NFFT, HOP, t, win, norm)
        got, want = fast(), plain()
        if not torch.equal(got, fast()):
            failed.append(f"stft_gate_packed [{label}] differs between two "
                          f"runs")
        record("stft_gate_packed", label, got[:, pad:-pad],
               want[:, pad:-pad], GATE_TOL, fast, plain, failed)
        if t == 0.0:
            err = (got[:, pad:-pad] - xc).abs().max().item()
            print(f"  stft_gate_packed [{label}] vs its input, retained "
                  f"samples: {err:.3e} absolute (limit {ROUNDTRIP_TOL:g}) "
                  f"{'ok' if err < ROUNDTRIP_TOL else 'FAIL'}")
            if not err < ROUNDTRIP_TOL:
                failed.append("stft_gate_packed threshold 0 vs its input")
    fast = lambda: ik.stft_gate_packed(xp, NFFT, HOP, GATE_T, win, norm)
    plain = lambda: ik.stft_gate_packed_plain(xp, NFFT, HOP, GATE_T, win,
                                              norm)
    got, want = fast(), plain()
    far = ((got - want)[:, pad:-pad].abs()
           > GATE_TOL * want.abs().max()).sum().item()
    flips_ok = far <= GATE_FLIPS_FRAMES * NFFT
    if not flips_ok:
        failed.append(f"stft_gate_packed dense input at threshold "
                      f"{GATE_T:g}: {far} samples differ")
    r = {"max_abs_err": (got - want)[:, pad:-pad].abs().max().item(),
         "ms": cuda_ms(fast), "plain_ms": cuda_ms(plain)}
    exact = ik.ola_norm(get_window_np("hann", NFFT), HOP,
                        stft_num_frames(n_pad, NFFT, HOP), n_pad, xc.device)

    def split():
        spec = sk.stft_spectrum(xp, NFFT, HOP, win, True)
        return ik.istft(spec, NFFT, HOP, n_pad, win, exact, GATE_T)

    r["split_ms"] = cuda_ms(split)
    nf = stft_num_frames(n_pad, NFFT, HOP)
    r.update(bound(4 * (2 * xp.numel() + n_pad),
                   2 * fft_flops(c * nf, NFFT) + c * nf * 4 * NFFT,
                   F32_FLOP_PER_S))
    r["library_ms"] = None
    print(f"kernel stft_gate_packed [dense, threshold {GATE_T:g}]: {far} of "
          f"{c * (n_pad - 2 * pad)} retained samples differ by more than "
          f"{GATE_TOL:g} of scale (bins near the threshold; limit "
          f"{GATE_FLIPS_FRAMES * NFFT}) {'ok' if flips_ok else 'FAIL'}; "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
          f"SpectralGate's split pair {r['split_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); library call: none (no "
          f"single PyTorch call computes STFT -> per-frame gate -> ISTFT)")
    return r


def chain_oracle(x64: np.ndarray, chain) -> np.ndarray:
    """The whole chain in float64 numpy/scipy (tests/test_models.py's
    oracle): lfilter -> resample_poly -> framed rfft power -> mel -> log ->
    DCT-II."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops.dct import _dct2_matrix
    from vv_dsp_tpu_torch.ops.mel import mel_filterbank_np
    from vv_dsp_tpu_torch.ops.window import get_window_np

    h = np.asarray(chain.fir_coeffs, np.float64)
    y = ss.lfilter(h, [1.0], x64, axis=-1)
    yr = ss.resample_poly(y, chain.up, chain.down, axis=-1)
    n_out = -(-y.shape[-1] * chain.up // chain.down)
    yr = yr[..., :n_out]
    nfft, hop = chain.nfft, chain.hop
    w = get_window_np(chain.window_name, nfft)
    nf = 1 + (n_out - nfft + hop) // hop
    yp = np.pad(yr, ((0, 0), (0, (nf - 1) * hop + nfft - n_out)))
    frames = np.stack([yp[:, i * hop:i * hop + nfft] for i in range(nf)], 1)
    pw = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    sr = chain.sample_rate * chain.up / chain.down
    fb = mel_filterbank_np(nfft, chain.n_mels, sr, 0.0, sr / 2, "htk")
    lm = np.log(pw @ fb.T + 1e-10)
    return lm @ _dct2_matrix(chain.n_mels)[:chain.n_mfcc].T


def filter_oracles(x64: np.ndarray, outs: dict) -> None:
    """The filter and resample rows' outputs on 2 channels against float64
    scipy: the FIRs as a full convolution cut to n (lfilter's output), the
    resamplers as scipy.signal.resample_poly, the multistage row as the
    same cascade of resample_poly stages."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    n = x64.shape[-1]
    for taps in FIR_TAPS:
        want = ss.oaconvolve(x64, design_lowpass_np(taps, 0.3)[None],
                             axes=-1)[:, :n]
        oracle_check(f"fir_{taps}_best vs float64 scipy (2 ch)",
                     outs[f"fir_{taps}_best"][:2].cpu().numpy(), want,
                     FIR_TOL)
    for u, d in RATIOS:
        want = ss.resample_poly(x64[:, :n // d * d], u, d, axis=-1)
        oracle_check(f"resample_poly_{u}_{d} vs float64 scipy (2 ch)",
                     outs[f"resample_poly_{u}_{d}"][:2].cpu().numpy(), want,
                     POLY_TOL)
        if (u, d) == (4, 3):
            oracle_check("resample_poly_kernel_4_3 vs float64 scipy (2 ch)",
                         outs["resample_poly_kernel_4_3"][:2].cpu().numpy(),
                         want, POLY_TOL)
    want = x64
    for u, d in rs._factor_stages(160, 147):
        want = ss.resample_poly(want, u, d, axis=-1)
    oracle_check("resample_multistage_160_147 vs float64 scipy stages (2 ch)",
                 outs["resample_multistage_160_147"][:2].cpu().numpy(),
                 want[:, :-(-n * 160 // 147)], POLY_TOL)


def spectrum_oracle(x64: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    from vv_dsp_tpu_torch.ops.window import get_window_np
    n = x64.shape[-1]
    nf = 1 + (n - nfft + hop) // hop
    xp = np.pad(x64, ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    frames = np.stack([xp[:, i * hop:i * hop + nfft] for i in range(nf)], 1)
    return np.fft.fft(frames * get_window_np("hann", nfft), axis=-1)


def frames64(x64: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """(c, n) -> (c, frames, nfft), zero past the end, in float64."""
    n = x64.shape[-1]
    nf = 1 + (n - nfft + hop) // hop if n >= nfft else 1
    xp = np.pad(x64, ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    idx = np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
    return xp[:, idx]


def gate_probe(n: int, seed: int, nfft: int = NFFT,
               bins=(40, 97, 211), channels: int = 2) -> np.ndarray:
    """(channels, n) tones at bin centres of the nfft-point frame (the three bins
    at amplitudes 1, 0.7 and 0.02) over N(0, 1e-4^2) noise. In every frame
    that lies inside the signal, each bin's power is >= 10x above or below
    0.01 of the frame's peak: the main lobes at 1, 0.49 and 4e-4 of the
    peak, their Hann neighbours at 0.25, 0.1225 and 1e-4, the noise far
    below (gate_oracle measures the factor)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 1e-4 * rng.standard_normal((channels, n))
    for k, a in zip(bins, (1.0, 0.7, 0.02)):
        x += a * np.cos(2 * np.pi * k * t / nfft
                        + rng.uniform(0, 2 * np.pi, (channels, 1)))
    return x.astype(np.float32)


def gate_oracle(x64: np.ndarray, threshold: float, nfft: int = NFFT,
                hop: int = HOP) -> tuple:
    """SpectralGate(nfft, hop) in float64 numpy: (output, the smallest
    factor by which a bin's power clears t^2 times its frame's peak, over
    the frames that lie inside the signal)."""
    from vv_dsp_tpu_torch.ops.window import get_window_np
    n, pad = x64.shape[-1], nfft - hop
    w = get_window_np("hann", nfft)
    fr = frames64(np.pad(x64, ((0, 0), (pad, pad))), nfft, hop)
    spec = np.fft.rfft(fr * w, axis=-1)
    p2 = np.abs(spec) ** 2
    level = threshold ** 2 * p2.max(axis=-1, keepdims=True)
    inside = slice(pad // hop, (pad + n - nfft) // hop + 1)
    factor = 10 ** np.abs(np.log10(p2[:, inside] / level[:, inside])).min()
    y = np.fft.irfft(np.where(p2 >= level, spec, 0), nfft, axis=-1) * w
    nf, total = y.shape[1], n + 2 * pad
    out = np.zeros((2, (nf - 1) * hop + nfft))
    norm = np.zeros(out.shape[1])
    for f in range(nf):
        out[:, f * hop:f * hop + nfft] += y[:, f]
        norm[f * hop:f * hop + nfft] += w * w
    out, norm = out[:, :total], norm[:total]
    out = out / np.where(norm > 1e-12, norm, 1.0)
    return out[:, pad:pad + n], factor


def frontend_oracle(x64: np.ndarray, front) -> np.ndarray:
    """MFCCFrontend in float64 numpy: framed rfft power -> HTK mel -> log
    -> liftered DCT-II."""
    from vv_dsp_tpu_torch.models import frontend_params
    p = frontend_params(front.nfft, front.n_mels, front.n_mfcc,
                        front.sample_rate, front.lifter)
    pw = np.abs(np.fft.rfft(frames64(x64, front.nfft, front.hop)
                            * p["window"], axis=-1)) ** 2
    return np.log(pw @ p["mel_fb"].T + 1e-10) @ p["dct_lift"].T


def oracle_check(name: str, got, want, tol: float, absolute: bool = False):
    got = np.asarray(got, np.complex128 if np.iscomplexobj(got)
                     else np.float64)
    err = np.abs(got - want).max()
    if not absolute:
        err /= np.abs(want).max()
    unit = "absolute" if absolute else "of scale"
    print(f"{name}: {err:.3e} {unit} (limit {tol:g})")
    if not err < tol:
        raise AssertionError(f"{name}: {err:.3e} >= {tol:g}")


def full_nfft_oracles(xc, xs, outs, front128, gate128) -> None:
    """The full-nfft paths' outputs against float64 numpy on 2 channels:
    the 128/32 power and MFCCs on the dense input, SpectralGate(128, 32)
    on its tone probe (the interior, which only frames inside the signal
    reach), and the first 4096 frames of the 512/8 spectra."""
    from vv_dsp_tpu_torch.ops.window import get_window_np
    x2 = xc[:2].double().cpu().numpy()
    w = get_window_np("hann", SMALL[0])
    want = np.abs(np.fft.rfft(frames64(x2, *SMALL) * w, axis=-1)) ** 2
    oracle_check("STFT 128/32 power vs float64 oracle (2 ch)",
                 outs["power 128/32"][:2].cpu().numpy(), want, ORACLE_TOL)
    oracle_check("MFCCFrontend 128/32 vs float64 oracle (2 ch)",
                 outs["MFCCFrontend 128/32"][:2].cpu().numpy(),
                 frontend_oracle(x2, front128), ORACLE_TOL)
    probe = gate_probe(N_CHAIN, 3, SMALL[0], (10, 25, 45))
    want, factor = gate_oracle(probe.astype(np.float64), GATE_T, *SMALL)
    print(f"gate probe 128/32: every bin of the frames inside the signal "
          f"clears the threshold by {factor:.2f}x or more (need 10x)")
    if not factor >= 10:
        raise AssertionError(f"gate probe too close to the threshold: "
                             f"{factor:.2f}x")
    edge = SMALL[0] - SMALL[1]
    got = gate128(torch.as_tensor(probe, device=xc.device)).cpu().numpy()
    oracle_check("SpectralGate 128/32 vs float64 oracle on the probe (2 ch), "
                 "interior", got[:, edge:-edge], want[:, edge:-edge],
                 ORACLE_TOL)
    frames, (nfft, hop) = 4096, DENSE
    head = xs[:2, :(frames - 1) * hop + nfft].double().cpu().numpy()
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    want = np.fft.fft(head[:, idx] * get_window_np("hann", nfft), axis=-1)
    for name, bins in (("spectrum 512/8", DENSE[0]),
                       ("spectrum 512/8 one-sided", DENSE[0] // 2 + 1)):
        oracle_check(f"STFT {name} vs float64 oracle (2 ch, {frames} frames)",
                     outs[name][:2, :frames].cpu().numpy(),
                     want[..., :bins], ORACLE_TOL)


def last_slice_oracles(xc, xs, outs, want) -> None:
    """The last slice's rows against float64 numpy on 2 channels: the
    windowed-DFT power and the spectrogram against the 1024/256 FFT oracle
    `want`, the roundtrips and both inverses against their input on the
    COLA-covered interior, and the packed fused gate on the 1024/256 tone
    probe against the float64 gate oracle."""
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np
    oracle_check("stft_power_pallas 1024/256 vs float64 oracle (2 ch)",
                 outs["stft_power_pallas_1024_256"][:2].cpu().numpy(),
                 np.abs(want[..., :NFFT // 2 + 1]) ** 2, ORACLE_TOL)
    oracle_check("STFT 1024/256 spectrogram vs float64 oracle (2 ch)",
                 outs["stft_1024_256_spectrogram"][:2].cpu().numpy(),
                 np.abs(want), ORACLE_TOL)
    edge = SMALL[0] - SMALL[1]
    oracle_check("STFT 128/32 roundtrip vs its input, interior",
                 outs["stft_128_32_roundtrip"][:, edge:-edge].cpu().numpy(),
                 xc[:, edge:-edge].double().cpu().numpy(), ROUNDTRIP_TOL,
                 absolute=True)
    pad = NFFT - HOP
    for name in ("istft_stockham_1024_256", "istft_stockham_1024_256_full"):
        oracle_check(f"{name} of the padded input's spectrum vs the input",
                     outs[name][:, pad:-pad].cpu().numpy(),
                     xc.double().cpu().numpy(), ROUNDTRIP_TOL, absolute=True)
    probe = gate_probe(N_CHAIN, 3)
    gate_want, _ = gate_oracle(probe.astype(np.float64), GATE_T)
    pp = torch.nn.functional.pad(torch.as_tensor(probe, device=xc.device),
                                 (pad, pad))
    norm = ik.periodic_norm(get_window_np("hann", NFFT), HOP, pp.shape[-1],
                            xc.device)
    got = ik.stft_gate_packed(pp, NFFT, HOP, GATE_T,
                              STFT(NFFT, HOP).win(xc.device),
                              norm)[:, pad:-pad].cpu().numpy()
    oracle_check("stft_gate_packed 1024/256 vs float64 oracle on the probe "
                 "(2 ch), interior", got[:, pad:-pad], gate_want[:, pad:-pad],
                 ORACLE_TOL)


def slice_phase(xc, xs, chain, staged, front, front128, card: str) -> dict:
    """Drive every entry point of the slice once, each with the launch
    counters zeroed just before it and read just after, then check and
    time them. Returns each kernel's launches summed over the paths."""
    from vv_dsp_tpu_torch.models import SpectralGate
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    counters = {"upfirdn_banded": uf.upfirdn_banded,
                "stft_mfcc": sk.stft_mfcc, "stft_spectrum": sk.stft_spectrum,
                "stft_power": sk.stft_power, "istft": ik.istft,
                "stft_power_stockham": stk.stft_power_stockham,
                "stft_mel_stockham": stk.stft_mel_stockham,
                "stft_gate_stockham": stk.stft_gate_stockham,
                "stft_spectrum_stockham": stk.stft_spectrum_stockham,
                "fir_direct": fk.fir_direct,
                "poly_kernel": fk.resample_poly_kernel,
                "stft_power_dft": sk.stft_power_dft,
                "istft_stockham": stk.istft_stockham,
                "stft_gate_packed": ik.stft_gate_packed}
    plan = STFT(NFFT, HOP)
    gate = SpectralGate()
    firs = {taps: design_lowpass_np(taps, 0.3) for taps in FIR_TAPS}
    cut = {d: xc[:, :N_CHAIN // d * d] for _, d in RATIOS}
    small, dense = STFT(*SMALL), STFT(*DENSE)
    gate128 = SpectralGate(*SMALL, GATE_T)
    ones = torch.ones(NFFT // 2 + 1, device=xc.device)
    roundtrip = lambda: plan.reconstruct(plan.process(xc, rfft=True),
                                         N_CHAIN, rfft=True)
    packed = lambda: plan.reconstruct_packed(
        plan.process_packed(xc).apply_mask(ones), N_CHAIN)
    # each path with the exact launches it must make
    synthesis = {"stft_spectrum": 1, "istft": 1}
    paths = (
        ("chain", lambda: chain(xc), {"upfirdn_banded": 1, "stft_mfcc": 1}),
        ("spectrum", lambda: plan.process(xs, rfft=False),
         {"stft_spectrum": 1}),
        ("SpectralGate", lambda: gate(xc), synthesis),
        ("roundtrip", roundtrip, synthesis),
        ("packed roundtrip", packed, synthesis),
        ("power", lambda: plan.power(xs), {"stft_power": 1}),
        ("MFCCFrontend", lambda: front(xc), {"stft_mfcc": 1}),
        ("power 128/32", lambda: small.power(xc), {"stft_power_stockham": 1}),
        ("MFCCFrontend 128/32", lambda: front128(xc),
         {"stft_mel_stockham": 1}),
        ("SpectralGate 128/32", lambda: gate128(xc),
         {"stft_gate_stockham": 1}),
        ("spectrum 512/8", lambda: dense.process(xs, rfft=False),
         {"stft_spectrum_stockham": 1}),
        ("spectrum 512/8 one-sided", lambda: dense.process(xs, rfft=True),
         {"stft_spectrum_stockham": 1}),
        ("staged chain", lambda: staged(xc),
         {"upfirdn_banded": 2, "stft_mfcc": 1}))
    # the filter and resample entry points on the TPU's routes, with the
    # input samples a channel each row counts
    filter_paths = [
        (f"fir_{taps}_best", lambda h=h: fk.fir_apply_best(h, xc), want,
         N_CHAIN)
        for (taps, h), want in zip(firs.items(), (
            {"fir_direct": 1}, {}, {}, {"upfirdn_banded": 1}))]
    filter_paths += [
        (f"resample_poly_{u}_{d}",
         lambda u=u, d=d: fk.resample_poly_best(cut[d], u, d), want,
         cut[d].shape[1])
        for (u, d), want in zip(RATIOS, (
            {"upfirdn_banded": 1}, {"upfirdn_banded": 1},
            {"upfirdn_banded": 1}, {}))]
    filter_paths += [
        ("resample_multistage_160_147",
         lambda: rs.resample_multistage(xc, 160, 147), {"upfirdn_banded": 3},
         N_CHAIN),
        ("resample_poly_kernel_4_3",
         lambda: fk.resample_poly_kernel(xc, 4, 3), {"poly_kernel": 1},
         N_CHAIN)]
    paths += tuple(p[:3] for p in filter_paths)
    # the last slice: the windowed-DFT power, the 128-point roundtrip, the
    # full-nfft inverse (both forms) of the COLA-padded input's spectra, the
    # packed fused gate on that input and the magnitude spectrogram
    pad = NFFT - HOP
    xp = torch.nn.functional.pad(xc, (pad, pad))
    n_pad = xp.shape[-1]
    half, full = plan.process(xp, rfft=True), plan.process(xp, rfft=False)
    win = plan.win(xc.device)
    inv_norm = ik.ola_norm(get_window_np("hann", NFFT), HOP, half.shape[1],
                           n_pad, xc.device)
    gate_norm = ik.periodic_norm(get_window_np("hann", NFFT), HOP, n_pad,
                                 xc.device)
    small_rt = lambda: small.reconstruct(small.process(xc, rfft=True),
                                         N_CHAIN, rfft=True)
    last_paths = (
        ("stft_power_pallas_1024_256",
         lambda: sk.stft_power_dft(xs, NFFT, HOP), {"stft_power_dft": 1},
         N_STFT),
        ("stft_128_32_roundtrip", small_rt,
         {"stft_spectrum_stockham": 1, "istft_stockham": 1}, N_CHAIN),
        ("istft_stockham_1024_256", lambda: stk.istft_stockham(
            half, NFFT, HOP, n_pad, win, inv_norm, rfft=True),
         {"istft_stockham": 1}, n_pad),
        ("istft_stockham_1024_256_full", lambda: stk.istft_stockham(
            full, NFFT, HOP, n_pad, win, inv_norm, rfft=False),
         {"istft_stockham": 1}, n_pad),
        ("stft_gate_packed_1024_256", lambda: ik.stft_gate_packed(
            xp, NFFT, HOP, GATE_T, win, gate_norm),
         {"stft_gate_packed": 1}, n_pad),
        ("stft_1024_256_spectrogram", lambda: plan.spectrogram(xs),
         {"stft_spectrum": 1}, N_STFT))
    paths += tuple(p[:3] for p in last_paths)
    outs, launches = {}, dict.fromkeys(counters, 0)
    for name, fn, want in paths:
        for counted in counters.values():
            counted.launches = 0
        outs[name] = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        print(f"launches [{name}]: {got}")
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        for k, count in got.items():
            launches[k] += count
    print(f"slice launches, summed over the paths: {launches}")
    feats, spec, gated = outs["chain"], outs["spectrum"], outs["SpectralGate"]
    rt, rtp = outs["roundtrip"], outs["packed roundtrip"]
    power, mfcc = outs["power"], outs["MFCCFrontend"]

    nf_chain = 1 + (-(-N_CHAIN * 4 // 3) - 2048 + 512) // 512
    nf_front = 1 + (N_CHAIN - NFFT + HOP) // HOP
    nf_small = 1 + (N_CHAIN - SMALL[0] + SMALL[1]) // SMALL[1]
    nf_dense = 1 + (N_STFT - DENSE[0] + DENSE[1]) // DENSE[1]
    for name, t, shape, dtype in (
            ("chain", feats, (CHANNELS, nf_chain, 20), torch.float32),
            ("spectrum", spec, (CHANNELS, 1873, NFFT), torch.complex64),
            ("SpectralGate", gated, (CHANNELS, N_CHAIN), torch.float32),
            ("roundtrip", rt, (CHANNELS, N_CHAIN), torch.float32),
            ("packed roundtrip", rtp, (CHANNELS, N_CHAIN), torch.float32),
            ("power", power, (CHANNELS, 1873, NFFT // 2 + 1), torch.float32),
            ("MFCCFrontend", mfcc, (CHANNELS, nf_front, 13), torch.float32),
            ("power 128/32", outs["power 128/32"],
             (CHANNELS, nf_small, SMALL[0] // 2 + 1), torch.float32),
            ("MFCCFrontend 128/32", outs["MFCCFrontend 128/32"],
             (CHANNELS, nf_small, 13), torch.float32),
            ("SpectralGate 128/32", outs["SpectralGate 128/32"],
             (CHANNELS, N_CHAIN), torch.float32),
            ("spectrum 512/8", outs["spectrum 512/8"],
             (CHANNELS, nf_dense, DENSE[0]), torch.complex64),
            ("spectrum 512/8 one-sided", outs["spectrum 512/8 one-sided"],
             (CHANNELS, nf_dense, DENSE[0] // 2 + 1), torch.complex64),
            ("staged chain", outs["staged chain"], (CHANNELS, nf_chain, 20),
             torch.float32),
            *((f"fir_{taps}_best", outs[f"fir_{taps}_best"],
               (CHANNELS, N_CHAIN), torch.float32) for taps in FIR_TAPS),
            *((f"resample_poly_{u}_{d}", outs[f"resample_poly_{u}_{d}"],
               (CHANNELS, -(-(N_CHAIN // d * d) * u // d)), torch.float32)
              for u, d in RATIOS),
            ("resample_multistage_160_147",
             outs["resample_multistage_160_147"],
             (CHANNELS, -(-N_CHAIN * 160 // 147)), torch.float32),
            ("resample_poly_kernel_4_3", outs["resample_poly_kernel_4_3"],
             (CHANNELS, N_CHAIN * 4 // 3), torch.float32),
            ("stft_power_pallas_1024_256", outs["stft_power_pallas_1024_256"],
             (CHANNELS, 1873, NFFT // 2 + 1), torch.float32),
            *((name, outs[name], (CHANNELS, n_pad), torch.float32)
              for name in ("istft_stockham_1024_256",
                           "istft_stockham_1024_256_full",
                           "stft_gate_packed_1024_256")),
            ("stft_128_32_roundtrip", outs["stft_128_32_roundtrip"],
             (CHANNELS, N_CHAIN), torch.float32),
            ("stft_1024_256_spectrogram", outs["stft_1024_256_spectrogram"],
             (CHANNELS, 1873, NFFT), torch.float32)):
        assert tuple(t.shape) == shape, (name, tuple(t.shape))
        assert t.dtype == dtype, (name, t.dtype)
        vals = torch.view_as_real(t) if t.is_complex() else t
        assert torch.isfinite(vals).all().item(), f"non-finite {name}"

    x2 = xc[:2].double().cpu().numpy()
    chain_want = chain_oracle(x2, chain)
    oracle_check("chain vs float64 oracle (2 ch)",
                 feats[:2].cpu().numpy(), chain_want, 5e-5)
    oracle_check("staged chain vs float64 oracle (2 ch)",
                 outs["staged chain"][:2].cpu().numpy(), chain_want, 5e-5)
    oracle_check("staged chain vs the fused chain (16 ch)",
                 outs["staged chain"].cpu().numpy(),
                 feats.double().cpu().numpy(), STAGED_TOL)
    filter_oracles(x2, outs)
    want = spectrum_oracle(xs[:2].double().cpu().numpy(), NFFT, HOP)
    oracle_check("STFT 1024/256 vs float64 oracle (2 ch)",
                 spec[:2].cpu().numpy(), want, 5e-5)
    oracle_check("STFT 1024/256 power vs float64 oracle (2 ch)",
                 power[:2].cpu().numpy(),
                 np.abs(want[..., :NFFT // 2 + 1]) ** 2, ORACLE_TOL)
    edge = NFFT - HOP  # the COLA-covered interior
    for name, y in (("roundtrip", rt), ("packed roundtrip", rtp)):
        oracle_check(f"STFT 1024/256 {name} vs its input, interior",
                     y[:, edge:-edge].cpu().numpy(),
                     xc[:, edge:-edge].double().cpu().numpy(),
                     ROUNDTRIP_TOL, absolute=True)
    probe = gate_probe(N_CHAIN, 3)
    want, factor = gate_oracle(probe.astype(np.float64), GATE_T)
    print(f"gate probe: every bin of the frames inside the signal clears "
          f"the threshold by {factor:.2f}x or more (need 10x)")
    if not factor >= 10:
        raise AssertionError(f"gate probe too close to the threshold: "
                             f"{factor:.2f}x")
    got = gate(torch.as_tensor(probe, device=xc.device)).cpu().numpy()
    oracle_check("SpectralGate vs float64 oracle on the probe (2 ch), "
                 "interior", got[:, edge:-edge], want[:, edge:-edge],
                 ORACLE_TOL)
    oracle_check("MFCCFrontend vs float64 oracle (2 ch)",
                 mfcc[:2].cpu().numpy(), frontend_oracle(x2, front),
                 ORACLE_TOL)
    full_nfft_oracles(xc, xs, outs, front128, gate128)
    last_slice_oracles(xc, xs, outs, want=spectrum_oracle(
        xs[:2].double().cpu().numpy(), NFFT, HOP))

    rows = (("northstar_chain_throughput", lambda: chain(xc), N_CHAIN),
            ("stft_1024_256_throughput",
             lambda: plan.process(xs, rfft=False), N_STFT),
            ("pipeline_spectral_gate", lambda: gate(xc), N_CHAIN),
            ("stft_1024_roundtrip", roundtrip, N_CHAIN),
            ("stft_1024_roundtrip_packed", packed, N_CHAIN),
            ("stft_128_32_power_throughput", lambda: small.power(xc),
             N_CHAIN),
            ("mfcc_frontend_128_32_throughput", lambda: front128(xc),
             N_CHAIN),
            ("pipeline_spectral_gate_128_32", lambda: gate128(xc), N_CHAIN),
            ("stft_512_8_throughput", lambda: dense.process(xs, rfft=False),
             N_STFT),
            ("stft_512_8_rfft_throughput",
             lambda: dense.process(xs, rfft=True), N_STFT),
            ("northstar_chain_staged_throughput", lambda: staged(xc),
             N_CHAIN),
            *((name, fn, n) for name, fn, _, n in filter_paths),
            *((name, fn, n) for name, fn, _, n in last_paths))
    for name, fn, n in rows:
        ms = cuda_ms(fn)
        print(f"{name} {CHANNELS * n / ms / 1e3:.2f} Msamples/s "
              f"({ms:.4f} ms, {CHANNELS} x {n}) | {card}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import_port()
    from vv_dsp_tpu_torch.models import MFCCFrontend, NorthStarChain

    card = device_phase()

    log = build_phase()
    torch.cuda.synchronize()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.standard_normal((CHANNELS, N_CHAIN)),
                         dtype=torch.float32, device=dev)
    xs = torch.as_tensor(rng.standard_normal((CHANNELS, N_STFT)),
                         dtype=torch.float32, device=dev)
    chain, front = NorthStarChain(device=dev), MFCCFrontend(device=dev)
    staged = NorthStarChain(fused_head=False, device=dev)
    front128 = MFCCFrontend(*SMALL, n_mels=26, n_mfcc=13, sample_rate=8000.0,
                            device=dev)
    kernels = kernel_phase(xc, xs, chain, front, front128, log)
    torch.cuda.synchronize()
    launches = slice_phase(xc, xs, chain, staged, front, front128, card)
    torch.cuda.synchronize()

    sources = {
        "upfirdn_banded": ("vv_dsp_tpu_torch/csrc/upfirdn.cu",
                           "vv_dsp_tpu/ops/pallas_upfirdn.py:141"),
        "stft_mfcc": ("vv_dsp_tpu_torch/csrc/stft.cu",
                      "vv_dsp_tpu/ops/pallas_fft.py:350"),
        "stft_spectrum": ("vv_dsp_tpu_torch/csrc/stft.cu",
                          "vv_dsp_tpu/ops/pallas_fft.py:589"),
        "stft_power": ("vv_dsp_tpu_torch/csrc/stft.cu",
                       "vv_dsp_tpu/ops/pallas_fft.py:686"),
        "istft": ("vv_dsp_tpu_torch/csrc/istft.cu",
                  "vv_dsp_tpu/ops/pallas_fft.py:1090"),
        "stft_mel_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                              "vv_dsp_tpu/ops/pallas_fft.py:1598"),
        "stft_power_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                                "vv_dsp_tpu/ops/pallas_fft.py:1649"),
        "stft_spectrum_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                                   "vv_dsp_tpu/ops/pallas_fft.py:1745"),
        "stft_gate_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                               "vv_dsp_tpu/ops/pallas_fft.py:2210"),
        "fir_direct": ("vv_dsp_tpu_torch/csrc/filter.cu",
                       "vv_dsp_tpu/ops/pallas_kernels.py:101"),
        "poly_kernel": ("vv_dsp_tpu_torch/csrc/filter.cu",
                        "vv_dsp_tpu/ops/pallas_kernels.py:183"),
        "stft_power_dft": ("vv_dsp_tpu_torch/csrc/dft_power.cu",
                           "vv_dsp_tpu/ops/pallas_kernels.py:345"),
        "istft_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                           "vv_dsp_tpu/ops/pallas_fft.py:2365"),
        "stft_gate_packed": ("vv_dsp_tpu_torch/csrc/gate_packed.cu",
                             "vv_dsp_tpu/ops/pallas_fft.py:2028"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernels[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
