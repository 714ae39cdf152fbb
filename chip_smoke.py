"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from vv_dsp_tpu_torch/csrc;
3. kernels: each kernel of the path against its plain PyTorch version on
   the card, at the shapes the main path gives it (the MFCC kernel at the
   chain's and at MFCCFrontend's geometry), within its tolerance,
   with CUDA-event times of both, of one PyTorch library call computing
   the same function where there is one, and the bound reckoned from the
   shapes; then tier probes, inputs on which a kernel must match the plain
   version at its own tier and land beyond the limit against another tier
   (the controls);
4. slice: through the public entry points, each with every launch counter
   zeroed just before it and read just after, NorthStarChain on
   (16, 479232), STFT(1024, 256).process on (16, 480000), SpectralGate() on
   (16, 479232), the natural-order and the packed STFT 1024/256 roundtrips
   on (16, 479232), STFT(1024, 256).power on (16, 480000) and
   MFCCFrontend() on (16, 479232); each path's launch counts equal to the
   kernels it must run, output shapes, finite values, float64
   numpy/scipy oracles on 2 channels (SpectralGate on a probe input whose
   every bin lies far from the threshold), the roundtrip against its
   input; then the throughput of each row.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing neither, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
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


def build_phase() -> None:
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


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def fft_flops(frames: int, nfft: int) -> float:
    """Operations of one real nfft-point FFT per frame (2.5 N log2 N)."""
    return frames * 2.5 * nfft * np.log2(nfft)


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


def kernel_phase(xc, xs, chain, front) -> dict:
    """Each kernel against its plain version at the main path's shapes
    (the MFCC kernel at the chain's and at MFCCFrontend's geometry)."""
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
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

    for tier in ("f32", "bf16x3", "bf16"):
        fast = lambda: uf.upfirdn_banded(xc, taps, up, down, offset, n_out,
                                         tier)
        plain = lambda: uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                        tier)
        got = fast()
        r = record("upfirdn_banded", tier, got, plain(), UPFIRDN_TOL, fast,
                   plain, failed)
        if tier == "f32":
            tier_gap("upfirdn_banded f32", got,
                     uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                     "bf16x3"), "bf16x3")
        if tier == chain.head_algorithm:
            results["upfirdn_banded"] = r
    # bf16x3: three bf16 products per tap, at the tensor cores' bf16 rate
    c = xc.shape[0]
    results["upfirdn_banded"].update(bound(
        4 * (xc.numel() + c * n_out + taps.numel()),
        3 * 2 * c * n_out * taps.shape[1], BF16_FLOP_PER_S))
    results["upfirdn_banded"]["library_ms"] = None
    print("  upfirdn_banded library call: none (no single PyTorch call "
          "computes a polyphase upfirdn; conv1d would need the signal "
          "zero-stuffed first)")
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
    nf_mfcc = c * got.shape[1]
    n_mels, n_mfcc = chain.mel_fb.shape[0], chain.dct_lift.shape[0]
    results["stft_mfcc"].update(bound(
        4 * (y.numel() + got.numel()),
        fft_flops(nf_mfcc, chain.nfft) + nf_mfcc * (
            3 * (chain.nfft // 2 + 1) + 2 * int((chain.mel_fb != 0).sum())
            + 2 * n_mels * n_mfcc), F32_FLOP_PER_S))
    results["stft_mfcc"]["library_ms"] = None
    print("  stft_mfcc library call: none (no single PyTorch call computes "
          "STFT -> mel -> log -> DCT)")
    # MFCCFrontend's geometry (1024/256, 26 mels, 13 MFCCs, f32) on xc
    front_args = (front.nfft, front.hop, front.window, front.mel_fb,
                  front.mel_bands, front.dct_lift, 1e-10, "f32")
    front_plain = front_args[:4] + front_args[5:]
    fast = lambda: sk.stft_mfcc(xc, *front_args)
    plain = lambda: sk.stft_mfcc_plain(xc, *front_plain)
    r = record("stft_mfcc", "MFCCFrontend f32", fast(), plain(), MFCC_TOL,
               fast, plain, failed)
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
        if not onesided:
            results["stft_spectrum"] = r

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


def gate_probe(n: int, seed: int) -> np.ndarray:
    """(2, n) tones at bin centres of the 1024-point frame (bins 40, 97 and
    211 at amplitudes 1, 0.7 and 0.02) over N(0, 1e-4^2) noise. In every
    frame that lies inside the signal, each bin's power is >= 10x above or
    below 0.01 of the frame's peak: the main lobes at 1, 0.49 and 4e-4 of
    the peak, their Hann neighbours at 0.25, 0.1225 and 1e-4, the noise
    near 1e-8."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 1e-4 * rng.standard_normal((2, n))
    for k, a in ((40, 1.0), (97, 0.7), (211, 0.02)):
        x += a * np.cos(2 * np.pi * k * t / NFFT
                        + rng.uniform(0, 2 * np.pi, (2, 1)))
    return x.astype(np.float32)


def gate_oracle(x64: np.ndarray, threshold: float) -> tuple:
    """SpectralGate() in float64 numpy: (output, the smallest factor by
    which a bin's power clears t^2 times its frame's peak, over the frames
    that lie inside the signal)."""
    from vv_dsp_tpu_torch.ops.window import get_window_np
    n, pad = x64.shape[-1], NFFT - HOP
    w = get_window_np("hann", NFFT)
    fr = frames64(np.pad(x64, ((0, 0), (pad, pad))), NFFT, HOP)
    spec = np.fft.rfft(fr * w, axis=-1)
    p2 = np.abs(spec) ** 2
    level = threshold ** 2 * p2.max(axis=-1, keepdims=True)
    inside = slice(pad // HOP, (pad + n - NFFT) // HOP + 1)
    factor = 10 ** np.abs(np.log10(p2[:, inside] / level[:, inside])).min()
    y = np.fft.irfft(np.where(p2 >= level, spec, 0), NFFT, axis=-1) * w
    nf, total = y.shape[1], n + 2 * pad
    out = np.zeros((2, (nf - 1) * HOP + NFFT))
    norm = np.zeros(out.shape[1])
    for f in range(nf):
        out[:, f * HOP:f * HOP + NFFT] += y[:, f]
        norm[f * HOP:f * HOP + NFFT] += w * w
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


def slice_phase(xc, xs, chain, front, card: str) -> dict:
    """Drive every entry point of the slice once, each with the launch
    counters zeroed just before it and read just after, then check and
    time them. Returns each kernel's launches summed over the paths."""
    from vv_dsp_tpu_torch.models import SpectralGate
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.stft import STFT

    counters = {"upfirdn_banded": uf.upfirdn_banded,
                "stft_mfcc": sk.stft_mfcc, "stft_spectrum": sk.stft_spectrum,
                "stft_power": sk.stft_power, "istft": ik.istft}
    plan = STFT(NFFT, HOP)
    gate = SpectralGate()
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
        ("MFCCFrontend", lambda: front(xc), {"stft_mfcc": 1}))
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
    for name, t, shape, dtype in (
            ("chain", feats, (CHANNELS, nf_chain, 20), torch.float32),
            ("spectrum", spec, (CHANNELS, 1873, NFFT), torch.complex64),
            ("SpectralGate", gated, (CHANNELS, N_CHAIN), torch.float32),
            ("roundtrip", rt, (CHANNELS, N_CHAIN), torch.float32),
            ("packed roundtrip", rtp, (CHANNELS, N_CHAIN), torch.float32),
            ("power", power, (CHANNELS, 1873, NFFT // 2 + 1), torch.float32),
            ("MFCCFrontend", mfcc, (CHANNELS, nf_front, 13), torch.float32)):
        assert tuple(t.shape) == shape, (name, tuple(t.shape))
        assert t.dtype == dtype, (name, t.dtype)
        vals = torch.view_as_real(t) if t.is_complex() else t
        assert torch.isfinite(vals).all().item(), f"non-finite {name}"

    x2 = xc[:2].double().cpu().numpy()
    oracle_check("chain vs float64 oracle (2 ch)",
                 feats[:2].cpu().numpy(), chain_oracle(x2, chain), 5e-5)
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

    rows = (("northstar_chain_throughput", lambda: chain(xc), N_CHAIN),
            ("stft_1024_256_throughput",
             lambda: plan.process(xs, rfft=False), N_STFT),
            ("pipeline_spectral_gate", lambda: gate(xc), N_CHAIN),
            ("stft_1024_roundtrip", roundtrip, N_CHAIN),
            ("stft_1024_roundtrip_packed", packed, N_CHAIN))
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

    build_phase()
    torch.cuda.synchronize()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.standard_normal((CHANNELS, N_CHAIN)),
                         dtype=torch.float32, device=dev)
    xs = torch.as_tensor(rng.standard_normal((CHANNELS, N_STFT)),
                         dtype=torch.float32, device=dev)
    chain, front = NorthStarChain(device=dev), MFCCFrontend(device=dev)
    kernels = kernel_phase(xc, xs, chain, front)
    torch.cuda.synchronize()
    launches = slice_phase(xc, xs, chain, front, card)
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
