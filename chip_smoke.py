"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from vv_dsp_tpu_torch/csrc;
3. kernels: each kernel of the path against its plain PyTorch version on
   the card, at the shapes the main path gives it, within its tolerance,
   with CUDA-event times of both; then tier probes, inputs on which a
   kernel must match the plain version at its own tier and land beyond
   the limit against another tier (the controls);
4. slice: NorthStarChain on (16, 479232) and STFT(1024, 256).process on
   (16, 480000) through the public entry points, with launch counters
   showing both went through the kernels, output shapes, finite values,
   and the chain and the spectrum against float64 numpy/scipy oracles on
   2 channels; then the throughput of both rows.
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
REPS = 10
# Limits, as fractions of the plain version's max |value| unless named
# otherwise; PERF.md gives the readings each was set from.
UPFIRDN_TOL = 1e-5      # same products, another float32 summation order
# float32 FFT noise in the log of low-energy mel bands: at f32 the plain
# version (cuFFT) sits 8.5e-4 and the kernel 4.1e-4 from a float64 oracle
# on this input, so the two differ by up to ~1.2e-3 (2.4e-6 of scale)
MFCC_TOL = 5e-6
SPECTRUM_TOL = 5e-5     # the FFT-class parity contract
UPFIRDN_PROBE_TOL = 2.5e-7
MFCC_PROBE_TOL = 2.5e-6  # of sum_b |dct[q, b]| (|log mel_b| + 1)


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


def kernel_phase(xc, xs, chain) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
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

    def record(name, tier, got, want, tol, fast, plain):
        """Error of the kernel against its plain version as a fraction of
        the plain version's max |value|, and both times."""
        err, rel = rel_err(got, want)
        ok = rel < tol
        ms, plain_ms = cuda_ms(fast), cuda_ms(plain)
        torch.cuda.synchronize()
        print(f"kernel {name} [{tier}]: max_abs_err {err:.3e}, {rel:.3e} of "
              f"scale (tol {tol:g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} [{tier}]")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

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
                   plain)
        if tier == "f32":
            tier_gap("upfirdn_banded f32", got,
                     uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                     "bf16x3"), "bf16x3")
        if tier == chain.head_algorithm:
            results["upfirdn_banded"] = r
    y = uf.upfirdn_banded(xc, taps, up, down, offset, n_out, "f32")
    mfcc_args = (chain.nfft, chain.hop, chain.window, chain.mel_fb,
                 chain.mel_bands, chain.dct_lift, 1e-10)
    plain_args = mfcc_args[:4] + mfcc_args[5:]
    for tier in ("f32", "bf16x3"):
        fast = lambda: sk.stft_mfcc(y, *mfcc_args, tier)
        plain = lambda: sk.stft_mfcc_plain(y, *plain_args, tier)
        got = fast()
        r = record("stft_mfcc", tier, got, plain(), MFCC_TOL, fast, plain)
        if tier == "f32":
            tier_gap("stft_mfcc f32", got,
                     sk.stft_mfcc_plain(y, *plain_args, "bf16x3"), "bf16x3")
        if tier == chain.stft_algorithm:
            results["stft_mfcc"] = r
    tier_gap("stft_mfcc bf16", sk.stft_mfcc(y, *mfcc_args, "bf16"),
             sk.stft_mfcc_plain(y, *plain_args, "f32"), "f32")
    win = STFT(1024, 256).win(xs.device)
    for onesided in (False, True):
        fast = lambda: sk.stft_spectrum(xs, 1024, 256, win, onesided)
        plain = lambda: sk.stft_spectrum_plain(xs, 1024, 256, win, onesided)
        r = record("stft_spectrum", "onesided" if onesided else "two-sided",
                   fast(), plain(), SPECTRUM_TOL, fast, plain)
        if not onesided:
            results["stft_spectrum"] = r
    tier_probes((up, down, offset, n_out, taps), mfcc_args, failed)
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return results


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


def slice_phase(xc, xs, chain, card: str) -> dict:
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.stft import STFT

    counters = {"upfirdn_banded": uf.upfirdn_banded,
                "stft_mfcc": sk.stft_mfcc, "stft_spectrum": sk.stft_spectrum}
    plan = STFT(1024, 256)
    for fn in counters.values():
        fn.launches = 0
    feats = chain(xc)
    spec = plan.process(xs, rfft=False)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"slice launches: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path never launched {name}")

    nf_chain = 1 + (-(-N_CHAIN * 4 // 3) - 2048 + 512) // 512
    assert tuple(feats.shape) == (CHANNELS, nf_chain, 20), feats.shape
    assert feats.dtype == torch.float32
    assert tuple(spec.shape) == (CHANNELS, 1873, 1024), spec.shape
    assert spec.dtype == torch.complex64
    assert torch.isfinite(feats).all().item(), "non-finite MFCCs"
    assert torch.isfinite(torch.view_as_real(spec)).all().item(), \
        "non-finite spectrum"

    want = chain_oracle(xc[:2].double().cpu().numpy(), chain)
    got = feats[:2].double().cpu().numpy()
    chain_err = np.abs(got - want).max() / np.abs(want).max()
    print(f"chain vs float64 oracle (2 ch): {chain_err:.3e} of scale "
          f"(limit 5e-5)")
    if not chain_err < 5e-5:
        raise AssertionError(f"chain error {chain_err:.3e} >= 5e-5")
    want = spectrum_oracle(xs[:2].double().cpu().numpy(), 1024, 256)
    got = spec[:2].cpu().numpy().astype(np.complex128)
    spec_err = np.abs(got - want).max() / np.abs(want).max()
    print(f"STFT 1024/256 vs float64 oracle (2 ch): {spec_err:.3e} of scale "
          f"(limit 5e-5)")
    if not spec_err < 5e-5:
        raise AssertionError(f"spectrum error {spec_err:.3e} >= 5e-5")

    chain_ms = cuda_ms(lambda: chain(xc))
    stft_ms = cuda_ms(lambda: plan.process(xs, rfft=False))
    print(f"northstar_chain_throughput "
          f"{CHANNELS * N_CHAIN / chain_ms / 1e3:.2f} Msamples/s "
          f"({chain_ms:.4f} ms) | stft_1024_256_throughput "
          f"{CHANNELS * N_STFT / stft_ms / 1e3:.2f} Msamples/s "
          f"({stft_ms:.4f} ms) | {card}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import_port()
    from vv_dsp_tpu_torch.models import NorthStarChain

    card = device_phase()

    build_phase()
    torch.cuda.synchronize()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.standard_normal((CHANNELS, N_CHAIN)),
                         dtype=torch.float32, device=dev)
    xs = torch.as_tensor(rng.standard_normal((CHANNELS, N_STFT)),
                         dtype=torch.float32, device=dev)
    chain = NorthStarChain().to(dev)
    kernels = kernel_phase(xc, xs, chain)
    torch.cuda.synchronize()
    launches = slice_phase(xc, xs, chain, card)
    torch.cuda.synchronize()

    sources = {
        "upfirdn_banded": ("vv_dsp_tpu_torch/csrc/upfirdn.cu",
                           "vv_dsp_tpu/ops/pallas_upfirdn.py:141"),
        "stft_mfcc": ("vv_dsp_tpu_torch/csrc/stft.cu",
                      "vv_dsp_tpu/ops/pallas_fft.py:350"),
        "stft_spectrum": ("vv_dsp_tpu_torch/csrc/stft.cu",
                          "vv_dsp_tpu/ops/pallas_fft.py:589"),
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
