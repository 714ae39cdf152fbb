"""The plain references against float64 NumPy/SciPy computed here at tiny
sizes, independently of the reference's own arithmetic, and the reference's
imports."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import signal

from h100bench.manifest import BENCH_DIR, ROOT
from h100bench.reference import common as C
from h100bench.reference import northstar_chain, stft_1024_256

CHAIN = json.loads((BENCH_DIR / "configs" / "northstar_chain.json"
                    ).read_text())["fields"]
STFT = json.loads((BENCH_DIR / "configs" / "stft_1024_256.json"
                   ).read_text())["fields"]


def _noise(c, n, seed=7):
    return np.random.default_rng(seed).standard_normal((c, n))


def _frames(y, nfft, hop):
    n = y.shape[-1]
    nf = 1 + (n - nfft + hop) // hop if n >= nfft else 1
    yp = np.pad(y, ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    return np.stack([yp[:, i * hop:i * hop + nfft] for i in range(nf)], 1)


def _chain_numpy(x):
    """lfilter -> scipy resample_poly -> framed rfft power -> HTK mel ->
    log -> DCT-II, float64, the mel bank by a loop of its own."""
    # the configuration's cutoff is a fraction of the sample rate, firwin's
    # of the Nyquist rate
    h = signal.firwin(CHAIN["fir_taps"], 2 * CHAIN["fir_cutoff"],
                      window="hamming", scale=False)
    h = h.astype(np.float32).astype(np.float64)
    y = signal.lfilter(h, [1.0], x, axis=-1)
    up, down = CHAIN["up"], CHAIN["down"]
    yr = signal.resample_poly(y, up, down, axis=-1)[:, :-(-x.shape[-1] * up
                                                          // down)]
    nfft, hop = CHAIN["nfft"], CHAIN["hop"]
    w = signal.get_window("hann", nfft, fftbins=False)
    pw = np.abs(np.fft.rfft(_frames(yr, nfft, hop) * w, axis=-1)) ** 2
    sr = CHAIN["sample_rate"] * up / down
    mel = lambda f: 2595 * np.log10(1 + f / 700)
    edges = 700 * (10 ** (np.linspace(0, mel(sr / 2), CHAIN["n_mels"] + 2)
                          / 2595) - 1)
    freqs = np.arange(nfft // 2 + 1) * sr / nfft
    fb = np.zeros((CHAIN["n_mels"], nfft // 2 + 1))
    for m in range(CHAIN["n_mels"]):
        lo, ce, hi = edges[m:m + 3]
        for k, f in enumerate(freqs):
            if lo <= f < ce:
                fb[m, k] = (f - lo) / (ce - lo)
            elif ce <= f < hi:
                fb[m, k] = (hi - f) / (hi - ce)
        fb[m] /= fb[m].sum()
    nm = CHAIN["n_mels"]
    dct = np.cos(np.pi * np.outer(np.arange(CHAIN["n_mfcc"]),
                                  np.arange(nm) + 0.5) / nm)
    return np.log(pw @ fb.T + 1e-10) @ dct.T


def test_lowpass_and_resample_filter_match_scipy():
    np.testing.assert_allclose(C.lowpass(1024, 0.45),
                               signal.firwin(1024, 0.9, window="hamming",
                                             scale=False), atol=1e-15)
    h = signal.firwin(81, 1 / 4, window=("kaiser", 5.0)) * 4
    np.testing.assert_allclose(C.resample_filter(4, 3), h, atol=1e-15)


def test_polyphase_matches_scipy():
    x = _noise(2, 3000)
    want = signal.resample_poly(x, 4, 3, axis=-1)
    got = C.polyphase(torch.as_tensor(x), 4, 3, 0, want.shape[-1]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_chain_matches_numpy():
    x = _noise(2, 9600)
    got = northstar_chain.call(CHAIN, torch.as_tensor(x)).numpy()
    want = _chain_numpy(x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_stream_matches_scipy():
    """The live stream's frames: the resampler's outputs run `latency`
    (16) behind the blocks, the framing nfft - hop behind the resampler,
    zeros before the signal."""
    x = _noise(2, 1536 * 6)
    got = northstar_chain.stream(CHAIN, torch.as_tensor(x), 1536).numpy()
    k = northstar_chain.Constants(CHAIN)
    h = signal.firwin(CHAIN["fir_taps"], 2 * CHAIN["fir_cutoff"],
                      window="hamming", scale=False)
    y = signal.lfilter(h.astype(np.float32).astype(np.float64), [1.0], x)
    hr = signal.firwin(81, 1 / 4, window=("kaiser", 5.0)) * 4
    full = signal.upfirdn(hr, y, 4, 1, axis=-1)
    t = 40 + 3 * (np.arange(x.shape[-1] * 4 // 3) - 16)
    ys = np.where(t >= 0, full[:, np.clip(t, 0, None)], 0.0)
    ys = np.pad(ys, ((0, 0), (k.nfft - k.hop, 0)))
    fr = _frames(ys, k.nfft, k.hop)[:, :got.shape[1]]
    want = k.mfcc(torch.as_tensor(fr)).numpy()
    assert got.shape == (2, 24, 20)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_stream_matches_the_port_on_the_cpu():
    from vv_dsp_tpu_torch.models import StreamingNorthStar
    x = torch.as_tensor(_noise(2, 1536 * 6), dtype=torch.float32)
    s = StreamingNorthStar()
    state = s.init((2,), device="cpu")
    outs = []
    for b in range(6):
        f, state = s.process(state, x[:, b * 1536:(b + 1) * 1536])
        outs.append(f)
    got = torch.cat(outs, -2).double()
    want = northstar_chain.stream(CHAIN, x, 1536)
    assert float((got - want).abs().max() / want.abs().max()) < 5e-6


def test_stft_matches_numpy():
    x = _noise(2, 5000)
    got = stft_1024_256.call(STFT, torch.as_tensor(x)).numpy()
    w = signal.get_window("hann", 1024, fftbins=False)
    want = np.fft.fft(_frames(x, 1024, 256) * w, axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_stft_control_is_coarse():
    x = torch.as_tensor(_noise(2, 5000))
    want = stft_1024_256.call(STFT, x)
    got = stft_1024_256.control_call(STFT, x.float())
    err = float((got.to(torch.complex128) - want).abs().max()
                / want.abs().max())
    assert 1e-4 < err < 5e-2


@pytest.mark.parametrize("mod", ["northstar_chain", "stft_1024_256",
                                 "common"])
def test_reference_imports_nothing_of_the_port(mod):
    code = (f"import sys; import h100bench.reference.{mod}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"vv_dsp_tpu_torch", "vv_dsp_tpu", "jax", "jaxlib",
                       "flax"}
