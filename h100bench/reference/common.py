"""Float64 building blocks of the plain references: windows, filter designs,
linear convolution, polyphase resampling, framing, the mel filterbank and
the DCT-II rows.

Every constant is worked out here again from the configuration's fields, by
the published formulas; nothing is taken from the program under test. The
constants are numpy float64, the signal arithmetic plain torch float64 on
whatever device the signal lies on (the card on the chip, the CPU in the
tests). This module imports numpy and torch only.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def window(name: str, n: int) -> np.ndarray:
    """Symmetric window of n points (the denominator is n - 1)."""
    k = np.arange(n, dtype=np.float64)
    if name in ("hann", "hanning"):
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))
    raise ValueError(f"reference has no window {name!r}")


def lowpass(taps: int, cutoff: float) -> np.ndarray:
    """Windowed-sinc lowpass, Hamming window, cutoff as a fraction of the
    sample rate (scipy's firwin at 2 * cutoff): 2 fc sinc(2 fc m)."""
    m = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    return 2.0 * cutoff * np.sinc(2.0 * cutoff * m) * window("hamming", taps)


def resample_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly's default filter: firwin of
    2 * 10 * max(up, down) + 1 taps at cutoff 1 / max(up, down) with a
    Kaiser(5.0) window, scaled to unit DC gain, times up."""
    max_rate = max(up, down)
    half = 10 * max_rate
    n = np.arange(2 * half + 1, dtype=np.float64) - half
    h = np.sinc(n / max_rate) / max_rate * np.kaiser(2 * half + 1, 5.0)
    return h / h.sum() * up


def reduce_ratio(up: int, down: int) -> tuple[int, int]:
    g = math.gcd(up, down)
    return up // g, down // g


def convolve(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Full linear convolution along the last axis, (..., n) -> (...,
    n + len(h) - 1), by zero-padded FFTs in float64."""
    n_full = x.shape[-1] + len(h) - 1
    size = 1 << (n_full - 1).bit_length()
    hx = torch.as_tensor(h, dtype=torch.float64, device=x.device)
    y = torch.fft.irfft(torch.fft.rfft(x.double(), size)
                        * torch.fft.rfft(hx, size), size)
    return y[..., :n_full]


def causal_fir(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """y[n] = sum_u h[u] x[n - u], zero history, cut to x's length."""
    return convolve(x, h)[..., :x.shape[-1]]


def polyphase(x: torch.Tensor, up: int, down: int, first: int,
              count: int) -> torch.Tensor:
    """Outputs first .. first + count - 1 of the polyphase resampler of
    scipy.signal.resample_poly(x, up, down): output o is
    full[half + o * down], full = zero-stuff(x, up) convolved with the
    default filter (half its half length), and 0 where that index falls
    outside full (a negative o reads the zeros before the signal)."""
    h = resample_filter(up, down)
    half = (len(h) - 1) // 2
    stuffed = torch.zeros(x.shape[:-1] + (x.shape[-1] * up,),
                          dtype=torch.float64, device=x.device)
    stuffed[..., ::up] = x
    full = convolve(stuffed, h)
    t = half + (first + torch.arange(count, device=x.device)) * down
    ok = (t >= 0) & (t < full.shape[-1])
    out = full[..., t.clamp(0, full.shape[-1] - 1)]
    return torch.where(ok, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))


def num_frames(n: int, nfft: int, hop: int) -> int:
    """Frames of a non-centred STFT whose last frame is zero-padded."""
    return 1 if n < nfft else 1 + (n - nfft + hop) // hop


def frames(x: torch.Tensor, nfft: int, hop: int, nf: int) -> torch.Tensor:
    """(..., n) -> (..., nf, nfft): frame f is x[f hop : f hop + nfft],
    zero past the end."""
    need = (nf - 1) * hop + nfft
    if need > x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, nfft, hop)[..., :nf, :]


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0)
                    - 1.0)


def mel_filterbank(nfft: int, n_mels: int, sample_rate: float, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_mels, nfft // 2 + 1) HTK triangles on the FFT bin frequencies,
    each row scaled to unit sum (area-normalised)."""
    n_bins = nfft // 2 + 1
    hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / nfft
    fb = np.zeros((n_mels, n_bins))
    for m in range(n_mels):
        left, centre, right = hz[m], hz[m + 1], hz[m + 2]
        rise = (freqs >= left) & (freqs < centre)
        fall = (freqs >= centre) & (freqs < right)
        fb[m, rise] = (freqs[rise] - left) / (centre - left)
        fb[m, fall] = (right - freqs[fall]) / (right - centre)
        if fb[m].sum() > 0:
            fb[m] /= fb[m].sum()
    return fb


def dct2(n_mels: int, n_coeffs: int) -> np.ndarray:
    """(n_coeffs, n_mels) unnormalised DCT-II rows,
    cos(pi (m + 1/2) k / n_mels)."""
    k = np.arange(n_coeffs, dtype=np.float64)[:, None]
    m = np.arange(n_mels, dtype=np.float64)[None, :]
    return np.cos(np.pi * (m + 0.5) * k / n_mels)


def mfcc_of_frames(fr: torch.Tensor, win: np.ndarray, fb: np.ndarray,
                   dct: np.ndarray, log_eps: float) -> torch.Tensor:
    """Windowed frames (..., nf, nfft) -> MFCCs (..., nf, n_coeffs):
    |rfft|^2, the mel products, log(. + eps), the DCT rows."""
    dev = fr.device
    spec = torch.fft.rfft(fr * torch.as_tensor(win, device=dev))
    power = spec.real.square() + spec.imag.square()
    mel = power @ torch.as_tensor(fb.T, device=dev)
    return torch.log(mel + log_eps) @ torch.as_tensor(dct.T, device=dev)


class MaxError:
    """The number a comparison reports, accumulated over blocks of rows:
    ``err_of_scale``, the largest |got - want| over the largest |want|."""

    def __init__(self):
        self.err = 0.0
        self.scale = 0.0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        got = got.to(want.device)
        got = got.to(torch.complex128 if got.is_complex() else torch.float64)
        err = float((got - want).abs().max())
        # a NaN answer reads as an infinite error, never as none
        self.err = math.inf if math.isnan(err) else max(self.err, err)
        self.scale = max(self.scale, float(want.abs().max()))

    def numbers(self) -> dict:
        return {"err_of_scale": self.err / self.scale}
