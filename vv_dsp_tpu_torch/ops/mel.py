"""Mel scale, filterbank and MFCC (the part of ``vv_dsp_tpu/ops/mel.py``
the north-star path uses).

The filterbank, DCT and lifter constants are copies of the JAX package's
numpy float64 builders. ``mfcc_stft`` goes through the fused STFT -> mel
-> log -> DCT kernel wrapper (ops/stft_kernels.py), wrapped so that its
gradient is the plain version's: a CPU tensor runs the plain version, a
CUDA tensor the kernel, which raises at a geometry it does not take.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops.dct import _dct2_matrix
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp


def hz_to_mel(hz, variant: str = "htk"):
    hz = np.maximum(np.asarray(hz, dtype=np.float64), 0.0)
    if variant == "htk":
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    if variant == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        lin = hz / f_sp
        log = min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep
        return np.where(hz >= min_log_hz, log, lin)
    raise ValueError("variant must be 'htk' or 'slaney'")


def mel_to_hz(mel, variant: str = "htk"):
    mel = np.maximum(np.asarray(mel, dtype=np.float64), 0.0)
    if variant == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    if variant == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        lin = mel * f_sp
        log = min_log_hz * np.exp(logstep * (mel - min_log_mel))
        return np.where(mel >= min_log_mel, log, lin)
    raise ValueError("variant must be 'htk' or 'slaney'")


@functools.lru_cache(maxsize=32)
def mel_filterbank_np(n_fft: int, n_mels: int, sample_rate: float,
                      fmin: float, fmax: float,
                      variant: str = "htk") -> np.ndarray:
    """(n_mels, n_fft//2+1) float64 area-normalized triangular filterbank
    (vv_dsp_mel_filterbank_create, mel.c:66-193)."""
    if fmax <= fmin or fmax > sample_rate / 2.0:
        raise ValueError("need fmin < fmax <= sample_rate/2")
    n_bins = n_fft // 2 + 1
    if n_mels >= n_bins:
        raise ValueError("n_mels must be < n_fft//2+1")
    mel_pts = np.linspace(hz_to_mel(fmin, variant), hz_to_mel(fmax, variant),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, variant)
    freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / n_fft

    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        li = np.searchsorted(freqs, left)
        ci = np.searchsorted(freqs, center)
        ri = np.searchsorted(freqs, right)
        ks = np.arange(li, min(ci, n_bins))
        fb[m, ks] = (freqs[ks] - left) / (center - left)
        ks = np.arange(ci, min(ri, n_bins))
        fb[m, ks] = (right - freqs[ks]) / (right - center)
        s = fb[m].sum()
        if s > 0:
            fb[m] /= s
    return fb


def _lifter_np(n_coeffs: int, lifter: float) -> np.ndarray:
    w = np.ones(n_coeffs, dtype=np.float64)
    if lifter > 0:
        i = np.arange(1, n_coeffs, dtype=np.float64)
        w[1:] = 1.0 + (lifter / 2.0) * np.sin(np.pi * i / lifter)
    return w


def mfcc_from_log_mel(log_mel: torch.Tensor, n_coeffs: int,
                      lifter: float = 0.0) -> torch.Tensor:
    """(..., frames, n_mels) -> (..., frames, n_coeffs): unnormalized
    DCT-II, keep the first K, sinusoidal liftering."""
    n_mels = log_mel.shape[-1]
    if n_coeffs > n_mels:
        raise ValueError("n_coeffs must be <= n_mels")
    dct = torch.as_tensor(_dct2_matrix(n_mels)[:n_coeffs], dtype=log_mel.dtype,
                          device=log_mel.device)
    lw = torch.as_tensor(_lifter_np(n_coeffs, float(lifter)),
                         dtype=log_mel.dtype, device=log_mel.device)
    return (log_mel @ dct.T) * lw


def mfcc_dct_np(n_mels: int, n_coeffs: int, lifter: float = 0.0) -> np.ndarray:
    """(n_coeffs, n_mels) float64 DCT-II rows with the lifter folded in, the
    matrix the fused kernel applies (vv_dsp_tpu/ops/pallas_fft.py::
    stft_mfcc_pallas)."""
    if n_coeffs > n_mels:
        raise ValueError("n_coeffs must be <= n_mels")
    return _dct2_matrix(n_mels)[:n_coeffs] * _lifter_np(
        n_coeffs, float(lifter))[:, None]


@functools.lru_cache(maxsize=16)
def _mel_constants(nfft: int, n_mels: int, sample_rate: float, fmin: float,
                   fmax: float, variant: str, window: str, window_param,
                   device: torch.device):
    """(window, filterbank, band edges) on `device`."""
    fb = mel_filterbank_np(nfft, n_mels, sample_rate, fmin, fmax, variant)
    return (torch.as_tensor(get_window_np(window, nfft, window_param),
                            dtype=torch.float32, device=device),
            torch.as_tensor(fb, dtype=torch.float32, device=device),
            torch.as_tensor(_sk.band_edges_np(fb), device=device))


@functools.lru_cache(maxsize=16)
def _mfcc_constants(nfft: int, n_mels: int, n_coeffs: int, sample_rate: float,
                    fmin: float, fmax: float, lifter: float, variant: str,
                    window: str, window_param, device: torch.device):
    """(window, filterbank, band edges, liftered DCT rows) on `device`."""
    dct = torch.as_tensor(mfcc_dct_np(n_mels, n_coeffs, lifter),
                          dtype=torch.float32, device=device)
    return _mel_constants(nfft, n_mels, sample_rate, fmin, fmax, variant,
                          window, window_param, device) + (dct,)


def mfcc_stft_with(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
                   mel_fb: torch.Tensor, bands: torch.Tensor,
                   dct: torch.Tensor | None, log_epsilon: float = 1e-10,
                   algorithm: str | None = None) -> torch.Tensor:
    """Signal -> MFCC from device constants: window (nfft,), mel_fb
    (n_mels, nfft//2+1) and dct (n_coeffs, n_mels) float32 tensors and the
    filterbank's band edges (``stft_kernels.band_edges_np``, int32) on x's
    device. (..., n) -> (..., frames, n_coeffs), or the mel energies
    (..., frames, n_mels) when dct is None."""
    x = config.as_compute(x)
    if x.is_complex():
        raise TypeError("mfcc_stft requires real input")
    if x.ndim != 2:
        lead = x.shape[:-1]
        y = mfcc_stft_with(x.reshape(-1, x.shape[-1]), nfft, hop, window,
                           mel_fb, bands, dct, log_epsilon, algorithm)
        return y.reshape(lead + y.shape[-2:])
    if x.dtype != torch.float32:
        x = x.float()
    return kernel_with_torch_vjp(
        lambda xv: _sk.stft_mfcc(xv, nfft, hop, window, mel_fb, bands, dct,
                                 log_epsilon, algorithm),
        lambda xv: _sk.stft_mfcc_plain(xv, nfft, hop, window, mel_fb, dct,
                                       log_epsilon, "f32"),
    )(x)


def mfcc_stft(x: torch.Tensor, nfft: int, hop: int, n_mels: int,
              n_coeffs: int, sample_rate: float, window: str = "hann",
              window_param=None, fmin: float = 0.0, fmax: float | None = None,
              log_epsilon: float = 1e-10, lifter: float = 0.0,
              variant: str = "htk",
              algorithm: str | None = None) -> torch.Tensor:
    """Signal -> MFCC: STFT power -> HTK mel -> log -> lifted DCT-II,
    (..., n) -> (..., frames, n_coeffs)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    win, fb, bands, dct = _mfcc_constants(
        nfft, n_mels, n_coeffs, float(sample_rate), float(fmin), float(fmax),
        float(lifter), variant, window, window_param, torch.device(x.device))
    return mfcc_stft_with(x, nfft, hop, win, fb, bands, dct, log_epsilon,
                          algorithm)


def mel_energies_stft(x: torch.Tensor, nfft: int, hop: int, n_mels: int,
                      sample_rate: float, window: str = "hann",
                      window_param=None, fmin: float = 0.0,
                      fmax: float | None = None, variant: str = "htk",
                      algorithm: str | None = None) -> torch.Tensor:
    """Signal -> STFT power -> mel energies, (..., n) -> (..., frames,
    n_mels): the MFCC kernel without its log and DCT."""
    if fmax is None:
        fmax = sample_rate / 2.0
    win, fb, bands = _mel_constants(nfft, n_mels, float(sample_rate),
                                    float(fmin), float(fmax), variant, window,
                                    window_param, torch.device(x.device))
    return mfcc_stft_with(x, nfft, hop, win, fb, bands, None,
                          algorithm=algorithm)
