"""Mel scale, filterbank and MFCC (counterpart of ``vv_dsp_tpu/ops/mel.py``:
the fused signal -> MFCC entry points, and the power-spectrogram and
power-parts forms, which are plain matrix products and logs).

The filterbank, DCT and lifter constants are copies of the JAX package's
numpy float64 builders. ``mfcc_stft`` goes through the fused STFT -> mel
-> log -> DCT kernel wrapper (ops/stft_kernels.py, or
ops/stockham_kernels.py on the JAX package's full-nfft route), wrapped
so that its gradient is the plain version's: a CPU tensor runs the plain
version, a CUDA tensor the kernel. Where neither kernel takes the
geometry (``mel_route``), it runs the plain version on any device, as the
JAX package runs XLA there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops import stockham_kernels as _stk
from vv_dsp_tpu_torch.ops.dct import _dct2_matrix
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp
from vv_dsp_tpu_torch.utils.shapes import collapse_leading


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
    dct, lw = _dct_lifter_on(n_mels, n_coeffs, float(lifter), log_mel.dtype,
                             log_mel.device)
    return (log_mel @ dct.T) * lw


@functools.lru_cache(maxsize=16)
def _dct_lifter_on(n_mels: int, n_coeffs: int, lifter: float,
                   dtype: torch.dtype, device: torch.device):
    """(DCT-II rows, lifter weights) on `device`, copied once."""
    return (torch.as_tensor(_dct2_matrix(n_mels)[:n_coeffs], dtype=dtype,
                            device=device),
            torch.as_tensor(_lifter_np(n_coeffs, lifter), dtype=dtype,
                            device=device))


@functools.lru_cache(maxsize=16)
def _filterbank_on(n_fft: int, n_mels: int, sample_rate: float, fmin: float,
                   fmax: float, variant: str, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The (n_mels, n_fft//2+1) filterbank on `device`, copied once."""
    return torch.as_tensor(mel_filterbank_np(n_fft, n_mels, sample_rate, fmin,
                                             fmax, variant),
                           dtype=dtype, device=device)


def _filterbank_like(t: torch.Tensor, n_fft: int, n_mels: int,
                     sample_rate: float, fmin: float, fmax: float | None,
                     variant: str) -> torch.Tensor:
    """The filterbank in t's dtype on t's device."""
    if fmax is None:
        fmax = sample_rate / 2.0
    return _filterbank_on(n_fft, n_mels, float(sample_rate), float(fmin),
                          float(fmax), variant, t.dtype, t.device)


def log_mel_spectrogram(power_spec: torch.Tensor, n_fft: int, n_mels: int,
                        sample_rate: float, fmin: float = 0.0,
                        fmax: float | None = None, log_epsilon: float = 1e-10,
                        variant: str = "htk") -> torch.Tensor:
    """(..., frames, n_fft//2+1) power -> (..., frames, n_mels) log-mel
    (vv_dsp_compute_log_mel_spectrogram, mel.c:204-245)."""
    fb = _filterbank_like(power_spec, n_fft, n_mels, sample_rate, fmin, fmax,
                          variant)
    return torch.log(power_spec @ fb.T + log_epsilon)


def mel_energies_from_power_parts(re: torch.Tensor, im: torch.Tensor,
                                  n_fft: int, n_mels: int,
                                  sample_rate: float, fmin: float = 0.0,
                                  fmax: float | None = None,
                                  variant: str = "htk") -> torch.Tensor:
    """Mel energies from the (re, im) rfft parts (``STFT.power_parts``):
    the projection is linear in the power, so mel_e = (re*re) @ fb.T +
    (im*im) @ fb.T, with no power array."""
    fb = _filterbank_like(re, n_fft, n_mels, sample_rate, fmin, fmax,
                          variant)
    return (re * re) @ fb.T + (im * im) @ fb.T


def mfcc_from_power_parts(re: torch.Tensor, im: torch.Tensor, n_fft: int,
                          n_mels: int, n_coeffs: int, sample_rate: float,
                          fmin: float = 0.0, fmax: float | None = None,
                          log_epsilon: float = 1e-10, lifter: float = 0.0,
                          variant: str = "htk") -> torch.Tensor:
    """MFCC from the (re, im) rfft parts: ``mfcc`` of re*re + im*im, the
    power never formed."""
    mel_e = mel_energies_from_power_parts(re, im, n_fft, n_mels, sample_rate,
                                          fmin, fmax, variant)
    return mfcc_from_log_mel(torch.log(mel_e + log_epsilon), n_coeffs,
                             lifter)


def mfcc(power_spec: torch.Tensor, n_fft: int, n_mels: int, n_coeffs: int,
         sample_rate: float, fmin: float = 0.0, fmax: float | None = None,
         log_epsilon: float = 1e-10, lifter: float = 0.0,
         variant: str = "htk") -> torch.Tensor:
    """MFCC plan execute (vv_dsp_mfcc_init/process, mel.c:314-463): power
    spectrogram -> log-mel -> DCT-II -> lifter."""
    lm = log_mel_spectrogram(power_spec, n_fft, n_mels, sample_rate, fmin,
                             fmax, log_epsilon, variant)
    return mfcc_from_log_mel(lm, n_coeffs, lifter)


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


def mel_route(nfft: int, hop: int) -> str:
    """The fused mel/MFCC route: "full_nfft" where the JAX package takes
    its full-nfft kernel (``stockham_kernels.takes_stockham``), "packed"
    where the packed kernel takes the geometry, else "torch"."""
    if _stk.takes_stockham(nfft, hop):
        return "full_nfft"
    return "packed" if _sk.stft_supported(nfft, hop) else "torch"


def mfcc_stft_with(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
                   mel_fb: torch.Tensor, bands: torch.Tensor,
                   dct: torch.Tensor | None, log_epsilon: float = 1e-10,
                   algorithm: str | None = None) -> torch.Tensor:
    """Signal -> MFCC from device constants: window (nfft,), mel_fb
    (n_mels, nfft//2+1) and dct (n_coeffs, n_mels) float32 tensors and the
    filterbank's band edges (``stft_kernels.band_edges_np``, int32) on x's
    device. (..., n) -> (..., frames, n_coeffs), or the mel energies
    (..., frames, n_mels) when dct is None. Where the JAX package takes its
    full-nfft kernel (``stockham_kernels.takes_stockham``: nfft = 128, or
    hop = 8) the port does too, and the contractions are float32 whatever
    `algorithm` names, as there; the packed kernel honours it; the "torch"
    route (``mel_route``) runs its products at the knob's tier, as the
    JAX package's XLA route does."""
    x = config.as_compute(x)
    if x.is_complex():
        raise TypeError("mfcc_stft requires real input")
    restore = None
    if x.ndim != 2:
        x, restore = collapse_leading(x)
    x = x.float().contiguous()   # the kernels take contiguous rows
    route = mel_route(nfft, hop)
    if route == "torch":
        y = _sk.stft_mfcc_plain(x, nfft, hop, window, mel_fb, dct,
                                log_epsilon, None)
    else:
        if route == "full_nfft":
            # the JAX package's full-nfft route takes no tier: float32
            fast = lambda xv: _stk.stft_mel_stockham(xv, nfft, hop, window,
                                                     mel_fb, bands, dct,
                                                     log_epsilon)
        else:
            fast = lambda xv: _sk.stft_mfcc(xv, nfft, hop, window, mel_fb,
                                            bands, dct, log_epsilon,
                                            algorithm)
        y = kernel_with_torch_vjp(
            fast,
            lambda xv: _sk.stft_mfcc_plain(xv, nfft, hop, window, mel_fb, dct,
                                           log_epsilon, "f32"),
        )(x)
    return y if restore is None else restore(y, 2)


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
