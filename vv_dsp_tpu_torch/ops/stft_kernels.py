"""The port's forward STFT kernels, with their plain versions: the windowed
packed-real STFT spectrum, the one-sided power spectrogram and the fused
STFT -> mel -> log -> DCT (MFCC) front end (the parts of
``vv_dsp_tpu/ops/pallas_fft.py`` behind ``stft_spectrum_packed``,
``stft_power_packed`` and ``stft_mfcc_pallas`` /
``stft_mel_energies_pallas``).

Frame f covers x[f*hop, f*hop + nfft), zero-padded past the signal, and a
signal of n samples has ``stft_num_frames(n, nfft, hop)`` frames. On a CUDA
tensor ``stft_spectrum`` and ``stft_mfcc`` launch the kernels in
``csrc/stft.cu``, or raise; on a CPU tensor they run the plain versions
(framing, window, ``torch.fft``, matmuls at the same tier). The same holds
for ``stft_power``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops.framing import frames_strided, stft_num_frames


def stft_supported(nfft: int, hop: int) -> bool:
    """Geometry the kernels take: power-of-two nfft in [256, 4096] (the
    m = nfft/2 complex frame, its powers and the mel row fit shared memory
    with room), 0 < hop <= nfft. The JAX kernels' hop % 16 condition keeps
    TPU sublanes aligned and has no counterpart here."""
    return (256 <= nfft <= 4096 and nfft & (nfft - 1) == 0
            and 0 < hop <= nfft)


@functools.lru_cache(maxsize=16)
def _fft_tables(nfft: int, device: torch.device):
    """(tw (m/2, 2), wk (m+1, 2)) float32 (cos, sin) tables, built in
    float64: tw[k] = exp(-2 pi i k / m) for the m-point butterflies and
    wk[k] = exp(-2 pi i k / nfft) for the Hermitian unpack."""
    m = nfft // 2
    a = -2.0 * np.pi * np.arange(m // 2) / m
    b = -2.0 * np.pi * np.arange(m + 1) / nfft
    tw = np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)
    wk = np.stack([np.cos(b), np.sin(b)], axis=-1).astype(np.float32)
    return (torch.as_tensor(tw, device=device),
            torch.as_tensor(wk, device=device))


def _check_signal(x: torch.Tensor, window: torch.Tensor, nfft: int,
                  hop: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{name} expects (channels, n)")
    _build.require(x, "x", x.device)
    _build.require(window, "window", x.device, (nfft,))
    if not stft_supported(nfft, hop):
        raise ValueError(f"{name}: unsupported geometry nfft={nfft} "
                         f"hop={hop}; check stft_supported()")
    if not 0 < x.shape[0] <= 65535:
        raise ValueError(f"channels must be in [1, 65535], got {x.shape[0]}")


def stft_spectrum_plain(x: torch.Tensor, nfft: int, hop: int,
                        window: torch.Tensor,
                        onesided: bool = False) -> torch.Tensor:
    """Windowed STFT: (..., n) -> (..., frames, nfft) complex, or
    (..., frames, nfft//2+1) when onesided (real input only)."""
    nf = stft_num_frames(x.shape[-1], nfft, hop)
    frames = frames_strided(x, nfft, hop, nf) * window
    if onesided:
        return _fft.rfft(frames)
    return _fft.fft(frames)


def stft_spectrum(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
                  onesided: bool = False) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft) complex64 (two-sided, the
    Hermitian mirror written by the kernel) or (c, frames, nfft//2+1)."""
    if x.device.type == "cpu":
        return stft_spectrum_plain(x, nfft, hop, window, onesided)
    _check_signal(x, window, nfft, hop, "stft_spectrum")
    c, n = x.shape
    nf = stft_num_frames(n, nfft, hop)
    bins = nfft // 2 + 1 if onesided else nfft
    out = torch.empty((c, nf, bins), dtype=torch.complex64, device=x.device)
    tw, wk = _fft_tables(nfft, x.device)
    err = _build.library().vv_stft_spectrum(
        _build.ptr(x), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(out), c, n, nf, nfft, hop, bins, x.device.index,
        _build.stream_handle(x))
    _build.check(err, "stft_spectrum")
    stft_spectrum.launches += 1
    return out


stft_spectrum.launches = 0


def stft_power_plain(x: torch.Tensor, nfft: int, hop: int,
                     window: torch.Tensor) -> torch.Tensor:
    """|rfft(w * frame)|^2: (..., n) -> (..., frames, nfft//2+1), natural
    bin order (real input only)."""
    spec = stft_spectrum_plain(x, nfft, hop, window, onesided=True)
    return spec.real * spec.real + spec.imag * spec.imag


def stft_power(x: torch.Tensor, nfft: int, hop: int,
               window: torch.Tensor) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft//2+1) float32 one-sided power in
    one kernel pass on a CUDA tensor: the complex spectrum never leaves
    shared memory."""
    if x.device.type == "cpu":
        return stft_power_plain(x, nfft, hop, window)
    _check_signal(x, window, nfft, hop, "stft_power")
    c, n = x.shape
    nf = stft_num_frames(n, nfft, hop)
    out = torch.empty((c, nf, nfft // 2 + 1), dtype=torch.float32,
                      device=x.device)
    tw, wk = _fft_tables(nfft, x.device)
    err = _build.library().vv_stft_power(
        _build.ptr(x), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(out), c, n, nf, nfft, hop, x.device.index,
        _build.stream_handle(x))
    _build.check(err, "stft_power")
    stft_power.launches += 1
    return out


stft_power.launches = 0


def stft_mfcc_plain(x: torch.Tensor, nfft: int, hop: int,
                    window: torch.Tensor, mel_fb: torch.Tensor,
                    dct: torch.Tensor | None = None, log_eps: float = 1e-10,
                    algorithm: str | None = None) -> torch.Tensor:
    """rfft -> |X|^2 -> mel (-> log(. + log_eps) -> DCT rows when dct is
    given): (..., n) -> (..., frames, n_mfcc) or (..., frames, n_mels).
    mel_fb: (n_mels, nfft//2+1); dct: (n_mfcc, n_mels), lifter folded in."""
    spec = stft_spectrum_plain(x, nfft, hop, window, onesided=True)
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = config.tier_matmul(power, mel_fb.T, algorithm)
    if dct is None:
        return mel
    return config.tier_matmul(torch.log(mel + log_eps), dct.T, algorithm)


def band_edges_np(mel_fb) -> np.ndarray:
    """(2, n_mels) int32 rows [lo; hi): per mel row of a host filterbank,
    the bin range around its nonzero weights (an all-zero row gets an empty
    range). Built once beside the filterbank; the MFCC kernel sums each
    band over its range only."""
    nz = np.asarray(mel_fb) != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, nz.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return np.stack([lo, hi]).astype(np.int32)


def stft_mfcc(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
              mel_fb: torch.Tensor, bands: torch.Tensor,
              dct: torch.Tensor | None = None, log_eps: float = 1e-10,
              algorithm: str | None = None) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, n_mfcc) MFCCs, or (c, frames, n_mels)
    mel energies when dct is None, in one kernel pass on a CUDA tensor: the
    frames, spectrum and power stay in shared memory. bands: mel_fb's
    ``band_edges_np`` on x's device (the plain version does not need it)."""
    algorithm = config.dot_algorithm(algorithm)
    if x.device.type == "cpu":
        return stft_mfcc_plain(x, nfft, hop, window, mel_fb, dct, log_eps,
                               algorithm)
    _check_signal(x, window, nfft, hop, "stft_mfcc")
    n_mels = mel_fb.shape[0]
    _build.require(mel_fb, "mel_fb", x.device, (n_mels, nfft // 2 + 1))
    _build.require(bands, "bands", x.device, (2, n_mels), torch.int32)
    n_out = n_mels
    if dct is not None:
        n_out = dct.shape[0]
        _build.require(dct, "dct", x.device, (n_out, n_mels))
    c, n = x.shape
    nf = stft_num_frames(n, nfft, hop)
    out = torch.empty((c, nf, n_out), dtype=torch.float32, device=x.device)
    tw, wk = _fft_tables(nfft, x.device)
    err = _build.library().vv_stft_mfcc(
        _build.ptr(x), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(mel_fb), _build.ptr(bands[0]), _build.ptr(bands[1]),
        _build.ptr(dct if dct is not None else mel_fb), _build.ptr(out), c,
        n, nf, nfft, hop, n_mels, n_out, float(log_eps),
        config.ALGORITHMS.index(algorithm), int(dct is not None),
        x.device.index,
        _build.stream_handle(x))
    _build.check(err, "stft_mfcc")
    stft_mfcc.launches += 1
    return out


stft_mfcc.launches = 0
