"""Analytic signal, instantaneous phase and frequency (counterpart of
``vv_dsp_tpu/ops/hilbert.py``; the reference's src/spectral/hilbert.c).

The analytic signal is ifft(fft(x) * mask) with the one-sided doubling
mask (src/spectral/hilbert.c:47-59):
  even n: keep DC and Nyquist, double bins 1..n/2-1, zero the negatives;
  odd  n: keep DC, double bins 1..(n-1)/2, zero the negatives.
Real input always takes the r2c/c2r factorization of that mask,
H[x] = irfft(-i * s * rfft(x)) (``_hilbert_mult``), through ``ops/fft.py``;
complex input the masked c2c transform.

The instantaneous phase replaces the reference's sequential accumulation
(src/spectral/hilbert.c:82-92) with wrap-free conj-product increments and
a cumulative sum. That sum is float32 over the whole signal, so on a long
signal its last bits depend on the summation order of the device's scan.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft


def _analytic_mask(n: int) -> np.ndarray:
    h = np.zeros(n, dtype=np.float64)
    h[0] = 1.0
    if n % 2 == 0:
        h[1:n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return h


@functools.lru_cache(maxsize=32)
def _hilbert_mult(n: int) -> np.ndarray:
    """One-sided multiplier s with H[x] = irfft(-i * s * rfft(x)): 1 on the
    strictly positive bins below Nyquist, 0 at DC (and at Nyquist for even
    n). ifft(fft(x) * mask) == x + i H[x] exactly."""
    s = np.zeros(n // 2 + 1, dtype=np.float64)
    s[1:(n + 1) // 2] = 1.0
    return s


@functools.lru_cache(maxsize=32)
def _const_on(kind: str, n: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The mask ("mask") or the one-sided multiplier ("mult") on `device`."""
    a = _analytic_mask(n) if kind == "mask" else _hilbert_mult(n)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _hilbert_pair(x: torch.Tensor):
    """(x in its compute dtype, H[x]) for real input, by rfft and irfft."""
    x = config.as_compute(x)
    n = x.shape[-1]
    xs = _fft.rfft(x)
    s = _const_on("mult", n, x.dtype, x.device)
    # -i * (re + i im) * s = (im * s) + i (-re * s)
    y = torch.complex(xs.imag * s, -xs.real * s)
    return x, _fft.irfft(y, n)


def hilbert_analytic(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal z = x + i H[x] of (..., n) -> complex (..., n)."""
    n = x.shape[-1]
    if x.is_complex():
        mask = _const_on("mask", n, x.real.dtype, x.device)
        return _fft.ifft(_fft.fft(x) * mask)
    xr, h = _hilbert_pair(x)
    return torch.complex(xr, h)


def instantaneous_phase(z: torch.Tensor) -> torch.Tensor:
    """Continuous phase by conj-product increments
    (vv_dsp_instantaneous_phase, src/spectral/hilbert.c:77-93)."""
    phi0 = torch.angle(z[..., :1])
    dphi = torch.angle(z[..., 1:] * torch.conj(z[..., :-1]))
    return torch.cat([phi0, phi0 + torch.cumsum(dphi, dim=-1)], dim=-1)


def instantaneous_frequency(phase: torch.Tensor, fs: float) -> torch.Tensor:
    """Hz from an unwrapped phase; out[0] = 0
    (vv_dsp_instantaneous_frequency, src/spectral/hilbert.c:95-113)."""
    d = torch.diff(phase, dim=-1) * (fs / (2.0 * math.pi))
    return torch.cat([torch.zeros_like(d[..., :1]), d], dim=-1)


def envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic| amplitude envelope; real input never forms the complex
    analytic signal (|z| = sqrt(x^2 + H[x]^2))."""
    if x.is_complex():
        return torch.abs(hilbert_analytic(x))
    xr, h = _hilbert_pair(x)
    return torch.sqrt(xr * xr + h * h)
