"""Chirp-Z transform by Bluestein's algorithm (counterpart of
``vv_dsp_tpu/ops/czt.py``; the reference's src/spectral/czt.c).

SciPy's convention (src/spectral/czt.h:11-13): X[k] = sum_n x[n] A^-n W^nk,
k in [0, M). Spiral contours (|W| != 1, |A| != 1) go through the
magnitude/angle decomposition of the reference (src/spectral/czt.c:84-111).

W and A are plan parameters (Python complex), so the input chirp
g[n] = A^-n W^(n^2/2), the FFT of the kernel b[i] = W^-((i-(N-1))^2/2) and
the output chirp W^(k^2/2) are built on the host in float64 numpy
(``_czt_tables``, cached per (N, M, W, A)) and copied to the device once
per dtype and device. On the device: a multiply, one c2c FFT of the
5-smooth length P >= N+M-1 (cuFFT on the card), a multiply by the kernel's
FFT, one inverse FFT and the output chirp.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops.fft import next_pow2


def czt_params_for_freq_range(f_start: float, f_end: float, m: int,
                              fs: float):
    """(W, A) for an M-point sweep of [f_start, f_end) Hz
    (vv_dsp_czt_params_for_freq_range, src/spectral/czt.c:20-38); the
    bins are (f_end - f_start)/M apart, the end point left out."""
    delta = (f_end - f_start) / float(m)
    w = np.exp(-2j * np.pi * delta / fs)
    a = np.exp(-2j * np.pi * f_start / fs)
    return complex(w), complex(a)


@functools.lru_cache(maxsize=64)
def next_fast_len(target: int) -> int:
    """Smallest 5-smooth length (2^a 3^b 5^c) >= target, the chirp
    convolution's length: it pads far less than next_pow2 (8197 -> 8640,
    not 16384)."""
    best = next_pow2(target)
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            q = f35           # the least power of two lifting f35 over target
            while q < target:
                q *= 2
            best = min(best, q)
            f35 *= 3
        f5 *= 5
    return best


@functools.lru_cache(maxsize=32)
def _czt_tables(n: int, m: int, w: complex, a: complex):
    """Float64 chirp constants of an (N, M, W, A) plan: (g, FFT of b,
    output chirp, P)."""
    arg_w = np.angle(complex(w))
    mag_w = abs(complex(w))

    def w_pow(e):  # W^e by magnitude and angle (czt.c:84-111)
        return (mag_w ** e) * np.exp(1j * arg_w * e)

    nn = np.arange(n, dtype=np.float64)
    g = (complex(a) ** (-nn)) * w_pow(0.5 * nn * nn)

    p = next_fast_len(n + m - 1)
    i = np.arange(n + m - 1, dtype=np.float64)
    b = np.zeros(p, dtype=np.complex128)
    mm = i - (n - 1)
    b[:n + m - 1] = w_pow(-0.5 * mm * mm)
    b_fft = np.fft.fft(b)

    kk = np.arange(m, dtype=np.float64)
    out_chirp = w_pow(0.5 * kk * kk)
    return g, b_fft, out_chirp, p


@functools.lru_cache(maxsize=32)
def _tables_on(n: int, m: int, w: complex, a: complex, dtype: torch.dtype,
               device: torch.device):
    """(g, FFT of b, output chirp) as `dtype` tensors on `device`, and P."""
    g, b_fft, chirp, p = _czt_tables(n, m, w, a)
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in (g, b_fft, chirp)) + (p,)


def czt(x: torch.Tensor, m: int, w: complex,
        a: complex = 1.0 + 0.0j) -> torch.Tensor:
    """Chirp-Z transform of (..., N) -> (..., M) complex
    (vv_dsp_czt_exec_cpx / _real, src/spectral/czt.c:40-178); real input is
    promoted to complex."""
    n = x.shape[-1]
    m = int(m)
    real = x.real.dtype if x.is_complex() else x.dtype
    cdt = config.complex_for_real(real)
    g, b_fft, chirp, p = _tables_on(n, m, complex(w), complex(a), cdt,
                                    x.device)
    ax = x.to(cdt) * g
    c = _fft.ifft(_fft.fft(ax, n=p) * b_fft)
    return c[..., n - 1:n - 1 + m] * chirp


def czt_range(x: torch.Tensor, f_start: float, f_end: float, m: int,
              fs: float) -> torch.Tensor:
    """Frequency-zoom form of ``czt``."""
    w, a = czt_params_for_freq_range(f_start, f_end, m, fs)
    return czt(x, m, w, a)
