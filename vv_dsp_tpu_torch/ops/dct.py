"""DCT-II / DCT-III / DCT-IV (counterpart of ``vv_dsp_tpu/ops/dct.py``,
the conventions of src/spectral/dct.c:18-68):

- DCT-II  forward : X[k] = sum_n x[n] cos(pi (n+0.5) k / N)
- DCT-II  backward: x[n] = (2/N)(0.5 X[0] + sum_{k>=1} X[k] cos(pi k (n+0.5)/N))
- DCT-III forward : Y[k] = x[0] + 2 sum_{n>=1} x[n] cos(pi k (n+0.5)/N)
- DCT-III backward: the DCT-II backward (the reference's inverse pair)
- DCT-IV          : self-inverse; backward scaled by 2/N

The JAX package's split is kept: cosine-matrix products (host float64
tables, the knob's tier, ``config.tier_matmul``) below 4096 points or at
a size that is not a power of two, the rfft form (Makhoul 1980) for
DCT-II forward and backward at powers of two from 4096.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.utils.nan_policy import NanPolicy, apply_nan_policy

# from this size (powers of two only) DCT-II forward and backward take rfft
_FFT_THRESHOLD = 4096


@functools.lru_cache(maxsize=64)
def _dct2_matrix(n: int) -> np.ndarray:
    """M[k, m] = cos(pi (m+0.5) k / n), float64."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (m + 0.5) * k / n)


@functools.lru_cache(maxsize=64)
def _dct4_matrix(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (m + 0.5) * (k + 0.5) / n)


def _matmul(x: torch.Tensor, mat_np: np.ndarray) -> torch.Tensor:
    """x @ mat.T over the last axis, at the knob's tier."""
    mat = torch.as_tensor(mat_np.T, dtype=x.dtype, device=x.device)
    return config.tier_matmul(x, mat, None)


def _fft_form(n: int) -> bool:
    return n >= _FFT_THRESHOLD and n & (n - 1) == 0


def _dct2_fft(x: torch.Tensor) -> torch.Tensor:
    """DCT-II by the even-reordering rfft identity (Makhoul 1980)."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    spec = _fft.rfft(v)
    k = np.arange(n // 2 + 1, dtype=np.float64)
    tw = torch.as_tensor(np.exp(-1j * np.pi * k / (2.0 * n)),
                         dtype=spec.dtype, device=x.device)
    half = spec * tw
    # X[k] = Re(half[k]); X[n - k] = -Im(half[k])
    tail = -half.imag[..., 1:(n + 1) // 2].flip(-1)
    return torch.cat([half.real[..., :n // 2 + 1], tail], dim=-1)


def _idct2_fft(X: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_dct2_fft`` (the 2/N-weighted DCT-II backward): rebuild
    the half spectrum from the packed outputs, undo the quarter-sample
    twiddle, irfft, undo the even/odd reordering."""
    n = X.shape[-1]
    h = n // 2
    head = X[..., :h + 1]
    zero = torch.zeros_like(X[..., :1])
    im = torch.cat([zero, -X[..., h + 1:].flip(-1)]
                   + ([zero] if n % 2 == 0 else []), dim=-1)
    half = torch.complex(head, im).to(config.complex_for_real(X.dtype))
    k = np.arange(h + 1, dtype=np.float64)
    spec = half * torch.as_tensor(np.exp(1j * np.pi * k / (2.0 * n)),
                                  dtype=half.dtype, device=X.device)
    if n % 2 == 0:
        # Nyquist: only Re survived packing; the bin is real, X[h] sqrt(2)
        spec = torch.cat([spec[..., :h], (head[..., h:] * np.sqrt(2.0)).to(
            spec.dtype)], dim=-1)
    v = _fft.irfft(spec, n)
    ne = (n + 1) // 2
    out = torch.empty_like(v)
    out[..., ::2] = v[..., :ne]
    out[..., 1::2] = v[..., ne:].flip(-1)
    return out


def dct2_forward(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if _fft_form(n):
        return _dct2_fft(x)
    return _matmul(x, _dct2_matrix(n))


@functools.lru_cache(maxsize=64)
def _dct2_backward_matrix(n: int) -> np.ndarray:
    """x[m] = sum_k w_k X[k] cos(pi k (m+0.5)/N), w_0 = 1/N, else 2/N, as
    the rows of a matrix applied like the forward ones."""
    w = np.full(n, 2.0 / n)
    w[0] = 1.0 / n
    return np.ascontiguousarray((_dct2_matrix(n) * w[:, None]).T)


def dct2_backward(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if _fft_form(n):
        return _idct2_fft(x)
    return _matmul(x, _dct2_backward_matrix(n))


@functools.lru_cache(maxsize=64)
def _dct3_matrix(n: int) -> np.ndarray:
    mat = 2.0 * _dct2_matrix(n)
    mat[:, 0] = 1.0
    return mat


def dct3_forward(x: torch.Tensor) -> torch.Tensor:
    """Y[k] = x[0] + 2 sum_{n>=1} x[n] cos(pi k (n+0.5)/N), the reference's
    formula with the unit weight on x[0] (src/spectral/dct.c:46-55): the
    transpose of the DCT-II backward's matrix, so it stays a product."""
    return _matmul(x, _dct3_matrix(x.shape[-1]))


def dct3_backward(x: torch.Tensor) -> torch.Tensor:
    """The reference inverts DCT-III with the DCT-II backward
    (src/spectral/dct.c:112-119)."""
    return dct2_backward(x)


def dct4(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    n = x.shape[-1]
    y = _matmul(x, _dct4_matrix(n))
    return y * (2.0 / n) if inverse else y


def dct(x: torch.Tensor, type: int = 2, inverse: bool = False,
        nan_policy: NanPolicy = NanPolicy.PROPAGATE) -> torch.Tensor:
    """Plan-free DCT execute (vv_dsp_dct_execute,
    src/spectral/dct.c:86-136): x (..., n) real; the NaN policy applies to
    the input and the output."""
    x = apply_nan_policy(x, nan_policy)
    if type == 2:
        y = dct2_backward(x) if inverse else dct2_forward(x)
    elif type == 3:
        y = dct3_backward(x) if inverse else dct3_forward(x)
    elif type == 4:
        y = dct4(x, inverse=inverse)
    else:
        raise ValueError("DCT type must be 2, 3, or 4")
    return apply_nan_policy(y, nan_policy)
