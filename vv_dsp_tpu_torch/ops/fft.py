"""FFT wrappers on ``torch.fft`` (the public ``fft``/``rfft``/``ifft``/
``irfft`` of ``vv_dsp_tpu/ops/fft.py`` that the plain STFT paths use), and
copies of the host functions that make its DFT bases, which the
framing-free STFT parts (``STFT.power_parts``, ``reconstruct_parts``)
multiply by.

Scaling follows the JAX package: forward unscaled, inverse 1/n. Its matmul-DFT,
four-step, CT3 and Bluestein tiers exist to work around the TPU and are
not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def fft(x: torch.Tensor, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """Complex-to-complex forward FFT, unscaled (real input is promoted)."""
    return torch.fft.fft(x, n=n, dim=axis)


def rfft(x: torch.Tensor, n: int | None = None,
         axis: int = -1) -> torch.Tensor:
    """Real-to-complex FFT: n real -> n//2+1 Hermitian-packed bins."""
    if x.is_complex():
        raise TypeError("rfft requires real input; use fft() for complex")
    return torch.fft.rfft(x, n=n, dim=axis)


def ifft(x: torch.Tensor, n: int | None = None,
         axis: int = -1) -> torch.Tensor:
    """Complex-to-complex inverse FFT, scaled by 1/n."""
    return torch.fft.ifft(x, n=n, dim=axis)


def irfft(x: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Complex-to-real inverse of n//2+1 Hermitian-packed bins, 1/n scaled;
    n is the plan size, as in the reference's C2R. The imaginary parts of
    the DC and (even n) Nyquist bins are ignored."""
    return torch.fft.irfft(x, n=n, dim=axis)


@functools.lru_cache(maxsize=8)
def _dft_basis(n: int, kind: str) -> np.ndarray:
    """Float64 DFT basis matrices, cast at use site (a copy of the JAX
    package's ``ops/fft.py::_dft_basis``, the kinds the STFT parts use).

    kind: 'r2c' -> (n, n//2+1) complex exp(-2i pi jk/n); 'c2r' ->
    (n//2+1, n) complex such that x = real(X_packed @ M), with the 1/n
    scaling and the Hermitian double weights folded in.
    """
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n // 2 + 1, dtype=np.float64)
    if kind == "r2c":
        return np.exp(-2j * np.pi * np.outer(j, k) / n)
    if kind == "c2r":
        # x[j] = (1/n) sum_k w_k Re(X[k] e^{+2i pi jk/n}), w = 1 except
        # double for the bins with a mirrored Hermitian partner
        w = np.full(n // 2 + 1, 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        return (w[:, None] / n) * np.exp(2j * np.pi * np.outer(k, j) / n)
    raise ValueError(kind)


@functools.lru_cache(maxsize=16)
def _basis_cast(n: int, kind: str, part: str, dtype_name: str) -> np.ndarray:
    """The real ("re") or imaginary part of ``_dft_basis(n, kind)``, cast
    once on the host to `dtype_name` and cached."""
    b = _dft_basis(n, kind)
    b = b.real if part == "re" else b.imag
    return np.ascontiguousarray(b).astype(np.dtype(dtype_name))
