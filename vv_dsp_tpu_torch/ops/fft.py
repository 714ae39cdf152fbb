"""FFT wrappers on ``torch.fft`` (counterpart of
``vv_dsp_tpu/ops/fft.py``): ``fft``/``rfft``/``ifft``/``irfft``,
``rfft_power``, ``hermitian_expand``, the shifts, phase wrap and unwrap,
``next_pow2``, the backend switch, and copies of the host functions that
make its DFT bases, which the framing-free STFT parts
(``STFT.power_parts``, ``reconstruct_parts``) multiply by.

Scaling follows the JAX package: forward unscaled, inverse 1/n. Its
matmul-DFT, four-step, CT3 and Bluestein tiers exist to work around the
TPU and are not ported, so the backend switch knows one backend,
"torch" (``torch.fft``: cuFFT on the card).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


_BACKENDS = ("torch",)
_BACKEND = "torch"


def set_fft_backend(name: str) -> None:
    """Runtime backend switch (vv_dsp_fft_set_backend parity); the port
    has one backend, "torch"."""
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"unknown FFT backend {name!r}; one of {_BACKENDS}")
    _BACKEND = name


def get_fft_backend() -> str:
    return _BACKEND


def is_backend_available(name: str) -> bool:
    """vv_dsp_fft_is_backend_available parity: whether the name is a
    backend of this package."""
    return name in _BACKENDS


def clear_plan_cache() -> None:
    """Drop the cached DFT bases and their casts (vv_dsp_fft_flush_fftw_cache
    role) and cuFFT's plan cache on every card."""
    _dft_basis.cache_clear()
    _basis_cast.cache_clear()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.backends.cuda.cufft_plan_cache[i].clear()


def next_pow2(v: int) -> int:
    n = 1
    while n < v:
        n <<= 1
    return n


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


def rfft_power(x: torch.Tensor, n: int | None = None,
               axis: int = -1) -> torch.Tensor:
    """|rfft(x)|^2 = re^2 + im^2 (real input only)."""
    s = rfft(x, n, axis)
    return s.real * s.real + s.imag * s.imag


def hermitian_expand(xh: torch.Tensor, n: int,
                     axis: int = -1) -> torch.Tensor:
    """Expand n//2+1 Hermitian-packed bins to the full n-bin spectrum."""
    xh = xh.movedim(axis, -1)
    tail = torch.conj(xh[..., 1:n - xh.shape[-1] + 1].flip(-1))
    return torch.cat([xh, tail], dim=-1).movedim(-1, axis)


def fftshift(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """Swap halves: out = [x[n/2:], x[:n/2]] (src/spectral/utils.c:5-46)."""
    return torch.fft.fftshift(x, dim=axis)


def ifftshift(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.fft.ifftshift(x, dim=axis)


def phase_wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap phase to (-pi, pi]; -pi maps to +pi, as the reference's loop
    (vv_dsp_phase_wrap, src/spectral/utils.c:48-58)."""
    return math.pi - torch.remainder(math.pi - x, 2.0 * math.pi)


def phase_unwrap(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """1-D phase unwrap (vv_dsp_phase_unwrap, src/spectral/utils.c:60-71):
    each step wrapped to (-pi, pi], then summed from the first sample."""
    x = x.movedim(axis, -1)
    steps = phase_wrap(torch.diff(x, dim=-1))
    out = torch.cat([x[..., :1], x[..., :1] + torch.cumsum(steps, dim=-1)],
                    dim=-1)
    return out.movedim(-1, axis)


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
