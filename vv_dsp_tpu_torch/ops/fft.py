"""FFT wrappers on ``torch.fft`` (the public ``fft``/``rfft``/``ifft``/
``irfft`` of ``vv_dsp_tpu/ops/fft.py`` that the plain STFT paths use).

Scaling follows the JAX package: forward unscaled, inverse 1/n. Its matmul-DFT,
four-step, CT3 and Bluestein tiers exist to work around the TPU and are
not ported.
"""

from __future__ import annotations

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
