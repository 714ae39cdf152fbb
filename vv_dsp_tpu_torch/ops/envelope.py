"""Envelope extraction: real cepstrum, minimum phase, LPC (counterpart of
``vv_dsp_tpu/ops/envelope.py``; the reference's
src/envelope/{cepstrum,minphase,lpc}.c).

- real cepstrum: IFFT(log(|FFT(x)| + 1e-12)).real (cepstrum.c:7-39); real
  input through rfft/irfft, which give the same numbers: log|FFT| of a real
  signal is real and Hermitian;
- inverse cepstrum and minimum phase: the causal window {c0, 2 c[1..n/2-1],
  0 at Nyquist, zeros} -> FFT -> exp of the real part -> (IFFT for the time
  signal) (cepstrum.c:41-78, minphase.c:7-31). The reference exponentiates
  only the real part, a zero-phase magnitude envelope: kept as the
  ``full_complex=False`` default, the complete exp(H) behind the flag;
- LPC: autocorrelation (lpc.c:7-16) and Levinson-Durbin (lpc.c:18-41) with
  the reference's signs (A(z) = 1 + sum a_m z^-m, k = -acc/e), and the LP
  magnitude |gain / (1 - sum a_m e^{j m theta})| (lpc.c:55-72).

``levinson`` is an order-static unrolled recursion of small batched tensor
ops, O(order^2) of them: on the card its time is the host's time to launch
them, not the device's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops.stats import autocorrelation


def cepstrum_real(x: torch.Tensor) -> torch.Tensor:
    """Real cepstrum of (..., n) (vv_dsp_cepstrum_real)."""
    if x.is_complex():
        spec = _fft.fft(x)
        logmag = torch.log(torch.abs(spec) + 1e-12)
        return _fft.ifft(logmag.to(spec.dtype)).real
    x = config.as_compute(x)
    n = x.shape[-1]
    logmag = torch.log(torch.abs(_fft.rfft(x)) + 1e-12)
    return _fft.irfft(torch.complex(logmag, torch.zeros_like(logmag)), n)


@functools.lru_cache(maxsize=32)
def _causal_window_on(n: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    w = np.zeros(n, dtype=np.float64)
    w[0] = 1.0
    w[1:n // 2] = 2.0   # Nyquist (even n) and the upper half stay zero
    return torch.as_tensor(w, dtype=dtype, device=device)


def _causal_cepstrum_window(c: torch.Tensor) -> torch.Tensor:
    """{c0, 2c1..c_{n/2-1}, 0 at Nyquist (even n), 0...}
    (cepstrum.c:55-60)."""
    return c * _causal_window_on(c.shape[-1], c.dtype, c.device)


def minphase_spectrum_from_cepstrum(c: torch.Tensor,
                                    full_complex: bool = False
                                    ) -> torch.Tensor:
    """Minimum-phase spectrum exp(FFT(causal-windowed cepstrum))
    (vv_dsp_minphase_from_cepstrum, minphase.c:7-31). full_complex=False
    is the reference's: exp(Re H) with the phase zeroed, the magnitude
    envelope; True gives exp(H)."""
    cw = _causal_cepstrum_window(c)
    h = _fft.fft(cw.to(config.complex_for_real(c.dtype)))
    if full_complex:
        return torch.exp(h)
    return torch.exp(h.real).to(h.dtype)


def icepstrum_minphase(c: torch.Tensor,
                       full_complex: bool = False) -> torch.Tensor:
    """Minimum-phase time signal from a real cepstrum
    (vv_dsp_icepstrum_minphase, cepstrum.c:41-78)."""
    return _fft.ifft(minphase_spectrum_from_cepstrum(c, full_complex)).real


def autocorr(x: torch.Tensor, order: int) -> torch.Tensor:
    """r[k] = sum_i x[i] x[i+k], k in [0, order] (vv_dsp_autocorr,
    lpc.c:7-16): the biased autocorrelation times n."""
    return autocorrelation(x, order, biased=True) * x.shape[-1]


def levinson(r: torch.Tensor, order: int):
    """Levinson-Durbin (vv_dsp_levinson, lpc.c:18-41).

    r: (..., order+1) autocorrelation. Returns (a, err): a is
    (..., order+1) with a[0] = 1 and A(z) = 1 + sum_{m>=1} a_m z^-m; err is
    the final prediction error. Where r[0] <= 0 (silent input) the
    reference returns an error status (lpc.c:25); here the reflection
    coefficients are zeroed instead, so a = (1, 0, ...) and err = r[0]."""
    dt = r.dtype
    e = r[..., 0]
    degenerate = e <= 0
    one = torch.ones_like(e)
    zero = torch.zeros_like(e)
    a = [one] + [zero] * order
    for m in range(1, order + 1):
        acc = r[..., m]
        for i in range(1, m):
            acc = acc + a[i] * r[..., m - i]
        k = torch.where(degenerate, zero,
                        -acc / torch.where(degenerate, one, e))
        new_a = list(a)
        new_a[m] = k
        for i in range(1, m):
            new_a[i] = a[i] + k * a[m - i]
        a = new_a
        e = e * (1.0 - k * k)
    return torch.stack(a, dim=-1).to(dt), e.to(dt)


def lpc(x: torch.Tensor, order: int):
    """Autocorrelation-method LPC (vv_dsp_lpc, lpc.c:43-53)."""
    return levinson(autocorr(x, order), order)


@functools.lru_cache(maxsize=16)
def _lp_basis_on(order: int, nfft: int, dtype: torch.dtype,
                 device: torch.device):
    """(cos, sin) of m theta_k, transposed to (order, nfft), on `device`."""
    k = np.arange(nfft, dtype=np.float64)
    m = np.arange(1, order + 1, dtype=np.float64)
    arg = m[:, None] * (2.0 * np.pi * k / nfft)[None, :]
    return (torch.as_tensor(np.cos(arg), dtype=dtype, device=device),
            torch.as_tensor(np.sin(arg), dtype=dtype, device=device))


def lpspec(a: torch.Tensor, gain, nfft: int) -> torch.Tensor:
    """LP magnitude envelope |gain / (1 - sum_m a_m e^{j m theta_k})| at
    nfft points (vv_dsp_lpspec, lpc.c:55-72; a[0] = 1 is skipped). The two
    contractions run at the matmul-precision knob's tier."""
    order = a.shape[-1] - 1
    cos_t, sin_t = _lp_basis_on(order, nfft, a.dtype, a.device)
    am = a[..., 1:]
    re = 1.0 - config.tier_matmul(am, cos_t, None)
    im = -config.tier_matmul(am, sin_t, None)
    den = torch.sqrt(re * re + im * im)
    gain = torch.as_tensor(gain, dtype=den.dtype, device=den.device)
    pos = den > 0
    return torch.where(pos, gain[..., None] / torch.where(pos, den, 1.0),
                       torch.zeros_like(den))
