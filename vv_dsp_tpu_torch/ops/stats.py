"""Statistics and elementwise core math (counterpart of
``vv_dsp_tpu/ops/stats.py``; the reference's src/core/core.c and
stats.c). Every function reduces over the last axis by default and
batches over the leading ones.
"""

from __future__ import annotations

import torch

from vv_dsp_tpu_torch.ops.fft import irfft, next_pow2, rfft


# ---- basic reductions (src/core/core.c:10-137) ----

def sum_(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.sum(x, dim=axis)


def mean(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.mean(x, dim=axis)


def var(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """Population variance (the reference's Welford gives the same)."""
    return torch.var(x, dim=axis, correction=0)


def minimum(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.amin(x, dim=axis)


def maximum(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.amax(x, dim=axis)


def argmin(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.argmin(x, dim=axis)


def argmax(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.argmax(x, dim=axis)


def cumsum(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.cumsum(x, dim=axis)


def diff(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.diff(x, dim=axis)


def clamp(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.clamp(x, lo, hi)


# ---- advanced stats (src/core/stats.c) ----

def rms(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """sqrt(mean(x^2)) (src/core/stats.c:10-19)."""
    return torch.sqrt(torch.mean(x * x, dim=axis))


def peak(x: torch.Tensor, axis=-1):
    """(min, max) (vv_dsp_peak, src/core/stats.c:21-32)."""
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


def crest_factor(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """max(|x|) / rms (src/core/stats.c:34-46); rms == 0 -> inf."""
    mn, mx = peak(x, axis=axis)
    pk = torch.maximum(mx, -mn)
    r = rms(x, axis=axis)
    return torch.where(r == 0, torch.full_like(r, float("inf")),
                       pk / torch.where(r == 0, torch.ones_like(r), r))


def zero_crossing_count(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """Strict sign changes, a > 0 > b or a < 0 < b (src/core/stats.c:48-59):
    a zero sample breaks both, as in the reference."""
    x = x.movedim(axis, -1)
    a, b = x[..., :-1], x[..., 1:]
    c = ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))
    return c.sum(dim=-1, dtype=torch.int32)


def _central_moments(x: torch.Tensor, axis=-1):
    d = x - torch.mean(x, dim=axis, keepdim=True)
    return (torch.mean(d * d, dim=axis), torch.mean(d ** 3, dim=axis),
            torch.mean(d ** 4, dim=axis))


def skewness(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """m3 / var^1.5, zero where var <= 0 (src/core/stats.c:61-80)."""
    m2, m3, _ = _central_moments(x, axis=axis)
    safe = torch.where(m2 > 0, m2, torch.ones_like(m2))
    return torch.where(m2 > 0, m3 / safe ** 1.5, torch.zeros_like(m2))


def kurtosis(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """Excess kurtosis m4 / var^2 - 3 (src/core/stats.c:82-104)."""
    m2, _, m4 = _central_moments(x, axis=axis)
    safe = torch.where(m2 > 0, m2, torch.ones_like(m2))
    return torch.where(m2 > 0, m4 / (safe * safe) - 3.0,
                       torch.zeros_like(m2))


def autocorrelation(x: torch.Tensor, max_lag: int,
                    biased: bool = False) -> torch.Tensor:
    """r[k] = sum_i x[i] x[i+k], k in [0, max_lag], by rfft: divided by n
    when biased, else by the overlap count n - k (0 past n)
    (vv_dsp_autocorrelation, src/core/stats.c:106-122). (..., n) ->
    (..., max_lag+1)."""
    n = x.shape[-1]
    nfft = next_pow2(2 * n)
    spec = rfft(x, nfft)
    r = irfft(spec * torch.conj(spec), nfft)[..., :max_lag + 1]
    if biased:
        return r / n
    lags = torch.arange(max_lag + 1, dtype=x.dtype, device=x.device)
    count = torch.clamp(n - lags, min=1.0)
    return torch.where(lags < n, r / count, torch.zeros_like(r))


def cross_correlation(x: torch.Tensor, y: torch.Tensor,
                      max_lag: int) -> torch.Tensor:
    """r[k] = mean over the overlap of x[i] y[i+k], k in [0, max_lag]
    (vv_dsp_cross_correlation, src/core/stats.c:124-139)."""
    nx, ny = x.shape[-1], y.shape[-1]
    nfft = next_pow2(nx + ny)
    spec = torch.conj(rfft(x, nfft)) * rfft(y, nfft)
    r = irfft(spec, nfft)[..., :max_lag + 1]
    lags = torch.arange(max_lag + 1, device=x.device)
    count = torch.minimum(torch.tensor(nx, device=x.device), ny - lags)
    safe = torch.clamp(count, min=1).to(x.dtype)
    return torch.where(count > 0, r / safe, torch.zeros_like(r))


def kahan_sum(x: torch.Tensor, axis=-1) -> torch.Tensor:
    """Compensated (Kahan) summation (vv_dsp_sum, src/core/core.c:44-53):
    128 running sums with their compensations walk the signal in chunks of
    128 samples, then the lanes are summed, as the JAX package's scan over
    128-lane chunks does."""
    lanes = 128
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    pad = (-n) % lanes
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    chunks = x.reshape(x.shape[:-1] + (-1, lanes))
    s = torch.zeros(x.shape[:-1] + (lanes,), dtype=x.dtype, device=x.device)
    comp = torch.zeros_like(s)
    for i in range(chunks.shape[-2]):
        y = chunks[..., i, :] - comp
        t = s + y
        comp = (t - s) - y
        s = t
    return torch.sum(s - comp, dim=-1)
