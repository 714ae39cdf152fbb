"""Savitzky-Golay smoothing and differentiation (counterpart of
``vv_dsp_tpu/ops/savgol.py``; the reference's src/filter/savgol.c).

- coefficients: the least-squares polynomial fit on centred indices,
  evaluated at the window's centre, derivatives scaled by
  deriv! / delta^deriv; window_length odd and <= 257, polyorder <= 15;
- application: pad window_length // 2 samples at each end by the boundary
  mode, then a valid *correlation* (no flip) with the weights;
- modes: "reflect" mirrors about the edge sample, which is left out
  (scipy's 'mirror'); "constant" and "nearest" both repeat the edge sample
  (the reference implements CONSTANT as NEAREST); "wrap" is circular;
- the NaN policy applies to the input and the output.

``savgol_filter`` routes as the JAX package does on the TPU: real float32
input, where ``upfirdn.banded_supported(1, 1, wl, wl - 1)`` holds (every
window length the filter takes), runs kernel 1, the banded upfirdn, at
1/1: y[k] = sum_j xp[j] g[(wl - 1) + k - j] with g the reversed weights,
at the knob's tier (``config.set_matmul_precision``). Its gradient is the
plain shift-add correlation's. Complex and float64 input take one
``conv1d`` (the real and imaginary parts apart), as the JAX package's
conv route. Under the PROPAGATE policy a non-finite sample poisons the
outputs of the kernel path's frames that read it (the band's zeros times
inf), as the JAX kernel's do on the TPU; the conv only its window's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops.upfirdn import (banded_supported, polyphase_table,
                                          upfirdn_banded)
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp
from vv_dsp_tpu_torch.utils.nan_policy import NanPolicy, apply_nan_policy

MODES = ("reflect", "constant", "nearest", "wrap")


@functools.lru_cache(maxsize=128)
def savgol_coeffs_np(window_length: int, polyorder: int, deriv: int = 0,
                     delta: float = 1.0) -> np.ndarray:
    """Correlation weights w, float64: y[n] = sum_k w[k] x[n - half + k]."""
    if window_length <= 0 or window_length % 2 == 0:
        raise ValueError("window_length must be odd and positive")
    if polyorder >= window_length or polyorder > 15:
        raise ValueError("polyorder must be < window_length and <= 15")
    if deriv > polyorder:
        return np.zeros(window_length, dtype=np.float64)
    half = window_length // 2
    t = np.arange(-half, half + 1, dtype=np.float64)
    a = np.vander(t, polyorder + 1, increasing=True)  # a[r, j] = t_r^j
    # the minimum-norm solution of a^T w = deriv! e_deriv, by SVD lstsq on
    # a^T itself: the normal equations square the condition number
    e = np.zeros(polyorder + 1)
    e[deriv] = float(math.factorial(deriv))
    w, *_ = np.linalg.lstsq(a.T, e, rcond=None)
    if deriv == 0:
        s = w.sum()
        if s != 0.0:
            w = w / s  # the reference's safeguard (savgol.c:158)
    else:
        w = w / (delta ** deriv)
    return w


def _pad(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    if pad == 0:
        return x
    n = x.shape[-1]
    if mode == "reflect":  # scipy's 'mirror': the edge sample left out
        left = x[..., 1:pad + 1].flip(-1)
        right = x[..., n - 1 - pad:n - 1].flip(-1)
    elif mode in ("constant", "nearest"):
        left = x[..., :1].expand(x.shape[:-1] + (pad,))
        right = x[..., -1:].expand(x.shape[:-1] + (pad,))
    elif mode == "wrap":
        left, right = x[..., -pad:], x[..., :pad]
    else:
        raise ValueError(f"mode must be one of {MODES}")
    return torch.cat([left, x, right], dim=-1)


def takes_kernel(x: torch.Tensor, window_length: int) -> bool:
    """Whether ``savgol_filter`` runs the banded upfirdn on x: real float32
    input at a geometry the JAX package's banded kernel takes."""
    return (x.dtype == torch.float32
            and banded_supported(1, 1, window_length, window_length - 1))


def correlate_plain(xp: torch.Tensor, w: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """Valid correlation as shift-adds, y[k] = sum_t w[t] xp[k + t]: the
    kernel path's plain version (and its gradient)."""
    acc = w[0] * xp[..., :n_out]
    for t in range(1, w.shape[0]):
        acc = acc + w[t] * xp[..., t:t + n_out]
    return acc


def _correlate_conv(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid correlation as one conv1d; complex input filters its real and
    imaginary parts apart."""
    if xp.is_complex():
        return torch.complex(_correlate_conv(xp.real, w),
                             _correlate_conv(xp.imag, w))
    y = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]),
                 w.to(xp.dtype).reshape(1, 1, -1))
    return y.reshape(xp.shape[:-1] + (y.shape[-1],))


def savgol_filter(x: torch.Tensor, window_length: int, polyorder: int,
                  deriv: int = 0, delta: float = 1.0, mode: str = "reflect",
                  nan_policy: NanPolicy = NanPolicy.PROPAGATE
                  ) -> torch.Tensor:
    """Savitzky-Golay filter over the last axis (vv_dsp_savgol,
    src/filter/savgol.c:220-287); (..., n) -> (..., n)."""
    x = config.as_compute(x)
    if window_length > 257:
        raise ValueError("window_length must be <= 257 (reference limit)")
    if window_length // 2 > x.shape[-1] - 1:
        raise ValueError(
            f"window_length // 2 = {window_length // 2} exceeds len(x)-1 = "
            f"{x.shape[-1] - 1}; padding cannot be constructed (scipy raises "
            "the same)")
    x = apply_nan_policy(x, nan_policy)
    w_np = savgol_coeffs_np(window_length, polyorder, deriv, delta)
    xp = _pad(x, window_length // 2, mode)
    n_out = xp.shape[-1] - window_length + 1
    if takes_kernel(xp, window_length):
        w = torch.as_tensor(w_np, dtype=torch.float32, device=xp.device)
        table = polyphase_table(w_np[::-1], 1, xp.device)
        y = kernel_with_torch_vjp(
            lambda xv: upfirdn_banded(xv, table, 1, 1, window_length - 1,
                                      n_out),
            lambda xv: correlate_plain(xv, w, n_out),
        )(xp.reshape(-1, xp.shape[-1]))
        y = y.reshape(xp.shape[:-1] + (n_out,))
    else:
        y = _correlate_conv(xp, torch.as_tensor(w_np, device=xp.device))
    return apply_nan_policy(y, nan_policy)
