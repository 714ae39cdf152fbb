"""Fused FIR + polyphase resample, the chain's head (the part of
``vv_dsp_tpu/ops/resample.py`` the north-star path runs).

Host constants (``_resample_poly_filter``, ``_fused_fir_resample_filter``,
``_staged_tail_matrix``) are copies of the JAX package's numpy builders.
``fir_resample_fused`` runs one banded upfirdn (ops/upfirdn.py) with the
composite filter, then recomputes the last outputs exactly as the staged
pair resample_poly(fir_apply(h, x)) defines them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops.upfirdn import (polyphase_table, upfirdn_banded,
                                          upfirdn_tall)
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp


@functools.lru_cache(maxsize=64)
def _resample_poly_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly default anti-alias FIR: firwin with a
    Kaiser(5.0) window, 2*10*max(up,down)+1 taps, cutoff 1/max(up,down),
    scaled by up."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    numtaps = 2 * half_len + 1
    n = np.arange(numtaps, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * n)
    h *= get_window_np("kaiser", numtaps, 5.0)
    h /= h.sum()  # firwin scales so DC gain is 1
    return h * up


@functools.lru_cache(maxsize=16)
def _fused_fir_resample_filter(fir_key, up: int, down: int):
    """Composite filter g = conv(zero-stuff_up(h_fir), h_resample): filtering
    at the input rate then polyphase-resampling equals ONE upfirdn with g
    (out[t] = sum_i x[i] g[t - up*i]). Returns (g float64, offset)."""
    h_f = np.asarray(fir_key, dtype=np.float64)
    h_r = _resample_poly_filter(up, down)
    up_f = np.zeros((len(h_f) - 1) * up + 1, dtype=np.float64)
    up_f[::up] = h_f
    return np.convolve(up_f, h_r), (len(h_r) - 1) // 2


@functools.lru_cache(maxsize=16)
def _staged_tail_matrix(h_key, up: int, down: int, offset: int, n_in: int,
                        m0: int, n_tail: int):
    """(W (n_tail, width) float64, jw0): the staged fused-head tail as one
    dense matrix over the input window x[jw0:n_in] — staged means the FIR
    intermediate is truncated at n_in (k < n_in), which is the one place the
    pure composite filter differs from resample_poly(fir_apply(x))."""
    h_fir = np.asarray(h_key, dtype=np.float64)
    h_r = _resample_poly_filter(up, down)
    len_r = len(h_r)
    taps_f = len(h_fir)
    # y_st[m] = sum_k 1[0<=k<n_in] h_r[offset + m*down - k*up] * y_fir[k],
    # y_fir[k] = sum_u h_fir[u] x[k-u]
    ms = np.arange(m0, m0 + n_tail)
    k_hi = min(n_in - 1, (offset + int(ms[-1]) * down) // up)
    k_lo = max(0, -(-(offset + int(ms[0]) * down - len_r + 1) // up))
    jw0 = k_lo - taps_f + 1
    width = k_hi - jw0 + 1
    # A[m, k] = h_r coefficient; B[k, j] = h_fir[k - j]
    kk = np.arange(k_lo, k_hi + 1)
    gi = offset + ms[:, None] * down - kk[None, :] * up
    a = np.where((gi >= 0) & (gi < len_r), h_r[np.clip(gi, 0, len_r - 1)], 0.0)
    jj = np.arange(jw0, jw0 + width)
    fi = kk[:, None] - jj[None, :]
    b = np.where((fi >= 0) & (fi < taps_f),
                 h_fir[np.clip(fi, 0, taps_f - 1)], 0.0)
    w = a @ b  # (n_tail, width)
    if jw0 < 0:  # clip columns for x indices < 0 (zero samples)
        w = w[:, -jw0:]
        jw0 = 0
    return np.ascontiguousarray(w), jw0


@functools.lru_cache(maxsize=16)
def _tail_weights(fir_key: bytes, up: int, down: int, offset: int, n_in: int,
                  m0: int, n_tail: int, device: torch.device):
    """(W^T (width, n_tail) float32 on `device`, jw0) of
    _staged_tail_matrix."""
    h = np.frombuffer(fir_key, dtype=np.float64)
    w, jw0 = _staged_tail_matrix(tuple(h), up, down, offset, n_in, m0, n_tail)
    wt = np.ascontiguousarray(w.T, dtype=np.float32)
    return torch.as_tensor(wt, device=device), jw0


def fir_resample_fused(h_fir, x: torch.Tensor, up: int, down: int,
                       algorithm: str | None = None,
                       taps: torch.Tensor | None = None) -> torch.Tensor:
    """resample_poly(fir_apply(h_fir, x), up, down) as one banded upfirdn:
    (..., n) -> (..., ceil(n*up/down)) float32, sample-exact against the
    staged pair including the staged FIR's end-of-signal truncation.

    algorithm: the banded contraction's tier ("f32" | "bf16x3" | "bf16").
    taps: the composite filter's polyphase table on x's device (a module
    passes its buffer); built from h_fir when None."""
    x = config.as_compute(x)
    if x.ndim != 2:
        lead = x.shape[:-1]
        y = fir_resample_fused(h_fir, x.reshape(-1, x.shape[-1]), up, down,
                               algorithm, taps)
        return y.reshape(lead + y.shape[-1:])
    if x.dtype != torch.float32:
        x = x.float()
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        raise NotImplementedError("up == down: the plain FIR paths are not "
                                  "ported yet")
    h_np = np.ascontiguousarray(h_fir, dtype=np.float64)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    gf, offset = _fused_fir_resample_filter(tuple(h_np), up, down)
    m0 = max(0, -(-(up * n_in - offset) // down))
    n_tail = n_out - m0
    staged_tail = 0 < n_tail <= 1024 and m0 > 0
    if not staged_tail and m0 < n_out:
        raise NotImplementedError(
            "signals shorter than the resample filter (the staged "
            "fir_apply tail branch) are not ported yet")
    if taps is None:
        taps = polyphase_table(gf, up, x.device)
    y = kernel_with_torch_vjp(
        lambda xv: upfirdn_banded(xv, taps, up, down, offset, n_out,
                                  algorithm),
        lambda xv: upfirdn_tall(xv, taps, up, down, offset, n_out, "f32"),
    )(x)
    if staged_tail:
        # the staged definition for the few outputs whose window crosses the
        # FIR's end collapses to a small dense matmul over the input's tail
        wt, jw0 = _tail_weights(h_np.tobytes(), up, down, offset, n_in, m0,
                                n_tail, x.device)
        tail = x[..., jw0:] @ wt[:x.shape[-1] - jw0]
        y = torch.cat([y[..., :m0], tail], dim=-1)
    return y
