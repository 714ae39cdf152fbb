"""FIR design and application (counterpart of ``vv_dsp_tpu/ops/fir.py``):
the windowed-sinc lowpass h[n] = 2 fc sinc(2 fc (n - (N-1)/2)) * w[n], built
on the host in float64, and causal filtering y[i] = sum_k h[k] x[i-k] with
zero initial history (``scipy.signal.lfilter(h, [1], x)``) in four forms
with the same function:

- ``fir_apply``: one ``conv1d`` (a cross-correlation with the taps flipped,
  after taps-1 left zeros), TF32 pinned off by ``config``;
- ``fir_apply_mxu``: block-Toeplitz matmuls, the JAX package's middle route
  of ``fir_apply_best`` (``ops/filter_kernels.py``);
- ``fir_apply_fft``: one rfft product over the whole signal;
- ``fir_apply_os``: blocked overlap-save rfft products.

``filtfilt_fir`` is the zero-phase form: symmetric padding, the causal
conv forward and then backward.

Taps come as numpy (a host constant) or as a tensor; a tensor that requires
grad stays differentiable through both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops.window import get_window_np


def design_lowpass_np(num_taps: int, cutoff: float,
                      window: str = "hamming") -> np.ndarray:
    """Float64 numpy windowed-sinc lowpass, cutoff in (0, 1)."""
    if num_taps <= 0:
        raise ValueError("num_taps must be positive")
    if not (0.0 < cutoff < 1.0):
        raise ValueError("cutoff must be in (0, 1)")
    n = np.arange(num_taps, dtype=np.float64)
    alpha = (num_taps - 1) / 2.0
    m = n - alpha
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * m)  # np.sinc is sin(pi x)/(pi x)
    return h * get_window_np(window, num_taps)


def design_lowpass(num_taps: int, cutoff: float, window: str = "hamming",
                   dtype=None, device="cuda") -> torch.Tensor:
    """Windowed-sinc lowpass (vv_dsp_fir_design_lowpass,
    src/filter/fir.c:47-73) as a tensor on `device`, the card unless the
    caller names another; cutoff in (0, 1), unit gain at DC."""
    return torch.as_tensor(design_lowpass_np(num_taps, cutoff, window),
                           dtype=config.real_dtype(dtype), device=device)


def taps_like(h, x: torch.Tensor) -> torch.Tensor:
    """Taps as a 1-D tensor of x's dtype on x's device; a tensor keeps its
    autograd graph."""
    if isinstance(h, torch.Tensor):
        return h.to(device=x.device, dtype=x.dtype).reshape(-1)
    return torch.as_tensor(np.asarray(h, dtype=np.float64).reshape(-1),
                           dtype=x.dtype, device=x.device)


def fir_apply(h, x: torch.Tensor) -> torch.Tensor:
    """Causal FIR filtering, lfilter(h, [1], x) semantics, over the last
    axis of x (any leading shape)."""
    x = config.as_compute(x)
    h = taps_like(h, x)
    taps = h.shape[-1]
    n = x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, n), (taps - 1, 0))
    y = F.conv1d(xb, h.flip(-1).reshape(1, 1, taps))
    return y.reshape(x.shape)


def _toeplitz_index(chunk: int):
    """(idx, valid) of the block-Toeplitz matrices: T_j[s, r] =
    h[j*chunk + idx[s, r]] where valid, 0 elsewhere."""
    s = np.arange(2 * chunk - 1)[:, None]
    r = np.arange(chunk)[None, :]
    idx = r + chunk - 1 - s
    return idx, (idx >= 0) & (idx < chunk)


@functools.lru_cache(maxsize=8)
def _toeplitz_on(h_bytes: bytes, chunk: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(J, 2C-1, C) stack of the matrices T_j of float64 taps, built on the
    host and copied to `device` once."""
    h = np.frombuffer(h_bytes, dtype=np.float64)
    c = chunk
    n_chunks = -(-len(h) // c)
    hp = np.zeros(n_chunks * c)
    hp[:len(h)] = h
    idx, valid = _toeplitz_index(c)
    t = np.stack([np.where(valid, hp[j * c + np.clip(idx, 0, c - 1)], 0.0)
                  for j in range(n_chunks)])
    return torch.as_tensor(t, dtype=dtype, device=device)


def fir_apply_mxu(h, x: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Causal FIR as block-Toeplitz matmuls, the same function as fir_apply.

    h is cut into J chunks of C taps and time into blocks of C. With windows
    W_k = x[kC-(C-1) : kC+C] (length 2C-1, zero left pad) and Toeplitz
    matrices T_j[s, r] = h[jC + r + C-1 - s] (zero outside the chunk),
        y_block[m] = sum_j  W_{m-j} @ T_j,
    J matmuls of (blocks, 2C-1) @ (2C-1, C). Numpy taps build T_j on the
    host in float64, copied to the device once (``_toeplitz_on``); tensor
    taps gather them on the device, differentiably.
    """
    x = config.as_compute(x)
    traced = isinstance(h, torch.Tensor)
    if not traced:
        h = np.asarray(h, dtype=np.float64).reshape(-1)
    taps = h.shape[-1]
    c = chunk
    n_chunks = -(-taps // c)
    batch = x.shape[:-1]
    n = x.shape[-1]
    nb = -(-n // c)
    if traced:
        idx, valid = _toeplitz_index(c)
        hp = F.pad(taps_like(h, x), (0, n_chunks * c - taps))
        idx_t = torch.as_tensor(np.clip(idx, 0, c - 1), device=x.device)
        valid_t = torch.as_tensor(valid, device=x.device)
    else:
        stack = _toeplitz_on(np.ascontiguousarray(h).tobytes(), c, x.dtype,
                             x.device)
    # window k = xp[kC : kC + 2C - 1] = x[kC - (C-1) : kC + C]
    xp = F.pad(x, (c - 1, nb * c - n))
    w = xp.unfold(-1, 2 * c - 1, c)       # (..., nb, 2C-1)
    y = None
    for j in range(min(n_chunks, nb)):   # chunks beyond nb meet zero history
        if traced:
            tj = torch.where(valid_t, hp[j * c + idx_t],
                             torch.zeros((), dtype=x.dtype, device=x.device))
        else:
            tj = stack[j]
        term = w @ tj                     # row m holds W_m @ T_j
        if j:                             # ... and belongs at block m + j
            term = F.pad(term[..., :nb - j, :], (0, 0, j, 0))
        y = term if y is None else y + term
    return y.reshape(batch + (nb * c,))[..., :n]


def fir_apply_fft(h, x: torch.Tensor) -> torch.Tensor:
    """Whole-signal linear convolution by rfft, cut to len(x)
    (vv_dsp_fir_apply_fft, src/filter/fir.c:75-135)."""
    x = config.as_compute(x)
    h = taps_like(h, x)
    n = x.shape[-1]
    nfft = _fft.next_pow2(n + h.shape[-1] - 1)
    y = _fft.irfft(_fft.rfft(x, nfft) * _fft.rfft(h, nfft), nfft)
    return y[..., :n]


def fir_apply_os(h, x: torch.Tensor,
                 block_size: int | None = None) -> torch.Tensor:
    """Overlap-save blocked rfft convolution, the function of fir_apply:
    each block of `block_size` outputs comes from a segment of
    block_size + taps - 1 inputs (taps - 1 of history), transformed at
    nfft = next_pow2(block_size + taps - 1). The default block fills a
    transform of max(4096, next_pow2(2 taps)) points, the JAX package's."""
    x = config.as_compute(x)
    h = taps_like(h, x)
    taps = h.shape[-1]
    n = x.shape[-1]
    if block_size is None:
        block_size = max(4096, _fft.next_pow2(2 * taps)) - taps + 1
    nfft = _fft.next_pow2(block_size + taps - 1)
    n_blocks = -(-n // block_size)
    xp = F.pad(x, (taps - 1, n_blocks * block_size - n))
    segs = xp.unfold(-1, block_size + taps - 1, block_size)
    y = _fft.irfft(_fft.rfft(segs, nfft) * _fft.rfft(h, nfft), nfft)
    y = y[..., taps - 1:taps - 1 + block_size]     # each block's valid part
    return y.reshape(x.shape[:-1] + (n_blocks * block_size,))[..., :n]


def filtfilt_fir(h, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase FIR (vv_dsp_filtfilt_fir, src/filter/common.c:23-80):
    pad taps - 1 samples at each end by symmetric reflection (numpy's
    'symmetric'), filter forward, filter the reversed result, reverse it
    back and cut the padding."""
    x = config.as_compute(x)
    taps = taps_like(h, x).shape[-1]
    pad = taps - 1
    if pad and x.shape[-1] < pad:
        raise ValueError(
            f"filtfilt_fir needs len(x) >= num_taps - 1 = {pad} "
            f"(got {x.shape[-1]}); scipy.filtfilt has the same padlen rule")
    ext = x
    if pad:
        ext = torch.cat([x[..., :pad].flip(-1), x, x[..., -pad:].flip(-1)],
                        dim=-1)
    y = fir_apply(h, fir_apply(h, ext).flip(-1)).flip(-1)
    return y[..., pad:y.shape[-1] - pad]
