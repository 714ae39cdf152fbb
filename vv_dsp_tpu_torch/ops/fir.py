"""FIR design and application (counterpart of ``vv_dsp_tpu/ops/fir.py``):
the windowed-sinc lowpass h[n] = 2 fc sinc(2 fc (n - (N-1)/2)) * w[n], built
on the host in float64, and causal filtering y[i] = sum_k h[k] x[i-k] with
zero initial history (``scipy.signal.lfilter(h, [1], x)``) in two plain
forms with the same numbers:

- ``fir_apply``: one ``conv1d`` (a cross-correlation with the taps flipped,
  after taps-1 left zeros), TF32 pinned off by ``config``;
- ``fir_apply_mxu``: block-Toeplitz matmuls, the JAX package's middle route
  of ``fir_apply_best`` (``ops/filter_kernels.py``).

Taps come as numpy (a host constant) or as a tensor; a tensor that requires
grad stays differentiable through both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch import config
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


def fir_apply_mxu(h, x: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Causal FIR as block-Toeplitz matmuls, the same function as fir_apply.

    h is cut into J chunks of C taps and time into blocks of C. With windows
    W_k = x[kC-(C-1) : kC+C] (length 2C-1, zero left pad) and Toeplitz
    matrices T_j[s, r] = h[jC + r + C-1 - s] (zero outside the chunk),
        y_block[m] = sum_j  W_{m-j} @ T_j,
    J matmuls of (blocks, 2C-1) @ (2C-1, C). Numpy taps build T_j on the
    host in float64; tensor taps gather them on the device, differentiably.
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
    idx, valid = _toeplitz_index(c)
    if traced:
        hp = F.pad(taps_like(h, x), (0, n_chunks * c - taps))
        idx_t = torch.as_tensor(np.clip(idx, 0, c - 1), device=x.device)
        valid_t = torch.as_tensor(valid, device=x.device)
    else:
        hp = np.zeros(n_chunks * c)
        hp[:taps] = h
    # window k = xp[kC : kC + 2C - 1] = x[kC - (C-1) : kC + C]
    xp = F.pad(x, (c - 1, nb * c - n))
    w = xp.unfold(-1, 2 * c - 1, c)       # (..., nb, 2C-1)
    y = None
    for j in range(min(n_chunks, nb)):   # chunks beyond nb meet zero history
        if traced:
            tj = torch.where(valid_t, hp[j * c + idx_t],
                             torch.zeros((), dtype=x.dtype, device=x.device))
        else:
            tj = torch.as_tensor(
                np.where(valid, hp[j * c + np.clip(idx, 0, c - 1)], 0.0),
                dtype=x.dtype, device=x.device)
        term = w @ tj                     # row m holds W_m @ T_j
        if j:                             # ... and belongs at block m + j
            term = F.pad(term[..., :nb - j, :], (0, 0, j, 0))
        y = term if y is None else y + term
    return y.reshape(batch + (nb * c,))[..., :n]
