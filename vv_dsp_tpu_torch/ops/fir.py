"""FIR design (the part of ``vv_dsp_tpu/ops/fir.py`` the chain uses):
windowed-sinc lowpass h[n] = 2 fc sinc(2 fc (n - (N-1)/2)) * w[n], built
on the host in float64."""

from __future__ import annotations

import numpy as np

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
