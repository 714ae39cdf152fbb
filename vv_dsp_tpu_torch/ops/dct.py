"""DCT-II matrix (the part of ``vv_dsp_tpu/ops/dct.py`` the MFCC path
uses): X[k] = sum_n x[n] cos(pi (n + 0.5) k / N), unnormalized."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def _dct2_matrix(n: int) -> np.ndarray:
    """M[k, m] = cos(pi (m+0.5) k / n), float64."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (m + 0.5) * k / n)
