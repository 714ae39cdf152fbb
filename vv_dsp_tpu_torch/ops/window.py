"""Window generators (counterpart of ``vv_dsp_tpu/ops/window.py``).

Windows are shape constants: they are built on the host in numpy float64 by
the same formulas as the JAX package (copied, not imported, because that
module imports jax) and cast once to the compute dtype. All windows are
symmetric, peak ~1.0, and N == 1 -> [1.0].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import config


def _np_hann(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))


def _np_hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def _np_blackman(n: int) -> np.ndarray:
    x = 2.0 * np.pi * np.arange(n, dtype=np.float64) / (n - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)


def _np_cosine_sum(n: int, coeffs) -> np.ndarray:
    """sum_k (-1)^k a_k cos(k x) with x = 2 pi n / (N-1)."""
    x = 2.0 * np.pi * np.arange(n, dtype=np.float64) / (n - 1)
    out = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coeffs):
        out += ((-1.0) ** k) * a * np.cos(k * x)
    return out


def _np_blackman_harris(n: int) -> np.ndarray:
    return _np_cosine_sum(n, (0.35875, 0.48829, 0.14128, 0.01168))


def _np_nuttall(n: int) -> np.ndarray:
    return _np_cosine_sum(n, (0.3635819, 0.4891775, 0.1365995, 0.0106411))


def _np_flattop(n: int) -> np.ndarray:
    return _np_cosine_sum(
        n, (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
    )


def _np_bartlett(n: int) -> np.ndarray:
    half = (n - 1) / 2.0
    k = np.arange(n, dtype=np.float64)
    return 1.0 - np.abs(k - half) / half


def _np_bohman(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    x = np.abs((k / (n - 1) - 0.5) * 2.0)
    w = (1.0 - x) * np.cos(np.pi * x) + np.sin(np.pi * x) / np.pi
    return np.where(x <= 1.0, w, 0.0)


def _np_cosine(n: int) -> np.ndarray:
    # Reference formula sin(pi n / (N-1)) — differs from scipy's cosine window
    # (src/window/window.c:138-148).
    k = np.arange(n, dtype=np.float64)
    return np.sin(np.pi * k / (n - 1))


def _np_planck_taper(n: int, eps: float = 0.1) -> np.ndarray:
    # src/window/window.c:150-185; eps fixed at 0.1 in the reference,
    # parameterized here.
    nn = float(n)
    taper = eps * nn / 2.0
    out = np.ones(n, dtype=np.float64)
    for i in range(n):
        fi = float(i)
        if fi < taper:
            x = 2.0 * eps * (fi / nn - eps / 2.0)
            out[i] = 0.0 if x == 0.0 else 1.0 / (
                1.0 + np.exp(2.0 * eps / x - 2.0 * eps / (eps - x))
            )
        elif fi >= nn - taper:
            x = 2.0 * eps * ((nn - 1.0 - fi) / nn - eps / 2.0)
            out[i] = 0.0 if x == 0.0 else 1.0 / (
                1.0 + np.exp(2.0 * eps / x - 2.0 * eps / (eps - x))
            )
    return out


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    # Series expansion like src/window/window.c:187-199 but run to convergence
    # in f64 (equivalent to np.i0 for the beta range used).
    result = np.ones_like(x)
    term = np.ones_like(x)
    x2 = x * x / 4.0
    for k in range(1, 64):
        term = term * x2 / (k * k)
        result = result + term
        if np.all(term < 1e-18):
            break
    return result


def _np_kaiser(n: int, beta: float) -> np.ndarray:
    half = (n - 1) / 2.0
    k = np.arange(n, dtype=np.float64)
    alpha = (k - half) / half
    inside = 1.0 - alpha * alpha
    w = np.zeros(n, dtype=np.float64)
    ok = inside >= 0.0
    w[ok] = _bessel_i0(beta * np.sqrt(inside[ok])) / _bessel_i0(
        np.asarray(beta, dtype=np.float64)
    )
    return w


def _np_tukey(n: int, alpha: float = 0.5) -> np.ndarray:
    alpha = min(max(alpha, 0.0), 1.0)
    nn = float(n)
    taper = alpha * (nn - 1.0) / 2.0
    k = np.arange(n, dtype=np.float64)
    out = np.ones(n, dtype=np.float64)
    if taper > 0:
        left = k < taper
        out[left] = 0.5 * (1.0 - np.cos(np.pi * k[left] / taper))
        right = k >= nn - taper
        out[right] = 0.5 * (1.0 - np.cos(np.pi * (nn - 1.0 - k[right]) / taper))
    return out


_GENERATORS = {
    "boxcar": lambda n: np.ones(n, dtype=np.float64),
    "hann": _np_hann,
    "hamming": _np_hamming,
    "blackman": _np_blackman,
    "blackman_harris": _np_blackman_harris,
    "nuttall": _np_nuttall,
    "bartlett": _np_bartlett,
    "bohman": _np_bohman,
    "cosine": _np_cosine,
    "planck_taper": _np_planck_taper,
    "flattop": _np_flattop,
    "kaiser": _np_kaiser,
    "tukey": _np_tukey,
    # Aliases used by the reference filter module (src/filter/common.h:14-19).
    "rectangular": lambda n: np.ones(n, dtype=np.float64),
    "hanning": _np_hann,
}

WINDOW_NAMES = tuple(
    k for k in _GENERATORS if k not in ("rectangular", "hanning")
)

_PARAM_DEFAULTS = {"kaiser": 9.0, "tukey": 0.5, "planck_taper": 0.1}


@functools.lru_cache(maxsize=256)
def _window_f64(name: str, n: int, param) -> np.ndarray:
    if n <= 0:
        raise ValueError("window length must be positive")
    gen = _GENERATORS.get(name)
    if gen is None:
        raise ValueError(f"unknown window {name!r}; one of {sorted(_GENERATORS)}")
    if n == 1:
        return np.ones(1, dtype=np.float64)
    if name in _PARAM_DEFAULTS:
        p = _PARAM_DEFAULTS[name] if param is None else float(param)
        w = gen(n, p)
    else:
        if param is not None:
            raise ValueError(f"window {name!r} takes no parameter")
        w = gen(n)
    w.flags.writeable = False
    return w


def get_window_np(name: str, n: int, param=None) -> np.ndarray:
    """Float64 numpy window (host-side constant generation)."""
    return _window_f64(name, int(n), param)


def get_window(name: str, n: int, param=None, dtype=None,
               device=None) -> torch.Tensor:
    """Window as a tensor in the compute dtype on `device`.

    `param` is beta for kaiser, alpha for tukey, epsilon for planck_taper.
    """
    return torch.tensor(get_window_np(name, n, param),
                        dtype=config.real_dtype(dtype), device=device)
