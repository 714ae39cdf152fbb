"""vv_dsp_tpu_torch: the PyTorch + CUDA port of vv_dsp_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every TPU kernel on the ported path is a
hand-written CUDA kernel (``csrc/``), built with nvcc on first use
(``_build.py``). Tensors on the CPU run each kernel's plain PyTorch version.
This package never imports jax.

The top level re-exports what ``vv_dsp_tpu`` does, as far as the port has
it. ``config`` and the NaN policy load with the package; the ops,
``streaming`` and the subpackages (``models``, ``ops``, ``parallel``,
``io``, ``tools``) load on first access, so ``import vv_dsp_tpu_torch``
builds no kernel and loads no op module.
"""

import importlib

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.utils.nan_policy import NanPolicy, apply_nan_policy

__version__ = "0.1.0"

_SUBMODULES = {
    "models": "vv_dsp_tpu_torch.models",
    "ops": "vv_dsp_tpu_torch.ops",
    "parallel": "vv_dsp_tpu_torch.parallel",
    "io": "vv_dsp_tpu_torch.io",
    "streaming": "vv_dsp_tpu_torch.streaming",
    "tools": "vv_dsp_tpu_torch.tools",
    **{name: f"vv_dsp_tpu_torch.ops.{name}" for name in (
        "window", "complex_ops", "stats", "framing", "fft", "stft", "dct",
        "czt", "hilbert", "fir", "iir", "savgol", "resample", "envelope",
        "mel")},
}
_NAMES = {
    "get_window": ("window", "get_window"),
    "WINDOW_NAMES": ("window", "WINDOW_NAMES"),
    "fft_c2c": ("fft", "fft"),
    "ifft": ("fft", "ifft"),
    "rfft": ("fft", "rfft"),
    "irfft": ("fft", "irfft"),
    "fftshift": ("fft", "fftshift"),
    "ifftshift": ("fft", "ifftshift"),
    "phase_wrap": ("fft", "phase_wrap"),
    "phase_unwrap": ("fft", "phase_unwrap"),
    "STFT": ("stft", "STFT"),
    "stft_spectrogram": ("stft", "stft_spectrogram"),
    "num_frames": ("framing", "num_frames"),
    "fetch_frames": ("framing", "fetch_frames"),
    "overlap_add": ("framing", "overlap_add"),
}

__all__ = ["config", "NanPolicy", "apply_nan_policy",
           *_SUBMODULES, *_NAMES]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(_SUBMODULES[name])
    if name in _NAMES:
        module, attr = _NAMES[name]
        return getattr(importlib.import_module(_SUBMODULES[module]), attr)
    raise AttributeError(
        f"module 'vv_dsp_tpu_torch' has no attribute {name!r}")
