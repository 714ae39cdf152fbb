"""Forward STFT plan (the part of ``vv_dsp_tpu/ops/stft.py`` on the
north-star path).

Frames start at f*hop (non-centered), the tail frame is zero-padded, the
frame count is 1 if n < nfft else 1 + (n - nfft + hop)//hop, and the
forward transform is the unscaled FFT of the windowed frame. ``process``
goes through the packed-real spectrum kernel wrapper (ops/stft_kernels.py),
wrapped so that its gradient is the plain version's: a CPU tensor runs the
plain framed FFT, a CUDA tensor the kernel, which raises at a geometry or
dtype it does not take (complex input included).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import framing
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops.window import get_window
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp


@functools.lru_cache(maxsize=32)
def _window_on(name: str, n: int, param, device: torch.device) -> torch.Tensor:
    return get_window(name, n, param, device=device)


@dataclasses.dataclass(frozen=True)
class STFT:
    """Shape-specialized STFT plan: window and static geometry."""

    nfft: int
    hop: int
    window: str = "hann"
    window_param: float | None = None

    def __post_init__(self):
        if self.nfft <= 0 or self.hop <= 0 or self.hop > self.nfft:
            raise ValueError("need 0 < hop <= nfft (src/spectral/stft.c:33)")

    def win(self, device=None) -> torch.Tensor:
        """The float32 window on `device`."""
        return _window_on(self.window, self.nfft, self.window_param,
                          torch.device(device or "cpu"))

    def num_frames(self, n: int) -> int:
        """Frame count used by spectrogram (src/spectral/stft.c:118)."""
        return framing.stft_num_frames(n, self.nfft, self.hop)

    def process(self, x: torch.Tensor, rfft: bool = False) -> torch.Tensor:
        """Forward STFT of (..., n) -> (..., frames, nfft) complex (or
        (..., frames, nfft//2+1) with rfft=True)."""
        x = config.as_compute(x)
        if x.ndim != 2 and not x.is_complex():
            lead = x.shape[:-1]
            y = self.process(x.reshape(-1, x.shape[-1]), rfft)
            return y.reshape(lead + y.shape[-2:])
        if not x.is_complex() and x.dtype != torch.float32:
            x = x.float()
        win = self.win(x.device)
        return kernel_with_torch_vjp(
            lambda xv: _sk.stft_spectrum(xv, self.nfft, self.hop, win,
                                         onesided=rfft),
            lambda xv: _sk.stft_spectrum_plain(xv, self.nfft, self.hop, win,
                                               onesided=rfft),
        )(x)
