"""STFT plan: forward, power and inverse (counterpart of
``vv_dsp_tpu/ops/stft.py``).

Frames start at f*hop (non-centered), the tail frame is zero-padded, the
frame count is 1 if n < nfft else 1 + (n - nfft + hop)//hop, and the
forward transform is the unscaled FFT of the windowed frame. The inverse
is the 1/nfft-scaled inverse of each frame, windowed, overlap-added and
divided by the w^2 overlap-add norm (values <= 1e-12 replaced by 1).

Each entry point goes through its kernel wrapper (``process`` and
``process_packed``: the spectrum kernel; ``power``: the power kernel;
``reconstruct`` and ``reconstruct_packed``: the inverse kernel), wrapped
so that its gradient is the plain version's: a CPU tensor runs the plain
version, a CUDA tensor the kernel, which raises at a geometry or dtype it
does not take (complex input to the forward kernels included).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import framing
from vv_dsp_tpu_torch.ops import istft_kernels as _ik
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops.packed import PackedSpectrum
from vv_dsp_tpu_torch.ops.window import get_window, get_window_np
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

    def _signal(self, x: torch.Tensor) -> torch.Tensor:
        x = config.as_compute(x)
        if not x.is_complex() and x.dtype != torch.float32:
            x = x.float()
        return x

    def process(self, x: torch.Tensor, rfft: bool = False) -> torch.Tensor:
        """Forward STFT of (..., n) -> (..., frames, nfft) complex (or
        (..., frames, nfft//2+1) with rfft=True)."""
        x = self._signal(x)
        if x.ndim != 2 and not x.is_complex():
            lead = x.shape[:-1]
            y = self.process(x.reshape(-1, x.shape[-1]), rfft)
            return y.reshape(lead + y.shape[-2:])
        win = self.win(x.device)
        return kernel_with_torch_vjp(
            lambda xv: _sk.stft_spectrum(xv, self.nfft, self.hop, win,
                                         onesided=rfft),
            lambda xv: _sk.stft_spectrum_plain(xv, self.nfft, self.hop, win,
                                               onesided=rfft),
        )(x)

    def power(self, x: torch.Tensor) -> torch.Tensor:
        """One-sided power spectrogram |rfft(w * frame)|^2, the complex
        spectrum never in device memory: (..., n) -> (..., frames,
        nfft//2+1)."""
        x = self._signal(x)
        if x.ndim != 2 and not x.is_complex():
            lead = x.shape[:-1]
            y = self.power(x.reshape(-1, x.shape[-1]))
            return y.reshape(lead + y.shape[-2:])
        win = self.win(x.device)
        return kernel_with_torch_vjp(
            lambda xv: _sk.stft_power(xv, self.nfft, self.hop, win),
            lambda xv: _sk.stft_power_plain(xv, self.nfft, self.hop, win),
        )(x)

    def _norm(self, nf: int, output_len: int, device) -> torch.Tensor:
        return _ik.ola_norm(get_window_np(self.window, self.nfft,
                                          self.window_param),
                            self.hop, nf, output_len, device)

    def reconstruct(self, spec: torch.Tensor, output_len: int,
                    rfft: bool = False) -> torch.Tensor:
        """Inverse STFT with w^2-normalized overlap-add: (..., frames, bins)
        -> (..., output_len), bins = nfft//2+1 with rfft=True, else nfft.
        Only bins 0..nfft//2 are read, as the JAX package's packed inverse
        does, so with rfft=False the spectrum is taken to be Hermitian
        (the spectrum of a real signal)."""
        if spec.ndim != 3:
            lead = spec.shape[:-2]
            out = self.reconstruct(spec.reshape((-1,) + spec.shape[-2:]),
                                   output_len, rfft)
            return out.reshape(lead + out.shape[-1:])
        m = self.nfft // 2
        bins = m + 1 if rfft else self.nfft
        if spec.shape[-1] != bins:
            raise ValueError(f"rfft={rfft} expects {bins} bins, got "
                             f"{spec.shape[-1]}")
        spec = spec.to(torch.complex64)
        half = (spec if rfft else spec[..., :m + 1]).contiguous()
        win = self.win(spec.device)
        norm = self._norm(spec.shape[-2], output_len, spec.device)
        return kernel_with_torch_vjp(
            lambda sp: _ik.istft(sp, self.nfft, self.hop, output_len, win,
                                 norm),
            lambda sp: _ik.istft_plain(sp, self.nfft, self.hop, output_len,
                                       win, norm),
        )(half)

    def _ola_norm(self, time: torch.Tensor, output_len: int) -> torch.Tensor:
        """(..., frames, nfft) inverse frames -> (..., output_len): window,
        overlap-add, divide by the guarded w^2 norm."""
        norm = self._norm(time.shape[-2], output_len, time.device)
        return _ik.overlap_add_normalized(time, self.win(time.device),
                                          self.hop, output_len, norm)

    def process_packed(self, x: torch.Tensor) -> PackedSpectrum:
        """Forward STFT of (channels, n) real input into the spectrum that
        ``reconstruct_packed`` consumes as it is."""
        if x.ndim != 2 or x.is_complex():
            raise ValueError("process_packed needs 2-D real input; use "
                             "process()")
        return PackedSpectrum(self.process(x, rfft=True), self.nfft,
                              self.hop)

    def reconstruct_packed(self, ps: PackedSpectrum,
                           output_len: int) -> torch.Tensor:
        """Inverse of ``process_packed`` (the OLA and norm of
        ``reconstruct``)."""
        if (ps.nfft, ps.hop) != (self.nfft, self.hop):
            raise ValueError(f"spectrum of nfft={ps.nfft} hop={ps.hop} given "
                             f"to a plan of nfft={self.nfft} hop={self.hop}")
        return self.reconstruct(ps.spec, output_len, rfft=True)


def power_spectrogram_onesided(x: torch.Tensor, nfft: int, hop: int,
                               window: str = "hann") -> torch.Tensor:
    """|rfft|^2 over frames, the MFCC pipeline's input shape."""
    return STFT(nfft, hop, window).power(x)
