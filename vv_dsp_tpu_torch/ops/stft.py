"""STFT plan: forward, power and inverse (counterpart of
``vv_dsp_tpu/ops/stft.py``).

Frames start at f*hop (non-centered), the tail frame is zero-padded, the
frame count is 1 if n < nfft else 1 + (n - nfft + hop)//hop, and the
forward transform is the unscaled FFT of the windowed frame. The inverse
is the 1/nfft-scaled inverse of each frame, windowed, overlap-added and
divided by the w^2 overlap-add norm (values <= 1e-12 replaced by 1).

Each entry point picks its route from the geometry alone
(``spectrum_route``, ``power_route``, ``inverse_route``), as the JAX
package does on the TPU: the full-nfft kernels (``stockham_kernels``)
where ``takes_stockham`` holds (nfft = 128 for ``power``, hop = 8), the
packed kernels where they take the geometry, and "torch" where the JAX
package runs XLA: the plain version, ``torch.fft`` and dense adds, on
any device (a non-power-of-two nfft, one off both kernels' lattices,
complex input, an inverse whose hop does not divide nfft). A kernel route
goes through the kernel wrapper, wrapped so that its gradient is the
plain version's: a CPU tensor runs the plain version, a CUDA tensor the
kernel, which raises at what it does not take. Two routes reach past the
JAX package's kernels: at nfft = 128, where it runs ``process`` and
``reconstruct`` on XLA, both take the full-nfft kernels
(``takes_stockham_128``), and the packed forward and inverse kernels take
every hop of their nfft range (``stft_kernels.stft_supported``,
``istft_kernels.istft_supported``): the same numbers, on the card.

The framing-free parts (``power_parts``, ``reconstruct_parts``, and the
mel functions of ``ops/mel.py`` built on them) are plain matrix products
with the windowed DFT bases, as the JAX package computes them on XLA.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import framing
from vv_dsp_tpu_torch.ops import istft_kernels as _ik
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops import stockham_kernels as _stk
from vv_dsp_tpu_torch.ops.packed import PackedSpectrum
from vv_dsp_tpu_torch.ops.window import get_window, get_window_np
from vv_dsp_tpu_torch.utils import profiling
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp
from vv_dsp_tpu_torch.utils.shapes import collapse_leading


@functools.lru_cache(maxsize=32)
def _window_on(name: str, n: int, param, device: torch.device) -> torch.Tensor:
    return get_window(name, n, param, device=device)


def spectrum_route(nfft: int, hop: int, is_complex: bool) -> str:
    """``process``'s route: "full_nfft", "packed" or "torch"."""
    if is_complex:
        return "torch"
    if (_stk.takes_stockham(nfft, hop, min_nfft=512)
            or _stk.takes_stockham_128(nfft, hop)):
        return "full_nfft"
    return "packed" if _sk.stft_supported(nfft, hop) else "torch"


def power_route(nfft: int, hop: int, is_complex: bool) -> str:
    """``power``'s route: "full_nfft", "packed" or "torch" (which raises
    on complex input, as the JAX package's does)."""
    if is_complex:
        return "torch"
    if _stk.takes_stockham(nfft, hop):
        return "full_nfft"
    return "packed" if _sk.stft_supported(nfft, hop) else "torch"


def inverse_route(nfft: int, hop: int) -> str:
    """``reconstruct``'s route: "full_nfft", "packed" or "torch"."""
    if _stk.takes_stockham_128(nfft, hop):
        return "full_nfft"
    return "packed" if _ik.istft_supported(nfft, hop) else "torch"


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
        # the kernels take contiguous rows; a strided view is copied
        x = config.as_compute(x).contiguous()
        if not x.is_complex() and x.dtype != torch.float32:
            x = x.float()
        return x

    def process(self, x: torch.Tensor, rfft: bool = False) -> torch.Tensor:
        """Forward STFT of (..., n) -> (..., frames, nfft) complex (or
        (..., frames, nfft//2+1) with rfft=True). Span (while a profiler
        runs): ``stft`` around the call."""
        with profiling.span("stft"):
            x = self._signal(x)
            restore = None
            if x.ndim != 2 and not x.is_complex():
                x, restore = collapse_leading(x)
            win = self.win(x.device)
            route = spectrum_route(self.nfft, self.hop, x.is_complex())
            if route == "torch":
                y = _sk.stft_spectrum_plain(x, self.nfft, self.hop, win,
                                            onesided=rfft)
            else:
                spectrum = (_stk.stft_spectrum_stockham if route == "full_nfft"
                            else _sk.stft_spectrum)
                y = kernel_with_torch_vjp(
                    lambda xv: spectrum(xv, self.nfft, self.hop, win,
                                        onesided=rfft),
                    lambda xv: _sk.stft_spectrum_plain(xv, self.nfft, self.hop,
                                                       win, onesided=rfft),
                )(x)
            return y if restore is None else restore(y, 2)

    def power(self, x: torch.Tensor) -> torch.Tensor:
        """One-sided power spectrogram |rfft(w * frame)|^2, the complex
        spectrum never in device memory: (..., n) -> (..., frames,
        nfft//2+1)."""
        x = self._signal(x)
        restore = None
        if x.ndim != 2 and not x.is_complex():
            x, restore = collapse_leading(x)
        win = self.win(x.device)
        route = power_route(self.nfft, self.hop, x.is_complex())
        if route == "torch":
            y = _sk.stft_power_plain(x, self.nfft, self.hop, win)
        else:
            power = (_stk.stft_power_stockham if route == "full_nfft"
                     else _sk.stft_power)
            y = kernel_with_torch_vjp(
                lambda xv: power(xv, self.nfft, self.hop, win),
                lambda xv: _sk.stft_power_plain(xv, self.nfft, self.hop, win),
            )(x)
        return y if restore is None else restore(y, 2)

    def power_parts(self, x: torch.Tensor, nf: int | None = None):
        """(re, im) of the windowed rfft, framing-free, for hop | nfft:
        (..., n) -> two (..., frames, nfft//2+1). Frame k spans
        x[k*hop : k*hop + nfft], so the windowed basis cut into q = nfft/hop
        row blocks gives X[k] = sum_r x_r[k] @ Bw[r*hop:(r+1)*hop], x_r a
        strided view of x shifted by r*hop; the frames never exist. Linear
        reductions of the power (the mel projection) can then take
        (re*re) and (im*im) (``mel.mel_energies_from_power_parts``). Real
        input only (the windowed r2c basis assumes it)."""
        x = self._parts_input(x)
        if nf is None:
            nf = self.num_frames(x.shape[-1])
        bre, bim = _sk._dft_basis_on(self.nfft, self.window,
                                     self.window_param, x.dtype, x.device,
                                     self.nfft // 2 + 1)
        return _sk.power_parts(x, self.nfft, self.hop, bre, bim, nf)

    def _power_direct(self, x: torch.Tensor, nf: int) -> torch.Tensor:
        """Framing-free power spectrogram for hop | nfft (see power_parts):
        |X|^2 = re^2 + im^2; the plain version of ``stft_power_dft``."""
        return _sk.stft_power_dft_plain(self._parts_input(x), self.nfft,
                                        self.hop, self.window,
                                        self.window_param, nf)

    def _parts_input(self, x: torch.Tensor) -> torch.Tensor:
        """x for the framing-free parts: real, hop | nfft; float64 stays
        float64, else float32 (``_real_compute_dtype``)."""
        if x.is_complex():
            raise TypeError("power_parts requires real input (windowed r2c)")
        if self.nfft % self.hop:
            raise ValueError("power_parts needs hop | nfft")
        x = config.as_compute(x)
        return x if x.dtype == torch.float64 else x.float()

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
        (the spectrum of a real signal), on every route. At nfft = 128 the
        full-nfft inverse (``stockham_kernels.istft_stockham``) takes the
        half spectrum in its rfft=True form; where hop divides a power of
        two nfft in [256, 4096], the packed inverse; elsewhere the plain
        version (irfft, then the deterministic overlap-add)."""
        lead = spec.shape[:-2]
        if spec.ndim != 3:     # a 1-D spectrum is one frame
            spec = spec.reshape((-1,) + torch.atleast_2d(spec).shape[-2:])
        m = self.nfft // 2
        bins = m + 1 if rfft else self.nfft
        if spec.shape[-1] != bins:
            raise ValueError(f"rfft={rfft} expects {bins} bins, got "
                             f"{spec.shape[-1]}")
        spec = spec.to(torch.complex64)
        half = (spec if rfft else spec[..., :m + 1]).contiguous()
        win = self.win(spec.device)
        norm = self._norm(spec.shape[-2], output_len, spec.device)
        route = inverse_route(self.nfft, self.hop)
        plain = lambda sp: _ik.istft_plain(sp, self.nfft, self.hop,
                                           output_len, win, norm)
        if route == "torch":
            out = plain(half)
        else:
            if route == "full_nfft":
                fast = lambda sp: _stk.istft_stockham(
                    sp, self.nfft, self.hop, output_len, win, norm, rfft=True)
            else:
                fast = lambda sp: _ik.istft(sp, self.nfft, self.hop,
                                            output_len, win, norm)
            out = kernel_with_torch_vjp(fast, plain)(half)
        return out.reshape(lead + out.shape[-1:])

    def reconstruct_parts(self, re: torch.Tensor, im: torch.Tensor,
                          output_len: int) -> torch.Tensor:
        """Inverse STFT from the one-sided (re, im) rfft parts, the complex
        spectrum never formed: irfft(X) = re @ M_re - im @ M_im with M the
        weighted c2r basis (1/nfft and the Hermitian double weights folded
        in, ``fft._dft_basis``), then the windowed, w^2-normalized
        overlap-add of ``reconstruct``. Pairs with ``power_parts``."""
        name = str(re.dtype).removeprefix("torch.")
        mre, mim = (torch.as_tensor(_fft._basis_cast(self.nfft, "c2r", part,
                                                     name), device=re.device)
                    for part in ("re", "im"))
        return self._ola_norm(re @ mre - im @ mim, output_len)

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

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        """Magnitude spectrogram (vv_dsp_stft_spectrogram,
        src/spectral/stft.c:112-144): (..., n) -> (..., frames, nfft), all
        two-sided bins, |process(x)| (the JAX package's route off its
        dense-matmul tier)."""
        return self.process(x).abs()


def stft_spectrogram(x: torch.Tensor, nfft: int, hop: int,
                     window: str = "hann") -> torch.Tensor:
    return STFT(nfft, hop, window).spectrogram(x)


def power_spectrogram_onesided(x: torch.Tensor, nfft: int, hop: int,
                               window: str = "hann") -> torch.Tensor:
    """|rfft|^2 over frames, the MFCC pipeline's input shape."""
    return STFT(nfft, hop, window).power(x)
