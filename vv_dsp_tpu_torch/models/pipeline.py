"""The models of ``vv_dsp_tpu/models/pipeline.py`` as ``nn.Module``s:
``NorthStarChain``, ``SpectralGate`` and ``MFCCFrontend``.

Each builds its buffers (the device constants) on ``device``, the card
unless the caller passes ``device="cpu"``, and raises without a GPU rather
than building on the CPU. ``forward`` raises when the input lies on another
device than the buffers.

NorthStarChain:

1024-tap FIR -> 4/3 polyphase resample (one fused banded upfirdn, kernel 1)
-> 2048/512 STFT -> 80 HTK mel bands -> log -> 20 MFCCs (one fused kernel,
kernel 2). The module's buffers are the device constants: the composite
head filter's polyphase table, the window, the mel filterbank with its
band edges and the liftered DCT rows. ``chain_params`` builds them on the
host in float64; ``convert.params_from_reference`` carries the JAX
chain's arrays across.

The JAX chain hands the head's raw segment tiles to the STFT kernel on the
TPU to skip two transposes; here the head writes natural (c, n_out) order,
which is what the MFCC kernel reads, so the chain runs the two kernels
back to back (the same numbers).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fir as _fir
from vv_dsp_tpu_torch.ops import istft_kernels as _ik
from vv_dsp_tpu_torch.ops import mel as _mel
from vv_dsp_tpu_torch.ops import resample as _rs
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from vv_dsp_tpu_torch.ops.upfirdn import polyphase_table_np
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp


def _build_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to build on "
                           "the CPU")
    return device


def _check_input(x: torch.Tensor, buffer: torch.Tensor, name: str) -> None:
    if x.device != buffer.device:
        raise ValueError(f"{name}: input on {x.device}, buffers on "
                         f"{buffer.device}; move one to the other")


def _buffer(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def chain_params(fir_taps: int = 1024, fir_cutoff: float = 0.45, up: int = 4,
                 down: int = 3, nfft: int = 2048, n_mels: int = 80,
                 n_mfcc: int = 20, sample_rate: float = 48000.0,
                 window: str = "hann") -> dict:
    """The chain's host constants, as numpy arrays: fir_coeffs (float32, as
    the JAX chain keeps them), the composite head filter g (float64) and
    its offset, the window, the mel filterbank at the output rate and the
    DCT-II rows (float64)."""
    fir = _fir.design_lowpass_np(fir_taps, fir_cutoff).astype(np.float32)
    gcd = math.gcd(up, down)
    g, offset = _rs._fused_fir_resample_filter(
        tuple(fir.astype(np.float64)), up // gcd, down // gcd)
    sr = sample_rate * up / down
    return {
        "fir_coeffs": fir,
        "g": g,
        "offset": offset,
        "window": get_window_np(window, nfft),
        "mel_fb": _mel.mel_filterbank_np(nfft, n_mels, float(sr), 0.0,
                                         float(sr) / 2.0, "htk"),
        "dct_lift": _mel.mfcc_dct_np(n_mels, n_mfcc, 0.0),
    }


class NorthStarChain(nn.Module):
    """1024-tap FIR -> up/down polyphase resample -> STFT -> log-mel -> MFCC.

    Same fields and defaults as the JAX chain. head_algorithm and
    stft_algorithm name the dot-algorithm tier of the banded head and of
    the mel/DCT contractions ("bf16x3" by default, as in the JAX chain;
    "f32" for full float32). params: host constants from ``chain_params``
    or ``convert.params_from_reference``; built from the fields when None.
    """

    def __init__(self, fir_taps: int = 1024, fir_cutoff: float = 0.45,
                 up: int = 4, down: int = 3, nfft: int = 2048, hop: int = 512,
                 n_mels: int = 80, n_mfcc: int = 20,
                 sample_rate: float = 48000.0, window: str = "hann",
                 fused_head: bool = True,
                 head_algorithm: str | None = "bf16x3",
                 stft_algorithm: str | None = "bf16x3",
                 params: dict | None = None, device="cuda"):
        super().__init__()
        device = _build_device(device)
        if not fused_head:
            raise NotImplementedError(
                "fused_head=False (the separate FIR and resample kernels) is "
                "not ported yet")
        self.fir_taps, self.fir_cutoff = fir_taps, fir_cutoff
        self.up, self.down = up, down
        self.nfft, self.hop = nfft, hop
        self.n_mels, self.n_mfcc = n_mels, n_mfcc
        self.sample_rate, self.window_name = sample_rate, window
        self.fused_head = fused_head
        self.head_algorithm = head_algorithm
        self.stft_algorithm = stft_algorithm
        if params is None:
            params = chain_params(fir_taps, fir_cutoff, up, down, nfft, n_mels,
                                  n_mfcc, sample_rate, window)
        # host copy: the staged tail correction is built from it per length
        self.fir_coeffs = np.asarray(params["fir_coeffs"])

        up_r = up // math.gcd(up, down)
        self.register_buffer("head_taps", _buffer(
            polyphase_table_np(params["g"], up_r), device))
        self.register_buffer("window", _buffer(params["window"], device))
        self.register_buffer("mel_fb", _buffer(params["mel_fb"], device))
        self.register_buffer("mel_bands", torch.as_tensor(
            _sk.band_edges_np(params["mel_fb"]), device=device))
        self.register_buffer("dct_lift", _buffer(params["dct_lift"], device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (channels, n) -> (channels, frames, n_mfcc)."""
        x = config.as_compute(x)
        _check_input(x, self.head_taps, "NorthStarChain")
        y = _rs.fir_resample_fused(self.fir_coeffs, x, self.up, self.down,
                                   algorithm=self.head_algorithm,
                                   taps=self.head_taps)
        return _mel.mfcc_stft_with(y, self.nfft, self.hop, self.window,
                                   self.mel_fb, self.mel_bands,
                                   self.dct_lift, 1e-10,
                                   self.stft_algorithm)


class SpectralGate(nn.Module):
    """The reference's end-to-end benchmark pipeline: frame -> window ->
    FFT -> spectral magnitude gate -> IFFT -> OLA
    (bench/bench_pipeline.c:77-120). Every bin whose power is below
    threshold^2 times its frame's peak power is zeroed.

    The input is zero-padded by nfft - hop at both ends, so that every
    sample of the signal has full window coverage (at the edges the w^2
    norm goes to 0, and dividing a gated frame by it would amplify the
    error without bound), and the output is cut back to the input's
    length. On a CUDA tensor it runs the spectrum kernel (one-sided) and
    then the inverse kernel with the gate. params: ``{"window": float64
    (nfft,)}``, e.g. ``convert.gate_params_from_reference``; the named
    window when None.
    """

    def __init__(self, nfft: int = 1024, hop: int = 256,
                 threshold: float = 0.1, window: str = "hann",
                 params: dict | None = None, device="cuda"):
        super().__init__()
        if not 0 < hop <= nfft:
            raise ValueError("need 0 < hop <= nfft")
        device = _build_device(device)
        self.nfft, self.hop, self.threshold = nfft, hop, threshold
        self.window_name = window
        if params is None:
            params = {"window": get_window_np(window, nfft)}
        # host copy in float64: the w^2 norm is built from it per length
        self.window_np = np.asarray(params["window"], dtype=np.float64)
        if self.window_np.shape != (nfft,):
            raise ValueError(f"window must have shape ({nfft},)")
        self.register_buffer("window", _buffer(self.window_np, device))

    @property
    def edge_pad(self) -> int:
        return self.nfft - self.hop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> (..., n) gated."""
        x = config.as_compute(x)
        if x.is_complex():
            raise TypeError("SpectralGate requires real input")
        if x.ndim != 2:
            return self(x.reshape(-1, x.shape[-1])).reshape(x.shape)
        _check_input(x, self.window, "SpectralGate")
        x = x.float()
        n, pad = x.shape[-1], self.edge_pad
        xp = F.pad(x, (pad, pad))
        n_pad = xp.shape[-1]
        nfft, hop, win, t = self.nfft, self.hop, self.window, self.threshold
        norm = _ik.ola_norm(self.window_np, hop,
                            stft_num_frames(n_pad, nfft, hop), n_pad,
                            x.device)

        def fast(xv):
            spec = _sk.stft_spectrum(xv, nfft, hop, win, onesided=True)
            return _ik.istft(spec, nfft, hop, n_pad, win, norm, t)

        def plain(xv):
            spec = _sk.stft_spectrum_plain(xv, nfft, hop, win, onesided=True)
            return _ik.istft_plain(spec, nfft, hop, n_pad, win, norm, t)

        out = kernel_with_torch_vjp(fast, plain)(xp)
        return out[..., pad:pad + n]


def frontend_params(nfft: int = 1024, n_mels: int = 26, n_mfcc: int = 13,
                    sample_rate: float = 16000.0, lifter: float = 0.0,
                    window: str = "hann", fmin: float = 0.0,
                    fmax: float | None = None) -> dict:
    """MFCCFrontend's host constants in float64: the window, the HTK mel
    filterbank and the DCT-II rows with the lifter folded in."""
    if fmax is None:
        fmax = sample_rate / 2.0
    return {
        "window": get_window_np(window, nfft),
        "mel_fb": _mel.mel_filterbank_np(nfft, n_mels, float(sample_rate),
                                         float(fmin), float(fmax), "htk"),
        "dct_lift": _mel.mfcc_dct_np(n_mels, n_mfcc, float(lifter)),
    }


class MFCCFrontend(nn.Module):
    """Signal -> MFCC features, the tools/dump_mfcc.c chain as one model:
    STFT power -> mel filterbank -> log -> DCT-II -> lifter, in the fused
    MFCC kernel on a CUDA tensor (float32 contractions). params: host
    constants from ``frontend_params`` or
    ``convert.frontend_params_from_reference``; built from the fields when
    None.
    """

    def __init__(self, nfft: int = 1024, hop: int = 256, n_mels: int = 26,
                 n_mfcc: int = 13, sample_rate: float = 16000.0,
                 lifter: float = 0.0, window: str = "hann",
                 fmin: float = 0.0, fmax: float | None = None,
                 params: dict | None = None, device="cuda"):
        super().__init__()
        device = _build_device(device)
        self.nfft, self.hop = nfft, hop
        self.n_mels, self.n_mfcc = n_mels, n_mfcc
        self.sample_rate, self.lifter = sample_rate, lifter
        self.window_name, self.fmin, self.fmax = window, fmin, fmax
        if params is None:
            params = frontend_params(nfft, n_mels, n_mfcc, sample_rate,
                                     lifter, window, fmin, fmax)
        self.register_buffer("window", _buffer(params["window"], device))
        self.register_buffer("mel_fb", _buffer(params["mel_fb"], device))
        self.register_buffer("mel_bands", torch.as_tensor(
            _sk.band_edges_np(params["mel_fb"]), device=device))
        self.register_buffer("dct_lift", _buffer(params["dct_lift"], device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> (..., frames, n_mfcc)."""
        x = config.as_compute(x)
        _check_input(x, self.window, "MFCCFrontend")
        return _mel.mfcc_stft_with(x, self.nfft, self.hop, self.window,
                                   self.mel_fb, self.mel_bands,
                                   self.dct_lift)
