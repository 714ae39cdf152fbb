"""The port's full-nfft STFT kernels, with their plain versions: the
windowed complex spectrum, the one-sided power spectrogram, the fused
STFT -> power -> mel (-> log -> DCT) front end, the fused SpectralGate and
the inverse STFT (the parts of ``vv_dsp_tpu/ops/pallas_fft.py`` behind
``stft_spectrum_stockham``, ``stft_power_stockham``, ``_stft_mel_call``,
``stft_gate_pallas`` and ``istft_stockham``).

The JAX package runs these where its packed-real kernels refuse the
geometry: ``stockham_supported`` and not ``stft_kernels.packed_supported``
(copies of ``stft_mel_supported`` and ``stft_mel_packed_supported``), which
for a power-of-two nfft is nfft = 128 at any hop, or hop = 8. ``takes_stockham``
and ``takes_stockham_gate`` are that route; the entry points
(``STFT.process``/``power``, ``mel.mfcc_stft_with``, ``SpectralGate``)
follow it on every device. ``takes_stockham_128`` adds the one route the
JAX package leaves to XLA: ``STFT.process`` and ``reconstruct`` at
nfft = 128, below the packed kernels' lattice. On a CUDA tensor each
wrapper launches its kernel in ``csrc/stockham.cu`` or raises; on a CPU
tensor it runs the plain version. The spectrum, power and mel kernels compute the functions of the
packed kernels of ``stft_kernels`` (only the transform inside differs), so
they share those plain versions; the mel kernel's contractions are float32
whatever tier the caller names, as on the TPU.
"""

from __future__ import annotations

import torch

from vv_dsp_tpu_torch import _build
from vv_dsp_tpu_torch._build import ptr
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import fft_plan
from vv_dsp_tpu_torch.ops import istft_kernels as _ik
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from vv_dsp_tpu_torch.utils import profiling


def stockham_supported(nfft: int, hop: int) -> bool:
    """The full-nfft kernels' geometry (a copy of ``stft_mel_supported``):
    pow2 nfft in [128, 2048], hop | nfft, hop % 8 == 0, q = nfft/hop <=
    128."""
    return (128 <= nfft <= 2048 and nfft & (nfft - 1) == 0
            and hop > 0 and nfft % hop == 0 and hop % 8 == 0
            and nfft // hop <= 128)


def stockham_gate_supported(nfft: int, hop: int) -> bool:
    """A copy of ``stft_gate_supported``: the full-nfft geometry with
    hop < nfft."""
    return stockham_supported(nfft, hop) and hop < nfft


def takes_stockham(nfft: int, hop: int, min_nfft: int = 128) -> bool:
    """Whether the JAX package routes this geometry to the full-nfft
    kernels: the packed kernels refuse it and the full-nfft ones take it
    (from min_nfft up: ``STFT.process`` starts at 512)."""
    return (not _sk.packed_supported(nfft, hop) and nfft >= min_nfft
            and stockham_supported(nfft, hop))


def takes_stockham_gate(nfft: int, hop: int) -> bool:
    """Whether the JAX package's SpectralGate takes the fused full-nfft
    gate kernel rather than the packed split pair."""
    return (not _sk.packed_gate_supported(nfft, hop)
            and stockham_gate_supported(nfft, hop))


def takes_stockham_128(nfft: int, hop: int) -> bool:
    """Whether ``STFT.process`` and ``reconstruct`` take the full-nfft
    kernels at a geometry where the JAX package runs XLA: nfft = 128 (below
    the packed kernels' 256) on the full-nfft lattice."""
    return nfft == 128 and stockham_supported(nfft, hop)


stft_spectrum_stockham_plain = _sk.stft_spectrum_plain
stft_power_stockham_plain = _sk.stft_power_plain


@_build.counted
def stft_spectrum_stockham(x: torch.Tensor, nfft: int, hop: int,
                           window: torch.Tensor,
                           onesided: bool = False) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft) complex64, or (c, frames,
    nfft//2+1) when onesided, in natural bin order."""
    if x.device.type == "cpu":
        return stft_spectrum_stockham_plain(x, nfft, hop, window, onesided)
    with profiling.span("kernel.stft_spectrum_stockham"):
        _sk.require_frames("stft_spectrum_stockham", x, window, nfft, hop,
                           stockham_supported)
        c, n = x.shape
        nf = stft_num_frames(n, nfft, hop)
        bins = nfft // 2 + 1 if onesided else nfft
        out = torch.empty((c, nf, bins), dtype=torch.complex64,
                          device=x.device)
        tw = fft_plan.pass_twiddles(nfft, x.device)
        lib, dev, stream = _build.target(x)
        _build.launch(stft_spectrum_stockham, c, lambda r0, k:
                      lib.vv_stockham_spectrum(
                          ptr(x, r0), ptr(window), ptr(tw), ptr(out, r0), k,
                          n, nf, nfft, hop, bins, dev, stream))
        return out


@_build.counted
def stft_power_stockham(x: torch.Tensor, nfft: int, hop: int,
                        window: torch.Tensor) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft//2+1) float32 one-sided power in
    one kernel pass on a CUDA tensor."""
    if x.device.type == "cpu":
        return stft_power_stockham_plain(x, nfft, hop, window)
    with profiling.span("kernel.stft_power_stockham"):
        _sk.require_frames("stft_power_stockham", x, window, nfft, hop,
                           stockham_supported)
        c, n = x.shape
        nf = stft_num_frames(n, nfft, hop)
        out = torch.empty((c, nf, nfft // 2 + 1), dtype=torch.float32,
                          device=x.device)
        tw = fft_plan.pass_twiddles(nfft, x.device)
        lib, dev, stream = _build.target(x)
        _build.launch(stft_power_stockham, c, lambda r0, k:
                      lib.vv_stockham_power(
                          ptr(x, r0), ptr(window), ptr(tw), ptr(out, r0), k,
                          n, nf, nfft, hop, dev, stream))
        return out


def stft_mel_stockham_plain(x: torch.Tensor, nfft: int, hop: int,
                            window: torch.Tensor, mel_fb: torch.Tensor,
                            dct: torch.Tensor | None = None,
                            log_eps: float = 1e-10) -> torch.Tensor:
    """The packed MFCC kernel's plain version at the float32 tier."""
    return _sk.stft_mfcc_plain(x, nfft, hop, window, mel_fb, dct, log_eps,
                               "f32")


@_build.counted
def stft_mel_stockham(x: torch.Tensor, nfft: int, hop: int,
                      window: torch.Tensor, mel_fb: torch.Tensor,
                      bands: torch.Tensor, dct: torch.Tensor | None = None,
                      log_eps: float = 1e-10) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, n_mfcc) MFCCs, or (c, frames, n_mels)
    mel energies when dct is None, in one kernel pass on a CUDA tensor.
    mel_fb: (n_mels, nfft//2+1); bands: its ``band_edges_np`` on x's
    device; dct: (n_mfcc, n_mels), lifter folded in. The kernel sums each
    band over the filterbank's compact form (``stft_kernels._mel_tables``,
    built on the first call with this filterbank) in the layout of
    ``fft_plan.stockham_mel_plan``."""
    if x.device.type == "cpu":
        return stft_mel_stockham_plain(x, nfft, hop, window, mel_fb, dct,
                                       log_eps)
    with profiling.span("kernel.stft_mel_stockham"):
        _sk.require_frames("stft_mel_stockham", x, window, nfft, hop,
                           stockham_supported)
        n_mels = mel_fb.shape[0]
        _build.require(mel_fb, "mel_fb", x.device, (n_mels, nfft // 2 + 1))
        _build.require(bands, "bands", x.device, (2, n_mels), torch.int32)
        n_out = n_mels
        if dct is not None:
            n_out = dct.shape[0]
            _build.require(dct, "dct", x.device, (n_out, n_mels))
        c, n = x.shape
        nf = stft_num_frames(n, nfft, hop)
        weights, index = _sk._mel_tables(mel_fb, bands)
        plan = fft_plan.stockham_mel_plan(nfft, n_mels, n_out, weights.numel(),
                                          dct is not None)
        out = torch.empty((c, nf, n_out), dtype=torch.float32, device=x.device)
        tw = fft_plan.pass_twiddles(nfft, x.device)
        lib, dev, stream = _build.target(x)
        _build.launch(stft_mel_stockham, c, lambda r0, k: lib.vv_stockham_mel(
            ptr(x, r0), ptr(window), ptr(tw), ptr(weights), ptr(index),
            ptr(dct if dct is not None else weights), ptr(out, r0), k, n, nf,
            nfft, hop, n_mels, n_out, weights.numel(), float(log_eps),
            int(dct is not None), int(plan.staged), plan.smem, dev, stream))
        return out


def stft_gate_stockham_plain(x: torch.Tensor, nfft: int, hop: int,
                             window: torch.Tensor, norm: torch.Tensor,
                             threshold: float) -> torch.Tensor:
    """(..., n) -> (..., n): the two-sided spectrum of every frame, each
    bin zeroed unless re^2 + im^2 >= t^2 times the frame's peak over all
    nfft bins (float32), the real part of the inverse, windowed,
    overlap-added and divided by the norm."""
    spec = _sk.stft_spectrum_plain(x, nfft, hop, window)
    time = _fft.ifft(_ik.gate_plain(spec, threshold)).real
    return _ik.overlap_add_normalized(time, window, hop, x.shape[-1], norm)


@_build.counted
def stft_gate_stockham(x: torch.Tensor, nfft: int, hop: int,
                       window: torch.Tensor, norm: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """(c, n) float32 -> (c, n) gated, in one kernel pass on a CUDA tensor:
    no spectrum in device memory, each output sample written once, two
    frames per register-resident transform each way. norm:
    ``istft_kernels.ola_norm`` of the float64 window for the n samples'
    frames, on x's device."""
    if x.device.type == "cpu":
        return stft_gate_stockham_plain(x, nfft, hop, window, norm,
                                        threshold)
    with profiling.span("kernel.stft_gate_stockham"):
        _sk.require_frames("stft_gate_stockham", x, window, nfft, hop,
                           stockham_gate_supported)
        c, n = x.shape
        _build.require(norm, "norm", x.device, (n,))
        out = torch.empty_like(x)
        nf = stft_num_frames(n, nfft, hop)
        tw = fft_plan.pass_twiddles(nfft, x.device)
        smem = fft_plan.stockham_gate_smem(nfft, hop)
        lib, dev, stream = _build.target(x)
        _build.launch(stft_gate_stockham, c, lambda r0, k:
                      lib.vv_stockham_gate(
                          ptr(x, r0), ptr(window), ptr(tw), ptr(norm),
                          ptr(out, r0), k, n, nf, nfft, hop,
                          float(threshold) ** 2, smem, dev, stream))
        return out


def istft_stockham_plain(spec: torch.Tensor, nfft: int, hop: int,
                         output_len: int, window: torch.Tensor,
                         norm: torch.Tensor,
                         rfft: bool = False) -> torch.Tensor:
    """(..., frames, bins) -> (..., output_len): each frame's inverse
    (irfft of nfft//2+1 bins with rfft=True; the real part of the complex
    inverse of all nfft bins with rfft=False), windowed, overlap-added and
    divided by the norm."""
    time = _fft.irfft(spec, nfft) if rfft else _fft.ifft(spec).real
    return _ik.overlap_add_normalized(time, window, hop, output_len, norm)


@_build.counted
def istft_stockham(spec: torch.Tensor, nfft: int, hop: int, output_len: int,
                   window: torch.Tensor, norm: torch.Tensor,
                   rfft: bool = False) -> torch.Tensor:
    """(c, frames, bins) complex64 -> (c, output_len) float32 in one kernel
    pass on a CUDA tensor, each output sample written once, two frames per
    register-resident transform (``csrc/stockham.cu``). bins = nfft
    (rfft=False: all nfft bins are inverted, a non-Hermitian spectrum
    included, and the real part kept, as the JAX package's
    ``istft_stockham``) or nfft//2+1 (rfft=True: bins above nfft/2 are the
    conjugate mirror, and the imaginary parts of the DC and Nyquist bins
    drop out of the real part, as in irfft). norm: ``istft_kernels.ola_norm``
    of the window's float64 values for these frames, on spec's device (the
    exact guarded w^2 norm the JAX launcher divides by)."""
    bins = nfft // 2 + 1 if rfft else nfft
    if spec.shape[-1] != bins:
        raise ValueError(f"rfft={rfft} expects {bins} bins, got "
                         f"{spec.shape[-1]}")
    if spec.device.type == "cpu":
        return istft_stockham_plain(spec, nfft, hop, output_len, window, norm,
                                    rfft)
    with profiling.span("kernel.istft_stockham"):
        _sk.require_frames("istft_stockham", spec, window, nfft, hop,
                           stockham_supported, "spec", 3, torch.complex64)
        c, nf, _ = spec.shape
        if output_len < 1:
            raise ValueError(f"output_len must be positive, got {output_len}")
        _build.require(norm, "norm", spec.device, (output_len,))
        out = torch.empty((c, output_len), dtype=torch.float32,
                          device=spec.device)
        tw = fft_plan.pass_twiddles(nfft, spec.device)
        smem = fft_plan.istft_smem(nfft, hop)
        lib, dev, stream = _build.target(spec)
        _build.launch(istft_stockham, c, lambda r0, k: lib.vv_istft_stockham(
            ptr(spec, r0), ptr(window), ptr(tw), ptr(norm), ptr(out, r0), k,
            nf, nfft, hop, bins, output_len, smem, dev, stream))
        return out
