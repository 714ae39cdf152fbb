"""The port's inverse-STFT kernel, with its plain version: the one-sided
spectrum's inverse with w^2-normalized overlap-add and the SpectralGate's
optional per-frame peak gate (the part of ``vv_dsp_tpu/ops/pallas_fft.py``
behind ``istft_packed``, ``istft_packed_from_storage`` and
``stft_gate_split``).

Frame f of the output is ``irfft(spec[:, f], nfft)``, windowed and added at
f*hop; the sum is divided by the w^2 overlap-add norm, whose values at or
below 1e-12 are replaced by 1 (``ola_norm_np``). With ``gate_threshold`` t,
bin k of a frame is zeroed first unless ``p2[k] >= t^2 * max(p2)``, with
``p2 = re^2 + im^2`` over the frame's nfft//2+1 bins, in float32.

Both versions ignore the imaginary parts of the DC and Nyquist bins, as
``torch.fft.irfft`` does (the TPU kernel folds them into its repack; for
the spectrum of a real signal they are rounding noise). On a CUDA tensor
``istft`` launches the kernel in ``csrc/istft.cu`` or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import _build
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import framing
from vv_dsp_tpu_torch.ops import stft_kernels as _sk


def istft_supported(nfft: int, hop: int) -> bool:
    """Geometry the kernel takes: the forward kernels' (power-of-two nfft
    in [256, 4096]) with hop | nfft, as the JAX package's packed inverse
    (whose hop % 16 term keeps TPU sublanes aligned and has no counterpart
    here)."""
    return _sk.stft_supported(nfft, hop) and nfft % hop == 0


def ola_norm_np(window, hop: int, nf: int, output_len: int) -> np.ndarray:
    """(output_len,) float32 w^2 overlap-add norm of nf frames of the
    float64 window, summed in float64 (a copy of the JAX package's
    ``_ola_norm_table``): zero past the frames' cover, cut at output_len,
    and values <= 1e-12 replaced by 1."""
    wsq = np.asarray(window, np.float64) ** 2
    q = -(-len(wsq) // hop)
    wsq = np.pad(wsq, (0, q * hop - len(wsq)))
    acc = np.zeros((nf + q - 1, hop), np.float64)
    for r in range(q):
        acc[r:r + nf] += wsq[r * hop:(r + 1) * hop][None, :]
    flat = acc.reshape(-1)
    if output_len > flat.shape[0]:
        flat = np.pad(flat, (0, output_len - flat.shape[0]))
    flat = flat[:output_len]
    return np.where(flat > 1e-12, flat, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _norm_on(window_bytes: bytes, hop: int, nf: int, output_len: int,
             device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        ola_norm_np(np.frombuffer(window_bytes, np.float64), hop, nf,
                    output_len), device=device)


def ola_norm(window, hop: int, nf: int, output_len: int,
             device) -> torch.Tensor:
    """``ola_norm_np`` of a float64 host window as a float32 tensor on
    `device`, built once per geometry."""
    return _norm_on(np.asarray(window, np.float64).tobytes(), hop, nf,
                    output_len, torch.device(device))


def overlap_add_normalized(time: torch.Tensor, window: torch.Tensor,
                           hop: int, output_len: int,
                           norm: torch.Tensor) -> torch.Tensor:
    """(..., frames, nfft) inverse frames -> (..., output_len): window,
    overlap-add, divide by the guarded norm. Where hop divides nfft (every
    geometry the kernel takes) the overlap-add is the strided form: dense
    adds, deterministic on a CUDA tensor (the scatter-add's index_add_ is
    not) and differentiable without a scatter. Other geometries, which
    only CPU tensors reach, take the scatter-add."""
    ola = (framing.overlap_add_strided if time.shape[-1] % hop == 0
           else framing.overlap_add)
    return ola(time * window, hop, output_len) / norm


def gate_plain(spec: torch.Tensor, gate_threshold: float) -> torch.Tensor:
    """Zero each bin whose power is below t^2 times its frame's peak
    power, comparing squared magnitudes in float32."""
    p2 = spec.real * spec.real + spec.imag * spec.imag
    peak2 = p2.amax(dim=-1, keepdim=True)
    thresh2 = torch.tensor(float(gate_threshold) ** 2, dtype=p2.dtype,
                           device=p2.device)
    return torch.where(p2 >= thresh2 * peak2, spec, torch.zeros_like(spec))


def istft_plain(spec: torch.Tensor, nfft: int, hop: int, output_len: int,
                window: torch.Tensor, norm: torch.Tensor,
                gate_threshold: float | None = None) -> torch.Tensor:
    """(..., frames, nfft//2+1) one-sided spectrum -> (..., output_len):
    the gate when given, irfft, window, overlap-add, divide by the norm
    (``ola_norm``)."""
    if gate_threshold is not None:
        spec = gate_plain(spec, gate_threshold)
    return overlap_add_normalized(_fft.irfft(spec, nfft), window, hop,
                                  output_len, norm)


def istft(spec: torch.Tensor, nfft: int, hop: int, output_len: int,
          window: torch.Tensor, norm: torch.Tensor,
          gate_threshold: float | None = None) -> torch.Tensor:
    """(c, frames, nfft//2+1) complex64 -> (c, output_len) float32 in one
    kernel pass on a CUDA tensor, each output sample written once. norm:
    ``ola_norm`` of the window's float64 values, on spec's device."""
    if spec.device.type == "cpu":
        return istft_plain(spec, nfft, hop, output_len, window, norm,
                           gate_threshold)
    if spec.device.type != "cuda":
        raise ValueError(f"istft: unsupported device {spec.device}")
    if spec.ndim != 3:
        raise ValueError("istft expects (channels, frames, nfft//2+1)")
    if not istft_supported(nfft, hop):
        raise ValueError(f"istft: unsupported geometry nfft={nfft} hop={hop};"
                         f" check istft_supported()")
    c, nf, _ = spec.shape
    if not 0 < c <= 65535:
        raise ValueError(f"channels must be in [1, 65535], got {c}")
    if output_len < 1:
        raise ValueError(f"output_len must be positive, got {output_len}")
    _build.require(spec, "spec", spec.device, (c, nf, nfft // 2 + 1),
                   torch.complex64)
    _build.require(window, "window", spec.device, (nfft,))
    _build.require(norm, "norm", spec.device, (output_len,))
    out = torch.empty((c, output_len), dtype=torch.float32,
                      device=spec.device)
    tw, wk = _sk._fft_tables(nfft, spec.device)
    gate = gate_threshold is not None
    thresh2 = float(gate_threshold) ** 2 if gate else 0.0
    err = _build.library().vv_istft(
        _build.ptr(spec), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(norm), _build.ptr(out), c, nf, nfft, hop, output_len,
        int(gate), thresh2, spec.device.index, _build.stream_handle(spec))
    _build.check(err, "istft")
    istft.launches += 1
    return out


istft.launches = 0
