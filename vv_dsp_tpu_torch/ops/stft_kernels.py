"""The port's forward STFT kernels, with their plain versions: the windowed
packed-real STFT spectrum, the one-sided power spectrogram and the fused
STFT -> mel -> log -> DCT (MFCC) front end (the parts of
``vv_dsp_tpu/ops/pallas_fft.py`` behind ``stft_spectrum_packed``,
``stft_power_packed`` and ``stft_mfcc_pallas`` /
``stft_mel_energies_pallas``), and the power spectrogram as a windowed-DFT
product (``vv_dsp_tpu/ops/pallas_kernels.py::stft_power_pallas``), whose
plain version is the framing-free ``power_parts``.

Frame f covers x[f*hop, f*hop + nfft), zero-padded past the signal, and a
signal of n samples has ``stft_num_frames(n, nfft, hop)`` frames. On a CUDA
tensor ``stft_spectrum`` and ``stft_mfcc`` launch the kernels in
``csrc/stft.cu``, or raise; on a CPU tensor they run the plain versions
(framing, window, ``torch.fft``, matmuls at the same tier). The same holds
for ``stft_power``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import fft_plan, mma_plan
from vv_dsp_tpu_torch.ops.framing import frames_strided, stft_num_frames
from vv_dsp_tpu_torch.ops.window import get_window_np


def stft_supported(nfft: int, hop: int) -> bool:
    """Geometry the kernels take: power-of-two nfft in [256, 4096] (the
    m = nfft/2 complex frame, its powers and the mel row fit shared memory
    with room), 0 < hop <= nfft. The JAX kernels' hop % 16 condition keeps
    TPU sublanes aligned and has no counterpart here."""
    return (256 <= nfft <= 4096 and nfft & (nfft - 1) == 0
            and 0 < hop <= nfft)


def packed_supported(nfft: int, hop: int) -> bool:
    """The JAX package's packed-real kernels' geometry (a copy of
    ``stft_mel_packed_supported``): pow2 nfft in [256, 4096], hop | nfft,
    hop % 16 == 0, q = nfft/hop <= 128."""
    return (256 <= nfft <= 4096 and nfft & (nfft - 1) == 0
            and hop > 0 and nfft % hop == 0 and hop % 16 == 0
            and nfft // hop <= 128)


def packed_gate_supported(nfft: int, hop: int) -> bool:
    """A copy of ``stft_gate_packed_supported``: the packed geometry with
    hop < nfft, so the overlap-add has coverage."""
    return packed_supported(nfft, hop) and hop < nfft


@functools.lru_cache(maxsize=16)
def _fft_tables(nfft: int, device: torch.device):
    """(tw (m/2, 2), wk (m+1, 2)) float32 (cos, sin) tables, built in
    float64: tw[k] = exp(-2 pi i k / m) for the m-point butterflies and
    wk[k] = exp(-2 pi i k / nfft) for the Hermitian unpack."""
    m = nfft // 2
    a = -2.0 * np.pi * np.arange(m // 2) / m
    b = -2.0 * np.pi * np.arange(m + 1) / nfft
    tw = np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)
    wk = np.stack([np.cos(b), np.sin(b)], axis=-1).astype(np.float32)
    return (torch.as_tensor(tw, device=device),
            torch.as_tensor(wk, device=device))


def _check_signal(x: torch.Tensor, window: torch.Tensor, nfft: int,
                  hop: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{name} expects (channels, n)")
    _build.require(x, "x", x.device)
    _build.require(window, "window", x.device, (nfft,))
    if not stft_supported(nfft, hop):
        raise ValueError(f"{name}: unsupported geometry nfft={nfft} "
                         f"hop={hop}; check stft_supported()")
    if not 0 < x.shape[0] <= 65535:
        raise ValueError(f"channels must be in [1, 65535], got {x.shape[0]}")


def stft_spectrum_plain(x: torch.Tensor, nfft: int, hop: int,
                        window: torch.Tensor,
                        onesided: bool = False) -> torch.Tensor:
    """Windowed STFT: (..., n) -> (..., frames, nfft) complex, or
    (..., frames, nfft//2+1) when onesided (real input only)."""
    nf = stft_num_frames(x.shape[-1], nfft, hop)
    frames = frames_strided(x, nfft, hop, nf) * window
    if onesided:
        return _fft.rfft(frames)
    return _fft.fft(frames)


def stft_spectrum(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
                  onesided: bool = False) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft) complex64 (two-sided, the
    Hermitian mirror written by the kernel) or (c, frames, nfft//2+1)."""
    if x.device.type == "cpu":
        return stft_spectrum_plain(x, nfft, hop, window, onesided)
    _check_signal(x, window, nfft, hop, "stft_spectrum")
    c, n = x.shape
    nf = stft_num_frames(n, nfft, hop)
    bins = nfft // 2 + 1 if onesided else nfft
    out = torch.empty((c, nf, bins), dtype=torch.complex64, device=x.device)
    tw = fft_plan.pass_twiddles(nfft // 2, x.device)
    wk = _fft_tables(nfft, x.device)[1]
    err = _build.library().vv_stft_spectrum(
        _build.ptr(x), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(out), c, n, nf, nfft, hop, bins, x.device.index,
        _build.stream_handle(x))
    _build.check(err, "stft_spectrum")
    stft_spectrum.launches += 1
    return out


stft_spectrum.launches = 0


def stft_power_plain(x: torch.Tensor, nfft: int, hop: int,
                     window: torch.Tensor) -> torch.Tensor:
    """|rfft(w * frame)|^2: (..., n) -> (..., frames, nfft//2+1), natural
    bin order (real input only)."""
    spec = stft_spectrum_plain(x, nfft, hop, window, onesided=True)
    return spec.real * spec.real + spec.imag * spec.imag


def stft_power(x: torch.Tensor, nfft: int, hop: int,
               window: torch.Tensor) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft//2+1) float32 one-sided power in
    one kernel pass on a CUDA tensor: the complex spectrum never leaves
    shared memory."""
    if x.device.type == "cpu":
        return stft_power_plain(x, nfft, hop, window)
    _check_signal(x, window, nfft, hop, "stft_power")
    c, n = x.shape
    nf = stft_num_frames(n, nfft, hop)
    out = torch.empty((c, nf, nfft // 2 + 1), dtype=torch.float32,
                      device=x.device)
    tw, wk = _fft_tables(nfft, x.device)
    err = _build.library().vv_stft_power(
        _build.ptr(x), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(out), c, n, nf, nfft, hop, x.device.index,
        _build.stream_handle(x))
    _build.check(err, "stft_power")
    stft_power.launches += 1
    return out


stft_power.launches = 0


def stft_mfcc_plain(x: torch.Tensor, nfft: int, hop: int,
                    window: torch.Tensor, mel_fb: torch.Tensor,
                    dct: torch.Tensor | None = None, log_eps: float = 1e-10,
                    algorithm: str | None = None) -> torch.Tensor:
    """rfft -> |X|^2 -> mel (-> log(. + log_eps) -> DCT rows when dct is
    given): (..., n) -> (..., frames, n_mfcc) or (..., frames, n_mels).
    mel_fb: (n_mels, nfft//2+1); dct: (n_mfcc, n_mels), lifter folded in."""
    spec = stft_spectrum_plain(x, nfft, hop, window, onesided=True)
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = config.tier_matmul(power, mel_fb.T, algorithm)
    if dct is None:
        return mel
    return config.tier_matmul(torch.log(mel + log_eps), dct.T, algorithm)


def band_edges_np(mel_fb) -> np.ndarray:
    """(2, n_mels) int32 rows [lo; hi): per mel row of a host filterbank,
    the bin range around its nonzero weights (an all-zero row gets an empty
    range). Built once beside the filterbank; the MFCC kernel sums each
    band over its range only."""
    nz = np.asarray(mel_fb) != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, nz.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return np.stack([lo, hi]).astype(np.int32)


def stft_mfcc(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
              mel_fb: torch.Tensor, bands: torch.Tensor,
              dct: torch.Tensor | None = None, log_eps: float = 1e-10,
              algorithm: str | None = None) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, n_mfcc) MFCCs, or (c, frames, n_mels)
    mel energies when dct is None, in one kernel pass on a CUDA tensor: the
    frames, spectrum and power stay in shared memory. bands: mel_fb's
    ``band_edges_np`` on x's device (the plain version does not need it)."""
    algorithm = config.dot_algorithm(algorithm)
    if x.device.type == "cpu":
        return stft_mfcc_plain(x, nfft, hop, window, mel_fb, dct, log_eps,
                               algorithm)
    _check_signal(x, window, nfft, hop, "stft_mfcc")
    n_mels = mel_fb.shape[0]
    _build.require(mel_fb, "mel_fb", x.device, (n_mels, nfft // 2 + 1))
    _build.require(bands, "bands", x.device, (2, n_mels), torch.int32)
    n_out = n_mels
    if dct is not None:
        n_out = dct.shape[0]
        _build.require(dct, "dct", x.device, (n_out, n_mels))
    c, n = x.shape
    nf = stft_num_frames(n, nfft, hop)
    out = torch.empty((c, nf, n_out), dtype=torch.float32, device=x.device)
    tw, wk = _fft_tables(nfft, x.device)
    err = _build.library().vv_stft_mfcc(
        _build.ptr(x), _build.ptr(window), _build.ptr(tw), _build.ptr(wk),
        _build.ptr(mel_fb), _build.ptr(bands[0]), _build.ptr(bands[1]),
        _build.ptr(dct if dct is not None else mel_fb), _build.ptr(out), c,
        n, nf, nfft, hop, n_mels, n_out, float(log_eps),
        config.ALGORITHMS.index(algorithm), int(dct is not None),
        x.device.index,
        _build.stream_handle(x))
    _build.check(err, "stft_mfcc")
    stft_mfcc.launches += 1
    return out


stft_mfcc.launches = 0


@functools.lru_cache(maxsize=16)
def _windowed_rfft_basis(nfft: int, window: str, param, dtype_name: str):
    """(re, im) of diag(w) @ B_r2c, (nfft, nfft//2+1), built in float64 on
    the host and cast once (a copy of the JAX package's
    ``ops/stft.py::_windowed_rfft_basis``): windowing a frame and
    multiplying by the DFT basis is multiplying by the row-scaled basis."""
    w = get_window_np(window, nfft, param)
    b = _fft._dft_basis(nfft, "r2c") * w[:, None]
    dt = np.dtype(dtype_name)
    return (np.ascontiguousarray(b.real).astype(dt),
            np.ascontiguousarray(b.imag).astype(dt))


def power_parts(x: torch.Tensor, nfft: int, hop: int, bre: torch.Tensor,
                bim: torch.Tensor, nf: int):
    """(re, im) of the windowed rfft of nf frames, for hop | nfft, without
    framing: frame k spans x[k*hop : k*hop + nfft], so with the windowed
    basis cut into q = nfft/hop row blocks, X[k] = sum_r x_r[k] @
    B[r*hop:(r+1)*hop], where x_r is the signal shifted by r*hop and viewed
    as (nf, hop) rows. bre, bim: the basis parts in x's dtype on x's
    device. (..., n) -> two (..., nf, nfft//2+1)."""
    need = (nf - 1) * hop + nfft
    if need > x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    lead = x.shape[:-1]
    re = im = 0.0
    for r in range(nfft // hop):
        seg = x[..., r * hop:r * hop + nf * hop].reshape(lead + (nf, hop))
        re = re + torch.matmul(seg, bre[r * hop:(r + 1) * hop])
        im = im + torch.matmul(seg, bim[r * hop:(r + 1) * hop])
    return re, im


@functools.lru_cache(maxsize=16)
def _dft_basis_on(nfft: int, window: str, param, dtype: torch.dtype,
                  device: torch.device, cols: int):
    """The windowed basis parts as (nfft, cols) tensors on `device`, zero
    past column nfft//2: the plain version's operands (cols = bins). The
    kernel's operand is ``_dft_parts_on``, built from the same basis."""
    name = str(dtype).removeprefix("torch.")
    parts = []
    for b in _windowed_rfft_basis(nfft, window, param, name):
        b = np.pad(b, ((0, 0), (0, cols - b.shape[1])))
        parts.append(torch.as_tensor(b, device=device))
    return tuple(parts)


def _check_dft_geometry(nfft: int, hop: int) -> None:
    if nfft % hop or hop % 128:
        raise ValueError("stft_power_dft needs hop | nfft and 128 | hop")


def stft_power_dft_plain(x: torch.Tensor, nfft: int, hop: int,
                         window: str = "hann", window_param=None,
                         n_frames: int | None = None) -> torch.Tensor:
    """|power_parts|^2 = re^2 + im^2, the JAX package's
    ``STFT._power_direct`` (the port's ``STFT._power_direct`` is this):
    (..., n) real -> (..., frames, nfft//2+1), for hop | nfft;
    ``stft_power_dft`` adds its 128 | hop refusal."""
    if x.is_complex():
        raise TypeError("stft_power_dft requires real input")
    if n_frames is None:
        n_frames = stft_num_frames(x.shape[-1], nfft, hop)
    bre, bim = _dft_basis_on(nfft, window, window_param, x.dtype, x.device,
                             nfft // 2 + 1)
    re, im = power_parts(x, nfft, hop, bre, bim, n_frames)
    return re * re + im * im


@functools.lru_cache(maxsize=16)
def _dft_parts_on(nfft: int, window: str, param, device: torch.device):
    """The kernel's B: the float32 windowed basis's three bf16 parts,
    columns interleaved (re, im) and tiled (``mma_plan.dft_parts_np``), as
    a bf16 tensor on `device`."""
    bre, bim = _windowed_rfft_basis(nfft, window, param, "float32")
    return torch.as_tensor(mma_plan.dft_parts_np(bre, bim),
                           device=device).to(torch.bfloat16).contiguous()


def stft_power_dft(x: torch.Tensor, nfft: int, hop: int,
                   window: str = "hann", window_param=None,
                   n_frames: int | None = None) -> torch.Tensor:
    """|rfft(w * frame)|^2 as one windowed-DFT product (the port's
    ``vv_dsp_tpu/ops/pallas_kernels.py::stft_power_pallas``, with its
    signature and refusals): (c, n) float32 -> (c, n_frames, nfft//2+1)
    float32, n_frames the STFT's frame count unless given. Needs hop | nfft
    and 128 | hop, on every device. On a CUDA tensor one kernel
    (``csrc/dft_power.cu``) multiplies the frames, never formed, by the
    windowed r2c basis on the tensor cores at the f32 tier (its operands'
    three bf16 parts, six products) and squares in registers; on a CPU
    tensor it runs the plain version."""
    _check_dft_geometry(nfft, hop)
    if x.device.type == "cpu":
        return stft_power_dft_plain(x, nfft, hop, window, window_param,
                                    n_frames)
    if x.device.type != "cuda":
        raise ValueError(f"stft_power_dft: unsupported device {x.device}")
    if x.ndim != 2:
        raise ValueError("stft_power_dft expects (channels, n)")
    _build.require(x, "x", x.device)
    c, n = x.shape
    if not 0 < c <= 65535:
        raise ValueError(f"channels must be in [1, 65535], got {c}")
    if n_frames is None:
        n_frames = stft_num_frames(n, nfft, hop)
    if n_frames < 1:
        raise ValueError(f"n_frames must be positive, got {n_frames}")
    bins = nfft // 2 + 1
    plan = mma_plan.dft_plan(nfft, hop)
    bparts = _dft_parts_on(nfft, window, window_param, x.device)
    out = torch.empty((c, n_frames, bins), dtype=torch.float32,
                      device=x.device)
    err = _build.library().vv_dft_power(
        _build.ptr(x), _build.ptr(bparts), _build.ptr(out), c, n, n_frames,
        nfft, hop, bins, mma_plan.dft_cols(nfft), plan.tiles, plan.smem,
        x.device.index, _build.stream_handle(x))
    _build.check(err, "stft_power_dft")
    stft_power_dft.launches += 1
    return out


stft_power_dft.launches = 0
