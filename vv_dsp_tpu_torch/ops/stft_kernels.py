"""The port's forward STFT kernels, with their plain versions: the windowed
packed-real STFT spectrum, the one-sided power spectrogram and the fused
STFT -> mel -> log -> DCT (MFCC) front end (the parts of
``vv_dsp_tpu/ops/pallas_fft.py`` behind ``stft_spectrum_packed``,
``stft_power_packed`` and ``stft_mfcc_pallas`` /
``stft_mel_energies_pallas``), and the power spectrogram as a windowed-DFT
product (``vv_dsp_tpu/ops/pallas_kernels.py::stft_power_pallas``), whose
plain version is the framing-free ``power_parts``.

Frame f covers x[f*hop, f*hop + nfft), zero-padded past the signal, and a
signal of n samples has ``stft_num_frames(n, nfft, hop)`` frames;
``stft_spectrum`` also takes a zero pad at both ends, which its kernel
reads in place. On a CUDA tensor ``stft_spectrum`` and ``stft_mfcc``
launch the kernels in ``csrc/stft.cu``, or raise; on a CPU tensor they run
the plain versions (framing, window, ``torch.fft``, matmuls at the same
tier). The same holds for ``stft_power``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch._build import ptr
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import fft_plan, mma_plan
from vv_dsp_tpu_torch.ops.framing import frames_strided, stft_num_frames
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils import profiling
from vv_dsp_tpu_torch.utils.tensor_cache import PerTensor


def stft_supported(nfft: int, hop: int) -> bool:
    """Geometry the kernels take: power-of-two nfft in [256, 4096] (the
    m = nfft/2 complex frame of the register-resident transform, 128 to
    2048 points), 0 < hop <= nfft. The JAX kernels' hop % 16 condition
    keeps TPU sublanes aligned and has no counterpart here."""
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
    float64: wk[k] = exp(-2 pi i k / nfft) for the Hermitian unpack, and
    tw[k] = exp(-2 pi i k / m), the JAX package's radix-2 stage twiddles
    (the tests hold both to its tables; the kernels' butterflies take
    ``fft_plan.pass_twiddles``)."""
    m = nfft // 2
    a = -2.0 * np.pi * np.arange(m // 2) / m
    b = -2.0 * np.pi * np.arange(m + 1) / nfft
    tw = np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)
    wk = np.stack([np.cos(b), np.sin(b)], axis=-1).astype(np.float32)
    return (torch.as_tensor(tw, device=device),
            torch.as_tensor(wk, device=device))


def require_frames(op: str, x: torch.Tensor, window: torch.Tensor,
                   nfft: int, hop: int, supported=stft_supported,
                   name: str = "x", ndim: int = 2, dtype=None) -> None:
    """The STFT kernels' refusal: raise unless x is rows op's entry takes
    (``_build.require_rows``), window an (nfft,) float32 tensor on x's
    device and supported(nfft, hop)."""
    _build.require_rows(x, op, name, ndim, dtype)
    _build.require(window, "window", x.device, (nfft,))
    if not supported(nfft, hop):
        raise ValueError(f"{op}: unsupported geometry nfft={nfft} hop={hop}; "
                         f"check {supported.__name__}()")


def stft_spectrum_plain(x: torch.Tensor, nfft: int, hop: int,
                        window: torch.Tensor, onesided: bool = False,
                        pad: int = 0) -> torch.Tensor:
    """Windowed STFT: (..., n) -> (..., frames, nfft) complex, or
    (..., frames, nfft//2+1) when onesided (real input only), of x
    zero-padded by pad samples at both ends."""
    if pad:
        x = torch.nn.functional.pad(x, (pad, pad))
    nf = stft_num_frames(x.shape[-1], nfft, hop)
    frames = frames_strided(x, nfft, hop, nf) * window
    if onesided:
        return _fft.rfft(frames)
    return _fft.fft(frames)


@_build.counted
def stft_spectrum(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
                  onesided: bool = False, pad: int = 0) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft) complex64 (two-sided, the
    Hermitian mirror written by the kernel) or (c, frames, nfft//2+1), of
    x zero-padded by pad samples at both ends: the kernel reads the pad in
    place (frame f starts at f*hop - pad), so no padded copy is made; each
    launch with pad > 0 adds one to ``stft_spectrum.edge_pads``."""
    if pad < 0:
        raise ValueError(f"stft_spectrum: pad must be >= 0, got {pad}")
    if x.device.type == "cpu":
        return stft_spectrum_plain(x, nfft, hop, window, onesided, pad)
    with profiling.span("kernel.stft_spectrum"):
        require_frames("stft_spectrum", x, window, nfft, hop)
        c, n = x.shape
        nf = stft_num_frames(n + 2 * pad, nfft, hop)
        bins = nfft // 2 + 1 if onesided else nfft
        out = torch.empty((c, nf, bins), dtype=torch.complex64,
                          device=x.device)
        tw = fft_plan.pass_twiddles(nfft // 2, x.device)
        wk = _fft_tables(nfft, x.device)[1]
        lib, dev, stream = _build.target(x)
        launches = _build.launch(
            stft_spectrum, c, lambda r0, k: lib.vv_stft_spectrum(
                ptr(x, r0), ptr(window), ptr(tw), ptr(wk), ptr(out, r0), k,
                n, nf, nfft, hop, bins, pad, dev, stream))
        if pad:
            stft_spectrum.edge_pads += launches
        return out


# launches of stft_spectrum that read an edge pad in place, always on
stft_spectrum.edge_pads = 0


def stft_power_plain(x: torch.Tensor, nfft: int, hop: int,
                     window: torch.Tensor) -> torch.Tensor:
    """|rfft(w * frame)|^2: (..., n) -> (..., frames, nfft//2+1), natural
    bin order (real input only)."""
    spec = stft_spectrum_plain(x, nfft, hop, window, onesided=True)
    return spec.real * spec.real + spec.imag * spec.imag


@_build.counted
def stft_power(x: torch.Tensor, nfft: int, hop: int,
               window: torch.Tensor) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, nfft//2+1) float32 one-sided power in
    one kernel pass on a CUDA tensor: ``stft_spectrum``'s register-resident
    walk, writing re^2 + im^2 where it writes a bin, so the complex
    spectrum never leaves registers and shared memory."""
    if x.device.type == "cpu":
        return stft_power_plain(x, nfft, hop, window)
    with profiling.span("kernel.stft_power"):
        require_frames("stft_power", x, window, nfft, hop)
        c, n = x.shape
        nf = stft_num_frames(n, nfft, hop)
        out = torch.empty((c, nf, nfft // 2 + 1), dtype=torch.float32,
                          device=x.device)
        tw = fft_plan.pass_twiddles(nfft // 2, x.device)
        wk = _fft_tables(nfft, x.device)[1]
        lib, dev, stream = _build.target(x)
        _build.launch(stft_power, c, lambda r0, k: lib.vv_stft_power(
            ptr(x, r0), ptr(window), ptr(tw), ptr(wk), ptr(out, r0), k, n,
            nf, nfft, hop, dev, stream))
        return out


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


_MEL_TABLES = PerTensor()


def _mel_tables(mel_fb: torch.Tensor, bands: torch.Tensor):
    """(weights, index): ``fft_plan.compact_filterbank_np`` of the
    filterbank on its device, cached for the filterbank tensor (rebuilt if
    it or its bands are written in place, or other bands come with it), so
    a call reads nothing back from the device after its first. The entry
    holds its bands, so their id names them while it lives."""
    def build():
        fb = mel_fb.detach().cpu().numpy()
        lo, hi = bands.cpu().numpy()
        if not ((0 <= lo) & (lo <= hi) & (hi <= fb.shape[1])).all():
            raise ValueError("bands must be [lo; hi) bin ranges of mel_fb's "
                             "rows (band_edges_np)")
        return bands, tuple(torch.as_tensor(t, device=mel_fb.device) for t in
                            fft_plan.compact_filterbank_np(fb, (lo, hi)))
    return _MEL_TABLES.get(mel_fb, (id(bands), bands._version), build)[1]


@_build.counted
def stft_mfcc(x: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
              mel_fb: torch.Tensor, bands: torch.Tensor,
              dct: torch.Tensor | None = None, log_eps: float = 1e-10,
              algorithm: str | None = None) -> torch.Tensor:
    """(c, n) float32 -> (c, frames, n_mfcc) MFCCs, or (c, frames, n_mels)
    mel energies when dct is None, in one kernel pass on a CUDA tensor: the
    frames, spectrum and power stay in registers and shared memory. bands:
    mel_fb's ``band_edges_np`` on x's device (the plain version does not
    need it); the kernel sums each band over that range, from the
    filterbank's compact form (``fft_plan.compact_filterbank_np``, built on
    the first call with this filterbank) in the layout of
    ``fft_plan.mfcc_plan``, which raises where a block's log-mel rows do not
    fit its shared memory (above 2,744 mel bands at nfft 256, 13,911 at
    4096)."""
    algorithm = config.dot_algorithm(algorithm)
    if x.device.type == "cpu":
        return stft_mfcc_plain(x, nfft, hop, window, mel_fb, dct, log_eps,
                               algorithm)
    with profiling.span("kernel.stft_mfcc"):
        require_frames("stft_mfcc", x, window, nfft, hop)
        n_mels = mel_fb.shape[0]
        _build.require(mel_fb, "mel_fb", x.device, (n_mels, nfft // 2 + 1))
        _build.require(bands, "bands", x.device, (2, n_mels), torch.int32)
        n_out = n_mels
        if dct is not None:
            n_out = dct.shape[0]
            _build.require(dct, "dct", x.device, (n_out, n_mels))
        c, n = x.shape
        nf = stft_num_frames(n, nfft, hop)
        weights, index = _mel_tables(mel_fb, bands)
        plan = fft_plan.mfcc_plan(nfft, n_mels, n_out, weights.numel(),
                                  dct is not None)
        out = torch.empty((c, nf, n_out), dtype=torch.float32, device=x.device)
        tw = fft_plan.pass_twiddles(nfft // 2, x.device)
        wk = _fft_tables(nfft, x.device)[1]
        lib, dev, stream = _build.target(x)
        _build.launch(stft_mfcc, c, lambda r0, k: lib.vv_stft_mfcc(
            ptr(x, r0), ptr(window), ptr(tw), ptr(wk), ptr(weights),
            ptr(index), ptr(dct if dct is not None else weights), ptr(out, r0),
            k, n, nf, nfft, hop, n_mels, n_out, weights.numel(),
            float(log_eps), config.ALGORITHMS.index(algorithm),
            int(dct is not None), int(plan.staged), plan.smem, dev, stream))
        return out


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


@_build.counted
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
    with profiling.span("kernel.stft_power_dft"):
        _build.require_rows(x, "stft_power_dft")
        c, n = x.shape
        if n_frames is None:
            n_frames = stft_num_frames(n, nfft, hop)
        if n_frames < 1:
            raise ValueError(f"n_frames must be positive, got {n_frames}")
        bins = nfft // 2 + 1
        plan = mma_plan.dft_plan(nfft, hop)
        bparts = _dft_parts_on(nfft, window, window_param, x.device)
        out = torch.empty((c, n_frames, bins), dtype=torch.float32,
                          device=x.device)
        lib, dev, stream = _build.target(x)
        _build.launch(stft_power_dft, c, lambda r0, k: lib.vv_dft_power(
            ptr(x, r0), ptr(bparts), ptr(out, r0), k, n, n_frames, nfft,
            hop, bins, mma_plan.dft_cols(nfft), plan.tiles, plan.smem, dev,
            stream))
        return out
