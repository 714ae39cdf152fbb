"""The port's inverse-STFT kernel, with its plain version: the one-sided
spectrum's inverse with w^2-normalized overlap-add and the SpectralGate's
optional per-frame peak gate (the part of ``vv_dsp_tpu/ops/pallas_fft.py``
behind ``istft_packed``, ``istft_packed_from_storage`` and
``stft_gate_split``); and the packed fused gate, forward, gate, inverse
and overlap-add in one kernel (``stft_gate_packed``).

Frame f of the output is ``irfft(spec[:, f], nfft)``, windowed and added at
f*hop; the sum is divided by the w^2 overlap-add norm, whose values at or
below 1e-12 are replaced by 1 (``ola_norm_np``). With ``gate_threshold`` t,
bin k of a frame is zeroed first unless ``p2[k] >= t^2 * max(p2)``, with
``p2 = re^2 + im^2`` over the frame's nfft//2+1 bins, in float32.

Both versions ignore the imaginary parts of the DC and Nyquist bins, as
``torch.fft.irfft`` does on the CPU (the TPU kernel folds them into its
repack; for the spectrum of a real signal they are rounding noise). The
plain version zeroes them itself: cuFFT's c2r transform reads them at
large batches (2.9% of scale at 60 x 76 frames of 1024/256). On a CUDA tensor
``istft`` launches the kernel in ``csrc/istft.cu`` or raises, and
``stft_gate_packed`` the kernel in ``csrc/gate_packed.cu``; on a CPU
tensor each runs its plain version. Both kernels run the nfft/2-point
register-resident transform of ``csrc/fft_reg.cuh`` (its twiddle table
``fft_plan.pass_twiddles``; the blocks' layouts ``fft_plan.packed_istft_smem``
and ``fft_plan.gate_packed_smem``, which the launchers check). The inverse
copies each group's spectrum rows into a shared-memory stage one group
ahead of their use; while a ``torch.profiler`` session runs, each launch
also counts its groups and those whose rows had landed when first looked
at (``ring_tally``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch._build import ptr
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import fft_plan, framing
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.utils import profiling


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
    overlap-add (``framing.overlap_add``: shifted dense adds at any hop,
    deterministic on a CUDA tensor), divide by the guarded norm."""
    return framing.overlap_add(time * window, hop, output_len) / norm


def gate_plain(spec: torch.Tensor, gate_threshold: float) -> torch.Tensor:
    """Zero each bin whose power is below t^2 times its frame's peak
    power, comparing squared magnitudes in float32."""
    p2 = spec.real * spec.real + spec.imag * spec.imag
    peak2 = p2.amax(dim=-1, keepdim=True)
    thresh2 = torch.tensor(float(gate_threshold) ** 2, dtype=p2.dtype,
                           device=p2.device)
    return torch.where(p2 >= thresh2 * peak2, spec, torch.zeros_like(spec))


def _real_ends(spec: torch.Tensor) -> torch.Tensor:
    """spec with the imaginary parts of its DC and Nyquist bins zeroed."""
    k = torch.arange(spec.shape[-1], device=spec.device)
    ends = (k == 0) | (k == spec.shape[-1] - 1)
    return torch.where(ends, torch.complex(spec.real,
                                           torch.zeros_like(spec.real)), spec)


def istft_plain(spec: torch.Tensor, nfft: int, hop: int, output_len: int,
                window: torch.Tensor, norm: torch.Tensor,
                gate_threshold: float | None = None) -> torch.Tensor:
    """(..., frames, nfft//2+1) one-sided spectrum -> (..., output_len):
    the gate when given, the DC and Nyquist bins made real, irfft, window,
    overlap-add, divide by the norm (``ola_norm``)."""
    if gate_threshold is not None:
        spec = gate_plain(spec, gate_threshold)
    return overlap_add_normalized(_fft.irfft(_real_ends(spec), nfft), window,
                                  hop, output_len, norm)


@_build.counted
def istft(spec: torch.Tensor, nfft: int, hop: int, output_len: int,
          window: torch.Tensor, norm: torch.Tensor,
          gate_threshold: float | None = None) -> torch.Tensor:
    """(c, frames, nfft//2+1) complex64 -> (c, output_len) float32 in one
    kernel pass on a CUDA tensor, each output sample written once. norm:
    ``ola_norm`` of the window's float64 values, on spec's device."""
    if spec.device.type == "cpu":
        return istft_plain(spec, nfft, hop, output_len, window, norm,
                           gate_threshold)
    with profiling.span("kernel.istft"):
        _sk.require_frames("istft", spec, window, nfft, hop, istft_supported,
                           "spec", 3, torch.complex64)
        c, nf, _ = spec.shape
        if output_len < 1:
            raise ValueError(f"output_len must be positive, got {output_len}")
        _build.require(spec, "spec", spec.device, (c, nf, nfft // 2 + 1),
                       torch.complex64)
        _build.require(norm, "norm", spec.device, (output_len,))
        out = torch.empty((c, output_len), dtype=torch.float32,
                          device=spec.device)
        tw = fft_plan.pass_twiddles(nfft // 2, spec.device)
        wk = _sk._fft_tables(nfft, spec.device)[1]
        gate = gate_threshold is not None
        thresh2 = float(gate_threshold) ** 2 if gate else 0.0
        smem = fft_plan.packed_istft_smem(nfft, hop)
        tally = (ptr(_tally_on(spec.device))
                 if profiling._profiler_on() else None)
        lib, dev, stream = _build.target(spec)
        launches = _build.launch(istft, c, lambda r0, k: lib.vv_istft(
            ptr(spec, r0), ptr(window), ptr(tw), ptr(wk), ptr(norm),
            ptr(out, r0), k, nf, nfft, hop, output_len, int(gate), thresh2,
            smem, dev, stream, tally))
        if tally is not None:
            istft.ring_launches += launches
        return out


istft.ring_launches = 0      # launches that added to ring_tally

_tallies: dict[torch.device, torch.Tensor] = {}


def _tally_on(device: torch.device) -> torch.Tensor:
    """The spectrum stage's two device counters on `device`: groups
    walked, and groups whose rows had landed when the block first
    looked."""
    if device not in _tallies:
        _tallies[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _tallies[device]


def ring_tally(device=None, reset: bool = False) -> dict:
    """What the inverse's spectrum stage counted on `device` (the current
    CUDA device if None) over the launches made while a ``torch.profiler``
    session ran: ``groups`` walked, ``ready``, those whose copy had landed
    when their block first tested its barrier, and ``launches`` (all
    devices'). reset zeroes them after the read. Synchronises the device:
    for tests and ``chip_smoke.py``, never the hot path."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    groups, ready = (int(v) for v in _tally_on(device).tolist())
    read = {"launches": istft.ring_launches, "groups": groups,
            "ready": ready}
    if reset:
        _tally_on(device).zero_()
        istft.ring_launches = 0
    return read


def periodic_norm_np(window, hop: int, n: int) -> np.ndarray:
    """(n,) float32 interior-periodic w^2 norm (the JAX package's
    ``stft_gate_packed`` divides by it): the sum over r < q = nfft/hop of
    w^2[r*hop:(r+1)*hop], in float64, values <= 1e-12 replaced by 1, tiled
    over n. It equals ``ola_norm_np`` wherever q frames cover a sample,
    which is every sample a COLA-padded caller keeps."""
    wsq = np.asarray(window, np.float64) ** 2
    q = len(wsq) // hop
    period = wsq[:q * hop].reshape(q, hop).sum(axis=0)
    period = np.where(period > 1e-12, period, 1.0)
    return np.tile(period, -(-n // hop))[:n].astype(np.float32)


@functools.lru_cache(maxsize=32)
def _periodic_on(window_bytes: bytes, hop: int, n: int,
                 device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        periodic_norm_np(np.frombuffer(window_bytes, np.float64), hop, n),
        device=device)


def periodic_norm(window, hop: int, n: int, device) -> torch.Tensor:
    """``periodic_norm_np`` of a float64 host window as a float32 tensor on
    `device`, built once per geometry."""
    return _periodic_on(np.asarray(window, np.float64).tobytes(), hop, n,
                        torch.device(device))


def _gate_tier(algorithm: str | None) -> None:
    """The fused gate computes float32, under any matmul-precision knob;
    naming another tier raises."""
    if algorithm is not None and config.dot_algorithm(algorithm) != "f32":
        raise ValueError(f"stft_gate_packed computes float32; tier "
                         f"{algorithm!r} is not available")


def stft_gate_packed_plain(x: torch.Tensor, nfft: int, hop: int,
                           threshold: float, window: torch.Tensor,
                           norm: torch.Tensor,
                           algorithm: str | None = None) -> torch.Tensor:
    """(..., n) real -> (..., n): the one-sided spectrum of every frame,
    ``gate_plain`` (each bin kept iff re^2 + im^2 >= t^2 times the frame's
    peak over the nfft//2+1 bins, in float32), irfft, window, overlap-add,
    divide by the norm."""
    _gate_tier(algorithm)
    spec = _sk.stft_spectrum_plain(x, nfft, hop, window, onesided=True)
    return istft_plain(spec, nfft, hop, x.shape[-1], window, norm, threshold)


@_build.counted
def stft_gate_packed(x: torch.Tensor, nfft: int, hop: int, threshold: float,
                     window: torch.Tensor, norm: torch.Tensor,
                     algorithm: str | None = None) -> torch.Tensor:
    """Fused STFT -> spectral gate -> ISTFT on the packed-real transforms
    (the port of ``vv_dsp_tpu/ops/pallas_fft.py::stft_gate_packed``): (c, n)
    float32 -> (c, n) in one kernel pass on a CUDA tensor, the spectrum
    never in device memory, each output sample written once. x is
    COLA-padded by the caller, as for ``stft_gate_split``: a sample whose
    frames do not all lie in [0, n) is off the contract. norm: the
    interior-periodic norm, ``periodic_norm`` (the JAX function's), on x's
    device. algorithm: the JAX function's dot-algorithm argument; the
    kernel computes float32, and any other tier raises. The geometry is
    ``stft_kernels.packed_gate_supported``."""
    _gate_tier(algorithm)
    if x.device.type == "cpu":
        return stft_gate_packed_plain(x, nfft, hop, threshold, window, norm)
    with profiling.span("kernel.stft_gate_packed"):
        _sk.require_frames("stft_gate_packed", x, window, nfft, hop,
                           _sk.packed_gate_supported)
        c, n = x.shape
        _build.require(norm, "norm", x.device, (n,))
        out = torch.empty_like(x)
        nf = framing.stft_num_frames(n, nfft, hop)
        tw = fft_plan.pass_twiddles(nfft // 2, x.device)
        wk = _sk._fft_tables(nfft, x.device)[1]
        smem = fft_plan.gate_packed_smem(nfft, hop)
        lib, dev, stream = _build.target(x)
        _build.launch(stft_gate_packed, c, lambda r0, k:
                      lib.vv_stft_gate_packed(
                          ptr(x, r0), ptr(window), ptr(tw), ptr(wk),
                          ptr(norm), ptr(out, r0), k, n, nf, nfft, hop,
                          float(threshold) ** 2, smem, dev, stream))
        return out
