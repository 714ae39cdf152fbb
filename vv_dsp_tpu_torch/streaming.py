"""Streaming (block-at-a-time) processing with carried state (counterpart
of ``vv_dsp_tpu/streaming.py``).

The reference's streaming surface is stateful C structs advanced one block
at a time: the FIR history ring buffer (vv_dsp_fir_state,
src/filter/fir.c:160-196), the per-biquad z1/z2 registers
(src/filter/iir.h:14-17), the STFT handle's frame-by-frame process and
reconstruct (src/spectral/stft.c:74-110) and the resampler handle
(src/resample/resampler.c). Here:

- state is an explicit tensor (or a tuple or dict of tensors); every
  ``*_process`` is a function (state, block) -> (output, new state) that
  leaves its arguments untouched;
- block outputs equal the offline ops on the concatenated signal, to float
  tolerance;
- the streaming resampler emits with a fixed latency instead of looking
  ahead, so equal input blocks give equal output blocks; ``flush`` drains
  the tail.

Every ``*_init`` builds its state on ``device``, the card unless the caller
passes another ("cpu"), and raises without a GPU. The states are what
``utils/checkpoint.py`` saves and restores.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import fir as _fir
from vv_dsp_tpu_torch.ops import iir as _iir
from vv_dsp_tpu_torch.ops import resample as _resample
from vv_dsp_tpu_torch.ops.framing import (frames_strided, overlap_add,
                                          overlap_add_strided)
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils.device import build_device


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=build_device(device))


# ---------------------------------------------------------------------------
# many blocks per call
# ---------------------------------------------------------------------------

def scan_stream(step, state, signal: torch.Tensor, block_len: int,
                out_axis: int = -1):
    """Run a stream `step` over the K consecutive blocks of `signal`.

    `step` is any (state, (..., block_len)) -> (out, new_state) step of
    this module, or a composition such as StreamingNorthStar.process.
    `signal` is (..., K*block_len). The result is exactly K sequential
    `step` calls. `out_axis` is the axis of each block's output along
    which consecutive blocks concatenate: -1 for sample streams
    (FIR/IIR/resample/synthesis), -2 for frame streams ((..., frames,
    bins) from STFT analysis or the MFCC chain). Returns (merged outputs,
    final state)."""
    total = signal.shape[-1]
    if block_len <= 0 or total % block_len:
        raise ValueError(
            f"signal length {total} must be a positive multiple of "
            f"block_len {block_len}")
    outs = []
    for i in range(total // block_len):
        out, state = step(state, signal[..., i * block_len:
                                        (i + 1) * block_len])
        if not isinstance(out, torch.Tensor):
            raise TypeError(
                "scan_stream expects step to return a single tensor per "
                f"block; got {type(out).__name__}: merge multi-output steps "
                "yourself or wrap the step to return one tensor")
        outs.append(out)
    if not outs:
        raise ValueError("scan_stream needs at least one block")
    rank = outs[0].ndim
    a = out_axis if out_axis < 0 else out_axis - rank
    if not -rank <= a <= -1:
        raise ValueError(f"out_axis {out_axis} out of range for per-block "
                         f"output of rank {rank}")
    return torch.cat(outs, dim=a), state


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

def fir_stream_init(h, batch_shape=(), dtype=torch.float32, device="cuda"):
    """Zeroed taps-1 history (the reference zeroes its ring buffer,
    src/filter/fir.c:147-153)."""
    taps = (h.shape if isinstance(h, torch.Tensor) else np.shape(h))[-1]
    return _zeros(tuple(batch_shape) + (taps - 1,), dtype, device)


def fir_stream_process(h, state: torch.Tensor, block: torch.Tensor):
    """One block of causal FIR: the convolution of history ++ block cut to
    the block; returns (y, new state). vv_dsp_fir_apply's cross-call
    contract (src/filter/fir.c:160-196). Above 32 taps the block-Toeplitz
    matmuls (``fir.fir_apply_mxu``), else one conv1d, as the JAX stream."""
    taps = (h.shape if isinstance(h, torch.Tensor) else np.shape(h))[-1]
    if taps == 1:
        return _fir.taps_like(h, block)[0] * block, state
    ext = torch.cat([state, block], dim=-1)
    apply = _fir.fir_apply_mxu if taps > 32 else _fir.fir_apply
    y = apply(h, ext)[..., taps - 1:]
    return y, ext[..., -(taps - 1):]


# ---------------------------------------------------------------------------
# IIR
# ---------------------------------------------------------------------------

def iir_stream_init(sos, batch_shape=(), dtype=torch.float32, device="cuda"):
    """(..., n_stages, 2) zero z1/z2 registers."""
    rows = _iir.normalize_sos(sos)
    return _zeros(tuple(batch_shape) + (len(rows), 2), dtype, device)


def iir_stream_process(sos, state: torch.Tensor, block: torch.Tensor):
    """One block through the biquad cascade with the carried per-stage
    state: sosfilt with zi (the reference carries z1/z2 across calls in its
    struct, src/filter/iir.c:21-27). Every section takes the scan."""
    y = block
    new_states = []
    for i, (b0, b1, b2, a1, a2) in enumerate(
            _iir.normalize_sos(sos).tolist()):
        a_cum, b_cum = _iir._biquad_cumulative(y, b0, b1, b2, a1, a2)
        y, s = _iir._biquad_output(y, b0, state[..., i, :], a_cum, b_cum)
        new_states.append(s)
    return y, torch.stack(new_states, dim=-2)


# ---------------------------------------------------------------------------
# STFT analysis / overlap-add synthesis
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _window_on(name: str, n: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """The window built in float64, cast to the stream's dtype (a float64
    stream keeps a float64 window), on `device`."""
    return torch.tensor(get_window_np(name, n), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class StftStream:
    """Streaming STFT geometry (blocks must be multiples of hop)."""

    nfft: int
    hop: int
    window: str = "hann"

    def analysis_init(self, batch_shape=(), dtype=torch.float32,
                      device="cuda"):
        """Carried input tail of nfft - hop samples."""
        return _zeros(tuple(batch_shape) + (self.nfft - self.hop,), dtype,
                      device)

    def frames(self, state: torch.Tensor, block: torch.Tensor):
        """Windowed framing step: (state, (..., k*hop)) -> ((..., k, nfft)
        frames, new state); shared by analysis and the streams that take
        a power spectrum instead of complex bins."""
        b = block.shape[-1]
        if b % self.hop:
            raise ValueError("block length must be a multiple of hop")
        ext = torch.cat([state, block], dim=-1)
        k = b // self.hop
        win = _window_on(self.window, self.nfft, block.dtype, block.device)
        if self.nfft % self.hop == 0:
            frames = frames_strided(ext, self.nfft, self.hop, k) * win
        else:
            idx = (torch.arange(k, device=ext.device)[:, None] * self.hop
                   + torch.arange(self.nfft, device=ext.device)[None, :])
            frames = ext[..., idx] * win
        # a positive-offset slice: at nfft == hop the carried tail is empty
        tail_start = ext.shape[-1] - (self.nfft - self.hop)
        return frames, ext[..., tail_start:]

    def analysis(self, state: torch.Tensor, block: torch.Tensor,
                 rfft: bool = True):
        """(state, (..., k*hop)) -> ((..., k, bins), new state). Frame f of
        call t covers the global samples [t B + f hop - (nfft - hop), ...
        + nfft): analysis runs nfft - hop behind the blocks, and emits the
        offline STFT's frames in order, none skipped."""
        frames, new_state = self.frames(state, block)
        spec = _fft.rfft(frames) if rfft else _fft.fft(frames)
        return spec, new_state

    def synthesis_init(self, batch_shape=(), dtype=torch.float32,
                       device="cuda"):
        """Carried overlap-add accumulators (data, w^2 norm) of nfft - hop
        samples."""
        z = _zeros(tuple(batch_shape) + (self.nfft - self.hop,), dtype,
                   device)
        return z, z

    def synthesis(self, state, spec: torch.Tensor, rfft: bool = True):
        """(state, (..., k, bins)) -> ((..., k*hop), new state): inverse
        FFT, window, overlap-add with the carried tail, w^2-normalized with
        the reference's 1e-12 guard (tools/dump_stft_roundtrip.c:50-54)."""
        acc, norm_acc = state
        time = _fft.irfft(spec, self.nfft) if rfft else _fft.ifft(spec).real
        win = _window_on(self.window, self.nfft, time.dtype, time.device)
        k = spec.shape[-2]
        out_len = k * self.hop
        overlap = self.nfft - self.hop
        buf_len = out_len + overlap
        ola = (overlap_add_strided if self.nfft % self.hop == 0
               else overlap_add)
        recon = ola(time * win, self.hop, buf_len)
        wsq = (win * win).expand(k, self.nfft)
        norm = ola(wsq, self.hop, buf_len).expand(recon.shape)
        recon = torch.cat([recon[..., :overlap] + acc, recon[..., overlap:]],
                          dim=-1)
        norm = torch.cat([norm[..., :overlap] + norm_acc,
                          norm[..., overlap:]], dim=-1)
        y, ny = recon[..., :out_len], norm[..., :out_len]
        good = ny > 1e-12
        y = torch.where(good, y / torch.where(good, ny, 1.0), y)
        return y, (recon[..., out_len:], norm[..., out_len:])


# ---------------------------------------------------------------------------
# polyphase resampler stream
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _poly_stream_tables(up: int, down: int, b: int, dtype_name: str):
    """Gather indices (n_out, taps_pp) and phase weights of one block
    geometry of ResamplePolyStream.process, numpy."""
    h = _resample._resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    h_pad = np.zeros((-(-len(h) // up)) * up)
    h_pad[:len(h)] = h
    taps_pp = len(h_pad) // up
    hpp = h_pad.reshape(taps_pp, up).T
    n_out = b * up // down
    j = np.arange(n_out)
    t_loc = half_len + j * down
    anchor = t_loc // up
    phase = t_loc % up
    idx = anchor[:, None] - np.arange(taps_pp)[None, :] + taps_pp - 1
    return (np.ascontiguousarray(idx.astype(np.int64)),
            np.ascontiguousarray(hpp[phase].astype(np.dtype(dtype_name))))


@functools.lru_cache(maxsize=32)
def _poly_tables_on(up: int, down: int, b: int, dtype: torch.dtype,
                    device: torch.device):
    """The flattened gather index and the (n_out, 1, taps_pp) weights of
    ``_poly_stream_tables`` on `device`, copied once."""
    dtype_name = str(dtype).replace("torch.", "")
    idx, w = _poly_stream_tables(up, down, b, dtype_name)
    return (torch.as_tensor(idx.reshape(-1), device=device),
            torch.as_tensor(w, device=device)[:, :, None])


@dataclasses.dataclass(frozen=True)
class ResamplePolyStream:
    """Streaming scipy-parity polyphase resampler with a fixed latency.

    Blocks of B input samples (B % down == 0, B >= the delay) emit exactly
    B*up/down outputs a call. The emitted stream equals resample_poly of
    the concatenated input preceded by the `latency_out` lead-in samples
    (the resample of the implicit zeros before the signal): drop the first
    `latency_out` outputs for offline parity, and call `flush()` once at
    the end to drain the last `latency_out` outputs. Each block is a gather
    of the input windows and a per-phase dot at the matmul-precision knob's
    tier, the offline polyphase path's arithmetic.
    """

    up: int
    down: int

    def __post_init__(self):
        g = math.gcd(self.up, self.down)
        object.__setattr__(self, "up", self.up // g)
        object.__setattr__(self, "down", self.down // g)

    @functools.cached_property
    def _geometry(self):
        h = _resample._resample_poly_filter(self.up, self.down)
        half_len = (len(h) - 1) // 2
        h_pad = np.zeros((-(-len(h) // self.up)) * self.up)
        h_pad[:len(h)] = h
        taps_pp = len(h_pad) // self.up
        hpp = h_pad.reshape(taps_pp, self.up).T
        # the filter's future span in input samples, rounded up to a
        # multiple of `down` so that each block's geometry repeats
        look = -(-half_len // self.up) + 1
        delay_in = -(-look // self.down) * self.down
        hist = taps_pp - 1 + delay_in
        return hpp, taps_pp, half_len, delay_in, hist

    @property
    def latency_out(self) -> int:
        """Output-sample latency of the stream."""
        _, _, _, delay_in, _ = self._geometry
        return delay_in * self.up // self.down

    def init(self, batch_shape=(), dtype=torch.float32, device="cuda"):
        """Zero input history of taps_pp - 1 + delay samples (the zeros
        before the signal)."""
        *_, hist = self._geometry
        return _zeros(tuple(batch_shape) + (hist,), dtype, device)

    def process(self, state: torch.Tensor, block: torch.Tensor):
        """(state, (..., B)) -> ((..., B*up/down), new state).

        Call t's buffer covers the global inputs [tB - hist, (t+1)B) and
        emits the global outputs [t n_out - latency, ... + n_out); output j
        gathers the buffer at (taps_pp - 1) + (half_len + j down)//up - i,
        i in [0, taps_pp), weighted by hpp[(half_len + j down) % up, i]:
        the offline polyphase decomposition, shifted so that the filter's
        future span is already in the buffer."""
        *_, hist = self._geometry
        b = block.shape[-1]
        if b % self.down:
            raise ValueError("block length must be a multiple of `down`")
        ext = torch.cat([state, block], dim=-1)
        idx, w = _poly_tables_on(self.up, self.down, b, block.dtype,
                                 block.device)
        n_out = w.shape[0]
        gathered = ext.index_select(-1, idx).reshape(
            ext.shape[:-1] + (n_out, 1, -1))
        y = config.tier_matmul(gathered, w, None)[..., 0, 0]
        return y, ext[..., -hist:]

    def flush(self, state: torch.Tensor) -> torch.Tensor:
        """Drain the last latency_out outputs by pushing delay_in zeros
        (the offline path's zero padding past the signal's end)."""
        _, _, _, delay_in, _ = self._geometry
        zeros = state.new_zeros(state.shape[:-1] + (delay_in,))
        y, _ = self.process(state, zeros)
        return y
