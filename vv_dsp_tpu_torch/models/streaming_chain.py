"""The NorthStarChain as a block-at-a-time stream with carried,
checkpointable state (counterpart of
``vv_dsp_tpu/models/streaming_chain.py``).

The FIR history, the polyphase latency buffer and the STFT analysis tail of
``vv_dsp_tpu_torch.streaming`` compose into one (state, block) ->
(features, state) function: fixed-size audio blocks in, fixed-size batches
of MFCC frames out, the state saved or restored at any block boundary
(``utils/checkpoint.py``). It matches the offline chain on the frames the
two share. As the JAX chain, it runs plain PyTorch ops and none of the
port's kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import streaming
from vv_dsp_tpu_torch.ops import mel as _mel
from vv_dsp_tpu_torch.ops.fft import rfft_power
from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
from vv_dsp_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class StreamingNorthStar:
    """Block-streaming FIR -> polyphase resample -> STFT -> log-mel -> MFCC.

    A block of block_in samples needs block_in % down == 0 (the resampler)
    and (block_in * up / down) % hop == 0 (the STFT). params: the host
    constants, ``{"fir_coeffs": (taps,) taps}`` (e.g.
    ``convert.streaming_params_from_reference``); the float32 design of
    the fields when None. ``init`` builds the state on the card unless the
    caller names another device.
    """

    fir_taps: int = 1024
    fir_cutoff: float = 0.45
    up: int = 4
    down: int = 3
    nfft: int = 2048
    hop: int = 512
    n_mels: int = 80
    n_mfcc: int = 20
    sample_rate: float = 48000.0
    window: str = "hann"
    params: dict | None = dataclasses.field(default=None, compare=False,
                                            repr=False)

    @functools.cached_property
    def fir_coeffs(self) -> np.ndarray:
        if self.params is not None:
            return np.asarray(self.params["fir_coeffs"])
        return design_lowpass_np(self.fir_taps,
                                 self.fir_cutoff).astype(np.float32)

    @functools.cached_property
    def _resampler(self):
        return streaming.ResamplePolyStream(self.up, self.down)

    @functools.cached_property
    def _stft(self):
        return streaming.StftStream(self.nfft, self.hop, self.window)

    def validate_block(self, block_in: int) -> int:
        """Frames emitted a block; raises if the geometry does not tile."""
        if block_in % self.down:
            raise ValueError("block must be a multiple of `down`")
        out = block_in * self.up // self.down
        if out % self.hop:
            raise ValueError(
                "resampled block length must be a multiple of hop "
                f"(got {out} % {self.hop})")
        return out // self.hop

    def init(self, batch_shape=(), dtype=torch.float32, device="cuda"):
        return {
            "fir": streaming.fir_stream_init(self.fir_coeffs, batch_shape,
                                             dtype, device),
            "resample": self._resampler.init(batch_shape, dtype, device),
            "stft": self._stft.analysis_init(batch_shape, dtype, device),
        }

    def process(self, state: dict, block: torch.Tensor):
        """(state, (..., block_in)) -> ((..., frames, n_mfcc), state).
        Spans (while a profiler runs): ``stream`` around the call,
        ``stream.fir``, ``stream.resample``, ``stream.frames`` and
        ``stream.mfcc`` around its four steps."""
        with profiling.span("stream"):
            self.validate_block(block.shape[-1])
            with profiling.span("stream.fir"):
                y, fir_s = streaming.fir_stream_process(self.fir_coeffs,
                                                        state["fir"], block)
            with profiling.span("stream.resample"):
                y, rs_s = self._resampler.process(state["resample"], y)
            # windowed framing by the shared StftStream step, then the power
            # spectrum -> MFCC
            with profiling.span("stream.frames"):
                frames, stft_s = self._stft.frames(state["stft"], y)
            with profiling.span("stream.mfcc"):
                feats = self._mfcc(frames)
            return feats, {"fir": fir_s, "resample": rs_s, "stft": stft_s}

    def process_blocks(self, state: dict, signal: torch.Tensor,
                       block_in: int):
        """K = signal_len / block_in blocks in one call: ((..., K*block_in)
        signal) -> ((..., K*frames, n_mfcc), state), exactly K sequential
        ``process`` calls (``streaming.scan_stream``)."""
        self.validate_block(block_in)
        return streaming.scan_stream(self.process, state, signal, block_in,
                                     out_axis=-2)

    def _mfcc(self, frames: torch.Tensor) -> torch.Tensor:
        return _mel.mfcc(rfft_power(frames), self.nfft, self.n_mels,
                         self.n_mfcc, self.sample_rate * self.up / self.down)

    def flush(self, state: dict) -> torch.Tensor:
        """End of stream: the last (..., latency_out//hop + 1, n_mfcc)
        feature frames.

        Drains the two tails a block cannot emit: the resampler's
        `latency_out` buffered outputs (by its `delay_in` zeros, the
        offline resampler's zero extension past the signal's end) and the
        STFT's carried nfft - hop tail (completed with zeros, as the
        offline zero-padded tail frames, src/spectral/stft.c:124-137). After
        flush the streamed output equals the offline chain on the whole
        signal, tail frames included: streamed[warm:] == offline with
        warm = nfft/hop - 1."""
        if self.nfft % self.hop:
            raise ValueError("flush requires nfft % hop == 0")
        y_tail = self._resampler.flush(state["resample"])
        lat = self._resampler.latency_out
        z = self.hop - lat % self.hop
        feed = torch.cat([y_tail, y_tail.new_zeros(y_tail.shape[:-1] + (z,))],
                         dim=-1)
        frames, _ = self._stft.frames(state["stft"], feed)
        return self._mfcc(frames)
