"""Plain float64 reference of the ``northstar_chain`` configuration: causal
FIR -> polyphase resampling -> Hann STFT -> HTK mel -> log -> DCT-II.

``call`` is the offline chain on whole clips; ``stream`` is the same chain as
the live stream emits it, block after block from a zeroed state: the
resampler runs ``latency`` outputs behind the blocks and the framing
``nfft - hop`` samples behind the resampler, so the first frames cover the
zeros before the signal. Imports numpy, torch and the reference's own
``common`` only.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import common as C

LOG_EPS = 1e-10

# The number compared and its limit, per entry (the readings it was set from
# are in PERF.md). err_of_scale: max |got - want| / max |want| over an
# answer: a call's MFCCs, or the whole stream's frames.
LIMITS = {
    "call": {"err_of_scale": 1e-3},
    "stream": {"err_of_scale": 2e-5},
}

# The control of each entry: the nearest precision below the configuration's.
# "call" states bf16x3 products, so the program's own bf16 tier; "stream"
# runs float32 matmuls with TF32 off, so the same with TF32 on.
CONTROL = {
    "call": {"kind": "program",
             "fields": {"head_algorithm": "bf16", "stft_algorithm": "bf16"}},
    "stream": {"kind": "tf32"},
}


class Constants:
    """The chain's constants from the configuration's fields."""

    def __init__(self, fields: dict):
        f = fields
        # the configuration keeps its FIR taps in float32
        self.taps = C.lowpass(f["fir_taps"], f["fir_cutoff"]).astype(
            np.float32).astype(np.float64)
        self.up, self.down = C.reduce_ratio(f["up"], f["down"])
        self.nfft, self.hop = f["nfft"], f["hop"]
        sr = f["sample_rate"] * self.up / self.down
        self.win = C.window(f["window"], self.nfft)
        self.fb = C.mel_filterbank(self.nfft, f["n_mels"], sr, 0.0, sr / 2.0)
        self.dct = C.dct2(f["n_mels"], f["n_mfcc"])

    def latency(self) -> int:
        """Outputs the live resampler runs behind its blocks: the filter's
        future span in input samples, rounded up to whole multiples of
        down, at the output rate."""
        half = (len(C.resample_filter(self.up, self.down)) - 1) // 2
        look = -(-half // self.up) + 1
        return -(-look // self.down) * self.down * self.up // self.down

    def mfcc(self, fr: torch.Tensor) -> torch.Tensor:
        return C.mfcc_of_frames(fr, self.win, self.fb, self.dct, LOG_EPS)


def call(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """(c, n) clips -> (c, frames, n_mfcc) float64 MFCCs."""
    k = Constants(fields)
    n = x.shape[-1]
    n_out = -(-n * k.up // k.down)
    y = C.polyphase(C.causal_fir(x.double(), k.taps), k.up, k.down, 0, n_out)
    nf = C.num_frames(n_out, k.nfft, k.hop)
    return k.mfcc(C.frames(y, k.nfft, k.hop, nf))


def stream(fields: dict, x: torch.Tensor, block: int) -> torch.Tensor:
    """(c, K * block) signal -> (c, K * frames a block, n_mfcc): the frames
    the live stream emits over its first K blocks."""
    k = Constants(fields)
    n_res = x.shape[-1] * k.up // k.down
    lat = k.latency()
    y = C.polyphase(C.causal_fir(x.double(), k.taps), k.up, k.down, -lat,
                    n_res)
    y = torch.nn.functional.pad(y, (k.nfft - k.hop, 0))
    return k.mfcc(C.frames(y, k.nfft, k.hop, n_res // k.hop))

