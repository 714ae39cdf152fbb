"""roofline.gate: the least time SpectralGate's whole call can take on the
card, over the device's busy time a call in the traced stretch, in %.

Per call of c channels of n samples: bytes, the input read once and the
gated output written once (float32, 8 c n); operations, two real FFTs of
nfft points (forward and inverse) a frame of the row edge-padded by
nfft - hop at both ends (float32, CUDA cores). At 1024/256 the FFTs bind.
The denominator is the call's whole device busy time (the edge pad's copy
included), not a named kernel's.
"""

from h100bench import peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    nfft, hop = fields["nfft"], fields["hop"]
    frames = c * common.num_frames(n + 2 * (nfft - hop), nfft, hop)
    return peaks.least_s(8.0 * c * n,
                         (2 * peaks.fft_flops(frames, nfft),
                          peaks.F32_FLOP_PER_S))


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    busy_per_call = tr["busy_s"] / tr["calls"]
    return 100.0 * work_s(rec["fields"], rec["channels"],
                          rec["samples"]) / busy_per_call
