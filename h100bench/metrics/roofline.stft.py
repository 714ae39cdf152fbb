"""roofline.stft: the least time the two-sided STFT's work can take on the
card, over the device's busy time a call in the traced stretch, in %.

Per call of c channels of n samples: bytes, the input read once (float32)
and the (frames, nfft) complex64 spectrum written once; operations, a real
FFT of nfft points a frame (float32, CUDA cores). At 1024/256 the bytes
bind. The denominator is the call's whole device busy time, not a named
kernel's.
"""

from h100bench import peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    nfft, hop = fields["nfft"], fields["hop"]
    frames = c * common.num_frames(n, nfft, hop)
    return peaks.least_s(4.0 * c * n + 8.0 * frames * nfft,
                         (peaks.fft_flops(frames, nfft),
                          peaks.F32_FLOP_PER_S))


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    busy_per_call = tr["busy_s"] / tr["calls"]
    return 100.0 * work_s(rec["fields"], rec["channels"],
                          rec["samples"]) / busy_per_call
