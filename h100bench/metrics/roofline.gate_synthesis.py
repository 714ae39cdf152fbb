"""roofline.gate_synthesis: the least time SpectralGate's synthesis (the
gate, the inverse FFT, the window, the overlap-add and the norm) can take
on the card, over the mean device time of the program's ``gate.synthesis``
spans, in %.

The device time is the program's own: two CUDA events around the stage on
its stream (``vv_dsp_tpu_torch.utils.profiling.span``), read for the spans
inside the traced stretch's calls (``h100bench/inside.py``).

Per call of c channels of n samples, padded to n + 2 (nfft - hop): bytes,
the (frames, nfft / 2 + 1) complex64 spectrum read once and the padded
rows written once (float32); operations, each bin's power for the gate and
a real inverse FFT of nfft points a frame (float32, CUDA cores). At
1024/256 the bytes bind. A program that records no ``gate.synthesis``
span gives nothing to read.
"""

from h100bench import inside, peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    nfft, hop = fields["nfft"], fields["hop"]
    n_pad = n + 2 * (nfft - hop)
    frames = c * common.num_frames(n_pad, nfft, hop)
    nbytes = 8.0 * frames * (nfft // 2 + 1) + 4.0 * c * n_pad
    f32 = peaks.fft_flops(frames, nfft) + frames * 3 * (nfft // 2 + 1)
    return peaks.least_s(nbytes, (f32, peaks.F32_FLOP_PER_S))


def read(rec: dict):
    return inside.stage_roofline(rec, "gate.synthesis", work_s)
