"""roofline.gate_analysis: the least time SpectralGate's analysis (the
one-sided spectrum of the edge-padded rows) can take on the card, over the
mean device time of the program's ``gate.analysis`` spans, in %.

The device time is the program's own: two CUDA events around the stage on
its stream (``vv_dsp_tpu_torch.utils.profiling.span``), read for the spans
inside the traced stretch's calls (``h100bench/inside.py``).

Per call of c channels of n samples, padded to n + 2 (nfft - hop): bytes,
the padded rows read once (float32) and the (frames, nfft / 2 + 1)
complex64 spectrum written once; operations, a real FFT of nfft points a
frame (float32, CUDA cores). At 1024/256 the bytes bind. A program that
records no ``gate.analysis`` span gives nothing to read.
"""

from h100bench import inside, peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    nfft, hop = fields["nfft"], fields["hop"]
    n_pad = n + 2 * (nfft - hop)
    frames = c * common.num_frames(n_pad, nfft, hop)
    nbytes = 4.0 * c * n_pad + 8.0 * frames * (nfft // 2 + 1)
    return peaks.least_s(nbytes, (peaks.fft_flops(frames, nfft),
                                  peaks.F32_FLOP_PER_S))


def read(rec: dict):
    return inside.stage_roofline(rec, "gate.analysis", work_s)
