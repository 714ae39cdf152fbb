"""roofline.chain_mfcc: the least time the chain's STFT -> mel -> log ->
DCT stage can take on the card, over the mean device time of the
program's ``chain.mfcc`` spans, in %.

The device time is the program's own: two CUDA events around the stage on
its stream (``vv_dsp_tpu_torch.utils.profiling.span``), read for the spans
inside the traced stretch's calls (``h100bench/inside.py``).

Per call, on the head's output of c channels of n_out samples, the stage's
own work by unit:

- bytes: y read once, 4 c n_out, and the MFCCs written once, float32;
- per frame, a real FFT of nfft points and the powers (float32, CUDA
  cores);
- per frame, the mel products over the filterbank's nonzero weights and
  the DCT, at the STFT tier's bf16 products (tensor cores).

The least time is the largest of the units' times (``peaks.least_s``). At
the cell's shape the float32 FFTs bind.
"""

from h100bench import inside, peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    up, down = common.reduce_ratio(fields["up"], fields["down"])
    n_out = -(-n * up // down)
    nfft, hop = fields["nfft"], fields["hop"]
    frames = c * common.num_frames(n_out, nfft, hop)
    sr = fields["sample_rate"] * up / down
    nnz = int((common.mel_filterbank(nfft, fields["n_mels"], sr, 0.0, sr / 2)
               != 0).sum())
    nbytes = 4.0 * (c * n_out + frames * fields["n_mfcc"])
    tc = (frames * (2 * nnz + 2 * fields["n_mels"] * fields["n_mfcc"])
          * peaks.TIER_PRODUCTS[fields["stft_algorithm"]])
    f32 = peaks.fft_flops(frames, nfft) + frames * 3 * (nfft // 2 + 1)
    return peaks.least_s(nbytes, (tc, peaks.BF16_FLOP_PER_S),
                         (f32, peaks.F32_FLOP_PER_S))


def read(rec: dict):
    return inside.stage_roofline(rec, "chain.mfcc", work_s)
