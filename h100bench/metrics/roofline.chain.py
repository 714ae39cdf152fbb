"""roofline.chain: the least time the northstar chain's work can take on
the card, over the device's busy time a call in the traced stretch, in %.

Per call of c channels of n samples, the work of the whole call by unit:

- bytes: the call's input read once and its MFCCs written once, float32
  (what passes between the stages need not reach HBM);
- the FIR of T taps: either its direct form, c n T multiply-adds at the
  tier's bf16 products on the tensor cores, or overlap-save FFTs at float32
  on the CUDA cores, which need fewer operations (``peaks.fir_fft_flops``);
  the least time takes whichever of the two gives the call less;
- the 4/3 polyphase resampler (the default filter of 2 * 10 * max(up,
  down) + 1 taps, split over `up` phases): n_out L / up multiply-adds a
  channel at the tier's bf16 products;
- per frame, a real FFT of nfft points and the powers (float32, CUDA
  cores), the mel products over the filterbank's nonzero weights and the
  DCT (the tier's bf16 products).

The least time is the largest of the three units' times for the whole call
(``peaks.least_s``), so a program that overlaps its stages still reads at
most 100%. The denominator is the call's whole device busy time (the union
of every device interval in the stretch over the calls in it), not a named
kernel's, so the share reads the same work whatever implements it.
"""

from h100bench import peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    up, down = common.reduce_ratio(fields["up"], fields["down"])
    n_out = -(-n * up // down)
    taps_r = len(common.resample_filter(up, down))
    nfft, hop = fields["nfft"], fields["hop"]
    frames = c * common.num_frames(n_out, nfft, hop)
    sr = fields["sample_rate"] * up / down
    nnz = int((common.mel_filterbank(nfft, fields["n_mels"], sr, 0.0, sr / 2)
               != 0).sum())
    head_tier = peaks.TIER_PRODUCTS[fields["head_algorithm"]]
    nbytes = 4.0 * (c * n + frames * fields["n_mfcc"])
    tc = (2 * c * n_out * taps_r / up * head_tier
          + frames * (2 * nnz + 2 * fields["n_mels"] * fields["n_mfcc"])
          * peaks.TIER_PRODUCTS[fields["stft_algorithm"]])
    f32 = peaks.fft_flops(frames, nfft) + frames * 3 * (nfft // 2 + 1)
    fir_direct = 2 * c * n * fields["fir_taps"] * head_tier
    fir_fft = peaks.fir_fft_flops(c, n, fields["fir_taps"])
    return min(
        peaks.least_s(nbytes, (tc + fir_direct, peaks.BF16_FLOP_PER_S),
                      (f32, peaks.F32_FLOP_PER_S)),
        peaks.least_s(nbytes, (tc, peaks.BF16_FLOP_PER_S),
                      (f32 + fir_fft, peaks.F32_FLOP_PER_S)))


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    busy_per_call = tr["busy_s"] / tr["calls"]
    return 100.0 * work_s(rec["fields"], rec["channels"],
                          rec["samples"]) / busy_per_call
