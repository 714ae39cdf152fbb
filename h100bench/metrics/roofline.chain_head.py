"""roofline.chain_head: the least time the chain's head (the 1,024-tap FIR
and the 4/3 polyphase resampler, as one stage) can take on the card, over
the mean device time of the program's ``chain.head`` spans, in %.

The device time is the program's own: two CUDA events around the head on
its stream (``vv_dsp_tpu_torch.utils.profiling.span``), read for the spans
inside the traced stretch's calls (``h100bench/inside.py``). In a
device-bound loop the stream is never empty, so the events bracket the
head's device work and nothing of the host.

Per call of c channels of n samples, the head's own work by unit:

- bytes: x read and the resampled y written once, float32,
  4 (c n + c n_out);
- the resampler: n_out L / up multiply-adds a channel at the head tier's
  bf16 products (``roofline.chain``'s count);
- the FIR: its direct form (c n T multiply-adds at the head tier's bf16
  products) or overlap-save FFTs at float32 on the CUDA cores, whichever
  gives the stage less time.

The least time is the largest of the units' times (``peaks.least_s``). At
the cell's shape the bytes bind. A head fused into another stage records
no ``chain.head`` span, and the metric reads nothing.
"""

from h100bench import inside, peaks
from h100bench.reference import common


def work_s(fields: dict, c: int, n: int) -> float:
    up, down = common.reduce_ratio(fields["up"], fields["down"])
    n_out = -(-n * up // down)
    taps_r = len(common.resample_filter(up, down))
    tier = peaks.TIER_PRODUCTS[fields["head_algorithm"]]
    nbytes = 4.0 * (c * n + c * n_out)
    resample = 2 * c * n_out * taps_r / up * tier
    fir_direct = 2 * c * n * fields["fir_taps"] * tier
    fir_fft = peaks.fir_fft_flops(c, n, fields["fir_taps"])
    return min(
        peaks.least_s(nbytes, (resample + fir_direct, peaks.BF16_FLOP_PER_S)),
        peaks.least_s(nbytes, (resample, peaks.BF16_FLOP_PER_S),
                      (fir_fft, peaks.F32_FLOP_PER_S)))


def read(rec: dict):
    return inside.stage_roofline(rec, "chain.head", work_s)
