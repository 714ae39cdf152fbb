"""roofline.fir: the least time a ``fir_apply_best`` call can take on the
card, over the mean device time of the program's ``fir`` spans, in %.

The device time is the program's own: two CUDA events around the call on
its stream (``vv_dsp_tpu_torch.utils.profiling.span``, every 8th span),
read for the spans inside the traced stretch's calls
(``h100bench/inside.py``). In a device-bound loop the stream is never
empty, so the events bracket the call's device work and nothing of the
host.

Per call of c channels of n samples and T taps, by unit
(``roofline.chain_head``'s FIR count):

- bytes: x read and y written once, float32, 4 (c n + c n);
- operations: the direct form (c n T multiply-adds at the
  configuration's tier of bf16 tensor-core products) or overlap-save FFTs
  at float32 on the CUDA cores, whichever gives the call less time.

The least time is the largest of the units' times (``peaks.least_s``). At
the cell's shape (64 x 479,232, 1,024 taps, the f32 tier) the bytes bind:
0.0732 ms. A program that records no ``fir`` span reads nothing.
"""

from h100bench import inside, peaks


def work_s(fields: dict, c: int, n: int) -> float:
    taps = fields["fir_taps"]
    nbytes = 4.0 * (c * n + c * n)
    direct = 2 * c * n * taps * peaks.TIER_PRODUCTS[fields["algorithm"]]
    fft = peaks.fir_fft_flops(c, n, taps)
    return min(peaks.least_s(nbytes, (direct, peaks.BF16_FLOP_PER_S)),
               peaks.least_s(nbytes, (fft, peaks.F32_FLOP_PER_S)))


def read(rec: dict):
    return inside.stage_roofline(rec, "fir", work_s)
