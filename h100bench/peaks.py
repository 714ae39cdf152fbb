"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W), and the least time a piece of work can take on it.

A roofline share is that least time over the device time the work took.
Bytes count the call's input read once and its output written once;
operations are counted in the form with the fewest of them known for each
stage, over the peak of the arithmetic that delivers the configuration's
stated precision, and summed per unit over the call: the least time is the
largest of the units' times, since the units may work at once.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # bf16 products on the tensor cores

# bf16 tensor-core products a multiply-add takes at each tier of the
# program's dot algorithms (a product of two bf16 parts is exact in float32)
TIER_PRODUCTS = {"f32": 6, "bf16x3": 3, "bf16": 1}


def least_s(nbytes: float, *work: tuple[float, float]) -> float:
    """The larger of the bytes' time and each (operations, peak) pair's
    time: work on separate units may overlap, so the least time is their
    maximum, not their sum."""
    return max([nbytes / HBM_BYTES_PER_S] + [ops / peak for ops, peak in work])


def fft_flops(frames: int, nfft: int) -> float:
    """Operations of one real nfft-point FFT a frame, 2.5 N log2 N."""
    return frames * 2.5 * nfft * (nfft.bit_length() - 1)


def fir_fft_flops(c: int, n: int, taps: int) -> float:
    """Operations of a causal FIR of `taps` taps on c signals of n samples
    by overlap-save FFTs, float32, at the block size that needs fewest: per
    block of N - taps + 1 outputs, a real FFT of N points each way and
    N / 2 + 1 complex products (the taps' transform made once)."""
    best = min((2 * fft_flops(1, size) + 6 * (size // 2 + 1))
               / (size - taps + 1)
               for size in (1 << k for k in range(taps.bit_length(), 25)))
    return c * n * best
