// The mel sums and the DCT of the MFCC kernels (stft.cu stft_mfcc_kernel,
// stockham.cu stockham_mel_kernel), on a group of frames whose powers sit in
// shared memory: the compact filterbank (ops/fft_plan.py
// compact_filterbank_np) summed by MEL_LANES threads a band for all the
// group's frames, the log, then the DCT rows the same way.
#pragma once

#include "fft_reg.cuh"

// Threads that sum one band of the mel projection or one coefficient of
// the DCT, for all of a group's frames at once, each taking every
// MEL_LANES-th term, then a shuffle tree: a band of 2-100 bins keeps at
// most 25 weights on one thread, each split once for the group's frames,
// and a warp's 32 / MEL_LANES items end together.
constexpr int MEL_LANES = 4;
constexpr int MEL_ITEMS = FR_THREADS / MEL_LANES;  // items a block takes at once

__device__ __forceinline__ float lane_group_sum(float v) {
#pragma unroll
  for (int s = MEL_LANES / 2; s > 0; s >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// The mel sums and the DCT of a group's FB frames, from pw (FB rows of
// BINS powers, packed split operands): each band's sum over its compact
// weights for up to 8 frames at once, logged into mel (FB rows of n_mels
// packed split operands) or, without the DCT, written out for the nb
// frames kept; a barrier; each coefficient's sum over the log-mel row.
// weight(i) and coef(i) give the compact filterbank's weight i and the DCT
// rows' element i as split operands; ifb: the filterbank's index. A group
// is FB = 2048/M frames of M + 1 bins: the packed kernel's M = nfft/2, and
// the full-nfft kernel's N/2 (its 4096/N frames of N/2 + 1 bins).
template <int M, int ALG, bool FUSE_DCT, class Weight, class Coef>
__device__ __forceinline__ void mel_dct(Weight weight, Coef coef,
                                        const int* ifb, const float* pw,
                                        float* mel, float* out,
                                        long long row0, int nb, int n_mels,
                                        int n_mfcc, float log_eps) {
  // frames a thread sums at once: at most 8 accumulators (16 frames at
  // M = 128 take two passes, 32 at M = 64 four), so no instance spills; an
  // item is a band (a coefficient) and one chunk of QC frames, so the
  // chunks of a group run side by side, and the items of a warp share a
  // band and its length
  constexpr int FB = FR_POINTS / M, BINS = M + 1, QC = FB < 8 ? FB : 8;
  constexpr int CHUNKS = FB / QC;
  using Op = TierOperand<ALG>;
  const int lane = threadIdx.x % MEL_LANES, item = threadIdx.x / MEL_LANES;
  const int bands_end =
      (n_mels * CHUNKS + MEL_ITEMS - 1) / MEL_ITEMS * MEL_ITEMS;
  for (int i = item; i < bands_end; i += MEL_ITEMS) {
    const int band = i / CHUNKS, q0 = i % CHUNKS * QC;
    float acc[QC];
#pragma unroll
    for (int q = 0; q < QC; ++q) acc[q] = 0.f;
    if (band < n_mels) {
      const int o = ifb[band], len = ifb[band + 1] - o;
      const float* pb = pw + q0 * BINS + ifb[n_mels + 1 + band];
      for (int t = lane; t < len; t += MEL_LANES) {
        const Op w = weight(o + t);
#pragma unroll
        for (int q = 0; q < QC; ++q)
          acc[q] = tier_fma(w, Op::unpack(pb[q * BINS + t]), acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const float sum = lane_group_sum(acc[q]);
      if (lane == 0 && band < n_mels) {
        if (FUSE_DCT)
          mel[(q0 + q) * n_mels + band] =
              Op::split(logf(sum + log_eps)).pack();
        else if (q0 + q < nb)
          out[(row0 + q0 + q) * n_mels + band] = sum;
      }
    }
  }
  // the powers are read and the log-mel rows written before the next
  // group's transform writes the exchange buffers or the DCT reads them
  __syncthreads();
  if (!FUSE_DCT) return;
  const int coefs_end =
      (n_mfcc * CHUNKS + MEL_ITEMS - 1) / MEL_ITEMS * MEL_ITEMS;
  for (int i = item; i < coefs_end; i += MEL_ITEMS) {
    const int k = i / CHUNKS, q0 = i % CHUNKS * QC;
    float acc[QC];
#pragma unroll
    for (int q = 0; q < QC; ++q) acc[q] = 0.f;
    if (k < n_mfcc) {
      for (int t = lane; t < n_mels; t += MEL_LANES) {
        const Op d = coef(k * n_mels + t);
#pragma unroll
        for (int q = 0; q < QC; ++q)
          acc[q] = tier_fma(d, Op::unpack(mel[(q0 + q) * n_mels + t]),
                            acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const float sum = lane_group_sum(acc[q]);
      if (lane == 0 && k < n_mfcc && q0 + q < nb)
        out[(row0 + q0 + q) * n_mfcc + k] = sum;
    }
  }
}
