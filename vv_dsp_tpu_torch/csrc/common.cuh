// Shared device helpers of the port's Hopper kernels.
//
// The dot-algorithm tiers keep the meaning they have in the JAX package
// (vv_dsp_tpu/ops/pallas_kernels.py::dot_alg). tier_fma evaluates them one
// product at a time on the CUDA cores:
//   ALG_F32    - plain float32 fused multiply-add;
//   ALG_BF16X3 - both operands split into bf16 hi/lo parts (round to nearest
//                even), hi*hi + hi*lo + lo*hi accumulated in float32, lo*lo
//                dropped;
//   ALG_BF16   - one bf16*bf16 product accumulated in float32.
// The two tensor-core kernels (upfirdn.cu, dft_power.cu) evaluate them as
// sums of bf16 products of the operands' parts (mma_tiers.cuh), where
// ALG_F32 is the TPU's own six-pass form: six products of three parts.
// A product of two bf16 values is exact in float32, so each tier rounds only
// where the TPU's matrix unit rounds: at the operand split and in the sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

enum { ALG_F32 = 0, ALG_BF16X3 = 1, ALG_BF16 = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc + w * x at tier ALG (operands split on the fly)
template <int ALG>
__device__ __forceinline__ float tier_fma(float w, float x, float acc) {
  if (ALG == ALG_F32) return fmaf(w, x, acc);
  if (ALG == ALG_BF16) return fmaf(bf16_round(w), bf16_round(x), acc);
  const float wh = bf16_round(w), wl = bf16_round(w - wh);
  const float xh = bf16_round(x), xl = bf16_round(x - xh);
  acc = fmaf(wh, xh, acc);
  acc = fmaf(wh, xl, acc);
  return fmaf(wl, xh, acc);
}

__device__ __forceinline__ float power2(float2 v) {
  // no contraction into an FMA: the gates compare these bit for bit with
  // the plain versions' re * re + im * im
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Owned hop-long output segments of a block of the overlap-add kernels
// (istft.cu, stockham.cu, gate_packed.cu): at least 4 (q - 1) against the
// q - 1 frames it recomputes (q = nfft/hop, rounded up), and a strip of at
// least 4096 samples.
inline int owned_segments(int nfft, int hop) {
  const int q = (nfft + hop - 1) / hop;
  return std::max({4 * (q - 1), (4096 + hop - 1) / hop, 1});
}

// Overlap-add of the overlap-add kernels: add sample(b, i) * win[i], sample
// i < nfft of inverse frame b < nb, into strip[lo, hi), frame b starting at
// strip position off + b*hop, frames in ascending order for each sample, so
// every block sums a sample the same way. Ends at a barrier. sample says
// where a kernel's inverse frames keep their samples.
template <class Sample>
__device__ __forceinline__ void ola_strip(Sample sample, float* strip, int nb,
                                          long long off, int strip_len,
                                          int nfft, int hop,
                                          const float* __restrict__ win) {
  const int lo = (int)max(off, 0LL);
  const int hi = (int)min(off + (long long)(nb - 1) * hop + nfft,
                          (long long)strip_len);
  for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
    float acc = strip[t];
    for (int b = 0; b < nb; ++b) {
      const long long i = t - off - (long long)b * hop;
      if (i >= 0 && i < nfft) acc += sample(b, (int)i) * win[i];
    }
    strip[t] = acc;
  }
  __syncthreads();
}
