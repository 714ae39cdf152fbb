// Shared device helpers of the port's Hopper kernels.
//
// The dot-algorithm tiers keep the meaning they have in the JAX package
// (vv_dsp_tpu/ops/pallas_kernels.py::dot_alg). tier_fma evaluates them one
// product at a time on the CUDA cores, on operands split once
// (TierOperand):
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

// An operand split for tier ALG: hi = bf16(v) and, at bf16x3, lo =
// bf16(v - hi); at f32 hi = v. Split once, an operand serves every product
// it takes part in. pack() keeps the parts in one 32-bit word (at bf16x3
// the two bf16 values side by side, else hi), so a split row takes the
// room of a float row.
template <int ALG>
struct TierOperand {
  float hi, lo;
  __device__ __forceinline__ static TierOperand split(float v) {
    const float h = ALG == ALG_F32 ? v : bf16_round(v);
    return {h, ALG == ALG_BF16X3 ? bf16_round(v - h) : 0.f};
  }
  __device__ __forceinline__ float pack() const {
    if (ALG != ALG_BF16X3) return hi;
    return __uint_as_float((__float_as_uint(hi) & 0xffff0000u) |
                           (__float_as_uint(lo) >> 16));
  }
  __device__ __forceinline__ static TierOperand unpack(float w) {
    if (ALG != ALG_BF16X3) return {w, 0.f};
    const unsigned u = __float_as_uint(w);
    return {__uint_as_float(u & 0xffff0000u), __uint_as_float(u << 16)};
  }
};

// acc + w * x at tier ALG: hi*hi, then at bf16x3 hi*lo and lo*hi
template <int ALG>
__device__ __forceinline__ float tier_fma(TierOperand<ALG> w,
                                          TierOperand<ALG> x, float acc) {
  acc = fmaf(w.hi, x.hi, acc);
  if (ALG == ALG_BF16X3) {
    acc = fmaf(w.hi, x.lo, acc);
    acc = fmaf(w.lo, x.hi, acc);
  }
  return acc;
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
// every block sums a sample the same way. A sample visits only the frames
// that cover it (b from the first with d - b hop < nfft to the last with
// b hop <= d, d its distance from frame 0's start), found by shifts: hop is
// a power of two (it divides the power-of-two nfft; every launcher checks).
// Ends at a barrier. sample says where a kernel's inverse frames keep their
// samples.
template <class Sample>
__device__ __forceinline__ void ola_strip(Sample sample, float* strip, int nb,
                                          long long off, int strip_len,
                                          int nfft, int hop,
                                          const float* __restrict__ win) {
  // |off| < nfft + strip_len: the frames start at most q - 1 hops before
  // the strip, and none after its end
  const int o = (int)off;
  const int hi = min(o + (nb - 1) * hop + nfft, strip_len);
  const int lh = __ffs(hop) - 1;
  for (int t = max(o, 0) + threadIdx.x; t < hi; t += blockDim.x) {
    const int d = t - o;
    float acc = strip[t];
    const int last = min(d >> lh, nb - 1);
    // (d - nfft) >> lh floors, also below 0 (an arithmetic shift)
    for (int b = max(((d - nfft) >> lh) + 1, 0); b <= last; ++b) {
      const int i = d - (b << lh);
      acc += sample(b, i) * win[i];
    }
    strip[t] = acc;
  }
  __syncthreads();
}
