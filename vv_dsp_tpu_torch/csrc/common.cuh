// Shared device helpers of the port's Hopper kernels.
//
// The dot-algorithm tiers keep the meaning they have in the JAX package
// (vv_dsp_tpu/ops/pallas_kernels.py::dot_alg), evaluated one product at a
// time on the CUDA cores:
//   ALG_F32    - plain float32 fused multiply-add;
//   ALG_BF16X3 - both operands split into bf16 hi/lo parts (round to nearest
//                even), hi*hi + hi*lo + lo*hi accumulated in float32, lo*lo
//                dropped;
//   ALG_BF16   - one bf16*bf16 product accumulated in float32.
// A product of two bf16 values is exact in float32, so each tier rounds only
// where the TPU's matrix unit rounds: at the operand split and in the sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}
