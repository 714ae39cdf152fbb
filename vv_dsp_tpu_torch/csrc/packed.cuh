// Packed-real transforms shared by the packed kernels (stft.cu, istft.cu,
// gate_packed.cu).
//
// Forward: the nfft-point real FFT of a frame is an m = nfft/2 point complex
// FFT of z[j] = w[2j] x[2j] + i w[2j+1] x[2j+1] (loaded in bit-reversed
// order, radix-2 DIT in shared memory with host-built float64 -> f32
// twiddles tw[k] = exp(-2 pi i k / m), k < m/2), then the Hermitian unpack
//   X[k] = E[k] + e^{-2 pi i k / nfft} O[k],  k = 0..m,
//   E = (Z[k] + conj Z[m-k]) / 2,  O = (Z[k] - conj Z[m-k]) / 2i.
// Inverse: the real nfft-point inverse of a one-sided spectrum X[0..m] is
// the m-point complex inverse FFT of the Hermitian repack
//   Z[k] = (X[k] + conj X[m-k]) + j W^-k (X[k] - conj X[m-k]),  W = e^{-2 pi
//   i / nfft},
// scaled by 1/nfft, whose output z[n] = y[2n] + j y[2n+1] is the frame's
// even and odd samples. wk[k] = exp(-2 pi i k / nfft), k <= m, serves both.
//
// A batch of nb frames sits in z as nb runs of m points; every loop strides
// over the block's threads, and each pass ends at a barrier. A caller with
// one frame a block passes nb = 1 as a constant, which folds the batch
// index away.
#pragma once

#include "common.cuh"

// Frames a block of the batched packed kernels transforms at once: up to
// 2048 packed points, so every barrier-separated stage has 1024 butterflies
// for 256 threads.
__host__ __device__ inline int packed_batch(int m) {
  return m >= 2048 ? 1 : 2048 / m;
}

// Frames f0 .. f0 + nb - 1 (frame f covers xc[f*hop, f*hop + 2m), zero past
// n) windowed and even/odd packed into z, each in bit-reversed order.
__device__ __forceinline__ void packed_load(
    const float* __restrict__ xc, long long n, long long f0, int nb, int hop,
    const float* __restrict__ win, float2* z, int m, int log2m) {
  for (int idx = threadIdx.x; idx < nb * m; idx += blockDim.x) {
    const int b = nb == 1 ? 0 : idx >> log2m, j = idx & (m - 1);
    const long long i0 = (f0 + b) * hop + 2 * j;
    const float a = i0 < n ? xc[i0] : 0.f;
    const float c = i0 + 1 < n ? xc[i0 + 1] : 0.f;
    z[b * m + (int)(__brev((unsigned)j) >> (32 - log2m))] =
        make_float2(a * win[2 * j], c * win[2 * j + 1]);
  }
  __syncthreads();
}

// The m-point forward FFT of each of nb frames in place: radix-2 DIT,
// bit-reversed input, natural-order output.
__device__ __forceinline__ void packed_fft(float2* z, int nb, int m,
                                           int log2m,
                                           const float2* __restrict__ tw) {
  const int half_m = m >> 1, log2h = log2m - 1;
  for (int s = 0; s < log2m; ++s) {
    const int half = 1 << s;
    const int stride = m >> (s + 1);  // span 2*half: exp(-2 pi i pos / 2half)
    for (int bi = threadIdx.x; bi < nb * half_m; bi += blockDim.x) {
      float2* zf = nb == 1 ? z : z + (bi >> log2h) * m;
      const int b = nb == 1 ? bi : bi & (half_m - 1);
      const int pos = b & (half - 1);
      const int i0 = ((b >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[pos * stride];
      const float2 u = zf[i0], v = zf[i1];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      zf[i0] = make_float2(u.x + tr, u.y + ti);
      zf[i1] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// X[k] of a 2m-point real frame from a = Z[k mod m], b = Z[(m - k) mod m]
// of its packed spectrum and w = wk[k]; X[m - k] takes the same pair
// swapped, with wk[m - k]
__device__ __forceinline__ float2 unpack_pair(float2 a, float2 b, float2 w) {
  const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
  const float o_r = 0.5f * (a.y + b.y), o_i = 0.5f * (b.x - a.x);
  return make_float2(er + (w.x * o_r - w.y * o_i),
                     ei + (w.x * o_i + w.y * o_r));
}

// X[k], 0 <= k <= m, of the 2m-point real frame whose packed spectrum is z
__device__ __forceinline__ float2 unpack_bin(
    const float2* z, const float2* __restrict__ wk, int k, int m) {
  return unpack_pair(z[k & (m - 1)], z[(m - k) & (m - 1)], wk[k]);
}

// Z[j] * scale of the repack, from a = X[j] and r = X[m - j], 0 <= j < m.
// At j = 0 (a = X[0], r = X[m]) the imaginary parts are dropped, as
// torch.fft.irfft drops them.
__device__ __forceinline__ float2 repack_bin(
    float2 a, float2 r, const float2* __restrict__ wk, int j, float scale) {
  if (j == 0) {
    a.y = 0.f;
    r.y = 0.f;
  }
  // e = a + conj r, d = a - conj r, o = conj(wk[j]) d
  const float er = a.x + r.x, ei = a.y - r.y;
  const float dr = a.x - r.x, di = a.y + r.y;
  const float2 w = wk[j];
  const float o_r = w.x * dr + w.y * di, o_i = w.x * di - w.y * dr;
  return make_float2((er - o_i) * scale, (ei + o_r) * scale);
}

// The m-point inverse FFT (conjugate twiddles, unscaled) of each of nb
// frames in place: radix-2 DIT, bit-reversed input, natural-order output.
// The caller fills z and ends that pass at a barrier.
__device__ inline void packed_ifft(float2* z, int nb, int m, int log2m,
                                   const float2* __restrict__ tw) {
  const int half_m = m >> 1, log2h = log2m - 1;
  for (int s = 0; s < log2m; ++s) {
    const int half = 1 << s;
    const int stride = m >> (s + 1);
    for (int bi = threadIdx.x; bi < nb * half_m; bi += blockDim.x) {
      float2* zf = z + (bi >> log2h) * m;
      const int b = bi & (half_m - 1);
      const int pos = b & (half - 1);
      const int i0 = ((b >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[pos * stride];
      const float2 u = zf[i0], v = zf[i1];
      const float tr = w.x * v.x + w.y * v.y;
      const float ti = w.x * v.y - w.y * v.x;
      zf[i0] = make_float2(u.x + tr, u.y + ti);
      zf[i1] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// ola_strip of nb packed inverse frames: z[b*m + i/2] holds samples i and
// i+1 of frame b as (re, im).
__device__ __forceinline__ void packed_ola(const float2* z, float* strip,
                                           int nb, long long off,
                                           int strip_len, int m, int hop,
                                           const float* __restrict__ win) {
  ola_strip(
      [=](int b, int i) {
        const float2 v = z[b * m + (i >> 1)];
        return (i & 1) ? v.y : v.x;
      },
      strip, nb, off, strip_len, 2 * m, hop, win);
}
