// Packed-real transforms shared by the packed kernels (stft.cu, istft.cu,
// gate_packed.cu).
//
// Forward: the nfft-point real FFT of a frame is an m = nfft/2 point complex
// FFT of z[j] = w[2j] x[2j] + i w[2j+1] x[2j+1], then the Hermitian unpack
//   X[k] = E[k] + e^{-2 pi i k / nfft} O[k],  k = 0..m,
//   E = (Z[k] + conj Z[m-k]) / 2,  O = (Z[k] - conj Z[m-k]) / 2i.
// Inverse: the real nfft-point inverse of a one-sided spectrum X[0..m] is
// the m-point complex inverse FFT of the Hermitian repack
//   Z[k] = (X[k] + conj X[m-k]) + j W^-k (X[k] - conj X[m-k]),  W = e^{-2 pi
//   i / nfft},
// scaled by 1/nfft, whose output z[n] = y[2n] + j y[2n+1] is the frame's
// even and odd samples. wk[k] = exp(-2 pi i k / nfft), k <= m, serves both.
//
// Every packed kernel (spectrum, power, MFCC, inverse, fused gate) runs
// the m-point transform register-resident (fft_reg.cuh): thread j of a
// frame holds its points k = j + s m/8 (s < 8), loaded straight into
// registers (packed_frame_regs), or bins k and m - k for the inverse
// (packed_inverse_regs), which runs as the forward transform of conj Z:
// m ifft(Z) = conj(fft(conj Z)).
#pragma once

#include <cstdint>

#include "fft_reg.cuh"

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

// Thread j's packed points z[p] = (w[2p] x[2p], w[2p+1] x[2p+1]), p = j +
// s M/8, of frame f of row xc (n samples; zero past the signal and for
// f >= nf), with its window pairs w[s] = (win[2p], win[2p+1]): one 8-byte
// load a point where the frame lies inside the signal at an even float
// offset, else two bounds-checked scalar loads, so any hop works. With
// LEAD, the row's first lead samples are zeros that are not in memory (xc
// points lead floats before the signal, and n counts them): frames from
// f_in = ceil(lead / hop) on start inside the signal and load as without
// it; the frames before take the scalar loads, bounded below too. Without
// LEAD, lead and f_in are not read.
template <int M, bool LEAD = false>
__device__ __forceinline__ void packed_frame_regs(
    float2 (&v)[8], const float* __restrict__ xc, long long n, int f, int nf,
    int hop, int j, const float2 (&w)[8], int lead = 0, int f_in = 0) {
  constexpr int T = M / 8;
  // samples of frame f left in the signal (none past the last frame)
  const long long left = f < nf ? n - (long long)f * hop : 0;
  const float* xf = xc + (f < nf ? (long long)f * hop : 0);
  if constexpr (LEAD) {
    if (f < f_in || left < 2 * M ||
        (reinterpret_cast<uintptr_t>(xf) & 7) != 0) {
      // the frame's samples below `below` lie in the lead
      const long long below = (long long)lead - (long long)f * hop;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int i = 2 * (j + s * T);
        const float e = i < left && i >= below ? __ldg(xf + i) : 0.f;
        const float o =
            i + 1 < left && i + 1 >= below ? __ldg(xf + i + 1) : 0.f;
        v[s] = make_float2(e * w[s].x, o * w[s].y);
      }
      return;
    }
  }
  if (left >= 2 * M && (reinterpret_cast<uintptr_t>(xf) & 7) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(xf);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float2 t = __ldg(x2 + j + s * T);
      v[s] = make_float2(t.x * w[s].x, t.y * w[s].y);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int i = 2 * (j + s * T);
      const float e = i < left ? __ldg(xf + i) : 0.f;
      const float o = i + 1 < left ? __ldg(xf + i + 1) : 0.f;
      v[s] = make_float2(e * w[s].x, o * w[s].y);
    }
  }
}

// Thread j's window pairs of packed_frame_regs, from win (the window in
// device memory, read once a block, or staged in shared memory)
template <int M>
__device__ __forceinline__ void packed_window_regs(
    float2 (&w)[8], const float* __restrict__ win, int j) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
    w[s] = reinterpret_cast<const float2*>(win)[j + s * (M / 8)];
}

__device__ __forceinline__ float peak_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ float2 peak_max(float2 a, float2 b) {
  return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
}
__device__ __forceinline__ float peak_shfl(float v, int s) {
  return __shfl_xor_sync(0xffffffffu, v, s);
}
__device__ __forceinline__ float2 peak_shfl(float2 v, int s) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, s),
                     __shfl_xor_sync(0xffffffffu, v.y, s));
}

// The maximum of pk over the M/8 threads of an M-point transform (its
// threads are consecutive in the block): xor shuffles within the warp,
// then, where a transform spans warps (M >= 512), one slot a warp in shared
// memory and a barrier that every thread of the block reaches. fmaxf is
// exact, so the order does not matter. The slots are read again only after
// the next barrier of the caller's transform, so one set serves every
// group. pk is one frame's peak (float) or the peaks of the two frames a
// full-nfft transform holds (float2, each reduced alone).
template <int M, class V>
__device__ __forceinline__ V frame_max(V pk, V* slots) {
  constexpr int T = M / 8, LANES = T < 32 ? T : 32, WARPS = T / 32;
#pragma unroll
  for (int s = LANES / 2; s > 0; s >>= 1) pk = peak_max(pk, peak_shfl(pk, s));
  if constexpr (WARPS > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) slots[warp] = pk;
    __syncthreads();
    const V* mine = slots + (warp & ~(WARPS - 1));
    pk = mine[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) pk = peak_max(pk, mine[w]);
  }
  return pk;
}

// Thread j's input to the inverse of a frame: conj Z[k] of the repack
// scaled by 1/(2M) (repack_bin), k = j + s M/8, from x[s] = X[k] and
// r[s] = X[M - k]; bins k and M - k cover 0..M, so every bin is in one
// thread's pairs. With GATE, each bin is first zeroed unless power2(X) >=
// thresh2 * peak, peak the frame's largest power2 (frame_max, which every
// thread of the block reaches), in float32 with no fused multiply-add: the
// plain version's comparison, bit for bit, on the same spectrum. The
// forward transform of v then gives conj of the frame's packed samples:
// y[2n] = Re, y[2n+1] = -Im.
template <int M, bool GATE>
__device__ __forceinline__ void packed_inverse_regs(
    float2 (&v)[8], float2 (&x)[8], float2 (&r)[8], int j,
    const float2* wks, float thresh2, float* slots) {
  constexpr int T = M / 8;
  if constexpr (GATE) {
    float pk = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      pk = fmaxf(pk, fmaxf(power2(x[s]), power2(r[s])));
    const float level = __fmul_rn(thresh2, frame_max<M>(pk, slots));
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (!(power2(x[s]) >= level)) x[s] = make_float2(0.f, 0.f);
      if (!(power2(r[s]) >= level)) r[s] = make_float2(0.f, 0.f);
    }
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float2 z = repack_bin(x[s], r[s], wks, j + s * T, 0.5f / M);
    v[s] = make_float2(z.x, -z.y);
  }
}

// ola_strip's sample of the packed inverse frames the transform of
// packed_inverse_regs's points leaves in z, M points a frame
template <int M>
struct PackedSample {
  const float2* z;
  __device__ __forceinline__ float operator()(int b, int i) const {
    const float2 u = z[b * M + (i >> 1)];
    return (i & 1) ? -u.y : u.x;
  }
};

// Dynamic shared memory of a block of the packed fused gate (gate_packed.cu,
// fft_plan.gate_packed_smem; istft.cu's istft_smem is this layout with its
// spectrum stage in place of the twiddle table): the M-point twiddle table,
// wk (M + 1), two exchange buffers, the window, a peak slot a warp and the
// strip of owned_segments(2M, hop) hops.
template <int M>
inline size_t packed_ola_smem(int hop) {
  return (fr_table_size(M) + M + 1 + 2 * FR_POINTS) * sizeof(float2) +
         ((size_t)2 * M + FR_THREADS / 32 +
          (size_t)owned_segments(2 * M, hop) * hop) * sizeof(float);
}

// The packed overlap-add kernels' shared memory, carved as packed_ola_smem
// lays it out; the twiddles, wk and the window staged (the caller ends
// the staging at a barrier).
template <int M>
struct PackedOlaSmem {
  float2 *tws, *wks, *a, *b;
  float *wins, *slots, *strip;
  __device__ __forceinline__ PackedOlaSmem(float2* sm,
                                           const float2* __restrict__ tw,
                                           const float2* __restrict__ wk,
                                           const float* __restrict__ win) {
    tws = sm;
    wks = tws + fr_table_size(M);
    a = wks + M + 1;
    b = a + FR_POINTS;
    wins = reinterpret_cast<float*>(b + FR_POINTS);
    slots = wins + 2 * M;
    strip = slots + FR_THREADS / 32;
    fr_stage(tws, tw, fr_table_size(M));
    fr_stage(wks, wk, M + 1);
    for (int i = threadIdx.x; i < 2 * M; i += blockDim.x) wins[i] = win[i];
  }
};

// A strip item g of the overlap-add kernels: channel c and its first owned
// segment s0 (owned_segments per strip), the frames f_lo..f_hi that touch
// it. I: the index type (int where the frame count is an int, as in the
// full-nfft gate, whose registers are tight)
template <class I = long long>
struct StripItem {
  int c;
  I s0, f_lo, f_hi;
  __device__ __forceinline__ StripItem(long long g, int strips_per_row,
                                       int seg, int q, int nf) {
    c = (int)(g / strips_per_row);
    s0 = (I)(g - (long long)c * strips_per_row) * seg;
    f_lo = max(s0 - (I)(q - 1), (I)0);
    f_hi = min(s0 + (I)(seg - 1), (I)(nf - 1));
  }
};
