// Register-resident forward FFT shared by every FFT kernel of the port:
// the two spectrum kernels (stft.cu stft_spectrum_kernel, stockham.cu
// stockham_spectrum_kernel), the two power kernels (stft.cu
// stft_power_kernel, stockham.cu stockham_power_kernel), the two MFCC
// kernels (stft.cu stft_mfcc_kernel, stockham.cu stockham_mel_kernel), the
// two inverses (istft.cu istft_kernel, stockham.cu istft_stockham_kernel,
// which run it on conjugated input: N ifft(Z) = conj(fft(conj Z))) and the
// two fused gates (gate_packed.cu, stockham.cu stockham_gate_kernel, which
// run it both ways).
//
// The N-point complex transform (N a power of two in [128, 2048]) of each
// frame runs on N/8 threads, each holding 8 points in registers, as
// self-sorting (Stockham) passes: radix 8, with one radix-2 or radix-4
// first pass where log2 N is not a multiple of 3 (ops/fft_plan.py builds
// the same plan and its twiddles; tests/test_torch_fft_plan.py replays it
// against np.fft.fft). Thread j enters with points j + s N/8 (s < 8), in
// natural order, and the spectrum leaves in natural order, so neither end
// needs a bit reversal. Butterfly jv of a radix-R pass of stride Ns (the
// product of the radices before it) takes points jv + r N/R, multiplies
// input r by exp(-2 pi i r (jv mod Ns) / (R Ns)), takes the R-point DFT in
// registers (the radix-8 constants +-1, +-i, (+-1 +- i)/sqrt 2 as
// literals) and writes output r to (jv div Ns) Ns R + (jv mod Ns) + r Ns.
// Points cross threads only there: one shared-memory write and one read a
// pass (two exchanges at N = 512 where a radix-2 transform makes nine
// round trips), each slot XOR-swizzled (fr_slot) so that neither side has
// a bank conflict. The exchanges alternate between two buffers, so one
// barrier a pass suffices.
//
// Twiddles: the host's float64 table cast to float32, [r - 1][k] for each
// pass after the first (whose stride is 1), staged in shared memory once
// per block; a block then walks over frame groups (a persistent grid), so
// the table and the window are loaded once per block, not once per frame.
// A block is FR_THREADS threads over FR_POINTS / N transforms. The host
// side (ops/fft_plan.py) also lays out each kernel's shared memory.
#pragma once

#include <mutex>

#include "common.cuh"

constexpr int FR_THREADS = 256;
constexpr int FR_POINTS = 2048;  // complex points of a block's frames

__host__ __device__ constexpr int fr_log2(int n) {
  return n > 1 ? 1 + fr_log2(n >> 1) : 0;
}
__host__ __device__ constexpr int fr_passes(int n) {
  return (fr_log2(n) + 2) / 3;
}
__host__ __device__ constexpr int fr_radix(int n, int p) {
  return p == 0 && fr_log2(n) % 3 != 0 ? 1 << (fr_log2(n) % 3) : 8;
}
__host__ __device__ constexpr int fr_stride(int n, int p) {
  return p == 0 ? 1 : fr_stride(n, p - 1) * fr_radix(n, p - 1);
}
// offset of pass p's twiddles in the table; at p = fr_passes(n) its length
__host__ __device__ constexpr int fr_table_offset(int n, int p) {
  return p <= 1 ? 0
                : fr_table_offset(n, p - 1) +
                      (fr_radix(n, p - 1) - 1) * fr_stride(n, p - 1);
}
__host__ __device__ constexpr int fr_table_size(int n) {
  return fr_table_offset(n, fr_passes(n));
}

// Slot of point p in the exchange written by a pass of stride NS: the low
// 4 bits (16 float2 slots, one per bank pair of a half-warp) XORed with the
// bits above, shifted once more when NS > 1. Reads (16 consecutive points)
// stay a permutation of one aligned run; writes of stride R (NS = 1) or
// of runs of NS spaced NS R apart spread over all 16 bank pairs.
template <int NS>
__device__ __forceinline__ int fr_slot(int p) {
  const int h = p >> 4;
  return p ^ ((NS > 1 ? h << 1 : h) & 15);
}

__device__ __forceinline__ float2 fr_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 fr_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 fr_mul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ __forceinline__ void fr_dft2(float2& a, float2& b) {
  const float2 t = a;
  a = fr_add(t, b);
  b = fr_sub(t, b);
}

__device__ __forceinline__ void fr_dft4(float2& c0, float2& c1, float2& c2,
                                        float2& c3) {
  const float2 e0 = fr_add(c0, c2), e1 = fr_sub(c0, c2);
  const float2 f0 = fr_add(c1, c3), d = fr_sub(c1, c3);
  const float2 f1 = make_float2(d.y, -d.x);  // -i (c1 - c3)
  c0 = fr_add(e0, f0);
  c1 = fr_add(e1, f1);
  c2 = fr_sub(e0, f0);
  c3 = fr_sub(e1, f1);
}

// 8-point DFT, natural order in and out: X[2k] = DFT4(v_r + v_r+4)[k],
// X[2k+1] = DFT4((v_r - v_r+4) W^r)[k], W = exp(-2 pi i / 8)
__device__ __forceinline__ void fr_dft8(float2 (&v)[8]) {
  constexpr float H = 0.70710678118654752440f;
  float2 a[4], b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = fr_add(v[r], v[r + 4]);
    b[r] = fr_sub(v[r], v[r + 4]);
  }
  b[1] = make_float2((b[1].x + b[1].y) * H, (b[1].y - b[1].x) * H);
  b[2] = make_float2(b[2].y, -b[2].x);
  b[3] = make_float2((b[3].y - b[3].x) * H, -(b[3].x + b[3].y) * H);
  fr_dft4(a[0], a[1], a[2], a[3]);
  fr_dft4(b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = a[k];
    v[2 * k + 1] = b[k];
  }
}

// Pass P of the N-point transform on thread j's registers, written to buf
// (this frame's N slots; natural order after the last pass). Butterfly u
// (jv = j + u N/8) of a radix-R pass holds input and output r in register
// u + r 8/R.
template <int N, int P>
__device__ __forceinline__ void fr_pass(float2 (&v)[8], int j,
                                        const float2* tw, float2* buf) {
  constexpr int R = fr_radix(N, P), NS = fr_stride(N, P), T = N / 8;
  constexpr int PER = 8 / R;
  constexpr bool LAST = P + 1 == fr_passes(N);
  static_assert(NS == 1 || R == 8, "only the first pass has radix < 8");
  if constexpr (NS > 1) {
    const float2* t = tw + fr_table_offset(N, P) + (j & (NS - 1));
#pragma unroll
    for (int r = 1; r < 8; ++r) v[r] = fr_mul(v[r], t[(r - 1) * NS]);
  }
  if constexpr (R == 8) {
    fr_dft8(v);
  } else if constexpr (R == 4) {
    fr_dft4(v[0], v[2], v[4], v[6]);
    fr_dft4(v[1], v[3], v[5], v[7]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) fr_dft2(v[u], v[u + 4]);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int jv = j + u * T;
    const int base = (jv / NS) * NS * R + (jv & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = base + r * NS;
      buf[LAST ? p : fr_slot<NS>(p)] = v[u + r * PER];
    }
  }
}

// Passes P.. of the N-point transform of the frame whose points j + s N/8
// thread j holds in v (pass P's input). a, b: the frame's N slots in the
// two exchange buffers; pass P writes a, the next b, and so on. Ends at a
// barrier, with the spectrum in fr_result(a, b) in natural order.
template <int N, int P = 0>
__device__ __forceinline__ void fr_fft(float2 (&v)[8], int j,
                                       const float2* tw, float2* a,
                                       float2* b) {
  fr_pass<N, P>(v, j, tw, a);
  __syncthreads();
  if constexpr (P + 1 < fr_passes(N)) {
    constexpr int NS = fr_stride(N, P), T = N / 8;
#pragma unroll
    for (int s = 0; s < 8; ++s) v[s] = a[fr_slot<NS>(j + s * T)];
    fr_fft<N, P + 1>(v, j, tw, b, a);
  }
}

// The buffer that holds the spectrum after fr_fft<N>(v, j, tw, a, b).
// A block that runs fr_fft again must start it in the other buffer when the
// pass count is odd (fr_swap_after), so no barrier is needed between a
// group's reads of its result and the next group's first pass.
template <int N>
__device__ __forceinline__ float2* fr_result(float2* a, float2* b) {
  return fr_passes(N) % 2 ? a : b;
}
template <int N>
__device__ __forceinline__ void fr_swap_after(float2*& a, float2*& b) {
  if constexpr (fr_passes(N) % 2) {
    float2* t = a;
    a = b;
    b = t;
  }
}

// Copy n float2 from device memory to shared memory, all threads of the
// block (the caller ends it at a barrier)
__device__ __forceinline__ void fr_stage(float2* dst,
                                         const float2* __restrict__ src,
                                         int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Launch a persistent fr kernel: one block of FR_THREADS per slot the card
// holds at this shared-memory size (at most `groups`), each walking over
// frame groups. An instance may be launched at several shared-memory sizes
// (the MFCC kernel's grows with its tables, the inverse's strip with hop):
// the kernel's maximum dynamic shared memory is raised to the largest size
// requested so far on the device, never lowered, and the block count is
// kept per (device, size), the last FR_SIZES sizes of the instance.
//
// The cache is read and written under a lock, since host threads may launch
// at once (the ctypes calls release the GIL), and fr_launch has internal
// linkage: a function-local static of a function with external linkage is
// a unique symbol across the process's shared objects (STB_GNU_UNIQUE), so
// two loaded builds of the library would share a cache that holds one
// build's kernel attributes.
constexpr int FR_SIZES = 16;

namespace {

template <auto Kernel, class... Args>
cudaError_t fr_launch(size_t smem, long long groups, int device,
                      cudaStream_t stream, Args... args) {
  if (groups <= 0) return cudaSuccess;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  static std::mutex mu;
  static size_t attr[64] = {0};
  static size_t sizes[64][FR_SIZES] = {};
  static int slots[64][FR_SIZES] = {};
  static int next[64] = {0};
  int grid;
  {
    std::lock_guard<std::mutex> lock(mu);
    cudaError_t e;
    if (smem > attr[device]) {
      e = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) {
        cudaGetLastError();  // clear it, so the next launch does not report it
        return e;
      }
      attr[device] = smem;
    }
    int i = 0;
    while (i < FR_SIZES && !(slots[device][i] && sizes[device][i] == smem))
      ++i;
    if (i == FR_SIZES) {
      int per_sm = 0, sms = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                        FR_THREADS, smem);
      if (e != cudaSuccess) return e;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      i = next[device];
      next[device] = (i + 1) % FR_SIZES;
      sizes[device][i] = smem;
      slots[device][i] = per_sm * sms;
    }
    grid = (int)std::min<long long>(groups, slots[device][i]);
  }
  Kernel<<<grid, FR_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
