// Direct FIR and per-phase polyphase resampling: the filter and resample
// kernels of ops/filter_kernels.py. Both run plain float32 FMAs on the CUDA
// cores.
//
// fir_direct_kernel replaces vv_dsp_tpu/ops/pallas_kernels.py::_fir_kernel
// (launcher fir_apply_pallas). It computes the causal FIR
//   y[c, i] = sum_{k < taps} h[k] * x[c, i - k],   x = 0 before 0,
// on (channels, n) -> (channels, n). Bound: at 16 taps on (16, 479232) the
// call reads and writes 61.3 MB (0.0183 ms at 3.35 TB/s) for 245 MFLOP
// (0.0037 ms at 67 TFLOP/s): bytes. Design: a block owns FIR_BLOCK
// consecutive outputs of one channel and stages them with their taps-1
// samples of history, and the taps, in shared memory with coalesced loads;
// each thread carries FIR_PER_THREAD sums FIR_THREADS apart, so a warp reads
// 32 consecutive window slots per tap (no bank conflicts) and the tap is a
// broadcast. The TPU's 8-channel tile, its 128-lane alignment, the padded
// right edge and the DMA semaphore do not come across: the block zero-fills
// the window outside the signal and stores only outputs below n.
//
// poly_kernel replaces vv_dsp_tpu/ops/pallas_kernels.py::_poly_kernel
// (launcher resample_poly_pallas). With t = half_len + m*down it computes
//   y[c, m] = sum_{i < taps_pp} hpp[t mod up, i] * x[c, t div up - i],
// m < n_out, where hpp is the (up, taps_pp) polyphase table of
// scipy.signal.resample_poly's filter. Bound: at 4/3 on (16, 479232) ->
// (16, 638976) with 21 taps a phase the call moves 71.6 MB (0.0214 ms at
// 3.35 TB/s) for 429 MFLOP (0.0064 ms at 67 TFLOP/s): bytes, at every
// ratio it takes (2/1 0.0275 ms, 1/2 0.0137, 3/4 0.0160, 7/5 0.0220).
// Design (its host plan is ops/poly_plan.py, which the launcher follows):
// - Residue rows. Output m = q*up + s is frame q, phase s; writing the
//   sample offsets a_s - i of phase s as M*down + r, its taps fall into
//   min(down, taps_pp) classes by r, each a unit-stride correlation of K =
//   ceil(taps_pp/down) or K - 1 taps along residue row X_r[j] = x[j*down
//   + r]. A tile's window is copied in deinterleaved, row r holding X_r
//   (the layout the TPU launcher builds in HBM with an XLA pass, built here
//   during the copy), with cp.async, zeros outside the signal. Over every
//   geometry the caller sends here (up*taps_pp <= 512) K is 1-7, 11 or
//   21: one instance each, running a phase's classes of K taps, then those
//   of K - 1.
// - Samples from registers. A warp takes one phase of 32*POLY_R frames
//   (POLY_R = 11 a lane), up to 8 warps a tile's phases. For each class a
//   lane loads POLY_R + K - 1 row samples into registers, the class's taps
//   as broadcast float4s and its window offset, and runs POLY_R*K FMAs: at
//   4/3 (K = 7) 20 loads for 77 FMAs, 0.26 a FMA (0.16 at K = 21, 0.33 at
//   7/5), where the per-phase stride-down form loaded 1.25 (a tap and 4
//   samples for 4 FMAs).
// - No bank conflicts at any up or down. Lanes read and write 11 (odd)
//   words apart. The window is copied by whole columns, lane l of a warp
//   taking row l mod down, column l div down, with the row pitch = 32 div
//   down (mod 32); outputs are staged phase-major (phase row s, column f)
//   and stored by whole frames, lane l taking phase l mod up of frame l div
//   up, with the phase pitch = 32 div up (mod 32): a warp's copies and its
//   reads of the staged outputs fall on distinct banks, and its stores are
//   one run of (32 div up)*up consecutive outputs. The stores are 4 bytes:
//   a lane holding 4 consecutive outputs would read 4 phase rows, which no
//   pitch keeps free of conflicts at every up.
// - Device memory busy. A persistent grid (as many blocks as fit the
//   card) walks the tiles; a block copies its next tile's window in with
//   cp.async, every copy of it in flight at once, while it computes and
//   stores the current one, so a block's copies, FMAs and stores overlap
//   (two window buffers; shared memory 14,880 bytes a block at 4/3, the
//   most 120,968 at 24/25).
#include <mutex>

#include "common.cuh"

constexpr int FIR_THREADS = 256;
constexpr int FIR_PER_THREAD = 4;
constexpr int FIR_BLOCK = FIR_THREADS * FIR_PER_THREAD;
constexpr int FIR_MAX_TAPS = 2048;  // fir_apply_pallas's limit

__global__ void __launch_bounds__(FIR_THREADS)
fir_direct_kernel(const float* __restrict__ x, const float* __restrict__ h,
                  float* __restrict__ y, long long n, int taps) {
  extern __shared__ float smem[];
  const int win = FIR_BLOCK + taps - 1;
  float* xs = smem;        // xs[j] = x[i0 - (taps - 1) + j]
  float* hs = smem + win;  // the taps

  const int c = blockIdx.y;
  const long long i0 = (long long)blockIdx.x * FIR_BLOCK;
  const long long j0 = i0 - (taps - 1);
  const float* xc = x + (long long)c * n;
  for (int j = threadIdx.x; j < win; j += FIR_THREADS) {
    const long long src = j0 + j;
    xs[j] = (src >= 0 && src < n) ? xc[src] : 0.f;
  }
  for (int k = threadIdx.x; k < taps; k += FIR_THREADS) hs[k] = h[k];
  __syncthreads();

  // output r of this thread is i0 + threadIdx.x + r*FIR_THREADS; its newest
  // sample x[i] sits at window slot threadIdx.x + r*FIR_THREADS + taps - 1
  float acc[FIR_PER_THREAD];
#pragma unroll
  for (int r = 0; r < FIR_PER_THREAD; ++r) acc[r] = 0.f;
  const float* xt = xs + threadIdx.x + taps - 1;
#pragma unroll 4
  for (int k = 0; k < taps; ++k) {
    const float hk = hs[k];
#pragma unroll
    for (int r = 0; r < FIR_PER_THREAD; ++r)
      acc[r] = fmaf(hk, xt[r * FIR_THREADS - k], acc[r]);
  }

  float* yc = y + (long long)c * n;
#pragma unroll
  for (int r = 0; r < FIR_PER_THREAD; ++r) {
    const long long i = i0 + threadIdx.x + r * FIR_THREADS;
    if (i < n) yc[i] = acc[r];
  }
}

extern "C" int vv_fir_direct(const float* x, const float* h, float* y,
                             int channels, long long n, int taps, int device,
                             void* stream) {
  if (taps < 1 || taps > FIR_MAX_TAPS || channels < 1 || channels > 65535 ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  // at most (1024 + 2047 + 2048) floats = 20.5 KB: no opt-in needed
  const size_t smem = (size_t)(FIR_BLOCK + 2 * taps - 1) * sizeof(float);
  const dim3 grid((unsigned)((n + FIR_BLOCK - 1) / FIR_BLOCK),
                  (unsigned)channels);
  fir_direct_kernel<<<grid, FIR_THREADS, smem, (cudaStream_t)stream>>>(
      x, h, y, n, taps);
  return (int)cudaGetLastError();
}

constexpr int POLY_R = 11;           // frames a thread (ops/poly_plan.py)
constexpr int POLY_MAX_THREADS = 256;

namespace {

// 4 bytes from global to shared memory, asynchronously, or zeros where ok
// is false
__device__ __forceinline__ void copy4_async(float* dst, const float* src,
                                            bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

}  // namespace

// acc[j] += sum_k w[k] * win[j + KC - 1 - k] for one class of KC taps
// (w, 16-byte aligned) and frames f0 + j: win[v] = src[v], v < POLY_R + KC
// - 1, the class's samples X_r[q0 + f0 + M - (KC - 1) + v], loaded once
// into registers.
template <int KC>
__device__ __forceinline__ void class_sums(float (&acc)[POLY_R],
                                           const float* src,
                                           const float* w) {
  if constexpr (KC > 0) {
    float win[POLY_R + KC - 1];
#pragma unroll
    for (int v = 0; v < POLY_R + KC - 1; ++v) win[v] = src[v];
    const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
    for (int kq = 0; kq < (KC + 3) / 4; ++kq) {
      const float4 h4 = w4[kq];
      const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kq + e;
        if (k < KC) {
#pragma unroll
          for (int j = 0; j < POLY_R; ++j)
            acc[j] = fmaf(h[e], win[j + KC - 1 - k], acc[j]);
        }
      }
    }
  }
}

// A persistent grid of blocks, each walking tiles blockIdx.x, blockIdx.x +
// gridDim.x, ..., tile t being frames q0 .. q0 + frames - 1 (q0 = (t %
// blocks_per_row) * frames) of row t / blocks_per_row. A tile's work items
// are (phase s, frame group g), g < frames / (32 * POLY_R), item i = g*up
// + s; warp w takes items w, w + warps, ..., lane l owning frames g*32*R +
// l*R .. + R - 1 of the item's group. Shared memory as ops/poly_plan.py
// lays it out: ws (the classes' taps, kp = K rounded up to 4 a class), os
// (each class's window start), two window buffers (down residue rows each,
// q_pitch apart; column j of row r holds x[(q0 + lo + j)*down + r]) and ys
// (up phase rows, p_pitch apart). The next tile's window is copied in
// while the block computes and stores the current one.
template <int K>
__global__ void __launch_bounds__(POLY_MAX_THREADS)
poly_kernel(const float* __restrict__ x, const float* __restrict__ wts,
            const int* __restrict__ offs, float* __restrict__ y,
            long long n_in, long long n_out, int up, int down, int ncls,
            int n_big, int lo, int row_len, int q_pitch, int p_pitch,
            int frames, long long blocks_per_row, long long tiles) {
  constexpr int KP = (K + 3) / 4 * 4;
  extern __shared__ __align__(16) float smem[];
  const int n_cls = up * ncls;
  float* ws = smem;
  int* os = reinterpret_cast<int*>(ws + n_cls * KP);
  float* xs0 = reinterpret_cast<float*>(os + n_cls);
  float* xs1 = xs0 + down * q_pitch;
  float* ys = xs1 + down * q_pitch;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int items = up * (frames / (32 * POLY_R));

  // a tile's window, by whole columns: lane l copies row l % down of
  // column l / down of each run of g_in columns; a window inside the
  // signal takes no bound checks
  const int g_in = 32 / down;
  const int r_in = lane % down, c_in = lane / down;
  const int step_in = warps * g_in;
  auto copy_window = [&](long long t, float* xs) {
    const long long c = t / blocks_per_row;
    const long long x0 = ((t - c * blocks_per_row) * frames + lo) * down;
    const float* xc = x + c * n_in;
    if (c_in < g_in) {
      int j = warp * g_in + c_in;
      float* dst = xs + r_in * q_pitch + j;
      long long src = x0 + (long long)j * down + r_in;
      const long long src_step = (long long)step_in * down;
      if (x0 >= 0 && x0 + (long long)row_len * down <= n_in) {
        const float* from = xc + src;
#pragma unroll 4
        for (; j < row_len; j += step_in, dst += step_in, from += src_step)
          copy4_async(dst, from, true);
      } else {
        for (; j < row_len; j += step_in, dst += step_in, src += src_step) {
          const bool ok = src >= 0 && src < n_in;
          copy4_async(dst, ok ? xc + src : xc, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  long long t = blockIdx.x;
  if (t < tiles) copy_window(t, xs0);
  for (int i = threadIdx.x; i < n_cls * KP; i += blockDim.x) ws[i] = wts[i];
  for (int i = threadIdx.x; i < n_cls; i += blockDim.x) os[i] = offs[i];

  const int g_out = 32 / up;
  const int s_out = lane % up, f_out = lane / up;
  const int step_out = warps * g_out;
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    // the next tile's window goes to the buffer the previous tile read,
    // which every thread left at the barrier after its sums
    const float* xs = (it & 1) ? xs1 : xs0;
    if (t + gridDim.x < tiles) {
      copy_window(t + gridDim.x, (it & 1) ? xs0 : xs1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    for (int item = warp; item < items; item += warps) {
      const int g = item / up, s = item - g * up;
      const int f0 = (g * 32 + lane) * POLY_R;
      float acc[POLY_R];
#pragma unroll
      for (int j = 0; j < POLY_R; ++j) acc[j] = 0.f;
      // the phase's n_big classes of K taps, then its classes of K - 1
      const int c0 = s * ncls;
      int ci = 0;
      if constexpr (K == 1) {
        // one tap a class: unrolled, the loop spilled
#pragma unroll 1
        for (; ci < ncls; ++ci)
          class_sums<1>(acc, xs + os[c0 + ci] + f0, ws + (c0 + ci) * KP);
      } else {
        for (; ci < n_big; ++ci)
          class_sums<K>(acc, xs + os[c0 + ci] + f0, ws + (c0 + ci) * KP);
        for (; ci < ncls; ++ci)
          class_sums<K - 1>(acc, xs + os[c0 + ci] + f0,
                            ws + (c0 + ci) * KP);
      }
      float* yrow = ys + s * p_pitch + f0;
#pragma unroll
      for (int j = 0; j < POLY_R; ++j) yrow[j] = acc[j];
    }
    __syncthreads();

    // the outputs, by whole frames: lane l stores phase l % up of frame
    // l / up of each run of g_out frames; outputs past n_out are not
    // stored
    if (f_out < g_out) {
      const long long c = t / blocks_per_row;
      const long long m0 = (t - c * blocks_per_row) * frames * up;
      int f = warp * g_out + f_out;
      const float* from = ys + s_out * p_pitch + f;
      float* dst = y + c * n_out + m0 + (long long)f * up + s_out;
      const int dst_step = step_out * up;
      if (m0 + (long long)frames * up <= n_out) {
#pragma unroll 4
        for (; f < frames; f += step_out, from += step_out, dst += dst_step)
          *dst = *from;
      } else {
        const long long left = n_out - m0 - s_out;
        for (; f < frames; f += step_out, from += step_out, dst += dst_step)
          if ((long long)f * up < left) *dst = *from;
      }
    }
  }
}

namespace {

// Blocks of poly_kernel<K> that fit the card at once with this block size
// and shared memory: the persistent grid. Cached per device and layout
// behind a lock, and set the instance's shared-memory attribute, as
// fr_launch (csrc/fft_reg.cuh) does for its kernels.
template <int K>
cudaError_t poly_resident(int device, int threads, size_t smem, int* out) {
  constexpr int SLOTS = 16;
  struct Slot {
    int threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static size_t attr[64] = {0};
  static Slot slots[64][SLOTS] = {};
  static int next[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t e;
  if (smem > attr[device]) {
    e = cudaFuncSetAttribute(poly_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return e;
    }
    attr[device] = smem;
  }
  for (const Slot& sl : slots[device])
    if (sl.blocks && sl.threads == threads && sl.smem == smem) {
      *out = sl.blocks;
      return cudaSuccess;
    }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, poly_kernel<K>,
                                                    threads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int i = next[device];
  next[device] = (i + 1) % SLOTS;
  slots[device][i] = {threads, smem, per_sm * sms};
  *out = per_sm * sms;
  return cudaSuccess;
}

template <int K>
int launch_poly(const float* x, const float* w, const int* offs, float* y,
                int channels, long long n_in, long long n_out, int up,
                int down, int ncls, int n_big, int lo, int row_len,
                int q_pitch, int p_pitch, int frames, int threads,
                size_t smem, int device, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = poly_resident<K>(device, threads, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long row_frames = (n_out + up - 1) / up;
  const long long per_row = (row_frames + frames - 1) / frames;
  const long long tiles = per_row * channels;
  const int grid = (int)std::min<long long>(tiles, resident);
  poly_kernel<K><<<grid, threads, smem, stream>>>(
      x, w, offs, y, n_in, n_out, up, down, ncls, n_big, lo, row_len,
      q_pitch, p_pitch, frames, per_row, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's layout (ops/poly_plan.py poly_plan): its instance k, classes
// a phase, block size, window and pitches, and its shared memory, which
// must be this layout's (ws, os, two windows, ys).
extern "C" int vv_poly(const float* x, const float* w, const int* offs,
                       float* y, int channels, long long n_in,
                       long long n_out, int up, int down, int ncls,
                       int n_big, int k, int lo, int row_len, int q_pitch,
                       int p_pitch,
                       int frames, int threads, int smem, int device,
                       void* stream) {
  const int kp = (k + 3) / 4 * 4;
  const long long need =
      4LL * ((long long)up * ncls * (kp + 1) +
             2LL * down * q_pitch + (long long)up * p_pitch);
  if (up < 1 || up > 32 || down < 1 || down > 32 || ncls < 1 ||
      ncls > down || n_big < (k == 1 ? ncls : 0) || n_big > ncls ||
      channels < 1 || channels > 65535 || n_in < 0 || n_out < 1 || threads < 32 || threads > POLY_MAX_THREADS ||
      threads % 32 || frames < 32 * POLY_R || frames % (32 * POLY_R) ||
      row_len < frames || q_pitch < row_len || p_pitch < frames ||
      smem != need)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const cudaStream_t st = (cudaStream_t)stream;
#define VV_POLY_CASE(K)                                                      \
  case K:                                                                    \
    return launch_poly<K>(x, w, offs, y, channels, n_in, n_out, up, down,   \
                          ncls, n_big, lo, row_len, q_pitch, p_pitch,       \
                          frames, threads, (size_t)smem, device, st);
  switch (k) {
    VV_POLY_CASE(1)
    VV_POLY_CASE(2)
    VV_POLY_CASE(3)
    VV_POLY_CASE(4)
    VV_POLY_CASE(5)
    VV_POLY_CASE(6)
    VV_POLY_CASE(7)
    VV_POLY_CASE(11)
    VV_POLY_CASE(21)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VV_POLY_CASE
}
