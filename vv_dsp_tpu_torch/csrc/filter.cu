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
// (16, 638976) with 21 taps a phase the call moves 71.6 MB (0.0214 ms) for
// 429 MFLOP (0.0064 ms): bytes. Design: the per-phase form. Output
// m = q*up + s is frame q, phase s; phase s of every frame uses one tap row
// and reads x[q*down + (half_len + s*down) div up - i], a stride-down
// correlation. A block owns POLY_FRAMES frames of one channel: it stages
// their input window and the whole tap table (up*taps_pp <= 512 by the
// caller's rule) in shared memory, runs the up phases one after another
// (all threads on one phase, so each tap is a broadcast), collects the
// outputs in shared memory in natural order and writes them out coalesced.
// The TPU's phase deinterleave of the input and re-interleave of the output
// are layout work for its lanes: here x is read and y written in natural
// order, with no pass on either side.
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

constexpr int POLY_THREADS = 128;
constexpr int POLY_PER_THREAD = 4;
constexpr int POLY_FRAMES = POLY_THREADS * POLY_PER_THREAD;

__global__ void __launch_bounds__(POLY_THREADS)
poly_kernel(const float* __restrict__ x, const float* __restrict__ hpp,
            float* __restrict__ y, long long n_in, long long n_out, int up,
            int down, int half_len, int taps_pp, int win) {
  extern __shared__ float smem[];
  float* xs = smem;                 // the frames' input window
  float* hs = xs + win;             // the (up, taps_pp) tap table
  float* ys = hs + up * taps_pp;    // POLY_FRAMES * up outputs, natural order

  const int c = blockIdx.y;
  const long long q0 = (long long)blockIdx.x * POLY_FRAMES;
  const int a0 = half_len / up;  // phase 0's newest sample in frame 0
  // window slot 0 holds x[j0], the oldest sample any output of the block
  // reads
  const long long j0 = q0 * down + a0 - (taps_pp - 1);
  const float* xc = x + (long long)c * n_in;
  for (int j = threadIdx.x; j < win; j += POLY_THREADS) {
    const long long src = j0 + j;
    xs[j] = (src >= 0 && src < n_in) ? xc[src] : 0.f;
  }
  for (int k = threadIdx.x; k < up * taps_pp; k += POLY_THREADS)
    hs[k] = hpp[k];
  __syncthreads();

  for (int s = 0; s < up; ++s) {
    const int t = half_len + s * down;
    const float* hrow = hs + (t % up) * taps_pp;
    // frame q0 + f, phase s: its newest sample x[(q0 + f)*down + t/up]
    // sits at window slot f*down + base
    const float* xt = xs + (t / up - a0) + (taps_pp - 1) +
                      (long long)threadIdx.x * down;
    float acc[POLY_PER_THREAD];
#pragma unroll
    for (int r = 0; r < POLY_PER_THREAD; ++r) acc[r] = 0.f;
    for (int i = 0; i < taps_pp; ++i) {
      const float w = hrow[i];
#pragma unroll
      for (int r = 0; r < POLY_PER_THREAD; ++r)
        acc[r] = fmaf(w, xt[r * POLY_THREADS * down - i], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < POLY_PER_THREAD; ++r)
      ys[(threadIdx.x + r * POLY_THREADS) * up + s] = acc[r];
  }
  __syncthreads();

  // outputs past n_out read zero-padded or unused window slots and are
  // not stored
  const long long m0 = q0 * up;
  float* yc = y + (long long)c * n_out;
  for (int k = threadIdx.x; k < POLY_FRAMES * up; k += POLY_THREADS)
    if (m0 + k < n_out) yc[m0 + k] = ys[k];
}

extern "C" int vv_poly(const float* x, const float* hpp, float* y,
                       int channels, long long n_in, long long n_out, int up,
                       int down, int half_len, int taps_pp, int device,
                       void* stream) {
  if (up < 1 || down < 1 || half_len < 0 || taps_pp < 1 || channels < 1 ||
      channels > 65535 || n_out < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  // the window spans POLY_FRAMES frames of `down` samples, the phases'
  // spread of newest samples and taps_pp - 1 samples of history
  const int a_last = (half_len + (up - 1) * down) / up;
  const int win =
      (POLY_FRAMES - 1) * down + (a_last - half_len / up) + taps_pp;
  const size_t smem =
      ((size_t)win + (size_t)up * taps_pp + (size_t)POLY_FRAMES * up) *
      sizeof(float);
  // a window and table beyond what one block may hold is refused here
  cudaError_t err = cudaFuncSetAttribute(
      poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const long long frames = (n_out + up - 1) / up;
  const dim3 grid((unsigned)((frames + POLY_FRAMES - 1) / POLY_FRAMES),
                  (unsigned)channels);
  poly_kernel<<<grid, POLY_THREADS, smem, (cudaStream_t)stream>>>(
      x, hpp, y, n_in, n_out, up, down, half_len, taps_pp, win);
  return (int)cudaGetLastError();
}
