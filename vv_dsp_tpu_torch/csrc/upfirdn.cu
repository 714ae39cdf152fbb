// Banded upfirdn: the fused FIR + polyphase-resample head of the north-star
// chain.
//
// Replaces vv_dsp_tpu/ops/pallas_upfirdn.py::_kern (launcher
// upfirdn_banded_pallas). Computes, for each channel c and output k,
//   y[c, k] = sum_j x[c, j] * g[offset + k*down - j*up],   x = 0 outside [0, n)
// in its polyphase form: with t = offset + k*down, a = t / up, p = t % up,
//   y[c, k] = sum_i x[c, a - i] * taps[p, i],   taps[p, i] = g[p + i*up],
// written in natural (c, n_out) order.
//
// Bound: at the chain's shape (16 x 638,976 outputs, 1,044 taps per phase)
// the call is ~10.7 G multiply-adds, ~21 GFLOP in f32 and three times the
// multiply-adds at bf16x3: compute, on the CUDA cores. Its memory traffic
// (41 MB out, 31 MB in) is small beside that.
//
// Design: a block owns UF_BLOCK consecutive outputs of one channel and
// stages in shared memory the input window they read (UF_BLOCK*down/up +
// taps_pp samples, zero outside the signal) and the (up, taps_pp) tap
// table, both already split into the tier's bf16 parts, so the inner loop
// is shared-memory loads and FMAs only. Each thread carries UF_PER_THREAD
// independent sums; when UF_THREADS*down is a multiple of up they share one
// phase and so one tap load per step. The TPU kernel's lane-axis segment
// layout, its pltpu.roll halos and its dense band matrix with zero fill do
// not come across: the band is walked directly.
#include "common.cuh"

constexpr int UF_THREADS = 128;
constexpr int UF_PER_THREAD = 4;
constexpr int UF_BLOCK = UF_THREADS * UF_PER_THREAD;

// store v at tier ALG: hi part at hi[i]; bf16x3 also keeps the lo part
template <int ALG>
__device__ __forceinline__ void store_split(float v, float* hi, float* lo,
                                            int i) {
  if (ALG == ALG_F32) {
    hi[i] = v;
  } else if (ALG == ALG_BF16) {
    hi[i] = bf16_round(v);
  } else {
    const float h = bf16_round(v);
    hi[i] = h;
    lo[i] = bf16_round(v - h);
  }
}

template <int ALG, bool SAME_PHASE>
__global__ void __launch_bounds__(UF_THREADS)
upfirdn_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               float* __restrict__ y, long long n_in, long long n_out, int up,
               int down, long long offset, int taps_pp, int win) {
  constexpr int PARTS = ALG == ALG_BF16X3 ? 2 : 1;
  extern __shared__ float smem[];
  float* xs_hi = smem;
  float* xs_lo = smem + win;  // used by bf16x3 only
  float* hs_hi = smem + PARTS * win;
  float* hs_lo = hs_hi + up * taps_pp;

  const int c = blockIdx.y;
  const long long k0 = (long long)blockIdx.x * UF_BLOCK;
  // window slot 0 holds x[j0]: the oldest sample any output of the block
  // reads
  const long long j0 = (offset + k0 * down) / up - (taps_pp - 1);
  const float* xc = x + (long long)c * n_in;
  for (int j = threadIdx.x; j < win; j += UF_THREADS) {
    const long long src = j0 + j;
    const float v = (src >= 0 && src < n_in) ? xc[src] : 0.f;
    store_split<ALG>(v, xs_hi, xs_lo, j);
  }
  for (int q = threadIdx.x; q < up * taps_pp; q += UF_THREADS)
    store_split<ALG>(taps[q], hs_hi, hs_lo, q);
  __syncthreads();

  // output r of this thread is k0 + threadIdx.x + r*UF_THREADS; its newest
  // sample sits at window slot base[r] and its taps start at row[r]
  int base[UF_PER_THREAD], row[UF_PER_THREAD];
  float acc[UF_PER_THREAD];
#pragma unroll
  for (int r = 0; r < UF_PER_THREAD; ++r) {
    const long long k = k0 + threadIdx.x + r * UF_THREADS;
    const long long t = offset + k * down;
    const long long a = t / up;
    base[r] = (int)(a - j0);
    row[r] = (int)(t - a * up) * taps_pp;
    acc[r] = 0.f;
  }
  // outputs past n_out read zero-padded window slots and are not stored

#pragma unroll 4
  for (int i = 0; i < taps_pp; ++i) {
#pragma unroll
    for (int r = 0; r < UF_PER_THREAD; ++r) {
      const int hq = (SAME_PHASE ? row[0] : row[r]) + i;
      const int xq = base[r] - i;
      if (ALG == ALG_BF16X3) {
        const float hh = hs_hi[hq], hl = hs_lo[hq];
        const float xh = xs_hi[xq], xl = xs_lo[xq];
        acc[r] = fmaf(hh, xh, acc[r]);
        acc[r] = fmaf(hh, xl, acc[r]);
        acc[r] = fmaf(hl, xh, acc[r]);
      } else {
        acc[r] = fmaf(hs_hi[hq], xs_hi[xq], acc[r]);
      }
    }
  }

  float* yc = y + (long long)c * n_out;
#pragma unroll
  for (int r = 0; r < UF_PER_THREAD; ++r) {
    const long long k = k0 + threadIdx.x + r * UF_THREADS;
    if (k < n_out) yc[k] = acc[r];
  }
}

// Shared memory the launch needs: the input window and the tap table, in
// the tier's parts.
static size_t upfirdn_smem(int up, int down, int taps_pp, int algorithm,
                           int* win) {
  *win = (UF_BLOCK - 1) * down / up + taps_pp + 1;
  const int parts = algorithm == ALG_BF16X3 ? 2 : 1;
  return (size_t)parts * ((size_t)*win + (size_t)up * taps_pp) * sizeof(float);
}

template <int ALG, bool SAME_PHASE>
static cudaError_t launch_upfirdn(const float* x, const float* taps, float* y,
                                  int channels, long long n_in,
                                  long long n_out, int up, int down,
                                  long long offset, int taps_pp,
                                  cudaStream_t stream) {
  int win = 0;
  const size_t smem = upfirdn_smem(up, down, taps_pp, ALG, &win);
  auto kern = upfirdn_kernel<ALG, SAME_PHASE>;
  // a window and table beyond what one block may hold is refused here
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  const dim3 grid((unsigned)((n_out + UF_BLOCK - 1) / UF_BLOCK),
                  (unsigned)channels);
  kern<<<grid, UF_THREADS, smem, stream>>>(x, taps, y, n_in, n_out, up, down,
                                           offset, taps_pp, win);
  return cudaGetLastError();
}

extern "C" int vv_upfirdn(const float* x, const float* taps, float* y,
                          int channels, long long n_in, long long n_out,
                          int up, int down, long long offset, int taps_pp,
                          int algorithm, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (up < 1 || down < 1 || offset < 0 || taps_pp < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const bool same = (UF_THREADS * down) % up == 0;
#define VV_UPFIRDN(ALG)                                                     \
  return same ? launch_upfirdn<ALG, true>(x, taps, y, channels, n_in, n_out, \
                                          up, down, offset, taps_pp, s)     \
              : launch_upfirdn<ALG, false>(x, taps, y, channels, n_in,      \
                                           n_out, up, down, offset,         \
                                           taps_pp, s)
  switch (algorithm) {
    case ALG_F32: VV_UPFIRDN(ALG_F32);
    case ALG_BF16X3: VV_UPFIRDN(ALG_BF16X3);
    case ALG_BF16: VV_UPFIRDN(ALG_BF16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VV_UPFIRDN
}

extern "C" const char* vv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
