// Causal FIR, lfilter(h, [1], x) on rows of (c, n), by fused overlap-save
// on the register-resident FFT: fir_os_kernel.
//
// It replaces no TPU kernel: the JAX package's overlap-save FIR
// (vv_dsp_tpu/ops/fir.py fir_apply_os) is XLA rffts, and its TPU route for
// a long float32 FIR is the banded upfirdn (pallas_upfirdn.py), ported as
// csrc/upfirdn.cu. On this card that banded kernel at the f32 tier does
// six bf16 tensor-core products a multiply-add: at 64 x 479,232 samples
// and 1,024 taps its own floor is 0.381 ms, and it read 6.7% of the call's
// byte bound (0.0732 ms: the input read and the output written once).
// Overlap-save needs a tenth of the arithmetic for the same filter, in
// float32 and more accurately than the direct sum.
//
// Segments. The transform is the 4,096-point real FFT, packed as an
// M = 2,048 point complex FFT (packed.cuh, fft_reg.cuh). Segment b of a
// row reads the 4,096 samples from b*block - lead, zero left of 0 and
// right of n, read in place (no padded copy), and gives the outputs
// b*block .. b*block + block - 1: positions lead .. lead + block - 1 of the
// segment's circular convolution, which the wrap does not reach since
// lead >= taps - 1. The host (ops/filter_kernels.py os_geometry) takes lead
// as taps - 1 rounded up to even and block = 4096 - lead, so every segment
// starts at an even sample and its outputs at an even offset: the loads
// and stores go two floats at a time wherever the row allows.
//
// The filter as one product a bin. With z the packed segment and Z its
// M-point spectrum, the packed output's spectrum is
//   Z'[k] = alpha[k] Z[k] + beta[k] conj Z[(M - k) mod M],
// which folds the Hermitian unpack, the product with the taps' 4,096-point
// spectrum H, the repack and the 1/4096 of the inverse into two complex
// factors a bin (alpha = ((H[k] + G) - (H[k] - G) sin t) / 4096, beta =
// i (H[k] - G) cos t / 4096, G = conj H[M - k], t = 2 pi k / 4096), built
// in float64 on the host once per taps (os_table_np) and cast to float32.
// The inverse runs as istft.cu's: M ifft(Z') = conj(fft(conj Z')), so the
// table holds conj alpha and conj beta and the kernel computes conj Z'
// straight into the registers of the second forward transform.
//
// Bound. At the cell's shape (64 x 479,232, 1,024 taps: 9,984 segments of
// 3,072 outputs) each segment costs two M = 2,048 transforms (5 M log2 M
// flops each) and the product, about 2.5 GFLOP a call, against 245 MB of
// input read and output written (0.0732 ms at 3.35 TB/s); the history
// (1,024 of each 4,096 samples) is read again, mostly from L2. The
// register FFT's barriers and shared-memory exchanges, not the float32
// peak (0.038 ms for those operations), keep it above the byte bound: it
// takes 0.148 ms, 17 TFLOP/s and 49% of the byte bound (H100 SXM, 700 W).
// The design keeps everything but the input and output on chip: one
// transform of 256 threads a block on a persistent grid (fr_launch), each
// thread holding 8 points in registers; the table (32 KB) and two
// exchange buffers (32 KB) in shared memory, 64 KB a block; the twiddle
// table read from device memory and held in L1, as istft.cu reads it. A
// segment's spectrum and time block never leave the SM, and the next
// segment's samples are loaded into the freed registers before this
// segment's outputs are stored, so the load waits behind the stores.
// Two blocks an SM, at up to 128 registers: at three (80 registers) the
// kernel spilled 108 bytes and took 0.179 ms at the cell's shape against
// 0.148 ms at two, and staging the twiddles in shared memory at two blocks
// took 0.173 ms (H100 SXM, 700 W).
#include "packed.cuh"

constexpr int OS_M = 2048;          // complex points of the packed transform
constexpr int OS_NFFT = 2 * OS_M;   // real points of a segment
constexpr size_t OS_SMEM =
    OS_M * sizeof(float4) + 2 * FR_POINTS * sizeof(float2);

static_assert(OS_M / 8 == FR_THREADS, "one transform a block");
static_assert(OS_M == FR_POINTS, "the exchange buffers hold one transform");

// Thread j's packed points v[s] = (x[s0 + 2p], x[s0 + 2p + 1]), p = j +
// s M/8, of row xc (n samples), zero outside [0, n): one 8-byte load a
// point where the segment lies inside the row at an 8-byte aligned
// address, else two bounds-checked scalar loads.
__device__ __forceinline__ void os_segment_regs(float2 (&v)[8],
                                                const float* __restrict__ xc,
                                                long long n, long long s0,
                                                int j) {
  constexpr int T = OS_M / 8;
  if (s0 >= 0 && s0 + OS_NFFT <= n &&
      ((reinterpret_cast<uintptr_t>(xc) + 4 * s0) & 7) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(xc + s0);
#pragma unroll
    for (int s = 0; s < 8; ++s) v[s] = __ldg(x2 + j + s * T);
    return;
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const long long i = s0 + 2 * (j + s * T);
    v[s] = make_float2(i >= 0 && i < n ? __ldg(xc + i) : 0.f,
                       i + 1 >= 0 && i + 1 < n ? __ldg(xc + i + 1) : 0.f);
  }
}

// x, y: (channels, n) float32; tab: (M,) float4 (conj alpha, conj beta)
// a bin; tw: the M-point transform's twiddle table
// (fft_plan.pass_twiddles). Block i takes the items i, i + gridDim.x, ...
// of the walk over (row c, segment s), per_row segments a row; it steps
// (c, s) by gridDim.x with no 64-bit division.
__global__ void __launch_bounds__(FR_THREADS, 2)
fir_os_kernel(const float* __restrict__ x, const float4* __restrict__ tab,
              const float2* __restrict__ tw, float* __restrict__ y,
              int channels, long long n, int lead, int block, int per_row) {
  constexpr int M = OS_M, T = M / 8;
  extern __shared__ __align__(16) float4 sm4[];
  float4* tabs = sm4;
  float2* a = reinterpret_cast<float2*>(sm4 + M);
  float2* b = a + FR_POINTS;
  for (int i = threadIdx.x; i < M; i += FR_THREADS) tabs[i] = tab[i];
  const int j = threadIdx.x;
  const int step_c = gridDim.x / per_row, step_b = gridDim.x % per_row;
  int c = blockIdx.x / per_row, s = blockIdx.x % per_row;
  float2 v[8];
  if (c < channels)
    os_segment_regs(v, x + c * n, n, (long long)s * block - lead, j);
  __syncthreads();
  while (c < channels) {
    fr_fft<M>(v, j, tw, a, b);
    const float2* z = fr_result<M>(a, b);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = j + u * T;
      const float2 zk = z[k], zr = z[(M - k) & (M - 1)];
      const float4 t = tabs[k];
      // conj Z'[k] = conj(alpha) conj(Z[k]) + conj(beta) Z[M - k]
      v[u] = make_float2(t.x * zk.x + t.y * zk.y + t.z * zr.x - t.w * zr.y,
                         t.y * zk.x - t.x * zk.y + t.z * zr.y + t.w * zr.x);
    }
    // the inverse's first pass writes the buffer that does not hold z
    fr_swap_after<M>(a, b);
    fr_fft<M>(v, j, tw, a, b);
    // the packed output conj(w): y[2i] = Re, y[2i + 1] = -Im
    const float2* w = fr_result<M>(a, b) + lead / 2;
    fr_swap_after<M>(a, b);
    // the next item's samples in flight while this one's are stored
    int cn = c + step_c, sn = s + step_b;
    if (sn >= per_row) {
      sn -= per_row;
      ++cn;
    }
    if (cn < channels)
      os_segment_regs(v, x + cn * n, n, (long long)sn * block - lead, j);
    const long long o0 = (long long)s * block;
    float* yo = y + c * n + o0;
    const int count = (int)min((long long)block, n - o0);
    const int pairs =
        (reinterpret_cast<uintptr_t>(yo) & 7) == 0 ? count / 2 : 0;
    float2* y2 = reinterpret_cast<float2*>(yo);
    for (int i = threadIdx.x; i < pairs; i += FR_THREADS) {
      const float2 u = w[i];
      y2[i] = make_float2(u.x, -u.y);
    }
    for (int i = 2 * pairs + threadIdx.x; i < count; i += FR_THREADS) {
      const float2 u = w[i >> 1];
      yo[i] = (i & 1) ? -u.y : u.x;
    }
    c = cn;
    s = sn;
  }
}

// lead, block: os_geometry's (even, lead + block <= 4096); the host keeps
// lead >= taps - 1.
extern "C" int vv_fir_os(const float* x, const void* tab, const void* tw,
                         float* y, int channels, long long n, int lead,
                         int block, int device, void* stream) {
  if (channels < 1 || channels > 65535 || n < 1 || lead < 0 || (lead & 1) ||
      block < 2 || (block & 1) || lead + block > OS_NFFT)
    return (int)cudaErrorInvalidValue;
  const long long per_row = (n + block - 1) / block;
  if (per_row > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)fr_launch<fir_os_kernel>(
      OS_SMEM, per_row * channels, device, (cudaStream_t)stream, x,
      (const float4*)tab, (const float2*)tw, y, channels, n, lead, block,
      (int)per_row);
}
