// Power spectrogram as a windowed-DFT product: |rfft(w * frame)|^2 of every
// frame, the frames never formed.
//
// dft_power_kernel replaces _stft_power_kernel of
// vv_dsp_tpu/ops/pallas_kernels.py (launcher stft_power_pallas).
//
// Frame f of channel c is x[f*hop, f*hop + nfft), zero past n. With the
// window folded into the r2c basis (B[j, k] = w[j] exp(-2 pi i j k / nfft),
// built in float64 on the host and cast once), the spectrum is one product
//   X[f, k] = sum_j A[f, j] B[j, k],  A[f, j] = x[f*hop + j],
// and A is a view of the signal with row stride hop: the TPU kernel's q =
// nfft/hop shifted (frames x hop) @ (hop x bins) products of the hop-blocked
// signal, which it stages through VMEM, are the q hop-long stretches of the
// depth here. The kernel is a float32 GEMM on the CUDA cores, written by
// hand: a block computes a 64-frame x 64-bin tile of the re and im parts,
// stepping through the depth 32 samples at a time; each step stages the
// signal rows (A, transposed, its rows padded so the transposing stores hit
// 32 distinct banks) and the basis rows (re and im) in shared memory, and
// each thread keeps a 4 x 4 register tile of re and im sums, reading 4
// frames and 4 + 4 basis values as float4s for 32 fused multiply-adds.
// re^2 + im^2 is written once, at the end. Products are float32, which the
// JAX kernel computes at its default precision (HIGHEST).
//
// Bound. The function reads the signal and writes the power, 92 MB at
// 1024/256 on 16 x 1873 frames (0.028 ms at 3.35 TB/s), and an FFT needs
// far fewer operations than that moves, so device memory bounds it, as it
// does the packed power kernel of stft.cu. This algorithm does 2 x 2 x nfft
// operations a bin, O(nfft) where an FFT does O(log nfft): 62.97 GFLOP,
// 0.94 ms at the card's 67 TFLOP/s float32 peak, a floor of the form, not
// of the function. The form exists because it is one GEMM (the TPU's matrix
// unit runs it at its full rate). The basis holds the bins padded to the
// 64-bin tile with zero columns; their power is never written.
#include "common.cuh"

constexpr int DP_THREADS = 256;
constexpr int DP_BM = 64;            // frames a block
constexpr int DP_BN = 64;            // bins a block
constexpr int DP_BK = 32;            // depth a step (frame samples)
constexpr int DP_TM = 4, DP_TN = 4;  // a thread's frames x bins
constexpr int DP_APAD = DP_BM + 4;   // A row: 16-byte aligned, banks spread

// x: (channels, n); bre, bim: (nfft, cols) windowed basis, zero past bin
// nfft/2; out: (channels, nf, bins)
__global__ void __launch_bounds__(DP_THREADS)
dft_power_kernel(const float* __restrict__ x, const float* __restrict__ bre,
                 const float* __restrict__ bim, float* __restrict__ out,
                 long long n, int nf, int nfft, int hop, int bins, int cols) {
  __shared__ __align__(16) float as[DP_BK][DP_APAD];
  __shared__ __align__(16) float bs_re[DP_BK][DP_BN];
  __shared__ __align__(16) float bs_im[DP_BK][DP_BN];
  const int f_base = blockIdx.x * DP_BM, k_base = blockIdx.y * DP_BN;
  const int c = blockIdx.z;
  const float* xc = x + (long long)c * n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float re[DP_TM][DP_TN] = {}, im[DP_TM][DP_TN] = {};

  for (int j0 = 0; j0 < nfft; j0 += DP_BK) {
    // A: a warp loads 8 depths x 4 frames at a time, 32-byte runs of x
    for (int g = warp; g < (DP_BK / 8) * (DP_BM / 4); g += DP_THREADS / 32) {
      const int kk = (g & 3) * 8 + (lane & 7);
      const int f = (g >> 2) * 4 + (lane >> 3);
      const long long i = (long long)(f_base + f) * hop + j0 + kk;
      as[kk][f] = (f_base + f < nf && i < n) ? xc[i] : 0.f;
    }
    // B: 16 float4s of 64 bins a row, re and im
    for (int t = threadIdx.x; t < DP_BK * DP_BN / 4; t += DP_THREADS) {
      const int row = t >> 4, col = (t & 15) * 4;
      const long long off = (long long)(j0 + row) * cols + k_base + col;
      *reinterpret_cast<float4*>(&bs_re[row][col]) =
          *reinterpret_cast<const float4*>(bre + off);
      *reinterpret_cast<float4*>(&bs_im[row][col]) =
          *reinterpret_cast<const float4*>(bim + off);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DP_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 br = *reinterpret_cast<const float4*>(&bs_re[kk][tx * 4]);
      const float4 bi = *reinterpret_cast<const float4*>(&bs_im[kk][tx * 4]);
      const float av[DP_TM] = {a.x, a.y, a.z, a.w};
      const float rv[DP_TN] = {br.x, br.y, br.z, br.w};
      const float iv[DP_TN] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int u = 0; u < DP_TM; ++u)
#pragma unroll
        for (int v = 0; v < DP_TN; ++v) {
          re[u][v] = fmaf(av[u], rv[v], re[u][v]);
          im[u][v] = fmaf(av[u], iv[v], im[u][v]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < DP_TM; ++u) {
    const int f = f_base + ty * 4 + u;
    if (f >= nf) continue;
    float* o = out + ((long long)c * nf + f) * bins;
#pragma unroll
    for (int v = 0; v < DP_TN; ++v) {
      const int k = k_base + tx * 4 + v;
      if (k < bins) o[k] = re[u][v] * re[u][v] + im[u][v] * im[u][v];
    }
  }
}

extern "C" int vv_dft_power(const float* x, const float* bre,
                            const float* bim, float* out, int channels,
                            long long n, int nf, int nfft, int hop, int bins,
                            int cols, int device, void* stream) {
  if (nfft < DP_BK || nfft % DP_BK || hop < 1 || nf < 1 || n < 1 ||
      channels < 1 || channels > 65535 || cols % DP_BN || bins < 1 ||
      bins > cols)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const dim3 grid((unsigned)((nf + DP_BM - 1) / DP_BM),
                  (unsigned)(cols / DP_BN), (unsigned)channels);
  dft_power_kernel<<<grid, DP_THREADS, 0, (cudaStream_t)stream>>>(
      x, bre, bim, out, n, nf, nfft, hop, bins, cols);
  return (int)cudaGetLastError();
}
