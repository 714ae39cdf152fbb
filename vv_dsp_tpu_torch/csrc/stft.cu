// Windowed packed-real STFT kernels: the complex spectrum, the power
// spectrogram and the fused STFT -> power -> mel -> log -> DCT (MFCC) front
// end.
//
// They replace kernels of vv_dsp_tpu/ops/pallas_fft.py:
//   stft_spectrum_kernel replaces _stft_spectrum_packed_kernel and its
//     _manual variant (launcher _spectrum_packed_planes, entry
//     stft_spectrum_packed) together with its XLA epilogue
//     _packed_natural_full / _packed_natural_onesided;
//   stft_mfcc_kernel replaces _stft_mel_packed_kernel (launcher
//     _stft_mel_call_packed, entries stft_mfcc_pallas and
//     stft_mel_energies_pallas);
//   stft_power_kernel replaces _stft_power_packed_kernel (entry
//     stft_power_packed) together with its _packed_natural_onesided
//     epilogue.
//
// Per (channel, frame) block: frame f covers x[f*hop, f*hop + nfft), zero
// past the signal. Its nfft-point real FFT is an m = nfft/2 point complex
// FFT of z[j] = w[2j] x[2j] + i w[2j+1] x[2j+1] (loaded in bit-reversed
// order, radix-2 DIT in shared memory with host-built float64 -> f32
// twiddles), then the Hermitian unpack
//   X[k] = E[k] + e^{-2 pi i k / nfft} O[k],  k = 0..m,
//   E = (Z[k] + conj Z[m-k]) / 2,  O = (Z[k] - conj Z[m-k]) / 2i.
//
// Bounds. The spectrum kernel writes 8 bytes per bin: 245 MB at the
// STFT row (16 x 1873 frames x 1024 bins), so it is bound by device-memory
// writes; each thread stores whole (re, im) pairs at consecutive bins, and
// the Hermitian mirror bins nfft/2+1..nfft-1 are written by the same kernel.
// The power kernel reads 4 bytes a sample and writes 4 bytes a bin (92 MB
// at 16 x 480000, 1024/256), so it is bound by device memory too; it
// writes re^2 + im^2 of bins 0..m in natural order, so the TPU kernel's
// storage-order permutation epilogue has no counterpart.
// The MFCC kernel reads the signal and writes 20 floats a frame; the
// frames, the spectrum and the power never leave shared memory, which is
// what the TPU kernel exists for. Its ~1.2 GFLOP at the chain's shape are
// small, so it is bound by latency: ~10 barrier-separated FFT stages per
// frame. The TPU kernel's DFT-64 matrix tail, its bit-reversed row-to-bin
// storage order and its VMEM tile picks do not come across: the butterflies
// run to the end and bins come out in natural order.
//
// Tiers: the MFCC kernel applies the dot-algorithm tier (common.cuh) to
// the mel projection and the DCT, the two contractions the TPU kernel runs
// at that tier on its matrix unit; the butterflies are float32 on both
// machines. (The TPU kernel also runs its DFT-64 tail at the tier; here
// that part of the transform is butterflies, in float32.)
#include "common.cuh"

constexpr int STFT_THREADS = 256;

// Load frame `start` of row xc (n samples), windowed and even/odd packed,
// into z in bit-reversed order, then run the m-point radix-2 DIT FFT.
// tw[k] = exp(-2 pi i k / m), k < m/2. On return z[k] = Z[k], natural order.
__device__ void packed_frame_fft(const float* __restrict__ xc, long long n,
                                 long long start,
                                 const float* __restrict__ win,
                                 const float2* __restrict__ tw, float2* z,
                                 int m, int log2m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const long long i0 = start + 2 * j;
    const float a = i0 < n ? xc[i0] : 0.f;
    const float b = i0 + 1 < n ? xc[i0 + 1] : 0.f;
    z[__brev((unsigned)j) >> (32 - log2m)] =
        make_float2(a * win[2 * j], b * win[2 * j + 1]);
  }
  __syncthreads();
  for (int s = 0; s < log2m; ++s) {
    const int half = 1 << s;
    const int stride = m >> (s + 1);  // span 2*half: exp(-2 pi i pos / 2half)
    for (int b = threadIdx.x; b < m / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i0 = ((b >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[pos * stride];
      const float2 u = z[i0], v = z[i1];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      z[i0] = make_float2(u.x + tr, u.y + ti);
      z[i1] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// X[k], 0 <= k <= m, of the 2m-point real frame whose packed spectrum is z;
// wk[k] = exp(-2 pi i k / 2m)
__device__ __forceinline__ float2 unpack_bin(const float2* z,
                                             const float2* __restrict__ wk,
                                             int k, int m) {
  const float2 a = z[k & (m - 1)];
  const float2 b = z[(m - k) & (m - 1)];
  const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
  const float o_r = 0.5f * (a.y + b.y), o_i = 0.5f * (b.x - a.x);
  const float2 w = wk[k];
  return make_float2(er + (w.x * o_r - w.y * o_i),
                     ei + (w.x * o_i + w.y * o_r));
}

// out: (channels, nf, bins) interleaved complex; bins = nfft (two-sided,
// X[nfft-k] = conj X[k]) or nfft/2 + 1 (one-sided)
__global__ void __launch_bounds__(STFT_THREADS)
stft_spectrum_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ wk, float2* __restrict__ out,
                     long long n, int nf, int nfft, int hop, int bins) {
  extern __shared__ float2 z[];
  const int f = blockIdx.x, c = blockIdx.y;
  const int m = nfft / 2, log2m = __ffs(m) - 1;
  packed_frame_fft(x + (long long)c * n, n, (long long)f * hop, win, tw, z, m,
                   log2m);
  float2* o = out + ((long long)c * nf + f) * bins;
  for (int k = threadIdx.x; k < bins; k += STFT_THREADS) {
    float2 v = unpack_bin(z, wk, k <= m ? k : nfft - k, m);
    if (k > m) v.y = -v.y;
    o[k] = v;
  }
}

// out: (channels, nf, nfft/2 + 1) |X[k]|^2, natural bin order
__global__ void __launch_bounds__(STFT_THREADS)
stft_power_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float2* __restrict__ tw,
                  const float2* __restrict__ wk, float* __restrict__ out,
                  long long n, int nf, int nfft, int hop) {
  extern __shared__ float2 z[];
  const int f = blockIdx.x, c = blockIdx.y;
  const int m = nfft / 2, log2m = __ffs(m) - 1;
  packed_frame_fft(x + (long long)c * n, n, (long long)f * hop, win, tw, z, m,
                   log2m);
  float* o = out + ((long long)c * nf + f) * (m + 1);
  for (int k = threadIdx.x; k <= m; k += STFT_THREADS) {
    const float2 v = unpack_bin(z, wk, k, m);
    o[k] = v.x * v.x + v.y * v.y;
  }
}

// out: (channels, nf, n_mfcc) MFCCs when FUSE_DCT, else (channels, nf,
// n_mels) mel energies. fb: (n_mels, m+1) dense filterbank whose row b is
// zero outside bins [band_lo[b], band_hi[b]); dct: (n_mfcc, n_mels), the
// liftered DCT-II rows.
template <int ALG, bool FUSE_DCT>
__global__ void __launch_bounds__(STFT_THREADS)
stft_mfcc_kernel(const float* __restrict__ x, const float* __restrict__ win,
                 const float2* __restrict__ tw,
                 const float2* __restrict__ wk, const float* __restrict__ fb,
                 const int* __restrict__ band_lo,
                 const int* __restrict__ band_hi,
                 const float* __restrict__ dct, float* __restrict__ out,
                 long long n, int nf, int nfft, int hop, int n_mels,
                 int n_mfcc, float log_eps) {
  extern __shared__ float2 z[];
  const int m = nfft / 2, log2m = __ffs(m) - 1;
  float* pw = reinterpret_cast<float*>(z + m);  // m + 1 powers
  float* mel = pw + m + 1;                      // n_mels log-mel values
  const int f = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = STFT_THREADS / 32;

  packed_frame_fft(x + (long long)c * n, n, (long long)f * hop, win, tw, z, m,
                   log2m);
  for (int k = threadIdx.x; k <= m; k += STFT_THREADS) {
    const float2 v = unpack_bin(z, wk, k, m);
    pw[k] = v.x * v.x + v.y * v.y;
  }
  __syncthreads();

  const long long row = (long long)c * nf + f;
  for (int b = warp; b < n_mels; b += WARPS) {
    const float* fr = fb + (long long)b * (m + 1);
    float acc = 0.f;
    for (int k = band_lo[b] + lane; k < band_hi[b]; k += 32)
      acc = tier_fma<ALG>(fr[k], pw[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (FUSE_DCT)
        mel[b] = logf(acc + log_eps);
      else
        out[row * n_mels + b] = acc;
    }
  }
  if (!FUSE_DCT) return;
  __syncthreads();
  for (int q = warp; q < n_mfcc; q += WARPS) {
    const float* dr = dct + (long long)q * n_mels;
    float acc = 0.f;
    for (int b = lane; b < n_mels; b += 32)
      acc = tier_fma<ALG>(dr[b], mel[b], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[row * n_mfcc + q] = acc;
  }
}

extern "C" int vv_stft_spectrum(const float* x, const float* win,
                                const void* tw, const void* wk, void* out,
                                int channels, long long n, int nf, int nfft,
                                int hop, int bins, int device,
                                void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t smem = (size_t)(nfft / 2) * sizeof(float2);
  const dim3 grid((unsigned)nf, (unsigned)channels);
  stft_spectrum_kernel<<<grid, STFT_THREADS, smem, (cudaStream_t)stream>>>(
      x, win, (const float2*)tw, (const float2*)wk, (float2*)out, n, nf, nfft,
      hop, bins);
  return (int)cudaGetLastError();
}

extern "C" int vv_stft_power(const float* x, const float* win, const void* tw,
                             const void* wk, float* out, int channels,
                             long long n, int nf, int nfft, int hop,
                             int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t smem = (size_t)(nfft / 2) * sizeof(float2);
  const dim3 grid((unsigned)nf, (unsigned)channels);
  stft_power_kernel<<<grid, STFT_THREADS, smem, (cudaStream_t)stream>>>(
      x, win, (const float2*)tw, (const float2*)wk, out, n, nf, nfft, hop);
  return (int)cudaGetLastError();
}

template <int ALG, bool FUSE_DCT>
static cudaError_t launch_mfcc(const float* x, const float* win,
                               const void* tw, const void* wk,
                               const float* fb, const int* band_lo,
                               const int* band_hi, const float* dct,
                               float* out, int channels, long long n, int nf,
                               int nfft, int hop, int n_mels, int n_mfcc,
                               float log_eps, cudaStream_t stream) {
  const int m = nfft / 2;
  const size_t smem = (size_t)m * sizeof(float2) +
                      (size_t)(m + 1 + n_mels) * sizeof(float);
  const dim3 grid((unsigned)nf, (unsigned)channels);
  stft_mfcc_kernel<ALG, FUSE_DCT><<<grid, STFT_THREADS, smem, stream>>>(
      x, win, (const float2*)tw, (const float2*)wk, fb, band_lo, band_hi, dct,
      out, n, nf, nfft, hop, n_mels, n_mfcc, log_eps);
  return cudaGetLastError();
}

extern "C" int vv_stft_mfcc(const float* x, const float* win, const void* tw,
                            const void* wk, const float* fb,
                            const int* band_lo, const int* band_hi,
                            const float* dct, float* out, int channels,
                            long long n, int nf, int nfft, int hop,
                            int n_mels, int n_mfcc, float log_eps,
                            int algorithm, int fuse_dct, int device,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
#define VV_MFCC(ALG, FUSE)                                                   \
  return (int)launch_mfcc<ALG, FUSE>(x, win, tw, wk, fb, band_lo, band_hi,   \
                                     dct, out, channels, n, nf, nfft, hop,   \
                                     n_mels, n_mfcc, log_eps, s)
  if (fuse_dct) {
    switch (algorithm) {
      case ALG_F32: VV_MFCC(ALG_F32, true);
      case ALG_BF16X3: VV_MFCC(ALG_BF16X3, true);
      case ALG_BF16: VV_MFCC(ALG_BF16, true);
    }
  } else {
    switch (algorithm) {
      case ALG_F32: VV_MFCC(ALG_F32, false);
      case ALG_BF16X3: VV_MFCC(ALG_BF16X3, false);
      case ALG_BF16: VV_MFCC(ALG_BF16, false);
    }
  }
#undef VV_MFCC
  return (int)cudaErrorInvalidValue;
}
