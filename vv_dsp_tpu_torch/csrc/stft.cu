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
// Frame f covers x[f*hop, f*hop + nfft), zero past the signal. Its
// nfft-point real FFT is a packed-real transform: an m = nfft/2 point
// complex FFT of the even/odd packed, windowed frame, then the Hermitian
// unpack of bins 0..m (packed.cuh). The spectrum kernel runs the m-point
// transform register-resident (fft_reg.cuh), 2048/m frames a block on a
// persistent grid; the power and MFCC kernels run packed.cuh's radix-2
// transform in shared memory, one (channel, frame) a block.
//
// Bounds. The spectrum kernel writes 8 bytes per bin: 245 MB at the
// STFT row (16 x 1873 frames x 1024 bins), so it is bound by device-memory
// writes; a block writes its frames' rows, the Hermitian mirror bins
// nfft/2+1..nfft-1 included, as one contiguous run. Its radix-2 form took
// 4-7x that bound: nine barrier-separated passes of one butterfly a thread
// for a 512-point frame, a bit-reversed scatter with 32-way bank conflicts
// and twiddles read from device memory per butterfly.
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
#include <cstdint>

#include "fft_reg.cuh"
#include "packed.cuh"

constexpr int STFT_THREADS = 256;

// Frame f of row xc (n samples): its packed spectrum Z[k], natural order
__device__ __forceinline__ void packed_frame_fft(
    const float* __restrict__ xc, long long n, int f, int hop,
    const float* __restrict__ win, const float2* __restrict__ tw, float2* z,
    int m, int log2m) {
  packed_load(xc, n, f, 1, hop, win, z, m, log2m);
  packed_fft(z, 1, m, log2m, tw);
}

// out: (channels, nf, BINS) interleaved complex; BINS = 2M (two-sided,
// X[2M-k] = conj X[k]) or M + 1 (one-sided). The register-resident M-point
// transform of fft_reg.cuh on the packed frame: thread j loads packed
// points z[p] = (w[2p] x[2p], w[2p+1] x[2p+1]) of its frame, p = j + s M/8,
// straight into registers (one 8-byte load a point where the frame lies
// inside the signal at an even float offset, else two bounds-checked
// scalar loads, so any hop works); its 16 window values stay in registers
// for the whole grid walk. The spectrum Z of FB = 2048/M frames ends in
// shared memory in natural order; bins 0..M are unpacked from it
// (unpack_bin, with wk staged in shared memory) and the FB rows, contiguous
// in out, written as one coalesced run (the division by BINS is by a
// constant), the mirror bins as conjugates.
template <int M, bool ONESIDED>
__global__ void __launch_bounds__(FR_THREADS, 4)
stft_spectrum_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ wk, float2* __restrict__ out,
                     long long n, int nf, int hop, int groups_per_row,
                     long long groups) {
  constexpr int T = M / 8, FB = FR_POINTS / M, NFFT = 2 * M;
  constexpr int BINS = ONESIDED ? M + 1 : NFFT;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* wks = tws + fr_table_size(M);
  float2* a = wks + M + 1;
  float2* b = a + FR_POINTS;
  fr_stage(tws, tw, fr_table_size(M));
  fr_stage(wks, wk, M + 1);
  const int fb = threadIdx.x / T, j = threadIdx.x % T;
  float2 w[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    w[s] = reinterpret_cast<const float2*>(win)[j + s * T];
  __syncthreads();
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c = (int)(g / groups_per_row);
    const int f0 = (int)(g - (long long)c * groups_per_row) * FB;
    const int f = f0 + fb;
    // samples of frame f left in the signal (none past the last frame)
    const long long left = f < nf ? n - (long long)f * hop : 0;
    const float* xf = x + (long long)c * n + (f < nf ? (long long)f * hop : 0);
    float2 v[8];
    if (left >= NFFT && (reinterpret_cast<uintptr_t>(xf) & 7) == 0) {
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
    fr_fft<M>(v, j, tws, a + fb * M, b + fb * M);
    const float2* z = fr_result<M>(a, b);
    const int nb = min(FB, nf - f0);
    float2* o = out + ((long long)c * nf + f0) * BINS;
    for (int idx = threadIdx.x; idx < nb * BINS; idx += FR_THREADS) {
      const int q = idx / BINS, k = idx - q * BINS;
      float2 val = unpack_bin(z + q * M, wks, k <= M ? k : NFFT - k, M);
      if (k > M) val.y = -val.y;
      o[idx] = val;
    }
    fr_swap_after<M>(a, b);
  }
}

template <int M, bool ONESIDED>
static cudaError_t launch_spectrum(const float* x, const float* win,
                                   const void* tw, const void* wk, void* out,
                                   int channels, long long n, int nf, int hop,
                                   int device, cudaStream_t stream) {
  constexpr int FB = FR_POINTS / M;
  const int per_row = (nf + FB - 1) / FB;
  const size_t smem =
      (fr_table_size(M) + M + 1 + 2 * FR_POINTS) * sizeof(float2);
  return fr_launch<stft_spectrum_kernel<M, ONESIDED>>(
      smem, (long long)per_row * channels, device, stream, x, win,
      (const float2*)tw, (const float2*)wk, (float2*)out, n, nf, hop, per_row,
      (long long)per_row * channels);
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
  packed_frame_fft(x + (long long)c * n, n, f, hop, win, tw, z, m, log2m);
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

  packed_frame_fft(x + (long long)c * n, n, f, hop, win, tw, z, m, log2m);
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
  if (bins != nfft && bins != nfft / 2 + 1) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool one = bins != nfft;
#define VV_SPECTRUM(M)                                                      \
  return (int)(one ? launch_spectrum<M, true>(x, win, tw, wk, out,         \
                                              channels, n, nf, hop, device, \
                                              s)                           \
                   : launch_spectrum<M, false>(x, win, tw, wk, out,        \
                                               channels, n, nf, hop,       \
                                               device, s))
  switch (nfft) {
    case 256: VV_SPECTRUM(128);
    case 512: VV_SPECTRUM(256);
    case 1024: VV_SPECTRUM(512);
    case 2048: VV_SPECTRUM(1024);
    case 4096: VV_SPECTRUM(2048);
  }
#undef VV_SPECTRUM
  return (int)cudaErrorInvalidValue;
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
