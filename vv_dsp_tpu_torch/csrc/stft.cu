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
// Frame f covers x[f*hop, f*hop + nfft), zero past the signal (the
// spectrum kernel can also read the signal as if zero-padded at both
// ends: frame f then covers x[f*hop - lead, f*hop - lead + nfft)). Its
// nfft-point real FFT is a packed-real transform: an m = nfft/2 point
// complex FFT of the even/odd packed, windowed frame, then the Hermitian
// unpack of bins 0..m (packed.cuh). All three kernels run the m-point
// transform register-resident (fft_reg.cuh), 2048/m frames a block on a
// persistent grid; the spectrum and power kernels share that walk
// (packed_spectrum_walk) and differ only in what they write.
//
// Bounds. The spectrum kernel writes 8 bytes per bin: 245 MB at the
// STFT row (16 x 1873 frames x 1024 bins), so it is bound by device-memory
// writes; a block writes its frames' rows, the Hermitian mirror bins
// nfft/2+1..nfft-1 included, as one contiguous run. Its radix-2 form took
// 4-7x that bound: nine barrier-separated passes of one butterfly a thread
// for a 512-point frame, a bit-reversed scatter with 32-way bank conflicts
// and twiddles read from device memory per butterfly.
// The power kernel reads 4 bytes a sample and writes 4 bytes a bin (92 MB
// at 16 x 480000, 1024/256: 0.028 ms at 3.35 TB/s), so it is bound by
// device memory too; it writes re^2 + im^2 of bins 0..m in natural order,
// the FB rows of a group as one coalesced run, so the TPU kernel's
// storage-order permutation epilogue has no counterpart. Its radix-2 form,
// one frame a block, took 12x that bound.
// The MFCC kernel reads the signal and writes 20 floats a frame; the
// frames, the spectrum and the power never leave registers and shared
// memory, which is what the TPU kernel exists for. Its ~1.3 GFLOP at the
// chain's shape bound it by operations (0.02 ms at the float32 peak), and
// latency keeps it from the bound: for each group of frames the
// transform, the powers, the mel sums and the DCT end at barriers. So the
// transform is register-resident over FB frames a block, the window, the
// twiddles, the compact filterbank (its nonzero weights, ~8 KB where the
// chain's dense one holds 328 KB) and the DCT rows are read from device
// memory once a block (the last two where they fit), and MEL_LANES threads
// sum a band for all the group's frames, each operand split for the tier
// once. The TPU
// kernel's DFT-64 matrix tail, its bit-reversed row-to-bin storage order
// and its VMEM tile picks do not come across: the butterflies run to the
// end and bins come out in natural order.
//
// Tiers: the MFCC kernel applies the dot-algorithm tier (common.cuh) to
// the mel projection and the DCT, the two contractions the TPU kernel runs
// at that tier on its matrix unit; the butterflies are float32 on both
// machines. (The TPU kernel also runs its DFT-64 tail at the tier; here
// that part of the transform is butterflies, in float32.)
#include "mel_dct.cuh"
#include "packed.cuh"

// The frame walk of the packed spectrum and power kernels: the
// register-resident M-point transform of fft_reg.cuh on the packed frame,
// FB = 2048/M frames of one channel a group on a persistent grid. Thread j
// loads its packed points straight into registers (packed_frame_regs); its
// 16 window values stay in registers for the whole walk, and the twiddles
// and wk are staged in shared memory once a block. For each group,
// store(z, wks, c, f0, nb) gets the group's spectra Z (FB rows of M points
// in shared memory, natural order), its channel and first frame and the
// number of its frames below nf; frames past nf run on zeros. With LEAD,
// frame f starts at signal sample f*hop - lead (packed_frame_regs): the
// rows are read as if zero-padded by lead samples in front.
template <int M, bool LEAD, class Store>
__device__ __forceinline__ void packed_spectrum_walk(
    const float* __restrict__ x, const float* __restrict__ win,
    const float2* __restrict__ tw, const float2* __restrict__ wk, long long n,
    int nf, int hop, int groups_per_row, long long groups, int lead,
    Store store) {
  constexpr int T = M / 8, FB = FR_POINTS / M;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* wks = tws + fr_table_size(M);
  float2* a = wks + M + 1;
  float2* b = a + FR_POINTS;
  fr_stage(tws, tw, fr_table_size(M));
  fr_stage(wks, wk, M + 1);
  const int fb = threadIdx.x / T, j = threadIdx.x % T;
  // with LEAD, the rows as packed_frame_regs reads them: lead zeros, then
  // the signal; f_in, the first frame wholly past the zeros
  const int f_in = LEAD ? (lead + hop - 1) / hop : 0;
  float2 w[8];
  packed_window_regs<M>(w, win, j);
  __syncthreads();
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c = (int)(g / groups_per_row);
    const int f0 = (int)(g - (long long)c * groups_per_row) * FB;
    float2 v[8];
    packed_frame_regs<M, LEAD>(v, x + (long long)c * n - (LEAD ? lead : 0),
                               n + (LEAD ? lead : 0), f0 + fb, nf, hop, j, w,
                               lead, f_in);
    fr_fft<M>(v, j, tws, a + fb * M, b + fb * M);
    store(fr_result<M>(a, b), wks, c, f0, min(FB, nf - f0));
    fr_swap_after<M>(a, b);
  }
}

// out: (channels, nf, BINS) interleaved complex; BINS = 2M (two-sided,
// X[2M-k] = conj X[k]) or M + 1 (one-sided). Bins 0..M are unpacked from
// the group's Z (unpack_bin) and the FB rows, contiguous in out, written as
// one coalesced run (the division by BINS is by a constant), the mirror
// bins as conjugates. With LEAD, the rows of n samples are read as if
// zero-padded by lead samples at both ends (nf counts the padded rows'
// frames), so an edge-padded input needs no padded copy; lead comes last,
// so the instances without it take their other parameters where they did.
template <int M, bool ONESIDED, bool LEAD>
__global__ void __launch_bounds__(FR_THREADS, 4)
stft_spectrum_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ wk, float2* __restrict__ out,
                     long long n, int nf, int hop, int groups_per_row,
                     long long groups, int lead) {
  constexpr int NFFT = 2 * M, BINS = ONESIDED ? M + 1 : NFFT;
  packed_spectrum_walk<M, LEAD>(
      x, win, tw, wk, n, nf, hop, groups_per_row, groups, lead,
      [=](const float2* z, const float2* wks, int c, int f0, int nb) {
        float2* o = out + ((long long)c * nf + f0) * BINS;
        for (int idx = threadIdx.x; idx < nb * BINS; idx += FR_THREADS) {
          const int q = idx / BINS, k = idx - q * BINS;
          float2 val = unpack_bin(z + q * M, wks, k <= M ? k : NFFT - k, M);
          if (k > M) val.y = -val.y;
          o[idx] = val;
        }
      });
}

// out: (channels, nf, M + 1) |X[k]|^2, natural bin order: the spectrum
// kernel's walk, with re^2 + im^2 of each unpacked bin written where the
// one-sided spectrum kernel writes the bin, the FB rows as one coalesced
// run.
template <int M>
__global__ void __launch_bounds__(FR_THREADS, 4)
stft_power_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float2* __restrict__ tw,
                  const float2* __restrict__ wk, float* __restrict__ out,
                  long long n, int nf, int hop, int groups_per_row,
                  long long groups) {
  constexpr int BINS = M + 1;
  packed_spectrum_walk<M, false>(
      x, win, tw, wk, n, nf, hop, groups_per_row, groups, 0,
      [=](const float2* z, const float2* wks, int c, int f0, int nb) {
        float* o = out + ((long long)c * nf + f0) * BINS;
        for (int idx = threadIdx.x; idx < nb * BINS; idx += FR_THREADS) {
          const int q = idx / BINS, k = idx - q * BINS;
          const float2 val = unpack_bin(z + q * M, wks, k, M);
          o[idx] = val.x * val.x + val.y * val.y;
        }
      });
}

// Launch a kernel on packed_spectrum_walk: a persistent grid over the
// groups of FB = 2048/M frames of each channel; the dynamic shared memory
// holds the twiddle table, wk and two exchange buffers. extra: the
// kernel's parameters after the group count.
template <int M, auto Kernel, class Out, class... Extra>
static cudaError_t launch_walk(const float* x, const float* win,
                               const void* tw, const void* wk, Out* out,
                               int channels, long long n, int nf, int hop,
                               int device, cudaStream_t stream,
                               Extra... extra) {
  constexpr int FB = FR_POINTS / M;
  const int per_row = (nf + FB - 1) / FB;
  return fr_launch<Kernel>(
      (fr_table_size(M) + M + 1 + 2 * FR_POINTS) * sizeof(float2),
      (long long)per_row * channels, device, stream, x, win,
      (const float2*)tw, (const float2*)wk, out, n, nf, hop, per_row,
      (long long)per_row * channels, extra...);
}

// out: (channels, nf, n_mfcc) MFCCs when FUSE_DCT, else (channels, nf,
// n_mels) mel energies. The filterbank in its compact form (the host's
// ops/fft_plan.py compact_filterbank_np): band b's weights fbw[off_b ..
// off_b+1) apply to bins lo_b ..., fbi = [off_0 .. off_n_mels, lo_0 ..
// lo_n_mels-1]; nnz = off_n_mels. dct: (n_mfcc, n_mels), the liftered
// DCT-II rows. fbi is staged in shared memory once a block; with `staged`
// (the host plan's choice, fft_plan.mfcc_plan) so are fbw and dct, split
// for the tier once, else they are read from device memory and split at
// each use.
//
// The frame walk is stft_spectrum_kernel's: FB = 2048/M frames a group,
// the twiddles and wk staged once a block, the window in registers, the
// packed frame loaded straight into registers, fr_fft<M>. Then, each
// stage ending at a barrier: the powers of bins 0..M of the FB frames,
// split for the tier once, into the exchange buffer the transform left
// free; mel_dct. Every thread reaches every barrier: frames past nf run on
// zeros and write no output.
template <int M, int ALG, bool FUSE_DCT>
__global__ void __launch_bounds__(FR_THREADS, 3)
stft_mfcc_kernel(const float* __restrict__ x, const float* __restrict__ win,
                 const float2* __restrict__ tw,
                 const float2* __restrict__ wk,
                 const float* __restrict__ fbw, const int* __restrict__ fbi,
                 const float* __restrict__ dct, float* __restrict__ out,
                 long long n, int nf, int hop, int n_mels, int n_mfcc,
                 int nnz, float log_eps, bool staged, int groups_per_row,
                 long long groups) {
  constexpr int T = M / 8, FB = FR_POINTS / M, BINS = M + 1;
  using Op = TierOperand<ALG>;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* wks = tws + fr_table_size(M);
  float2* a = wks + M + 1;
  float2* b = a + FR_POINTS;
  float* mel = reinterpret_cast<float*>(b + FR_POINTS);  // FB rows (FUSE_DCT)
  int* s_i = reinterpret_cast<int*>(mel + (FUSE_DCT ? FB * n_mels : 0));
  float* s_w = reinterpret_cast<float*>(s_i + 2 * n_mels + 1);  // staged
  float* s_d = s_w + nnz;                                         // staged
  fr_stage(tws, tw, fr_table_size(M));
  fr_stage(wks, wk, M + 1);
  for (int i = threadIdx.x; i < 2 * n_mels + 1; i += FR_THREADS)
    s_i[i] = fbi[i];
  if (staged) {
    for (int i = threadIdx.x; i < nnz; i += FR_THREADS)
      s_w[i] = Op::split(fbw[i]).pack();
    if (FUSE_DCT)
      for (int i = threadIdx.x; i < n_mfcc * n_mels; i += FR_THREADS)
        s_d[i] = Op::split(dct[i]).pack();
  }
  const int fb = threadIdx.x / T, j = threadIdx.x % T;
  float2 w[8];
  packed_window_regs<M>(w, win, j);
  __syncthreads();
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c = (int)(g / groups_per_row);
    const int f0 = (int)(g - (long long)c * groups_per_row) * FB;
    float2 v[8];
    packed_frame_regs<M>(v, x + (long long)c * n, n, f0 + fb, nf, hop, j, w);
    fr_fft<M>(v, j, tws, a + fb * M, b + fb * M);
    const float2* z = fr_result<M>(a, b);
    float* pw = reinterpret_cast<float*>(fr_result<M>(b, a));  // FB rows
    // bins k and M - k from one pair of reads
    for (int idx = threadIdx.x; idx < FB * (M / 2 + 1); idx += FR_THREADS) {
      const int q = idx / (M / 2 + 1), k = idx - q * (M / 2 + 1);
      const float2 zk = z[q * M + k], zr = z[q * M + ((M - k) & (M - 1))];
      const float2 u = unpack_pair(zk, zr, wks[k]);
      const float2 v = unpack_pair(zr, zk, wks[M - k]);
      pw[q * BINS + k] = Op::split(u.x * u.x + u.y * u.y).pack();
      pw[q * BINS + M - k] = Op::split(v.x * v.x + v.y * v.y).pack();
    }
    __syncthreads();
    const long long row0 = (long long)c * nf + f0;
    const int nb = min(FB, nf - f0);
    if (staged)
      mel_dct<M, ALG, FUSE_DCT>(
          [=](int i) { return Op::unpack(s_w[i]); },
          [=](int i) { return Op::unpack(s_d[i]); }, s_i, pw, mel, out,
          row0, nb, n_mels, n_mfcc, log_eps);
    else
      mel_dct<M, ALG, FUSE_DCT>(
          [=](int i) { return Op::split(__ldg(fbw + i)); },
          [=](int i) { return Op::split(__ldg(dct + i)); }, s_i, pw, mel,
          out, row0, nb, n_mels, n_mfcc, log_eps);
  }
}

// Dynamic shared memory of a stft_mfcc_kernel block (fft_plan.mfcc_smem)
template <int M>
static size_t mfcc_smem(int n_mels, int n_mfcc, int nnz, bool fuse_dct,
                        bool staged) {
  const size_t rows = fuse_dct ? (size_t)(FR_POINTS / M) * n_mels : 0;
  const size_t tables =
      2 * (size_t)n_mels + 1 +
      (staged ? nnz + (fuse_dct ? (size_t)n_mfcc * n_mels : 0) : 0);
  return (fr_table_size(M) + M + 1 + 2 * FR_POINTS) * sizeof(float2) +
         (rows + tables) * sizeof(float);
}

template <int M, int ALG, bool FUSE_DCT>
static cudaError_t launch_mfcc(const float* x, const float* win,
                               const void* tw, const void* wk,
                               const float* fbw, const int* fbi,
                               const float* dct, float* out, int channels,
                               long long n, int nf, int hop, int n_mels,
                               int n_mfcc, int nnz, float log_eps,
                               bool staged, size_t smem, int device,
                               cudaStream_t stream) {
  if (smem != mfcc_smem<M>(n_mels, n_mfcc, nnz, FUSE_DCT, staged))
    return cudaErrorInvalidValue;
  constexpr int FB = FR_POINTS / M;
  const int per_row = (nf + FB - 1) / FB;
  return fr_launch<stft_mfcc_kernel<M, ALG, FUSE_DCT>>(
      smem, (long long)per_row * channels, device, stream, x, win,
      (const float2*)tw, (const float2*)wk, fbw, fbi, dct, out, n, nf, hop,
      n_mels, n_mfcc, nnz, log_eps, staged, per_row,
      (long long)per_row * channels);
}

// lead: zero samples read in at both ends of each row of n samples (nf is
// the padded rows' frame count); the LEAD instances run only where it is
// positive.
extern "C" int vv_stft_spectrum(const float* x, const float* win,
                                const void* tw, const void* wk, void* out,
                                int channels, long long n, int nf, int nfft,
                                int hop, int bins, int lead, int device,
                                void* stream) {
  if ((bins != nfft && bins != nfft / 2 + 1) || lead < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool one = bins != nfft;
  float2* o = (float2*)out;
#define VV_SPECTRUM_AT(M, ONE, LEAD)                                   \
  launch_walk<M, stft_spectrum_kernel<M, ONE, LEAD>>(                  \
      x, win, tw, wk, o, channels, n, nf, hop, device, s, lead)
#define VV_SPECTRUM(M)                                                 \
  return (int)(one ? (lead ? VV_SPECTRUM_AT(M, true, true)            \
                           : VV_SPECTRUM_AT(M, true, false))          \
                   : (lead ? VV_SPECTRUM_AT(M, false, true)           \
                           : VV_SPECTRUM_AT(M, false, false)))
  switch (nfft) {
    case 256: VV_SPECTRUM(128);
    case 512: VV_SPECTRUM(256);
    case 1024: VV_SPECTRUM(512);
    case 2048: VV_SPECTRUM(1024);
    case 4096: VV_SPECTRUM(2048);
  }
#undef VV_SPECTRUM
#undef VV_SPECTRUM_AT
  return (int)cudaErrorInvalidValue;
}

extern "C" int vv_stft_power(const float* x, const float* win, const void* tw,
                             const void* wk, float* out, int channels,
                             long long n, int nf, int nfft, int hop,
                             int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define VV_POWER(M)                                                   \
  return (int)launch_walk<M, stft_power_kernel<M>>(x, win, tw, wk, out, \
                                                   channels, n, nf, hop, \
                                                   device, s)
  switch (nfft) {
    case 256: VV_POWER(128);
    case 512: VV_POWER(256);
    case 1024: VV_POWER(512);
    case 2048: VV_POWER(1024);
    case 4096: VV_POWER(2048);
  }
#undef VV_POWER
  return (int)cudaErrorInvalidValue;
}

// smem: the host plan's (fft_plan.mfcc_plan), which the launcher checks
// against its own reckoning of the layout.
extern "C" int vv_stft_mfcc(const float* x, const float* win, const void* tw,
                            const void* wk, const float* fbw, const int* fbi,
                            const float* dct, float* out, int channels,
                            long long n, int nf, int nfft, int hop,
                            int n_mels, int n_mfcc, int nnz, float log_eps,
                            int algorithm, int fuse_dct, int staged,
                            long long smem, int device, void* stream) {
  if (nf < 1 || hop < 1 || channels < 1 || n_mels < 1 || nnz < 0 ||
      (fuse_dct && n_mfcc < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
#define VV_MFCC(M, ALG, FUSE)                                                \
  return (int)launch_mfcc<M, ALG, FUSE>(x, win, tw, wk, fbw, fbi, dct, out,  \
                                        channels, n, nf, hop, n_mels, n_mfcc, \
                                        nnz, log_eps, staged != 0,           \
                                        (size_t)smem, device, s)
#define VV_MFCC_TIERS(M, FUSE)                                  \
  if (algorithm == ALG_F32) VV_MFCC(M, ALG_F32, FUSE);          \
  if (algorithm == ALG_BF16X3) VV_MFCC(M, ALG_BF16X3, FUSE);    \
  if (algorithm == ALG_BF16) VV_MFCC(M, ALG_BF16, FUSE)
#define VV_MFCC_SIZE(M)          \
  if (fuse_dct) {                \
    VV_MFCC_TIERS(M, true);      \
  } else {                       \
    VV_MFCC_TIERS(M, false);     \
  }                              \
  break
  switch (nfft) {
    case 256: VV_MFCC_SIZE(128);
    case 512: VV_MFCC_SIZE(256);
    case 1024: VV_MFCC_SIZE(512);
    case 2048: VV_MFCC_SIZE(1024);
    case 4096: VV_MFCC_SIZE(2048);
  }
#undef VV_MFCC_SIZE
#undef VV_MFCC_TIERS
#undef VV_MFCC
  return (int)cudaErrorInvalidValue;
}
