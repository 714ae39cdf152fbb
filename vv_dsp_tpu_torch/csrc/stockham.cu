// Full-nfft STFT kernels: the windowed complex spectrum, the one-sided power
// spectrogram, the fused STFT -> power -> mel (-> log -> DCT) front end,
// the fused SpectralGate (forward -> per-frame peak gate -> inverse ->
// overlap-add, one kernel) and the inverse STFT.
//
// They replace the unpacked ("Stockham") kernels of
// vv_dsp_tpu/ops/pallas_fft.py, which the JAX package dispatches where its
// packed-real kernels refuse the geometry: nfft = 128 at any hop, and
// hop = 8 (stft_mel_supported and not stft_mel_packed_supported):
//   stockham_spectrum_kernel replaces _spectrum_kernel (launcher
//     stft_spectrum_stockham) with its _stockham_natural epilogue;
//   stockham_power_kernel replaces _power_kernel (stft_power_stockham) with
//     the same epilogue;
//   stockham_mel_kernel replaces _stft_mel_kernel (launcher _stft_mel_call,
//     entries stft_mel_energies_pallas and stft_mfcc_pallas);
//   stockham_gate_kernel replaces _gate_kernel (stft_gate_pallas) with its
//     strip-merge epilogue and the w^2 norm division;
//   istft_stockham_kernel replaces _istft_kernel (istft_stockham) with its
//     strip-merge epilogue and the division by the exact w^2 norm, which the
//     JAX launcher applies after the kernel.
//
// Per frame f (x[f*hop, f*hop + nfft), zero past the signal): the
// nfft-point complex FFT of the windowed real frame, float32, with
// host-built float64 -> f32 twiddles. Bins come out in natural order, so
// the TPU kernels' bin permutation and the epilogue that undoes it have no
// counterpart, nor has their DFT-64 matrix tail: the butterflies run to
// the end. Every kernel runs the register-resident radix-8 transform of
// fft_reg.cuh (fr_fft), two real frames per N-point complex transform (z =
// x_f + i x_f+1, whose spectrum Z gives X_f[k] = (Z[k] + conj Z[N-k]) / 2
// and X_f+1[k] = (Z[k] - conj Z[N-k]) / 2i; the window carries the 1/2), on
// a persistent grid that stages the twiddle table once a block and walks
// groups of FB = 4096/N frames (32 at N = 128); the spectrum and power
// kernels share that walk (paired_spectrum_walk).
//
// Bounds, at the shapes the port's entry points give them on 16 channels
// of ~480k samples: the spectrum at 512/8 writes 3.93 GB (1.97 GB
// one-sided), ~1.2 ms at 3.35 TB/s, so its bound is device-memory writes;
// each block writes its FB frames' rows as one contiguous run. The power
// (128/32 on 16 x 479232: 30.7 MB read, 62.3 MB written, 93 MB), mel (30.7
// MB read, 12.5 MB written) and gate (31 MB each way) kernels move little
// and are bound by bytes too (0.028, 0.013 and 0.019 ms); their radix-2
// forms took 10-35x that, seven barrier-separated passes at N = 128
// (fourteen and two more in the gate) with twiddles read from device
// memory per butterfly, where fr_fft makes three passes with one exchange
// each.
//
// Mel/MFCC: the powers of bins 0..N/2 of a group's frames go into the
// exchange buffer the transform left free, both frames of a pair from one
// read of Z[k] and Z[N-k]; then mel_dct (mel_dct.cuh) on the compact
// filterbank, MEL_LANES threads a band for the whole group, log and the
// liftered DCT-II rows the same way, the filterbank, its index and the DCT
// rows staged in shared memory where the host plan (fft_plan.
// stockham_mel_plan) fits them. The TPU kernel runs its mel and DCT dots at
// _kernel_precision(), float32 under the default knob, and takes no
// dot-algorithm tier, so these are float32 products whatever tier the
// caller names.
//
// Gate: the peak and the mask are taken over all nfft bins of the
// two-sided spectrum, as the TPU kernel takes them, comparing
// re^2 + im^2 >= thresh2 * peak2 in float32 with no fused multiply-add
// (power2), as the plain version does. Thread j of a pair holds bins k =
// j + s N/8 of both frames in registers, unpacked from Z[k] and Z[N-k];
// these cover all N bins of each frame once, so a frame's peak is a
// per-thread max reduced by frame_max (packed.cuh). The unpacked X_f[N-k]
// is exactly conj X_f[k] (the real sums commute, the imaginary parts only
// change sign), so the mask is Hermitian, the gated spectrum is its own
// Hermitian part and its inverse is real: the pair's gated spectra, packed
// as conj(H_f + i H_f+1), run forward through fr_fft once more, which
// leaves N x_f in the real parts and -N x_f+1 in the imaginary parts in
// natural order, scaled by 1/N (exact: N is 2^k), windowed and
// overlap-added. Overlap-add across blocks is deterministic, with no
// atomics: as istft.cu does, a block walks (strip, channel) items, a strip
// owning `seg` consecutive hop-long output segments of channel c
// (owned_segments, which the gate rounds up so that an item's frames fill
// whole groups: gate_segments); it recomputes the q - 1 frames (q =
// nfft/hop) that reach into the first of them from the left, sums every
// frame that
// touches its segments into a shared-memory strip in ascending frame
// order (ola_strip) and writes each output sample once, divided by the
// guarded w^2 norm (the host's float64 table, cast once; the TPU kernel's
// caller divides by the interior-periodic norm, which equals it on every
// sample SpectralGate keeps). seg >= 4 (q - 1), so at 1024/8 (q = 128) a
// block recomputes at most 127 frames for 512 it owns.
//
// Inverse STFT: the overlap-add and norm of the gate, on frames read from
// a spectrum in natural bin order (the TPU kernel's storage permutation,
// _stockham_storage_from_natural, is TPU layout and has no counterpart).
// With all nfft bins given, the real part of each frame's complex inverse
// is kept, whether or not the spectrum is Hermitian; with the one-sided
// nfft/2 + 1 bins, bin k > nfft/2 is the conjugate of bin nfft - k, and
// the imaginary parts of the DC and Nyquist bins drop out of the real
// part, as in irfft. Bound: it reads 8 bytes a bin and writes 4 a sample
// (123 MB and 31 MB at 1024/256 one-sided on 16 x 1876 frames), so device
// memory bounds it, and the transform is what keeps it from the bound: so
// it inverts two real frames per register-resident transform (their
// Hermitian parts packed as one complex spectrum), reads the output in
// natural order and, in the overlap-add, visits only the frames covering
// a sample (at 128 points a block takes 32 frames, 4 of which cover one).
#include "mel_dct.cuh"
#include "packed.cuh"

// Thread j's window values win[j + s N/8] times 1/2, the unpack's factor
// (exact: the transform is linear and halving rounds nothing), for
// paired_frame_regs
template <int N>
__device__ __forceinline__ void paired_window_regs(
    float (&w)[8], const float* __restrict__ win, int j) {
#pragma unroll
  for (int s = 0; s < 8; ++s) w[s] = 0.5f * win[j + s * (N / 8)];
}

// Thread j's points of the pair's transform input z = w (x_f + i x_f+1) / 2
// at p = j + s N/8, frames f and f + 1 of row xc (n samples), w from
// paired_window_regs: zero past the signal and for frames >= nf, whose
// bounds are checked only for pairs that reach past either.
template <int N>
__device__ __forceinline__ void paired_frame_regs(
    float2 (&v)[8], const float* __restrict__ xc, long long n, long long f,
    long long nf, int hop, int j, const float (&w)[8]) {
  constexpr int T = N / 8;
  const long long i0 = f * hop;
  const float* xf = xc + i0 + j;
  if (f + 1 < nf && i0 + hop + N <= n) {  // both frames inside the signal
#pragma unroll
    for (int s = 0; s < 8; ++s)
      v[s] = make_float2(__ldg(xf + s * T) * w[s],
                         __ldg(xf + hop + s * T) * w[s]);
  } else {
    const long long left = n - i0 - j;  // samples from xf to the end
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int i = s * T;
      const float re = f < nf && i < left ? __ldg(xf + i) : 0.f;
      const float im =
          f + 1 < nf && i + hop < left ? __ldg(xf + i + hop) : 0.f;
      v[s] = make_float2(re * w[s], im * w[s]);
    }
  }
}

// The frame walk of the full-nfft spectrum and power kernels: each N-point
// complex FFT of fft_reg.cuh takes two real windowed frames at once, so a
// frame costs half a transform. Thread j loads samples j + s N/8 of both
// frames straight into registers (paired_frame_regs; its 8 window values
// stay in registers for the whole grid walk), and the twiddle table is
// staged in shared memory once a block. For each group of FB = 4096/N
// consecutive frames of one channel, store(z, c, f0, nb) gets the group's
// paired spectra (FB/2 rows of N points in shared memory, natural order),
// its channel and first frame and the number of its frames below nf;
// frames past nf run on zeros.
template <int N, class Store>
__device__ __forceinline__ void paired_spectrum_walk(
    const float* __restrict__ x, const float* __restrict__ win,
    const float2* __restrict__ tw, long long n, int nf, int hop,
    int groups_per_row, long long groups, Store store) {
  constexpr int T = N / 8, FB = 2 * FR_POINTS / N;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* a = sm + fr_table_size(N);
  float2* b = a + FR_POINTS;
  fr_stage(tws, tw, fr_table_size(N));
  const int pair = threadIdx.x / T, j = threadIdx.x % T;
  float w[8];
  paired_window_regs<N>(w, win, j);
  __syncthreads();
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c = (int)(g / groups_per_row);
    const int f0 = (int)(g - (long long)c * groups_per_row) * FB;
    float2 v[8];
    paired_frame_regs<N>(v, x + (long long)c * n, n, f0 + 2 * pair, nf, hop, j,
                         w);
    fr_fft<N>(v, j, tws, a + pair * N, b + pair * N);
    store(fr_result<N>(a, b), c, f0, min(FB, nf - f0));
    fr_swap_after<N>(a, b);
  }
}

// Bin k of frame f0 + q of a group whose paired spectra z holds, as the
// pair (u, t): X = (u, t) for even q, (t, -u) for odd q. From p = Z[k] and
// r = Z[(N - k) mod N] of the pair's transform, u = p.x +- r.x and t = p.y
// -+ r.y: exact products by +-1, one rounding each as a sum.
template <int N>
__device__ __forceinline__ float2 paired_bin(const float2* z, int q, int k) {
  const float2* zp = z + (q >> 1) * N;
  const float2 p = zp[k], r = zp[(N - k) & (N - 1)];
  const float sg = q & 1 ? -1.f : 1.f;
  return make_float2(fmaf(sg, r.x, p.x), fmaf(-sg, r.y, p.y));
}

// out: (channels, nf, BINS) interleaved complex, BINS = N (two-sided) or
// N/2 + 1 (one-sided): the group's FB rows, contiguous in out, written as
// one coalesced run (the division by BINS is by a constant).
template <int N, bool ONESIDED>
__global__ void __launch_bounds__(FR_THREADS, 4)
stockham_spectrum_kernel(const float* __restrict__ x,
                         const float* __restrict__ win,
                         const float2* __restrict__ tw,
                         float2* __restrict__ out, long long n, int nf,
                         int hop, int groups_per_row, long long groups) {
  constexpr int BINS = ONESIDED ? N / 2 + 1 : N;
  paired_spectrum_walk<N>(
      x, win, tw, n, nf, hop, groups_per_row, groups,
      [=](const float2* z, int c, int f0, int nb) {
        float2* o = out + ((long long)c * nf + f0) * BINS;
        for (int idx = threadIdx.x; idx < nb * BINS; idx += FR_THREADS) {
          const int q = idx / BINS, k = idx - q * BINS;
          const float2 ut = paired_bin<N>(z, q, k);
          o[idx] = q & 1 ? make_float2(ut.y, -ut.x) : ut;
        }
      });
}

// out: (channels, nf, N/2 + 1) |X[k]|^2, natural bin order: the spectrum
// kernel's walk, with u^2 + t^2 of each bin (paired_bin; frame f + 1's bin
// (t, -u) has the same power) written where the one-sided spectrum kernel
// writes the bin, the FB rows as one coalesced run.
template <int N>
__global__ void __launch_bounds__(FR_THREADS, 4)
stockham_power_kernel(const float* __restrict__ x,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw, float* __restrict__ out,
                      long long n, int nf, int hop, int groups_per_row,
                      long long groups) {
  constexpr int BINS = N / 2 + 1;
  paired_spectrum_walk<N>(
      x, win, tw, n, nf, hop, groups_per_row, groups,
      [=](const float2* z, int c, int f0, int nb) {
        float* o = out + ((long long)c * nf + f0) * BINS;
        for (int idx = threadIdx.x; idx < nb * BINS; idx += FR_THREADS) {
          const int q = idx / BINS, k = idx - q * BINS;
          const float2 ut = paired_bin<N>(z, q, k);
          o[idx] = ut.x * ut.x + ut.y * ut.y;
        }
      });
}

// Launch a kernel on paired_spectrum_walk: a persistent grid over the
// groups of FB = 4096/N frames of each channel; the dynamic shared memory
// holds the twiddle table and two exchange buffers.
template <int N, auto Kernel, class Out>
static cudaError_t launch_walk(const float* x, const float* win,
                               const void* tw, Out* out, int channels,
                               long long n, int nf, int hop, int device,
                               cudaStream_t stream) {
  constexpr int FB = 2 * FR_POINTS / N;
  const int per_row = (nf + FB - 1) / FB;
  return fr_launch<Kernel>(
      (fr_table_size(N) + 2 * FR_POINTS) * sizeof(float2),
      (long long)per_row * channels, device, stream, x, win,
      (const float2*)tw, out, n, nf, hop, per_row,
      (long long)per_row * channels);
}

// out: (channels, nf, n_mfcc) MFCCs when FUSE_DCT, else (channels, nf,
// n_mels) mel energies. The filterbank in its compact form
// (fft_plan.compact_filterbank_np: weights fbw, index fbi), dct: (n_mfcc,
// n_mels), the liftered DCT-II rows; fbi is staged in shared memory once a
// block, and with `staged` (fft_plan.stockham_mel_plan) fbw and dct too,
// else they are read from device memory.
//
// stockham_spectrum_kernel's walk over groups of FB = 4096/N frames of one
// channel (the paired load, fr_fft<N>), then, each stage ending at a
// barrier: the powers of bins 0..N/2 of the group's frames into the
// exchange buffer the transform left free, FB rows of N/2 + 1, both frames
// of a pair from one read of Z[k] and Z[N-k] (X_f[N-k] is conj X_f[k], so
// bin N - k has bin k's power); mel_dct<N/2> (FB = 2048/(N/2) frames of
// N/2 + 1 bins: the numbers of the packed kernel at M = N/2), float32.
// Every thread reaches every barrier: frames past nf run on zeros and
// write no output.
template <int N, bool FUSE_DCT>
__global__ void __launch_bounds__(FR_THREADS, 3)
stockham_mel_kernel(const float* __restrict__ x,
                    const float* __restrict__ win,
                    const float2* __restrict__ tw,
                    const float* __restrict__ fbw, const int* __restrict__ fbi,
                    const float* __restrict__ dct, float* __restrict__ out,
                    long long n, int nf, int hop, int n_mels, int n_mfcc,
                    int nnz, float log_eps, bool staged, int groups_per_row,
                    long long groups) {
  constexpr int T = N / 8, FB = 2 * FR_POINTS / N, BINS = N / 2 + 1;
  using Op = TierOperand<ALG_F32>;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* a = tws + fr_table_size(N);
  float2* b = a + FR_POINTS;
  float* mel = reinterpret_cast<float*>(b + FR_POINTS);  // FB rows (FUSE_DCT)
  int* s_i = reinterpret_cast<int*>(mel + (FUSE_DCT ? FB * n_mels : 0));
  float* s_w = reinterpret_cast<float*>(s_i + 2 * n_mels + 1);  // staged
  float* s_d = s_w + nnz;                                         // staged
  fr_stage(tws, tw, fr_table_size(N));
  for (int i = threadIdx.x; i < 2 * n_mels + 1; i += FR_THREADS)
    s_i[i] = fbi[i];
  if (staged) {
    for (int i = threadIdx.x; i < nnz; i += FR_THREADS) s_w[i] = fbw[i];
    if (FUSE_DCT)
      for (int i = threadIdx.x; i < n_mfcc * n_mels; i += FR_THREADS)
        s_d[i] = dct[i];
  }
  const int pair = threadIdx.x / T, j = threadIdx.x % T;
  float w[8];
  paired_window_regs<N>(w, win, j);
  __syncthreads();
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c = (int)(g / groups_per_row);
    const int f0 = (int)(g - (long long)c * groups_per_row) * FB;
    float2 v[8];
    paired_frame_regs<N>(v, x + (long long)c * n, n, f0 + 2 * pair, nf, hop,
                         j, w);
    fr_fft<N>(v, j, tws, a + pair * N, b + pair * N);
    const float2* z = fr_result<N>(a, b);
    float* pw = reinterpret_cast<float*>(fr_result<N>(b, a));  // FB rows
    for (int idx = threadIdx.x; idx < FB / 2 * BINS; idx += FR_THREADS) {
      const int p = idx / BINS, k = idx - p * BINS;
      const float2 zk = z[p * N + k], zr = z[p * N + ((N - k) & (N - 1))];
      // X_f[k] = zk + conj zr, X_f+1[k] = (zk - conj zr) / i
      const float er = zk.x + zr.x, ei = zk.y - zr.y;
      const float or_ = zk.y + zr.y, oi = zr.x - zk.x;
      pw[2 * p * BINS + k] = er * er + ei * ei;
      pw[(2 * p + 1) * BINS + k] = or_ * or_ + oi * oi;
    }
    __syncthreads();
    const long long row0 = (long long)c * nf + f0;
    const int nb = min(FB, nf - f0);
    if (staged)
      mel_dct<N / 2, ALG_F32, FUSE_DCT>(
          [=](int i) { return Op::unpack(s_w[i]); },
          [=](int i) { return Op::unpack(s_d[i]); }, s_i, pw, mel, out,
          row0, nb, n_mels, n_mfcc, log_eps);
    else
      mel_dct<N / 2, ALG_F32, FUSE_DCT>(
          [=](int i) { return Op::split(__ldg(fbw + i)); },
          [=](int i) { return Op::split(__ldg(dct + i)); }, s_i, pw, mel,
          out, row0, nb, n_mels, n_mfcc, log_eps);
  }
}

// Dynamic shared memory of a stockham_mel_kernel block
// (fft_plan.stockham_mel_smem): the twiddle table, two exchange buffers,
// the log-mel rows of its FB frames (fuse_dct), the filterbank's index and,
// staged, its nnz weights and the DCT rows.
template <int N>
static size_t stockham_mel_smem(int n_mels, int n_mfcc, int nnz,
                                bool fuse_dct, bool staged) {
  const size_t rows = fuse_dct ? (size_t)(2 * FR_POINTS / N) * n_mels : 0;
  const size_t tables =
      2 * (size_t)n_mels + 1 +
      (staged ? nnz + (fuse_dct ? (size_t)n_mfcc * n_mels : 0) : 0);
  return (fr_table_size(N) + 2 * FR_POINTS) * sizeof(float2) +
         (rows + tables) * sizeof(float);
}

template <int N, bool FUSE_DCT>
static cudaError_t launch_mel(const float* x, const float* win,
                              const void* tw, const float* fbw,
                              const int* fbi, const float* dct, float* out,
                              int channels, long long n, int nf, int hop,
                              int n_mels, int n_mfcc, int nnz, float log_eps,
                              bool staged, size_t smem, int device,
                              cudaStream_t stream) {
  if (smem != stockham_mel_smem<N>(n_mels, n_mfcc, nnz, FUSE_DCT, staged))
    return cudaErrorInvalidValue;
  constexpr int FB = 2 * FR_POINTS / N;
  const int per_row = (nf + FB - 1) / FB;
  return fr_launch<stockham_mel_kernel<N, FUSE_DCT>>(
      smem, (long long)per_row * channels, device, stream, x, win,
      (const float2*)tw, fbw, fbi, dct, out, n, nf, hop, n_mels, n_mfcc, nnz,
      log_eps, staged, per_row, (long long)per_row * channels);
}

// Thread j's part of the gate of the pair of frames whose paired spectrum
// Z (this pair's N points, natural order) the forward transform left in z:
// X_f[k] = Z[k] + conj Z[N-k], X_f+1[k] = (Z[k] - conj Z[N-k]) / i at its
// eight k = j + s N/8 (the window carried the 1/2), each frame's peak of
// power2 over its N bins (frame_max, which every thread of the block
// reaches), each bin kept iff power2(X) >= float32(thresh2 * peak), and v
// = conj(H_f + i H_f+1) of the gated bins, the inverse's input. The bins
// are unpacked twice, for the peak and for the mask, rather than held
// across the peak's reduction: 32 floats held there spill at 80 registers
// (the same arithmetic gives the same bits both times).
template <int N>
__device__ __forceinline__ void gate_pair(float2 (&v)[8], const float2* z,
                                          int j, float thresh2,
                                          float2* slots) {
  constexpr int T = N / 8;
  float2 pk = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int k = j + s * T;
    const float2 p = z[k], r = z[(N - k) & (N - 1)];
    pk = peak_max(pk, make_float2(power2(make_float2(p.x + r.x, p.y - r.y)),
                                  power2(make_float2(p.y + r.y, r.x - p.x))));
  }
  pk = frame_max<N>(pk, slots);
  const float l0 = __fmul_rn(thresh2, pk.x), l1 = __fmul_rn(thresh2, pk.y);
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int k = j + s * T;
    const float2 p = z[k], r = z[(N - k) & (N - 1)];
    const float2 x0 = make_float2(p.x + r.x, p.y - r.y);
    const float2 x1 = make_float2(p.y + r.y, r.x - p.x);
    const float2 h0 = power2(x0) >= l0 ? x0 : zero;
    const float2 h1 = power2(x1) >= l1 ? x1 : zero;
    v[s] = make_float2(h0.x - h1.y, -(h0.y + h1.x));
  }
}

// x, out: (channels, n); win: (N,) analysis and synthesis window; tw: the
// N-point transform's twiddle table (fft_plan.pass_twiddles); norm: (n,)
// guarded w^2 norm of the nf frames.
//
// A persistent block walks (strip, channel) items (StripItem of
// gate_segments), groups of FB = 4096/N frames from the item's first,
// which the item's frames fill: the paired load (frames past the item's
// last load zeros), fr_fft<N>, gate_pair, fr_fft<N> again in the buffer
// that does not hold Z (fr_swap_after), and ola_strip of the
// result's real (x_f) and negated imaginary (x_f+1) parts times 1/N. The
// twiddle table and the window are staged once a block; a thread reads its
// 8 window values from there for each group's loads, and the walk counts
// frames in int: held in registers for the walk, as the spectrum kernel
// holds them, the window values and 64-bit frame indices spill at 80
// registers.
// Blocks an SM the gate's launch bounds ask for: 3 (80 registers), but 2 at
// N = 1024, whose instance alone still spills at 80 (a ptxas sweep of the
// variants, PERF.md)
__host__ __device__ constexpr int gate_min_blocks(int n) {
  return n == 1024 ? 2 : 3;
}

template <int N>
__global__ void __launch_bounds__(FR_THREADS, gate_min_blocks(N))
stockham_gate_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     const float* __restrict__ norm, float* __restrict__ out,
                     long long n, int nf, int hop, int q, int seg,
                     int strips_per_row, long long strips, float thresh2) {
  constexpr int T = N / 8, FB = 2 * FR_POINTS / N;
  constexpr float SCALE = 1.f / N;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* a0 = tws + fr_table_size(N);
  float2* b0 = a0 + FR_POINTS;
  float2* slots = b0 + FR_POINTS;  // a pair of peaks a warp
  float* wins = reinterpret_cast<float*>(slots + FR_THREADS / 32);  // N
  float* strip = wins + N;                                 // seg * hop
  fr_stage(tws, tw, fr_table_size(N));
  for (int i = threadIdx.x; i < N; i += FR_THREADS) wins[i] = win[i];
  const int pair = threadIdx.x / T, j = threadIdx.x % T;
  const int strip_len = seg * hop;
  __syncthreads();
  for (long long g = blockIdx.x; g < strips; g += gridDim.x) {
    const StripItem<int> it(g, strips_per_row, seg, q, nf);
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS) strip[t] = 0.f;
    const float* xc = x + (long long)it.c * n;
    for (int f0 = it.f_lo; f0 <= it.f_hi; f0 += FB) {
      float2 v[8];
      float w[8];
      paired_window_regs<N>(w, wins, j);
      paired_frame_regs<N>(v, xc, n, f0 + 2 * pair, it.f_hi + 1, hop, j, w);
      float2* a = a0;
      float2* b = b0;
      fr_fft<N>(v, j, tws, a + pair * N, b + pair * N);
      gate_pair<N>(v, fr_result<N>(a, b) + pair * N, j, thresh2, slots);
      // the inverse's first pass writes the buffer that does not hold Z
      fr_swap_after<N>(a, b);
      fr_fft<N>(v, j, tws, a + pair * N, b + pair * N);
      const float2* y = fr_result<N>(a, b);
      ola_strip(
          [=](int fb, int i) {
            const float2 u = y[(fb >> 1) * N + i];
            return (fb & 1 ? -u.y : u.x) * SCALE;
          },
          strip, min(FB, it.f_hi - f0 + 1), (f0 - it.s0) * hop, strip_len, N,
          hop, wins);
    }
    float* oc = out + (long long)it.c * n;
    const long long g0 = (long long)it.s0 * hop;
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS) {
      const long long o = g0 + t;
      if (o < n) oc[o] = strip[t] / norm[o];
    }
  }
}

// Owned segments of a gate strip (fft_plan.gate_segments): owned_segments
// rounded up so that the seg + q - 1 frames of an item fill whole groups
// of FB (at 128/32 157 segments, 160 frames in 5 groups, where 128 would
// leave 29 of the 160 frames idle)
template <int N>
static int gate_segments(int hop) {
  constexpr int FB = 2 * FR_POINTS / N;
  const int q1 = N / hop - 1;
  return (owned_segments(N, hop) + q1 + FB - 1) / FB * FB - q1;
}

// Dynamic shared memory of a stockham_gate_kernel block
// (fft_plan.stockham_gate_smem): the twiddle table, two exchange buffers,
// a pair of peak slots a warp, the window and the strip.
template <int N>
static size_t stockham_gate_smem(int hop) {
  return (fr_table_size(N) + 2 * FR_POINTS + FR_THREADS / 32) *
             sizeof(float2) +
         ((size_t)N + (size_t)gate_segments<N>(hop) * hop) * sizeof(float);
}

template <int N>
static cudaError_t launch_gate(const float* x, const float* win,
                               const void* tw, const float* norm, float* out,
                               int channels, long long n, int nf, int hop,
                               float thresh2, size_t smem, int device,
                               cudaStream_t stream) {
  if (smem != stockham_gate_smem<N>(hop)) return cudaErrorInvalidValue;
  const int seg = gate_segments<N>(hop);
  const long long segs = (n + hop - 1) / hop;
  const long long per_row = (segs + seg - 1) / seg;
  return fr_launch<stockham_gate_kernel<N>>(
      smem, per_row * channels, device, stream, x, win, (const float2*)tw,
      norm, out, n, nf, hop, N / hop, seg, (int)per_row, per_row * channels,
      thresh2);
}

// spec: (channels, nf, BINS) interleaved complex, BINS = N (all bins) or
// N/2 + 1 (RFFT: the conjugate mirror above N/2); norm: (output_len,)
// guarded w^2 norm of the nf frames; out: (channels, output_len).
//
// Two real frames per N-point transform of fft_reg.cuh, run forward on
// conjugated input. Per frame, the Hermitian part H[k] = (X[k] + conj
// X[(N-k) mod N]) / 2, whose inverse is the real part of X's (all bins), or
// with RFFT the one-sided input mirrored, the imaginary parts of the DC
// and Nyquist bins dropped (irfft's real frame). For frames f, f+1 of a
// pair, Z = H_f + i H_f+1 has the inverse x_f + i x_f+1, and
// N ifft(Z) = conj(fft(conj Z)): thread j loads points k = j + s N/8 of
// conj Z straight into registers (bins k and N - k of both frames, zero
// for a frame past the block's last), and the transform leaves N x_f in
// the real parts, -N x_f+1 in the imaginary parts, in natural order. The
// halving of H (all bins) is folded into the scale: exact, as 1/N is.
//
// Overlap-add with stockham_gate_kernel's ownership, on a persistent grid:
// a block walks over (strip, channel) items, a strip being `seg` hop-long
// output segments (owned_segments); for each it recomputes the q - 1
// frames reaching in from the left, sums the frames touching the strip
// into shared memory, FB = 2 * 2048/N at a time, in ascending frame order
// (ola_strip), and writes each output sample once, divided by the norm.
// The twiddle table and the window are staged once a block.
template <int N, bool RFFT>
__global__ void __launch_bounds__(FR_THREADS, 3)
istft_stockham_kernel(const float2* __restrict__ spec,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw,
                      const float* __restrict__ norm, float* __restrict__ out,
                      int nf, int hop, int q, long long output_len, int seg,
                      int strips_per_row, long long strips) {
  constexpr int T = N / 8, FB = 2 * FR_POINTS / N;
  constexpr int BINS = RFFT ? N / 2 + 1 : N;
  constexpr float SCALE = (RFFT ? 1.f : 0.5f) / N;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* a = tws + fr_table_size(N);
  float2* b = a + FR_POINTS;
  float* wins = reinterpret_cast<float*>(b + FR_POINTS);  // N
  float* strip = wins + N;                                 // seg * hop
  fr_stage(tws, tw, fr_table_size(N));
  for (int i = threadIdx.x; i < N; i += FR_THREADS) wins[i] = win[i];
  const int pair = threadIdx.x / T, j = threadIdx.x % T;
  const int strip_len = seg * hop;
  __syncthreads();
  for (long long g = blockIdx.x; g < strips; g += gridDim.x) {
    const int c = (int)(g / strips_per_row);
    const long long s0 = (g - (long long)c * strips_per_row) * seg;
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS) strip[t] = 0.f;
    const float2* xc = spec + (long long)c * nf * BINS;
    const long long f_lo = max(s0 - (q - 1), 0LL);
    const long long f_hi = min(s0 + seg - 1, (long long)nf - 1);
    for (long long f0 = f_lo; f0 <= f_hi; f0 += FB) {
      const long long f = f0 + 2 * pair;
      const float2* xf = xc + f * BINS;
      const bool has0 = f <= f_hi, has1 = f + 1 <= f_hi;
      float2 v[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int k = j + s * T, kr = (N - k) & (N - 1);
        float2 h0 = make_float2(0.f, 0.f), h1 = h0;
        if (RFFT) {
          // H[k] = X[k] up to N/2, conj X[N - k] above; real at 0 and N/2
          const int kk = k <= N / 2 ? k : kr;
          const float sg = k <= N / 2 ? 1.f : -1.f;
          if (has0) h0 = xf[kk];
          if (has1) h1 = xf[BINS + kk];
          h0.y = (k == 0 || k == N / 2) ? 0.f : sg * h0.y;
          h1.y = (k == 0 || k == N / 2) ? 0.f : sg * h1.y;
        } else {
          // 2 H[k] = X[k] + conj X[N - k]
          if (has0) {
            const float2 p = xf[k], r = xf[kr];
            h0 = make_float2(p.x + r.x, p.y - r.y);
          }
          if (has1) {
            const float2 p = xf[BINS + k], r = xf[BINS + kr];
            h1 = make_float2(p.x + r.x, p.y - r.y);
          }
        }
        // conj(H_f + i H_f+1)
        v[s] = make_float2(h0.x - h1.y, -(h0.y + h1.x));
      }
      fr_fft<N>(v, j, tws, a + pair * N, b + pair * N);
      const float2* z = fr_result<N>(a, b);
      const int nb = (int)min((long long)FB, f_hi - f0 + 1);
      ola_strip(
          [=](int fb, int i) {
            const float2 u = z[(fb >> 1) * N + i];
            return (fb & 1 ? -u.y : u.x) * SCALE;
          },
          strip, nb, (f0 - s0) * hop, strip_len, N, hop, wins);
    }
    float* oc = out + (long long)c * output_len;
    const long long g0 = s0 * hop;
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS) {
      const long long o = g0 + t;
      if (o < output_len) oc[o] = strip[t] / norm[o];
    }
  }
}

// Dynamic shared memory of an istft_stockham_kernel block
// (fft_plan.istft_smem): the twiddle table, two exchange buffers, the
// window and the strip.
template <int N>
static size_t istft_smem(int hop) {
  return (fr_table_size(N) + 2 * FR_POINTS) * sizeof(float2) +
         ((size_t)N + (size_t)owned_segments(N, hop) * hop) * sizeof(float);
}

template <int N, bool RFFT>
static cudaError_t launch_istft(const void* spec, const float* win,
                                const void* tw, const float* norm,
                                float* out, int channels, int nf, int hop,
                                long long output_len, size_t smem,
                                int device, cudaStream_t stream) {
  if (smem != istft_smem<N>(hop)) return cudaErrorInvalidValue;
  const int seg = owned_segments(N, hop);
  const long long segs = (output_len + hop - 1) / hop;
  const long long per_row = (segs + seg - 1) / seg;
  return fr_launch<istft_stockham_kernel<N, RFFT>>(
      smem, per_row * channels, device, stream, (const float2*)spec, win,
      (const float2*)tw, norm, out, nf, hop, N / hop, output_len, seg,
      (int)per_row, per_row * channels);
}

// The geometries the launchers take: N = nfft a power of two in [128,
// FR_POINTS] (fr_fft's range; a frame batch and its strip stay within a
// block's shared memory), hop a divisor of nfft; the Python wrappers narrow
// this to the JAX package's lattice.
static bool bad_geometry(int nfft, int hop, int nf, int channels) {
  return nfft < 128 || nfft > FR_POINTS || (nfft & (nfft - 1)) || hop < 1 ||
         nfft % hop || nf < 1 || channels < 1 || channels > 65535;
}

extern "C" int vv_stockham_spectrum(const float* x, const float* win,
                                    const void* tw, void* out, int channels,
                                    long long n, int nf, int nfft, int hop,
                                    int bins, int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) ||
      (bins != nfft && bins != nfft / 2 + 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool one = bins != nfft;
  float2* o = (float2*)out;
#define VV_SPECTRUM(N)                                                    \
  return (int)(one ? launch_walk<N, stockham_spectrum_kernel<N, true>>(  \
                         x, win, tw, o, channels, n, nf, hop, device, s) \
                   : launch_walk<N, stockham_spectrum_kernel<N, false>>( \
                         x, win, tw, o, channels, n, nf, hop, device, s))
  switch (nfft) {
    case 128: VV_SPECTRUM(128);
    case 256: VV_SPECTRUM(256);
    case 512: VV_SPECTRUM(512);
    case 1024: VV_SPECTRUM(1024);
    case 2048: VV_SPECTRUM(2048);
  }
#undef VV_SPECTRUM
  return (int)cudaErrorInvalidValue;
}

extern "C" int vv_stockham_power(const float* x, const float* win,
                                 const void* tw, float* out, int channels,
                                 long long n, int nf, int nfft, int hop,
                                 int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels)) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define VV_POWER(N)                                                      \
  return (int)launch_walk<N, stockham_power_kernel<N>>(x, win, tw, out,   \
                                                       channels, n, nf,   \
                                                       hop, device, s)
  switch (nfft) {
    case 128: VV_POWER(128);
    case 256: VV_POWER(256);
    case 512: VV_POWER(512);
    case 1024: VV_POWER(1024);
    case 2048: VV_POWER(2048);
  }
#undef VV_POWER
  return (int)cudaErrorInvalidValue;
}

// The mel kernel's filterbank in its compact form (fbw, fbi, nnz weights) and smem,
// the host plan's (fft_plan.stockham_mel_plan), which the launcher checks
// against its own reckoning of the layout.
extern "C" int vv_stockham_mel(const float* x, const float* win,
                               const void* tw, const float* fbw,
                               const int* fbi, const float* dct, float* out,
                               int channels, long long n, int nf, int nfft,
                               int hop, int n_mels, int n_mfcc, int nnz,
                               float log_eps, int fuse_dct, int staged,
                               long long smem, int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) || n_mels < 1 ||
      nnz < 0 || (fuse_dct && n_mfcc < 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define VV_MEL(N, FUSE)                                                      \
  return (int)launch_mel<N, FUSE>(x, win, tw, fbw, fbi, dct, out, channels,  \
                                  n, nf, hop, n_mels, n_mfcc, nnz, log_eps,  \
                                  staged != 0, (size_t)smem, device, s)
#define VV_MEL_SIZE(N)    \
  if (fuse_dct) {         \
    VV_MEL(N, true);      \
  } else {                \
    VV_MEL(N, false);     \
  }
  switch (nfft) {
    case 128: VV_MEL_SIZE(128);
    case 256: VV_MEL_SIZE(256);
    case 512: VV_MEL_SIZE(512);
    case 1024: VV_MEL_SIZE(1024);
    case 2048: VV_MEL_SIZE(2048);
  }
#undef VV_MEL_SIZE
#undef VV_MEL
  return (int)cudaErrorInvalidValue;
}

// smem: the host plan's (fft_plan.stockham_gate_smem), which the launcher
// checks against its own reckoning of the layout.
extern "C" int vv_stockham_gate(const float* x, const float* win,
                                const void* tw, const float* norm, float* out,
                                int channels, long long n, int nf, int nfft,
                                int hop, float thresh2, long long smem,
                                int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) || hop >= nfft || n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define VV_GATE(N)                                                          \
  return (int)launch_gate<N>(x, win, tw, norm, out, channels, n, nf, hop, \
                             thresh2, (size_t)smem, device, s)
  switch (nfft) {
    case 128: VV_GATE(128);
    case 256: VV_GATE(256);
    case 512: VV_GATE(512);
    case 1024: VV_GATE(1024);
    case 2048: VV_GATE(2048);
  }
#undef VV_GATE
  return (int)cudaErrorInvalidValue;
}

// smem: the host plan's (fft_plan.istft_smem), which the launcher checks
// against its own reckoning of the layout.
extern "C" int vv_istft_stockham(const void* spec, const float* win,
                                 const void* tw, const float* norm, float* out,
                                 int channels, int nf, int nfft, int hop,
                                 int bins, long long output_len,
                                 long long smem, int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) || output_len < 1 ||
      (bins != nfft && bins != nfft / 2 + 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool one = bins != nfft;
#define VV_ISTFT(N)                                                         \
  return (int)(one ? launch_istft<N, true>(spec, win, tw, norm, out,       \
                                           channels, nf, hop, output_len,  \
                                           (size_t)smem, device, s)        \
                   : launch_istft<N, false>(spec, win, tw, norm, out,      \
                                            channels, nf, hop, output_len, \
                                            (size_t)smem, device, s))
  switch (nfft) {
    case 128: VV_ISTFT(128);
    case 256: VV_ISTFT(256);
    case 512: VV_ISTFT(512);
    case 1024: VV_ISTFT(1024);
    case 2048: VV_ISTFT(2048);
  }
#undef VV_ISTFT
  return (int)cudaErrorInvalidValue;
}
