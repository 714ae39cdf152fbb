// Full-nfft STFT kernels: the windowed complex spectrum, the one-sided power
// spectrogram, the fused STFT -> power -> mel (-> log -> DCT) front end and
// the fused SpectralGate (forward -> per-frame peak gate -> inverse ->
// overlap-add, one kernel).
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
// the end. The spectrum kernel and the inverse run the register-resident
// radix-8 transform of fft_reg.cuh (their own sections below), two real
// frames per complex transform. The other three run a
// radix-2 DIT in shared memory on bit-reversed input, twiddles
// tw[k] = exp(-2 pi i k / nfft), k < nfft/2: a block takes FB =
// max(1, 2048/nfft) consecutive frames of one channel, so every
// barrier-separated stage has 1024 butterflies for its 256 threads
// whatever nfft is (16 frames a block at nfft = 128, where one frame a
// block would leave 3/4 of the threads idle). Points sit in shared memory
// with one pad slot per 32 (slot()), so the bit-reversed scatter is free
// of bank conflicts.
//
// Bounds, at the shapes the port's entry points give them on 16 channels
// of ~480k samples: the spectrum at 512/8 writes 3.93 GB (1.97 GB
// one-sided), ~1.2 ms at 3.35 TB/s, so its bound is device-memory writes;
// each block writes its FB frames' rows as one contiguous run. Its radix-2
// form took 5.5-11x that bound (nine round trips of every point through
// shared memory, each behind a barrier); the register-resident transform
// makes two exchanges at 512 points. The power (128/32: 30.7 MB read,
// 62.3 MB written), mel (12.5 MB written) and gate (31 MB each way)
// kernels move little: what holds them back is the radix-2 transform, the
// next to move onto fft_reg.cuh.
//
// Mel/MFCC: the power row stays in shared memory; each mel band is summed
// over its nonzero bin range only (the host's band edges, as
// stft_mfcc_kernel in stft.cu does), one thread per (frame, band), then log
// and the liftered DCT-II rows, one thread per (frame, coefficient): at
// nfft = 128 a band holds 1-9 bins, too few to share among a warp.
// The TPU kernel runs its mel and DCT dots at _kernel_precision(), float32
// under the default knob, and takes no dot-algorithm tier, so these are
// plain float32 products whatever tier the caller names.
//
// Gate: the peak and the mask are taken over all nfft bins of the
// two-sided spectrum, as the TPU kernel takes them, comparing
// re^2 + im^2 >= thresh2 * peak2 in float32 with no fused multiply-add
// (power2), as the plain version does. The inverse is an unscaled radix-2
// DIF with conjugate twiddles (natural order in, bit-reversed out), scaled
// by 1/nfft (exact: nfft is 2^k); the real part is windowed and
// overlap-added. Overlap-add across blocks is deterministic, with no
// atomics: as istft.cu does, block (s, c) owns `seg` consecutive hop-long
// output segments of channel c, recomputes the q - 1 frames (q = nfft/hop)
// that reach into the first of them from the left, sums every frame that
// touches its segments into a shared-memory strip in ascending frame
// order and writes each output sample once, divided by the guarded w^2
// norm (the host's float64 table, cast once; the TPU kernel's caller
// divides by the interior-periodic norm, which equals it on every sample
// SpectralGate keeps). seg >= 4 (q - 1), so at 1024/8 (q = 128) a block
// recomputes at most 127 frames for 512 it owns.
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
#include "common.cuh"
#include "fft_reg.cuh"

constexpr int SH_THREADS = 256;
constexpr int SH_WARPS = SH_THREADS / 32;
constexpr int SH_POINTS = 2048;  // complex points a block transforms at once

__host__ __device__ inline int frames_per_block(int nfft) {
  return nfft >= SH_POINTS ? 1 : SH_POINTS / nfft;
}

__device__ __forceinline__ int brev(int j, int log2n) {
  return (int)(__brev((unsigned)j) >> (32 - log2n));
}

// Shared-memory slot of point p of a batch: one float2 of padding after
// every 32 points. Bit-reversal sends a warp's 32 consecutive points 2^k
// apart, all to one bank without it; with it they spread over all 32
// banks, and the butterflies' runs of consecutive points stay contiguous.
__device__ __forceinline__ int slot(int p) { return p + (p >> 5); }

__host__ __device__ inline size_t batch_floats2(int nfft) {
  const size_t points = (size_t)frames_per_block(nfft) * nfft;
  return points + points / 32;
}

// Frames f0 .. f0 + nb - 1 of row xc (n samples), windowed, into z (nb
// frames of nfft points, each in bit-reversed order, at slot()).
__device__ void load_frames(const float* __restrict__ xc, long long n,
                            long long f0, int nb, int hop,
                            const float* __restrict__ win, float2* z,
                            int nfft, int log2n) {
  for (int idx = threadIdx.x; idx < nb * nfft; idx += SH_THREADS) {
    const int b = idx >> log2n, j = idx & (nfft - 1);
    const long long i = (f0 + b) * hop + j;
    const float v = i < n ? xc[i] : 0.f;
    z[slot((b << log2n) + brev(j, log2n))] = make_float2(v * win[j], 0.f);
  }
  __syncthreads();
}

// Forward transform of nb frames in place: radix-2 DIT, bit-reversed
// input, natural-order output.
__device__ void fft_dit(float2* z, int nb, int nfft, int log2n,
                        const float2* __restrict__ tw) {
  const int half_n = nfft >> 1;
  for (int s = 0; s < log2n; ++s) {
    const int half = 1 << s, stride = half_n >> s;
    for (int bi = threadIdx.x; bi < nb * half_n; bi += SH_THREADS) {
      const int b = bi & (half_n - 1);
      const int pos = b & (half - 1);
      const int i0 = ((bi >> (log2n - 1)) << log2n) + ((b >> s) << (s + 1)) +
                     pos;
      const int s0 = slot(i0), s1 = slot(i0 + half);
      const float2 w = tw[pos * stride];
      const float2 u = z[s0], v = z[s1];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      z[s0] = make_float2(u.x + tr, u.y + ti);
      z[s1] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// Unscaled inverse transform of nb frames in place: radix-2 DIF with
// conjugate twiddles, natural-order input, bit-reversed output.
__device__ void ifft_dif(float2* z, int nb, int nfft, int log2n,
                         const float2* __restrict__ tw) {
  const int half_n = nfft >> 1;
  for (int s = log2n - 1; s >= 0; --s) {
    const int half = 1 << s, stride = half_n >> s;
    for (int bi = threadIdx.x; bi < nb * half_n; bi += SH_THREADS) {
      const int b = bi & (half_n - 1);
      const int pos = b & (half - 1);
      const int i0 = ((bi >> (log2n - 1)) << log2n) + ((b >> s) << (s + 1)) +
                     pos;
      const int s0 = slot(i0), s1 = slot(i0 + half);
      const float2 w = tw[pos * stride];
      const float2 u = z[s0], v = z[s1];
      const float dr = u.x - v.x, di = u.y - v.y;
      z[s0] = make_float2(u.x + v.x, u.y + v.y);
      z[s1] = make_float2(dr * w.x + di * w.y, di * w.x - dr * w.y);
    }
    __syncthreads();
  }
}

// ola_strip of the real parts of nb inverse frames (unscaled, bit-reversed
// at slot()), times scale.
__device__ __forceinline__ void ola_real(const float2* z, float* strip, int nb,
                                         long long off, int strip_len,
                                         int nfft, int log2n, int hop,
                                         const float* __restrict__ win,
                                         float scale) {
  ola_strip(
      [=](int b, int i) {
        return z[slot((b << log2n) + brev(i, log2n))].x * scale;
      },
      strip, nb, off, strip_len, nfft, hop, win);
}

// out: (channels, nf, BINS) interleaved complex, BINS = N (two-sided) or
// N/2 + 1 (one-sided). The register-resident transform of fft_reg.cuh,
// each N-point complex FFT taking two real windowed frames at once:
// z = x_f + i x_f+1, whose spectrum Z gives X_f[k] = (Z[k] + conj
// Z[N-k]) / 2 and X_f+1[k] = (Z[k] - conj Z[N-k]) / 2i (unpack_bin's E and
// O), so a frame costs half a transform; the window carries the 1/2.
// Thread j loads samples j + s N/8 of both frames straight into registers,
// windowed (its 8 window values stay in registers for the whole grid
// walk), zero past the signal (bounds checked only for pairs that reach
// past it or past the last frame). A group of FB = 4096/N consecutive
// frames of one channel ends in shared memory in natural order, and its FB
// rows, contiguous in out, are written as one coalesced run (the division
// by BINS is by a constant).
template <int N, bool ONESIDED>
__global__ void __launch_bounds__(FR_THREADS, 4)
stockham_spectrum_kernel(const float* __restrict__ x,
                         const float* __restrict__ win,
                         const float2* __restrict__ tw,
                         float2* __restrict__ out, long long n, int nf,
                         int hop, int groups_per_row, long long groups) {
  constexpr int T = N / 8, FB = 2 * FR_POINTS / N;
  constexpr int BINS = ONESIDED ? N / 2 + 1 : N;
  extern __shared__ float2 sm[];
  float2* tws = sm;
  float2* a = sm + fr_table_size(N);
  float2* b = a + FR_POINTS;
  fr_stage(tws, tw, fr_table_size(N));
  const int pair = threadIdx.x / T, j = threadIdx.x % T;
  // the window times 1/2, the unpack's factor (exact: the transform is
  // linear and halving rounds nothing)
  float w[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) w[s] = 0.5f * win[j + s * T];
  __syncthreads();
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c = (int)(g / groups_per_row);
    const int f0 = (int)(g - (long long)c * groups_per_row) * FB;
    const int f = f0 + 2 * pair;
    const long long i0 = (long long)f * hop;
    const float* xf = x + (long long)c * n + i0 + j;
    float2 v[8];
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
    fr_fft<N>(v, j, tws, a + pair * N, b + pair * N);
    const float2* z = fr_result<N>(a, b);
    const int nb = min(FB, nf - f0);
    float2* o = out + ((long long)c * nf + f0) * BINS;
    for (int idx = threadIdx.x; idx < nb * BINS; idx += FR_THREADS) {
      const int q = idx / BINS, k = idx - q * BINS;
      const float2* zp = z + (q >> 1) * N;
      const float2 p = zp[k], r = zp[(N - k) & (N - 1)];
      // p +- conj r: exact products by +-1, one rounding each as a sum
      const float sg = q & 1 ? -1.f : 1.f;
      const float u = fmaf(sg, r.x, p.x), t = fmaf(-sg, r.y, p.y);
      o[idx] = q & 1 ? make_float2(t, -u) : make_float2(u, t);
    }
    fr_swap_after<N>(a, b);
  }
}

template <int N, bool ONESIDED>
static cudaError_t launch_spectrum(const float* x, const float* win,
                                   const void* tw, void* out, int channels,
                                   long long n, int nf, int hop, int device,
                                   cudaStream_t stream) {
  constexpr int FB = 2 * FR_POINTS / N;
  const int per_row = (nf + FB - 1) / FB;
  const size_t smem = (fr_table_size(N) + 2 * FR_POINTS) * sizeof(float2);
  return fr_launch<stockham_spectrum_kernel<N, ONESIDED>>(
      smem, (long long)per_row * channels, device, stream, x, win,
      (const float2*)tw, (float2*)out, n, nf, hop, per_row,
      (long long)per_row * channels);
}

// out: (channels, nf, nfft/2 + 1) |X[k]|^2, natural bin order
__global__ void __launch_bounds__(SH_THREADS)
stockham_power_kernel(const float* __restrict__ x,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw, float* __restrict__ out,
                      long long n, int nf, int nfft, int hop) {
  extern __shared__ float2 z[];
  const int log2n = __ffs(nfft) - 1, fb = frames_per_block(nfft);
  const int bins = nfft / 2 + 1, c = blockIdx.y;
  const long long f0 = (long long)blockIdx.x * fb;
  const int nb = (int)min((long long)fb, nf - f0);
  load_frames(x + (long long)c * n, n, f0, nb, hop, win, z, nfft, log2n);
  fft_dit(z, nb, nfft, log2n, tw);
  float* o = out + ((long long)c * nf + f0) * bins;
  for (int idx = threadIdx.x; idx < nb * bins; idx += SH_THREADS) {
    const int b = idx / bins;
    const float2 v = z[slot((b << log2n) + idx - b * bins)];
    o[idx] = v.x * v.x + v.y * v.y;
  }
}

// out: (channels, nf, n_mfcc) MFCCs when FUSE_DCT, else (channels, nf,
// n_mels) mel energies. fb: (n_mels, nfft/2 + 1) dense filterbank whose row
// b is zero outside bins [band_lo[b], band_hi[b]); dct: (n_mfcc, n_mels),
// the liftered DCT-II rows.
template <bool FUSE_DCT>
__global__ void __launch_bounds__(SH_THREADS)
stockham_mel_kernel(const float* __restrict__ x,
                    const float* __restrict__ win,
                    const float2* __restrict__ tw,
                    const float* __restrict__ fb,
                    const int* __restrict__ band_lo,
                    const int* __restrict__ band_hi,
                    const float* __restrict__ dct, float* __restrict__ out,
                    long long n, int nf, int nfft, int hop, int n_mels,
                    int n_mfcc, float log_eps) {
  extern __shared__ float2 z[];
  const int log2n = __ffs(nfft) - 1, fpb = frames_per_block(nfft);
  const int bins = nfft / 2 + 1, c = blockIdx.y;
  float* pw = reinterpret_cast<float*>(z + batch_floats2(nfft));  // nb rows
  float* mel = pw + (size_t)fpb * bins;  // nb rows of n_mels log-mel values
  const long long f0 = (long long)blockIdx.x * fpb;
  const int nb = (int)min((long long)fpb, nf - f0);

  load_frames(x + (long long)c * n, n, f0, nb, hop, win, z, nfft, log2n);
  fft_dit(z, nb, nfft, log2n, tw);
  for (int idx = threadIdx.x; idx < nb * bins; idx += SH_THREADS) {
    const int b = idx / bins;
    const float2 v = z[slot((b << log2n) + idx - b * bins)];
    pw[idx] = v.x * v.x + v.y * v.y;
  }
  __syncthreads();

  const long long row0 = (long long)c * nf + f0;
  for (int p = threadIdx.x; p < nb * n_mels; p += SH_THREADS) {
    const int b = p / n_mels, band = p - b * n_mels;
    const float* fr = fb + (long long)band * bins;
    const float* pb = pw + b * bins;
    float acc = 0.f;
    for (int k = band_lo[band]; k < band_hi[band]; ++k)
      acc = fmaf(fr[k], pb[k], acc);
    if (FUSE_DCT)
      mel[p] = logf(acc + log_eps);
    else
      out[row0 * n_mels + p] = acc;
  }
  if (!FUSE_DCT) return;
  __syncthreads();
  for (int p = threadIdx.x; p < nb * n_mfcc; p += SH_THREADS) {
    const int b = p / n_mfcc, q = p - b * n_mfcc;
    const float* dr = dct + (long long)q * n_mels;
    const float* mb = mel + b * n_mels;
    float acc = 0.f;
    for (int k = 0; k < n_mels; ++k) acc = fmaf(dr[k], mb[k], acc);
    out[row0 * n_mfcc + p] = acc;
  }
}

// x, out: (channels, n); norm: (n,) guarded w^2 norm of the nf frames
__global__ void __launch_bounds__(SH_THREADS)
stockham_gate_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     const float* __restrict__ norm, float* __restrict__ out,
                     long long n, int nf, int nfft, int hop, int q, int seg,
                     float thresh2) {
  extern __shared__ float2 smem[];
  const int log2n = __ffs(nfft) - 1, fpb = frames_per_block(nfft);
  float2* z = smem;                                    // fpb frames, slot()
  float* strip = reinterpret_cast<float*>(z + batch_floats2(nfft));  // seg*hop
  float* peak2 = strip + (size_t)seg * hop;                          // fpb
  const int c = blockIdx.y, strip_len = seg * hop;
  const int lane = threadIdx.x & 31;
  const long long s0 = (long long)blockIdx.x * seg;  // first owned segment
  const float* xc = x + (long long)c * n;
  const float scale = 1.f / (float)nfft;

  for (int t = threadIdx.x; t < strip_len; t += SH_THREADS) strip[t] = 0.f;
  const long long f_lo = max(s0 - (q - 1), 0LL);
  const long long f_hi = min(s0 + seg - 1, (long long)nf - 1);
  for (long long f0 = f_lo; f0 <= f_hi; f0 += fpb) {
    const int nb = (int)min((long long)fpb, f_hi - f0 + 1);
    load_frames(xc, n, f0, nb, hop, win, z, nfft, log2n);
    fft_dit(z, nb, nfft, log2n, tw);
    // one warp per frame: the peak power over all nfft bins
    for (int b = threadIdx.x >> 5; b < nb; b += SH_WARPS) {
      float pk = 0.f;
      for (int k = lane; k < nfft; k += 32)
        pk = fmaxf(pk, power2(z[slot((b << log2n) + k)]));
      for (int s = 16; s > 0; s >>= 1)
        pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, s));
      if (lane == 0) peak2[b] = __fmul_rn(thresh2, pk);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * nfft; idx += SH_THREADS)
      if (!(power2(z[slot(idx)]) >= peak2[idx >> log2n]))
        z[slot(idx)] = make_float2(0.f, 0.f);
    __syncthreads();
    ifft_dif(z, nb, nfft, log2n, tw);
    // window and overlap-add the real parts, frames in ascending order
    ola_real(z, strip, nb, (f0 - s0) * hop, strip_len, nfft, log2n, hop, win,
             scale);
  }
  float* oc = out + (long long)c * n;
  const long long g0 = s0 * hop;
  for (int t = threadIdx.x; t < strip_len; t += SH_THREADS) {
    const long long g = g0 + t;
    if (g < n) oc[g] = strip[t] / norm[g];
  }
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

// The geometries the launchers take: power-of-two nfft in [4, 2048] (a
// frame batch and its strip stay within a block's shared memory), hop a
// divisor of nfft; the Python wrappers narrow this to the JAX package's
// lattice.
static bool bad_geometry(int nfft, int hop, int nf, int channels) {
  return nfft < 4 || nfft > SH_POINTS || (nfft & (nfft - 1)) || hop < 1 ||
         nfft % hop || nf < 1 || channels < 1 || channels > 65535;
}

static dim3 frame_grid(int nf, int nfft, int channels) {
  const int fb = frames_per_block(nfft);
  return dim3((unsigned)((nf + fb - 1) / fb), (unsigned)channels);
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
#define VV_SPECTRUM(N)                                                       \
  return (int)(one ? launch_spectrum<N, true>(x, win, tw, out, channels, n, \
                                              nf, hop, device, s)           \
                   : launch_spectrum<N, false>(x, win, tw, out, channels,   \
                                               n, nf, hop, device, s))
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
  const size_t smem = batch_floats2(nfft) * sizeof(float2);
  stockham_power_kernel<<<frame_grid(nf, nfft, channels), SH_THREADS, smem,
                          (cudaStream_t)stream>>>(
      x, win, (const float2*)tw, out, n, nf, nfft, hop);
  return (int)cudaGetLastError();
}

extern "C" int vv_stockham_mel(const float* x, const float* win,
                               const void* tw, const float* fb,
                               const int* band_lo, const int* band_hi,
                               const float* dct, float* out, int channels,
                               long long n, int nf, int nfft, int hop,
                               int n_mels, int n_mfcc, float log_eps,
                               int fuse_dct, int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) || n_mels < 1 ||
      n_mels > nfft / 2 + 1 || (fuse_dct && n_mfcc < 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int fpb = frames_per_block(nfft);
  const size_t smem = batch_floats2(nfft) * sizeof(float2) +
                      (size_t)fpb * (nfft / 2 + 1 + n_mels) * sizeof(float);
  const dim3 grid = frame_grid(nf, nfft, channels);
  cudaStream_t s = (cudaStream_t)stream;
  if (fuse_dct)
    stockham_mel_kernel<true><<<grid, SH_THREADS, smem, s>>>(
        x, win, (const float2*)tw, fb, band_lo, band_hi, dct, out, n, nf, nfft,
        hop, n_mels, n_mfcc, log_eps);
  else
    stockham_mel_kernel<false><<<grid, SH_THREADS, smem, s>>>(
        x, win, (const float2*)tw, fb, band_lo, band_hi, dct, out, n, nf, nfft,
        hop, n_mels, n_mfcc, log_eps);
  return (int)cudaGetLastError();
}

extern "C" int vv_stockham_gate(const float* x, const float* win,
                                const void* tw, const float* norm, float* out,
                                int channels, long long n, int nf, int nfft,
                                int hop, float thresh2, int device,
                                void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) || n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int fpb = frames_per_block(nfft);
  const int q = (nfft + hop - 1) / hop;
  const int seg = owned_segments(nfft, hop);
  const size_t smem = batch_floats2(nfft) * sizeof(float2) +
                      ((size_t)seg * hop + fpb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stockham_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const long long segs = (n + hop - 1) / hop;
  const dim3 grid((unsigned)((segs + seg - 1) / seg), (unsigned)channels);
  stockham_gate_kernel<<<grid, SH_THREADS, smem, (cudaStream_t)stream>>>(
      x, win, (const float2*)tw, norm, out, n, nf, nfft, hop, q, seg,
      thresh2);
  return (int)cudaGetLastError();
}

// smem: the host plan's (fft_plan.istft_smem), which the launcher checks
// against its own reckoning of the layout.
extern "C" int vv_istft_stockham(const void* spec, const float* win,
                                 const void* tw, const float* norm, float* out,
                                 int channels, int nf, int nfft, int hop,
                                 int bins, long long output_len,
                                 long long smem, int device, void* stream) {
  if (bad_geometry(nfft, hop, nf, channels) || nfft < 128 ||
      output_len < 1 || (bins != nfft && bins != nfft / 2 + 1))
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
