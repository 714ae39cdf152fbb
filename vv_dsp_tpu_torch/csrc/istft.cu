// Inverse STFT with w^2-normalized overlap-add, and the SpectralGate's
// per-frame peak gate applied before the inverse.
//
// istft_kernel replaces _istft_packed_kernel of vv_dsp_tpu/ops/pallas_fft.py
// (launcher _istft_from_storage_planes, entries istft_packed,
// istft_packed_from_storage and stft_gate_split) together with its XLA
// epilogue _ola_strips_epilogue and the _ola_norm_table division.
//
// Per frame f (one-sided spectrum X[0..M], M = nfft/2), the real nfft-point
// inverse is the packed-real inverse of packed.cuh: the M-point complex
// inverse FFT of the Hermitian repack, scaled by 1/nfft, whose output holds
// the frame's even and odd samples. It runs as the register-resident
// forward transform of fft_reg.cuh on conjugated input, M ifft(Z) =
// conj(fft(conj Z)): thread j of a frame loads bins k and M - k for its
// eight k = j + s M/8 straight into registers (coalesced; each bin is read
// twice, the second time mostly from cache), repacks them there
// (packed_inverse_regs) and runs fr_fft<M>. The imaginary parts of X[0]
// and X[M] are dropped, as torch.fft.irfft drops them (the TPU kernel
// folds them into Z[0]; for the spectrum of a real signal both are rounding
// noise). float32, with float64-built twiddles: the f32 contract of every
// caller of this path.
//
// Gate (GATE): per frame, peak2 = max_k p2[k] over the M + 1 bins with
// p2 = re^2 + im^2, and bin k is kept iff p2[k] >= thresh2 * peak2, in
// float32 with no fused multiply-add, exactly as the TPU kernel compares.
// Each thread takes the max over the 16 bins it loaded, then the frame's
// threads reduce it (frame_max): the max is exact in any order, so the
// gate keeps the same bins as the plain version on the same spectrum.
//
// Overlap-add across blocks. The TPU grid runs in order, and each tile
// writes an owned strip plus a spill strip that XLA folds afterwards. Blocks
// here run in no order, and float atomics would make the sums depend on
// it. So a strip item (s, c) owns `seg` consecutive hop-long output
// segments of channel c (owned_segments) and also recomputes the q - 1
// frames (q = nfft/hop) that reach into the first of them from the left.
// A persistent block walks over items (fr_launch); for each it sums every
// frame that touches the strip into shared memory, FB = 2048/M frames at a
// time and in ascending frame order (ola_strip, visiting only the frames
// that cover a sample), and writes each output sample once, divided by the
// guarded w^2 norm (the host's float64 table, cast once). The twiddle
// table, wk and the window are staged once a block.
//
// Bound. At the gate's shape (16 x 1876 frames x 513 bins, 480768 samples
// out) it reads 123 MB of spectrum and writes 31 MB, ~0.05 ms at 3.35 TB/s;
// its ~0.9 GFLOP are far from the float32 peak. Its radix-2 form took 8x
// that: log2(M) barrier-separated passes of one butterfly a thread, a
// bit-reversed scatter, twiddles read from device memory per butterfly and
// a separate peak pass. Here a transform takes fr_passes(M) barriers (3 at
// M = 512) and the gate one more where a frame spans warps (M >= 512).
#include "packed.cuh"

// spec: (channels, nf, M + 1) one-sided complex; win: (2M,) synthesis
// window; tw: the M-point transform's twiddle table (fft_plan.pass_twiddles);
// wk[k] = exp(-2 pi i k / 2M), k <= M; norm: (output_len,) guarded w^2
// norm; out: (channels, output_len).
template <int M, bool GATE>
__global__ void __launch_bounds__(FR_THREADS, 3)
istft_kernel(const float2* __restrict__ spec, const float* __restrict__ win,
             const float2* __restrict__ tw, const float2* __restrict__ wk,
             const float* __restrict__ norm, float* __restrict__ out, int nf,
             int hop, int q, long long output_len, int seg,
             int strips_per_row, long long strips, float thresh2) {
  constexpr int T = M / 8, FB = FR_POINTS / M, BINS = M + 1;
  extern __shared__ float2 sm[];
  const PackedOlaSmem<M> s(sm, tw, wk, win);
  const int fb = threadIdx.x / T, j = threadIdx.x % T;
  const int strip_len = seg * hop;
  __syncthreads();
  for (long long g = blockIdx.x; g < strips; g += gridDim.x) {
    const StripItem<> it(g, strips_per_row, seg, q, nf);
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS)
      s.strip[t] = 0.f;
    const float2* xc = spec + (long long)it.c * nf * BINS;
    for (long long f0 = it.f_lo; f0 <= it.f_hi; f0 += FB) {
      const long long f = f0 + fb;
      float2 x[8], r[8];
      if (f <= it.f_hi) {
        const float2* xf = xc + f * BINS;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x[u] = __ldg(xf + j + u * T);
          r[u] = __ldg(xf + M - j - u * T);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = r[u] = make_float2(0.f, 0.f);
      }
      float2 v[8];
      packed_inverse_regs<M, GATE>(v, x, r, j, s.wks, thresh2, s.slots);
      fr_fft<M>(v, j, s.tws, s.a + fb * M, s.b + fb * M);
      const int nb = (int)min((long long)FB, it.f_hi - f0 + 1);
      ola_strip(PackedSample<M>{fr_result<M>(s.a, s.b)}, s.strip, nb,
                (f0 - it.s0) * hop, strip_len, 2 * M, hop, s.wins);
    }
    float* oc = out + (long long)it.c * output_len;
    const long long g0 = it.s0 * hop;
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS) {
      const long long o = g0 + t;
      if (o < output_len) oc[o] = s.strip[t] / norm[o];
    }
  }
}

template <int M, bool GATE>
static cudaError_t launch_istft(const void* spec, const float* win,
                                const void* tw, const void* wk,
                                const float* norm, float* out, int channels,
                                int nf, int hop, long long output_len,
                                float thresh2, size_t smem, int device,
                                cudaStream_t stream) {
  if (smem != packed_ola_smem<M>(hop)) return cudaErrorInvalidValue;
  const int seg = owned_segments(2 * M, hop);
  const long long segs = (output_len + hop - 1) / hop;
  const long long per_row = (segs + seg - 1) / seg;
  return fr_launch<istft_kernel<M, GATE>>(
      smem, per_row * channels, device, stream, (const float2*)spec, win,
      (const float2*)tw, (const float2*)wk, norm, out, nf, hop, 2 * M / hop,
      output_len, seg, (int)per_row, per_row * channels, thresh2);
}

// The geometries the launcher takes: power-of-two nfft in [256, 4096], hop
// a divisor of nfft (istft_supported). smem: the host plan's
// (fft_plan.packed_istft_smem), which the launcher checks against its own
// reckoning of the layout.
extern "C" int vv_istft(const void* spec, const float* win, const void* tw,
                        const void* wk, const float* norm, float* out,
                        int channels, int nf, int nfft, int hop,
                        long long output_len, int gate, float thresh2,
                        long long smem, int device, void* stream) {
  if (nfft < 256 || nfft > 4096 || (nfft & (nfft - 1)) || hop < 1 ||
      nfft % hop || nf < 1 || output_len < 1 || channels < 1 ||
      channels > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define VV_ISTFT(M)                                                          \
  return (int)(gate ? launch_istft<M, true>(spec, win, tw, wk, norm, out,   \
                                            channels, nf, hop, output_len,  \
                                            thresh2, (size_t)smem, device,  \
                                            s)                              \
                    : launch_istft<M, false>(spec, win, tw, wk, norm, out,  \
                                             channels, nf, hop, output_len, \
                                             thresh2, (size_t)smem, device, \
                                             s))
  switch (nfft / 2) {
    case 128: VV_ISTFT(128);
    case 256: VV_ISTFT(256);
    case 512: VV_ISTFT(512);
    case 1024: VV_ISTFT(1024);
    case 2048: VV_ISTFT(2048);
  }
#undef VV_ISTFT
  return (int)cudaErrorInvalidValue;
}
