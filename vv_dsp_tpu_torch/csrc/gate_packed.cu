// Fused SpectralGate on the packed-real transforms: forward STFT ->
// per-frame peak gate -> inverse STFT -> windowed overlap-add, one kernel.
//
// stft_gate_packed_kernel replaces _gate_packed_kernel of
// vv_dsp_tpu/ops/pallas_fft.py (launcher stft_gate_packed) together with its
// XLA epilogue _ola_strips_epilogue and the division by the
// interior-periodic w^2 norm.
//
// Per frame f (x[f*hop, f*hop + nfft), zero past the signal), on the
// register-resident M-point transform of fft_reg.cuh (M = nfft/2), with no
// spectrum in shared memory: thread j of a frame loads its packed points
// straight into registers (packed_frame_regs, its window pairs read from
// the staged window) and runs fr_fft<M>; from the result it reads Z[k] and
// Z[(M - k) mod M] for its eight k = j + s M/8 and unpacks X[k] and
// X[M - k] into registers (unpack_pair); then the frame's peak, the gate,
// the Hermitian repack scaled by 1/nfft and the inverse as the forward
// transform of the conjugate (packed_inverse_regs, as istft.cu), run in
// the other exchange buffer (fr_swap_after), so both transforms need one
// barrier a pass and nothing else does but the gate's peak where a frame
// spans warps (M >= 512). The 16 bins, the transform's temporaries and the
// window pairs do not fit 80 registers (3 blocks an SM): held for the
// walk, as the spectrum kernel holds them, the pairs spill 28-152 bytes at
// every M, and even at 128 registers at M = 256 and 128, so they are read
// from shared memory for each frame, at 2 blocks an SM. The gate: peak2 = max_k re^2 + im^2 over the
// M + 1 bins (the mirror bins share those magnitudes, so this is the
// two-sided peak too), and bin k is kept iff re^2 + im^2 >= thresh2 *
// peak2, in float32 with no fused multiply-add (power2), as the plain
// version compares. The imaginary parts of the DC and Nyquist bins are
// dropped in the repack, as irfft drops them (the TPU kernel folds them
// in; for a real signal they are rounding noise). The TPU kernel's DFT-64
// matrix tails, which it runs at the caller's dot-algorithm tier, are
// butterflies here, in float32: the wrapper refuses any other tier.
//
// Overlap-add across blocks is deterministic, with no atomics, as in
// istft.cu: a persistent block walks over strip items (s, c), each owning
// `seg` consecutive hop-long output segments of channel c; it recomputes
// the q - 1 frames (q = nfft/hop) that reach into the first of them from
// the left, sums every frame touching its segments into a shared-memory
// strip, 2048/M frames at a time in ascending frame order, and writes each
// output sample once, divided by the norm the caller gives (the JAX
// function's interior-periodic one). The twiddle table, wk and the window
// are staged once a block.
//
// Bound. At SpectralGate's shape (16 x 480768 samples at 1024/256) it reads
// the signal and the norm and writes the output, 61.5 MB, ~0.018 ms at
// 3.35 TB/s, against ~1.9 GFLOP of transforms (forward and inverse of 1876
// frames a channel, 19 frames per 16 owned): the operations bound it, at
// 0.025 ms. Its radix-2 form took 32x that: two transforms of log2(M)
// barrier-separated passes, a spectrum buffer and four more barriers a
// batch of frames.
#include "packed.cuh"

// x, out: (channels, n); win: (2M,) analysis and synthesis window; tw: the
// M-point transform's twiddle table (fft_plan.pass_twiddles); wk[k] =
// exp(-2 pi i k / 2M), k <= M; norm: (n,) w^2 norm
template <int M>
__global__ void __launch_bounds__(FR_THREADS, 2)
stft_gate_packed_kernel(const float* __restrict__ x,
                        const float* __restrict__ win,
                        const float2* __restrict__ tw,
                        const float2* __restrict__ wk,
                        const float* __restrict__ norm,
                        float* __restrict__ out, long long n, int nf, int hop,
                        int q, int seg, int strips_per_row, long long strips,
                        float thresh2) {
  constexpr int T = M / 8, FB = FR_POINTS / M;
  extern __shared__ float2 sm[];
  const PackedOlaSmem<M> s(sm, tw, wk, win);
  const int fb = threadIdx.x / T, j = threadIdx.x % T;
  const int strip_len = seg * hop;
  __syncthreads();
  for (long long g = blockIdx.x; g < strips; g += gridDim.x) {
    const StripItem<> it(g, strips_per_row, seg, q, nf);
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS)
      s.strip[t] = 0.f;
    const float* xc = x + (long long)it.c * n;
    for (long long f0 = it.f_lo; f0 <= it.f_hi; f0 += FB) {
      // frames past the item's last load zeros
      float2 v[8], w[8];
      packed_window_regs<M>(w, s.wins, j);
      packed_frame_regs<M>(v, xc, n, (int)(f0 + fb), (int)(it.f_hi + 1), hop,
                           j, w);
      float2* a = s.a;
      float2* b = s.b;
      fr_fft<M>(v, j, s.tws, a + fb * M, b + fb * M);
      const float2* z = fr_result<M>(a, b) + fb * M;
      float2 xk[8], xr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = j + u * T;
        const float2 p = z[k], m = z[(M - k) & (M - 1)];
        xk[u] = unpack_pair(p, m, s.wks[k]);
        xr[u] = unpack_pair(m, p, s.wks[M - k]);
      }
      packed_inverse_regs<M, true>(v, xk, xr, j, s.wks, thresh2, s.slots);
      // the inverse's first pass writes the buffer that does not hold z
      fr_swap_after<M>(a, b);
      fr_fft<M>(v, j, s.tws, a + fb * M, b + fb * M);
      const int nb = (int)min((long long)FB, it.f_hi - f0 + 1);
      ola_strip(PackedSample<M>{fr_result<M>(a, b)}, s.strip, nb,
                (f0 - it.s0) * hop, strip_len, 2 * M, hop, s.wins);
    }
    float* oc = out + (long long)it.c * n;
    const long long g0 = it.s0 * hop;
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS) {
      const long long o = g0 + t;
      if (o < n) oc[o] = s.strip[t] / norm[o];
    }
  }
}

template <int M>
static cudaError_t launch_gate(const float* x, const float* win,
                               const void* tw, const void* wk,
                               const float* norm, float* out, int channels,
                               long long n, int nf, int hop, float thresh2,
                               size_t smem, int device, cudaStream_t stream) {
  if (smem != packed_ola_smem<M>(hop)) return cudaErrorInvalidValue;
  const int seg = owned_segments(2 * M, hop);
  const long long segs = (n + hop - 1) / hop;
  const long long per_row = (segs + seg - 1) / seg;
  return fr_launch<stft_gate_packed_kernel<M>>(
      smem, per_row * channels, device, stream, x, win, (const float2*)tw,
      (const float2*)wk, norm, out, n, nf, hop, 2 * M / hop, seg,
      (int)per_row, per_row * channels, thresh2);
}

// The geometries the launcher takes: power-of-two nfft in [256, 4096], hop
// a divisor of nfft below it; the Python wrapper narrows this to the JAX
// package's lattice (packed_gate_supported). smem: the host plan's
// (fft_plan.gate_packed_smem), which the launcher checks against its own
// reckoning of the layout.
extern "C" int vv_stft_gate_packed(const float* x, const float* win,
                                   const void* tw, const void* wk,
                                   const float* norm, float* out,
                                   int channels, long long n, int nf,
                                   int nfft, int hop, float thresh2,
                                   long long smem, int device, void* stream) {
  if (nfft < 256 || nfft > 4096 || (nfft & (nfft - 1)) || hop < 1 ||
      hop >= nfft || nfft % hop || nf < 1 || n < 1 || channels < 1 ||
      channels > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define VV_GATE(M)                                                       \
  return (int)launch_gate<M>(x, win, tw, wk, norm, out, channels, n, nf, \
                             hop, thresh2, (size_t)smem, device, s)
  switch (nfft / 2) {
    case 128: VV_GATE(128);
    case 256: VV_GATE(256);
    case 512: VV_GATE(512);
    case 1024: VV_GATE(1024);
    case 2048: VV_GATE(2048);
  }
#undef VV_GATE
  return (int)cudaErrorInvalidValue;
}
