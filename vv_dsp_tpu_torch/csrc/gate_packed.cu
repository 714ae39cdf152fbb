// Fused SpectralGate on the packed-real transforms: forward STFT ->
// per-frame peak gate -> inverse STFT -> windowed overlap-add, one kernel.
//
// stft_gate_packed_kernel replaces _gate_packed_kernel of
// vv_dsp_tpu/ops/pallas_fft.py (launcher stft_gate_packed) together with its
// XLA epilogue _ola_strips_epilogue and the division by the
// interior-periodic w^2 norm.
//
// Per frame f (x[f*hop, f*hop + nfft), zero past the signal): the packed
// forward of packed.cuh (an m = nfft/2 point complex FFT and the Hermitian
// unpack of bins 0..m), then the gate: peak2 = max_k re^2 + im^2 over the
// m + 1 bins (the mirror bins share those magnitudes, so this is the
// two-sided peak too), and bin k is kept iff re^2 + im^2 >= thresh2 *
// peak2, in float32 with no fused multiply-add (power2), as the plain
// version compares; then the Hermitian repack and the m-point inverse,
// scaled by 1/nfft, the synthesis window and the overlap-add. The imaginary
// parts of the DC and Nyquist bins are dropped in the repack, as irfft drops
// them (the TPU kernel folds them in; for a real signal they are rounding
// noise). The TPU kernel's DFT-64 matrix tails, which it runs at the
// caller's dot-algorithm tier, are butterflies here, in float32: the
// wrapper refuses any other tier.
//
// Overlap-add across blocks is deterministic, with no atomics, as in
// istft.cu: block (s, c) owns `seg` consecutive hop-long output segments of
// channel c, recomputes the q - 1 frames (q = nfft/hop) that reach into the
// first of them from the left, sums every frame touching its segments into
// a shared-memory strip in ascending frame order and writes each output
// sample once, divided by the norm the caller gives (the JAX function's
// interior-periodic one). Frames go packed_batch(m) at a time.
//
// Bound. At SpectralGate's shape (16 x 480768 samples at 1024/256) it reads
// the signal and the norm and writes the output, 61.5 MB, ~0.018 ms at
// 3.35 TB/s, against ~1.9 GFLOP of transforms (forward and inverse of 1876
// frames a channel, 19 frames per 16 owned): the operations bound it on
// paper, and the barrier-separated radix-2 passes in practice.
#include "packed.cuh"

constexpr int GATE_THREADS = 256;
constexpr int GATE_WARPS = GATE_THREADS / 32;

// x, out: (channels, n); win: (nfft,) analysis and synthesis window;
// tw[k] = exp(-2 pi i k / m), k < m/2; wk[k] = exp(-2 pi i k / nfft),
// k <= m; norm: (n,) w^2 norm
__global__ void __launch_bounds__(GATE_THREADS)
stft_gate_packed_kernel(const float* __restrict__ x,
                        const float* __restrict__ win,
                        const float2* __restrict__ tw,
                        const float2* __restrict__ wk,
                        const float* __restrict__ norm,
                        float* __restrict__ out, long long n, int nf,
                        int nfft, int hop, int q, int seg, int fb,
                        float thresh2) {
  extern __shared__ float2 smem[];
  const int m = nfft / 2, log2m = __ffs(m) - 1;
  float2* z = smem;                                   // fb * m packed points
  float2* spec = z + (size_t)fb * m;                  // fb * (m + 1) bins
  float* strip = reinterpret_cast<float*>(spec + (size_t)fb * (m + 1));
  float* peak2 = strip + (size_t)seg * hop;           // fb
  const int c = blockIdx.y, strip_len = seg * hop;
  const int lane = threadIdx.x & 31;
  const long long s0 = (long long)blockIdx.x * seg;  // first owned segment
  const float* xc = x + (long long)c * n;
  const float scale = 1.f / (float)nfft;              // exact: nfft is 2^k

  for (int t = threadIdx.x; t < strip_len; t += GATE_THREADS) strip[t] = 0.f;
  const long long f_lo = max(s0 - (q - 1), 0LL);
  const long long f_hi = min(s0 + seg - 1, (long long)nf - 1);
  for (long long f0 = f_lo; f0 <= f_hi; f0 += fb) {
    const int nb = (int)min((long long)fb, f_hi - f0 + 1);
    packed_load(xc, n, f0, nb, hop, win, z, m, log2m);
    packed_fft(z, nb, m, log2m, tw);
    for (int idx = threadIdx.x; idx < nb * (m + 1); idx += GATE_THREADS) {
      const int b = idx / (m + 1);
      spec[idx] = unpack_bin(z + b * m, wk, idx - b * (m + 1), m);
    }
    __syncthreads();
    // one warp per frame: the peak power over bins 0..m
    for (int b = threadIdx.x >> 5; b < nb; b += GATE_WARPS) {
      const float2* xf = spec + b * (m + 1);
      float pk = 0.f;
      for (int k = lane; k <= m; k += 32) pk = fmaxf(pk, power2(xf[k]));
      for (int s = 16; s > 0; s >>= 1)
        pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, s));
      if (lane == 0) peak2[b] = __fmul_rn(thresh2, pk);
    }
    __syncthreads();
    // gate, then the Hermitian repack into bit-reversed order
    for (int idx = threadIdx.x; idx < nb * m; idx += GATE_THREADS) {
      const int b = idx >> log2m, j = idx & (m - 1);
      const float2* xf = spec + b * (m + 1);
      float2 a = xf[j], r = xf[m - j];
      if (!(power2(a) >= peak2[b])) a = make_float2(0.f, 0.f);
      if (!(power2(r) >= peak2[b])) r = make_float2(0.f, 0.f);
      z[b * m + (__brev((unsigned)j) >> (32 - log2m))] =
          repack_bin(a, r, wk, j, scale);
    }
    __syncthreads();
    packed_ifft(z, nb, m, log2m, tw);
    // window and overlap-add into the strip, frames in ascending order
    packed_ola(z, strip, nb, (f0 - s0) * hop, strip_len, m, hop, win);
  }
  float* oc = out + (long long)c * n;
  const long long g0 = s0 * hop;
  for (int t = threadIdx.x; t < strip_len; t += GATE_THREADS) {
    const long long g = g0 + t;
    if (g < n) oc[g] = strip[t] / norm[g];
  }
}

// The geometries the launcher takes: power-of-two nfft in [8, 4096], hop a
// divisor of nfft below it; the Python wrapper narrows this to the JAX
// package's lattice.
extern "C" int vv_stft_gate_packed(const float* x, const float* win,
                                   const void* tw, const void* wk,
                                   const float* norm, float* out,
                                   int channels, long long n, int nf,
                                   int nfft, int hop, float thresh2,
                                   int device, void* stream) {
  if (nfft < 8 || nfft > 4096 || (nfft & (nfft - 1)) || hop < 1 ||
      hop >= nfft || nfft % hop || nf < 1 || n < 1 || channels < 1 ||
      channels > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int m = nfft / 2;
  const int q = (nfft + hop - 1) / hop;
  const int fb = packed_batch(m), seg = owned_segments(nfft, hop);
  const size_t smem = ((size_t)fb * m + (size_t)fb * (m + 1)) * sizeof(float2)
                      + ((size_t)seg * hop + fb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_gate_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const long long segs = (n + hop - 1) / hop;
  const dim3 grid((unsigned)((segs + seg - 1) / seg), (unsigned)channels);
  stft_gate_packed_kernel<<<grid, GATE_THREADS, smem, (cudaStream_t)stream>>>(
      x, win, (const float2*)tw, (const float2*)wk, norm, out, n, nf, nfft,
      hop, q, seg, fb, thresh2);
  return (int)cudaGetLastError();
}
