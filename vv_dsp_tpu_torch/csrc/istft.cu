// Inverse STFT with w^2-normalized overlap-add, and the SpectralGate's
// per-frame peak gate applied before the inverse.
//
// istft_kernel replaces _istft_packed_kernel of vv_dsp_tpu/ops/pallas_fft.py
// (launcher _istft_from_storage_planes, entries istft_packed,
// istft_packed_from_storage and stft_gate_split) together with its XLA
// epilogue _ola_strips_epilogue and the _ola_norm_table division.
//
// Per frame f (one-sided spectrum X[0..m], m = nfft/2), the real nfft-point
// inverse runs as an m-point complex inverse FFT of the Hermitian repack
//   Z[k] = (X[k] + conj X[m-k]) + j W^-k (X[k] - conj X[m-k]),  W = e^{-2 pi
//   i / nfft},
// scaled by 1/nfft, whose output z[n] = y[2n] + j y[2n+1] is the frame's
// even and odd samples. The imaginary parts of X[0] and X[m] are dropped,
// as torch.fft.irfft drops them (the TPU kernel folds them into Z[0]; for
// the spectrum of a real signal both are rounding noise). The butterflies
// are radix-2 DIT in shared memory on bit-reversed input, float32, with
// float64-built twiddles: the f32 contract of every caller of this path.
//
// Gate (gate != 0): per frame, peak2 = max_k p2[k] over the m + 1 bins with
// p2 = re^2 + im^2, and bin k is kept iff p2[k] >= thresh2 * peak2, in
// float32 with no fused multiply-add, exactly as the TPU kernel compares.
//
// Overlap-add across blocks. The TPU grid runs in order, and each tile
// writes an owned strip plus a spill strip that XLA folds afterwards. Blocks
// here run in no order, and float atomics would make the sums depend on
// it. So block (s, c) owns `seg` consecutive hop-long output segments of
// channel c and also recomputes the q - 1 frames (q = nfft/hop) that
// reach into the first of them from the left. It sums every frame that
// touches its segments into a shared-memory strip, frames in ascending
// order, and writes each output sample once, divided by the guarded w^2
// norm (the host's float64 table, cast once). One kernel, one write, and
// (q - 1)/seg extra inverse FFTs (3/16 at 1024/256). Frames are taken
// `fb` at a time, so each barrier-separated stage covers fb frames.
//
// Bound. At the gate's shape (16 x 1876 frames x 513 bins, 480768 samples
// out) it reads 123 MB of spectrum and writes 31 MB, ~0.05 ms at 3.35 TB/s;
// its ~0.9 GFLOP are far from the float32 peak. What holds it back is
// latency: log2(m) barrier-separated stages per batch of frames.
#include <algorithm>

#include "common.cuh"

constexpr int ISTFT_THREADS = 256;
constexpr int ISTFT_WARPS = ISTFT_THREADS / 32;

__device__ __forceinline__ float power2(float2 v) {
  // no contraction into an FMA: the gate compares these bit for bit with
  // the plain version's re * re + im * im
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// spec: (channels, nf, m + 1) one-sided complex; win: (nfft,) synthesis
// window; tw[k] = exp(-2 pi i k / m), k < m/2; wk[k] = exp(-2 pi i k / nfft),
// k <= m; norm: (output_len,) guarded w^2 norm; out: (channels, output_len).
__global__ void __launch_bounds__(ISTFT_THREADS)
istft_kernel(const float2* __restrict__ spec, const float* __restrict__ win,
             const float2* __restrict__ tw, const float2* __restrict__ wk,
             const float* __restrict__ norm, float* __restrict__ out, int nf,
             int nfft, int hop, int q, long long output_len, int seg, int fb,
             int gate, float thresh2) {
  extern __shared__ float2 smem[];
  const int m = nfft / 2, log2m = __ffs(m) - 1;
  float2* z = smem;                                          // fb * m
  float* strip = reinterpret_cast<float*>(z + (size_t)fb * m);  // seg * hop
  float* peak2 = strip + (size_t)seg * hop;                  // fb
  const int c = blockIdx.y;
  const int strip_len = seg * hop;
  const long long s0 = (long long)blockIdx.x * seg;  // first owned segment
  const float2* xc = spec + (long long)c * nf * (m + 1);
  const float scale = 1.f / (float)nfft;             // exact: nfft is 2^k

  for (int t = threadIdx.x; t < strip_len; t += ISTFT_THREADS) strip[t] = 0.f;
  const long long f_lo = max(s0 - (q - 1), 0LL);
  const long long f_hi = min(s0 + seg - 1, (long long)nf - 1);
  for (long long f0 = f_lo; f0 <= f_hi; f0 += fb) {
    const int nb = (int)min((long long)fb, f_hi - f0 + 1);
    if (gate) {
      // one warp per frame: the peak power over bins 0..m
      const int lane = threadIdx.x & 31;
      for (int b = threadIdx.x >> 5; b < nb; b += ISTFT_WARPS) {
        const float2* xf = xc + (f0 + b) * (m + 1);
        float pk = 0.f;
        for (int k = lane; k <= m; k += 32) pk = fmaxf(pk, power2(xf[k]));
        for (int s = 16; s > 0; s >>= 1)
          pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, s));
        if (lane == 0) peak2[b] = __fmul_rn(thresh2, pk);
      }
      __syncthreads();
    }
    // Hermitian repack into bit-reversed order
    for (int idx = threadIdx.x; idx < nb * m; idx += ISTFT_THREADS) {
      const int b = idx >> log2m, j = idx & (m - 1);
      const float2* xf = xc + (f0 + b) * (m + 1);
      float2 a = xf[j], r = xf[m - j];
      if (gate) {
        if (!(power2(a) >= peak2[b])) a = make_float2(0.f, 0.f);
        if (!(power2(r) >= peak2[b])) r = make_float2(0.f, 0.f);
      }
      if (j == 0) {
        a.y = 0.f;
        r.y = 0.f;
      }
      // e = a + conj r, d = a - conj r, o = conj(wk[j]) d
      const float er = a.x + r.x, ei = a.y - r.y;
      const float dr = a.x - r.x, di = a.y + r.y;
      const float2 w = wk[j];
      const float o_r = w.x * dr + w.y * di, o_i = w.x * di - w.y * dr;
      z[b * m + (__brev((unsigned)j) >> (32 - log2m))] =
          make_float2((er - o_i) * scale, (ei + o_r) * scale);
    }
    __syncthreads();
    // m-point inverse FFT of every frame of the batch (conjugate twiddles)
    const int half_m = m >> 1, log2h = log2m - 1;
    for (int s = 0; s < log2m; ++s) {
      const int half = 1 << s;
      const int stride = m >> (s + 1);
      for (int bi = threadIdx.x; bi < nb * half_m; bi += ISTFT_THREADS) {
        float2* zf = z + (bi >> log2h) * m;
        const int b = bi & (half_m - 1);
        const int pos = b & (half - 1);
        const int i0 = ((b >> s) << (s + 1)) + pos;
        const int i1 = i0 + half;
        const float2 w = tw[pos * stride];
        const float2 u = zf[i0], v = zf[i1];
        const float tr = w.x * v.x + w.y * v.y;
        const float ti = w.x * v.y - w.y * v.x;
        zf[i0] = make_float2(u.x + tr, u.y + ti);
        zf[i1] = make_float2(u.x - tr, u.y - ti);
      }
      __syncthreads();
    }
    // window and overlap-add into the strip, frames in ascending order
    const long long off = (f0 - s0) * hop;  // frame f0's start in the strip
    const int lo = (int)max(off, 0LL);
    const int hi = (int)min(off + (long long)(nb - 1) * hop + nfft,
                            (long long)strip_len);
    for (int t = lo + threadIdx.x; t < hi; t += ISTFT_THREADS) {
      float acc = strip[t];
      for (int b = 0; b < nb; ++b) {
        const long long i = t - off - (long long)b * hop;
        if (i >= 0 && i < nfft) {
          const float2 v = z[b * m + (int)(i >> 1)];
          acc += ((i & 1) ? v.y : v.x) * win[i];
        }
      }
      strip[t] = acc;
    }
    __syncthreads();
  }
  float* oc = out + (long long)c * output_len;
  const long long g0 = s0 * hop;
  for (int t = threadIdx.x; t < strip_len; t += ISTFT_THREADS) {
    const long long g = g0 + t;
    if (g < output_len) oc[g] = strip[t] / norm[g];
  }
}

extern "C" int vv_istft(const void* spec, const float* win, const void* tw,
                        const void* wk, const float* norm, float* out,
                        int channels, int nf, int nfft, int hop,
                        long long output_len, int gate, float thresh2,
                        int device, void* stream) {
  if (nfft < 4 || (nfft & (nfft - 1)) || hop < 1 || hop > nfft || nf < 1 ||
      output_len < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int m = nfft / 2;
  const int q = (nfft + hop - 1) / hop;
  // a batch of up to 2048 complex points; at least 4 (q - 1) owned
  // segments against the q - 1 recomputed ones, and a strip of >= 4096
  const int fb = m >= 2048 ? 1 : 2048 / m;
  const int seg = std::max({4 * (q - 1), (4096 + hop - 1) / hop, 1});
  const size_t smem = (size_t)fb * m * sizeof(float2) +
                      ((size_t)seg * hop + fb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const long long segs = (output_len + hop - 1) / hop;
  const dim3 grid((unsigned)((segs + seg - 1) / seg), (unsigned)channels);
  istft_kernel<<<grid, ISTFT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)spec, win, (const float2*)tw, (const float2*)wk, norm,
      out, nf, nfft, hop, q, output_len, seg, fb, gate, thresh2);
  return (int)cudaGetLastError();
}
