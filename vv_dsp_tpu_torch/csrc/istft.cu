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
// conj(fft(conj Z)): thread j of a frame takes bins k and M - k for its
// eight k = j + s M/8 from the frame's row in shared memory (below),
// repacks them in registers (packed_inverse_regs) and runs fr_fft<M>. The
// imaginary parts of X[0] and X[M] are dropped, as torch.fft.irfft drops
// them (the TPU kernel folds them into Z[0]; for the spectrum of a real
// signal both are rounding noise). float32, with float64-built twiddles:
// the f32 contract of every caller of this path.
//
// The spectrum stage. The spectrum is far larger than L2, so every row
// comes from HBM. A group's FB rows are consecutive rows of one channel,
// one contiguous run of memory: thread 0 copies the next group's rows whole
// into a stage in shared memory (bulk.cuh: cp.async.bulk, completed on an
// mbarrier) as soon as every thread holds the current group's bins in
// registers, past the barrier after those reads (the gate's frame_max
// barrier where a frame spans warps, else one of its own), so the copy
// runs while the group is gated, transformed and overlap-added, and, at an
// item's last group, while the block writes out its strip. A row starts
// 16-byte aligned only every other row: a copy starts at its first row
// rounded down to 16 bytes and ends rounded up, so the stage's rows start
// 0 or 1 float2 in. Each bin crosses from HBM once. One stage, not a ring
// of two or three: a second stage (16 KB at every M) leaves two blocks an
// SM at 1024/256 where the kernel needs three, and two groups in flight
// then cost more than they hide. For the same reason the twiddle table is read
// from device memory (4 KB, held in L1) rather than staged. The strip's
// write-out loads the norm of eight samples a thread before it divides,
// so those loads wait on L2 together, not one after another. While a
// profiler session runs the wrapper passes a tally: each block adds its
// groups and those whose copy had landed when first tested.
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
// guarded w^2 norm (the host's float64 table, cast once). wk and the
// window are staged once a block.
//
// Bound. At the gate's shape (16 x 1876 frames x 513 bins, 480768 samples
// out) it reads 123 MB of spectrum and writes 31 MB, ~0.05 ms at 3.35 TB/s;
// its ~0.9 GFLOP are far from the float32 peak. Its radix-2 form took 8x
// that: log2(M) barrier-separated passes of one butterfly a thread, a
// bit-reversed scatter, twiddles read from device memory per butterfly and
// a separate peak pass. Here a transform takes fr_passes(M) barriers (3 at
// M = 512) and the gate one more where a frame spans warps (M >= 512).
#include "bulk.cuh"
#include "packed.cuh"

// float2 of the stage: a group's FB rows of M + 1 bins, plus the float2
// the rounding to 16 bytes may add at either end, rounded to 16 bytes
// (fft_plan.istft_stage_bytes)
template <int M>
__host__ __device__ constexpr int istft_stage() {
  return (FR_POINTS / M * (M + 1) + 2) & ~1;
}

// Dynamic shared memory of an inverse block (fft_plan.packed_istft_smem):
// the stage, wk (M + 1), two exchange buffers, the window, a peak slot a
// warp and the strip of owned_segments(2M, hop) hops; packed_ola_smem's
// layout with the stage in place of the twiddle table
template <int M>
inline size_t istft_smem(int hop) {
  return (istft_stage<M>() + M + 1 + 2 * FR_POINTS) * sizeof(float2) +
         ((size_t)2 * M + FR_THREADS / 32 +
          (size_t)owned_segments(2 * M, hop) * hop) * sizeof(float);
}

// The inverse's shared memory, carved as istft_smem lays it out; wk and
// the window staged (the caller ends the staging at a barrier)
template <int M>
struct IstftSmem {
  float2 *stage, *wks, *a, *b;
  float *wins, *slots, *strip;
  __device__ __forceinline__ IstftSmem(float2* sm,
                                       const float2* __restrict__ wk,
                                       const float* __restrict__ win) {
    stage = sm;
    wks = stage + istft_stage<M>();
    a = wks + M + 1;
    b = a + FR_POINTS;
    wins = reinterpret_cast<float*>(b + FR_POINTS);
    slots = wins + 2 * M;
    strip = slots + FR_THREADS / 32;
    fr_stage(wks, wk, M + 1);
    for (int i = threadIdx.x; i < 2 * M; i += blockDim.x) wins[i] = win[i];
  }
};

// Thread 0's copy cursor over its block's walk, kept in shared memory so
// that no thread holds it in registers: the next group to copy starts at
// frame f of item (c, s), channel c and its strip s, whose frames end at
// f_hi (StripItem's f_lo..f_hi); items c * per_row + s step by gridDim.x
// and end at strips
struct CopyCursor {
  long long f, f_hi;
  int c, s;
  __device__ __forceinline__ void enter(int seg, int q, int nf) {
    const long long s0 = (long long)s * seg;
    f = max(s0 - (q - 1), 0LL);
    f_hi = min(s0 + (seg - 1), (long long)nf - 1);
  }
  __device__ __forceinline__ bool done(long long strips, int per_row) const {
    return (long long)c * per_row + s >= strips;
  }
  // past the frames of finished items (and of items with none)
  __device__ __forceinline__ void seek(long long strips, int per_row,
                                       int seg, int q, int nf) {
    while (f > f_hi) {
      s += gridDim.x;
      if (s >= per_row) {
        c += s / per_row;
        s %= per_row;
      }
      if (done(strips, per_row)) return;
      enter(seg, q, nf);
    }
  }
};

// spec: (channels, nf, M + 1) one-sided complex; win: (2M,) synthesis
// window; tw: the M-point transform's twiddle table (fft_plan.pass_twiddles);
// wk[k] = exp(-2 pi i k / 2M), k <= M; norm: (output_len,) guarded w^2
// norm; out: (channels, output_len); tally: null, or groups and groups
// found landed, added once a block.
template <int M, bool GATE>
__global__ void __launch_bounds__(FR_THREADS, 3)
istft_kernel(const float2* __restrict__ spec, const float* __restrict__ win,
             const float2* __restrict__ tw, const float2* __restrict__ wk,
             const float* __restrict__ norm, float* __restrict__ out, int nf,
             int hop, int q, long long output_len, int seg,
             int strips_per_row, long long strips, float thresh2,
             unsigned long long* __restrict__ tally) {
  constexpr int T = M / 8, FB = FR_POINTS / M, BINS = M + 1;
  // packed_inverse_regs ends at frame_max's barrier where a frame spans
  // warps
  constexpr bool PEAK_BARRIER = GATE && T > 32;
  extern __shared__ __align__(16) float2 sm[];
  __shared__ __align__(8) uint64_t full;
  __shared__ CopyCursor cur;
  const IstftSmem<M> s(sm, wk, win);
  const int fb = threadIdx.x / T, j = threadIdx.x % T;
  const int strip_len = seg * hop;
  // thread 0: copy the cursor's group into the stage, then step on
  auto issue = [&] {
    CopyCursor k = cur;
    if (k.done(strips, strips_per_row)) return;
    const long long nb = min((long long)FB, k.f_hi - k.f + 1);
    const float2* rows = spec + ((long long)k.c * nf + k.f) * BINS;
    const uintptr_t a = reinterpret_cast<uintptr_t>(rows);
    const uintptr_t lo = a & ~(uintptr_t)15;
    const uintptr_t hi =
        (a + nb * BINS * sizeof(float2) + 15) & ~(uintptr_t)15;
    bulk_load(s.stage, reinterpret_cast<const void*>(lo), (uint32_t)(hi - lo),
              &full);
    k.f += FB;
    k.seek(strips, strips_per_row, seg, q, nf);
    cur = k;
  };
  if (threadIdx.x == 0) {
    bulk_bar_init(&full);
    cur.c = blockIdx.x / strips_per_row;
    cur.s = blockIdx.x % strips_per_row;
    cur.enter(seg, q, nf);
    cur.seek(strips, strips_per_row, seg, q, nf);
  }
  __syncthreads();
  if (threadIdx.x == 0) issue();
  int used = 0, ready = 0;
  for (long long g = blockIdx.x; g < strips; g += gridDim.x) {
    const StripItem<> it(g, strips_per_row, seg, q, nf);
    for (int t = threadIdx.x; t < strip_len; t += FR_THREADS)
      s.strip[t] = 0.f;
    const float2* xc = spec + (long long)it.c * nf * BINS;
    for (long long f0 = it.f_lo; f0 <= it.f_hi; f0 += FB) {
      ready += bulk_wait(&full, used++ & 1);
      const long long f = f0 + fb;
      float2 x[8], r[8];
      if (f <= it.f_hi) {
        const float2* xf =
            s.stage +
            ((reinterpret_cast<uintptr_t>(xc + f0 * BINS) & 15) >> 3) +
            fb * BINS;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x[u] = xf[j + u * T];
          r[u] = xf[M - j - u * T];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = r[u] = make_float2(0.f, 0.f);
      }
      float2 v[8];
      packed_inverse_regs<M, GATE>(v, x, r, j, s.wks, thresh2, s.slots);
      // every read of the stage is behind a barrier: the next group's
      // rows may land
      if constexpr (!PEAK_BARRIER) __syncthreads();
      if (threadIdx.x == 0) issue();
      fr_fft<M>(v, j, tw, s.a + fb * M, s.b + fb * M);
      const int nb = (int)min((long long)FB, it.f_hi - f0 + 1);
      ola_strip(PackedSample<M>{fr_result<M>(s.a, s.b)}, s.strip, nb,
                (f0 - it.s0) * hop, strip_len, 2 * M, hop, s.wins);
    }
    float* oc = out + (long long)it.c * output_len;
    const long long g0 = it.s0 * hop;
    // eight samples' norms in flight at once, then their quotients
    for (int t0 = threadIdx.x; t0 < strip_len; t0 += 8 * FR_THREADS) {
      float nv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = t0 + u * FR_THREADS;
        const long long o = g0 + t;
        nv[u] = t < strip_len && o < output_len ? __ldg(norm + o) : 1.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = t0 + u * FR_THREADS;
        const long long o = g0 + t;
        if (t < strip_len && o < output_len) oc[o] = s.strip[t] / nv[u];
      }
    }
  }
  if (tally && threadIdx.x == 0) {
    atomicAdd(tally, (unsigned long long)used);
    atomicAdd(tally + 1, (unsigned long long)ready);
  }
}

template <int M, bool GATE>
static cudaError_t launch_istft(const void* spec, const float* win,
                                const void* tw, const void* wk,
                                const float* norm, float* out, int channels,
                                int nf, int hop, long long output_len,
                                float thresh2, size_t smem, int device,
                                cudaStream_t stream,
                                unsigned long long* tally) {
  if (smem != istft_smem<M>(hop)) return cudaErrorInvalidValue;
  const int seg = owned_segments(2 * M, hop);
  const long long segs = (output_len + hop - 1) / hop;
  const long long per_row = (segs + seg - 1) / seg;
  return fr_launch<istft_kernel<M, GATE>>(
      smem, per_row * channels, device, stream, (const float2*)spec, win,
      (const float2*)tw, (const float2*)wk, norm, out, nf, hop, 2 * M / hop,
      output_len, seg, (int)per_row, per_row * channels, thresh2, tally);
}

// The geometries the launcher takes: power-of-two nfft in [256, 4096], hop
// a divisor of nfft (istft_supported). smem: the host plan's
// (fft_plan.packed_istft_smem), which the launcher checks against its own
// reckoning of the layout. tally: null, or two counters on the device
// (istft_kernels.ring_tally).
extern "C" int vv_istft(const void* spec, const float* win, const void* tw,
                        const void* wk, const float* norm, float* out,
                        int channels, int nf, int nfft, int hop,
                        long long output_len, int gate, float thresh2,
                        long long smem, int device, void* stream,
                        void* tally) {
  if (nfft < 256 || nfft > 4096 || (nfft & (nfft - 1)) || hop < 1 ||
      nfft % hop || nf < 1 || output_len < 1 || channels < 1 ||
      channels > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* t = (unsigned long long*)tally;
#define VV_ISTFT(M)                                                          \
  return (int)(gate ? launch_istft<M, true>(spec, win, tw, wk, norm, out,   \
                                            channels, nf, hop, output_len,  \
                                            thresh2, (size_t)smem, device,  \
                                            s, t)                           \
                    : launch_istft<M, false>(spec, win, tw, wk, norm, out,  \
                                             channels, nf, hop, output_len, \
                                             thresh2, (size_t)smem, device, \
                                             s, t))
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
