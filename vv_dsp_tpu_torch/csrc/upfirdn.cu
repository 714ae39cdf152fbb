// Banded upfirdn: the fused FIR + polyphase-resample head of the north-star
// chain, on the tensor cores.
//
// Replaces vv_dsp_tpu/ops/pallas_upfirdn.py::_kern (launcher
// upfirdn_banded_pallas). Computes, for each channel c and output k,
//   y[c, k] = sum_j x[c, j] * g[offset + k*down - j*up],   x = 0 outside [0, n)
// in its polyphase form: with t = offset + k*down, a = t / up, p = t % up,
//   y[c, k] = sum_i x[c, a - i] * taps[p, i],   taps[p, i] = g[p + i*up],
// written in natural (c, n_out) order, at the dot-algorithm tier the
// caller names (mma_tiers.cuh).
//
// Bound: at the chain's shape (16 x 638,976 outputs, 1,044 taps per phase)
// the call is ~10.7 G multiply-adds: 3 bf16 products each at bf16x3
// (0.065 ms at the tensor cores' 989 TFLOP/s), 6 at f32 (0.130 ms), 1 at
// bf16; operations bound it, its 72 MB of traffic far less. The TPU kernel
// runs the band as a matrix product on its matrix unit; the CUDA cores
// reached 13 TFLOP/s here, so the product moves to the tensor cores.
//
// Design: the function is one GEMM (ops/mma_plan.py): outputs in frames of
// n_real = group * up, frame f reading input from c_lo + f * stride
// (stride = group * down), times one band matrix B (k_pad x n_pad) whose
// columns hold the phases' taps at their lags, the same for every frame.
// A is then a Hankel view of the signal: a block stages its frames' input
// window once, split into the tier's bf16 parts, and each lane's ldmatrix
// row is a pointer into it, so no frame is copied. The host plan picks the
// group so that stride is an odd multiple of 8 (16-byte aligned rows on
// distinct bank groups) at the least zero fill. B's parts (built in
// float64 on the host, cast once, in core-matrix layout) stay resident in
// shared memory, loaded once by a persistent block that walks its row
// tiles, holding the first 32 samples a thread of the next tile's window
// in registers while it multiplies the current one; a frame wider than 64
// outputs, or a B slice too large for a block, is cut into column blocks.
// A block is 4 warps, each MT x NT tiles of 16 x 8, multiplied by
// mma.sync.m16n8k16; in bands deeper than 2,048 the hi*hi sum restarts
// every 1,024 of depth into a float32 total (mma_tiers.cuh WarpAcc: at
// 16,384 taps one running sum erred by 2.4e-5 of scale on an H100, beyond
// the 1e-5 contract). Where no column slice of B fits beside its window
// (long filters), the depth runs in chunks: each chunk's slice of B and
// its part of the window are staged in turn, the accumulators kept. Where
// the window itself does not fit (a large stride), A's rows are copied,
// each k_chunk + 8 elements apart, instead of read from a window. The plan
// chooses all of it (the group, NT and the column blocks, MT, the chunk,
// A's pitch and window); the launcher only dispatches. Outputs past n_out
// and columns past n_real are not stored; the window is zero outside the
// signal.
#include "mma_tiers.cuh"

constexpr int UF_WARPS = 4;
constexpr int UF_THREADS = 32 * UF_WARPS;
constexpr int UF_PF = 16;   // sample pairs a thread prefetches (4,096 a
                            // block: the chain head's window is 4,120)

// A launch as the host plan gives it
struct UfArgs {
  const float* x;             // (channels, n_in)
  const __nv_bfloat16* b;     // B's parts, (parts, n_pad/8, k_pad/8, 8, 8)
  float* y;                   // (channels, n_out)
  long long n_in, n_out, c_lo;
  int channels, n_real, n_pad, stride, k_pad, k_chunk, a_pitch, win,
      flush, smem, row_tiles;
};

// Samples s, s + 1 (zero outside [0, n_in)) split into their P bf16 parts
// at ws[p * win + j]
template <int P>
__device__ __forceinline__ void stage_pair(const float* __restrict__ xc,
                                           long long n_in, long long s,
                                           __nv_bfloat16* ws, int win,
                                           int j) {
  const float v0 = (s >= 0 && s < n_in) ? xc[s] : 0.f;
  const float v1 = (s + 1 >= 0 && s + 1 < n_in) ? xc[s + 1] : 0.f;
  uint32_t parts[P];
  split_parts<P>(v0, v1, parts);
#pragma unroll
  for (int p = 0; p < P; ++p)
    *reinterpret_cast<uint32_t*>(ws + p * win + j) = parts[p];
}

// Elements j >= first of a pass's A from sample s0: a window (a_pitch ==
// stride, element j is sample s0 + j) or rows of a_pitch elements, stride
// samples apart; a function of its own (inlined, its 64-bit indices made
// ptxas spill in the product loop). a_pitch is even, so a pair never
// straddles two rows.
template <int P>
__device__ __noinline__ void stage_window(const float* __restrict__ xc,
                                          long long n_in, long long s0,
                                          __nv_bfloat16* ws, int win,
                                          int first, int a_pitch,
                                          int stride) {
  if (a_pitch == stride) {
    for (int j = first + 2 * threadIdx.x; j < win; j += 2 * UF_THREADS)
      stage_pair<P>(xc, n_in, s0 + j, ws, win, j);
  } else {
    for (int j = first + 2 * threadIdx.x; j < win; j += 2 * UF_THREADS)
      stage_pair<P>(xc, n_in,
                    s0 + (long long)(j / a_pitch) * stride + j % a_pitch, ws,
                    win, j);
  }
}

// Depth chunk kc of column block cb's slice of B's P parts, into bs laid
// out [P][NT][k_chunk/8][8][8]
template <int P, int NT>
__device__ __noinline__ void stage_b(const __nv_bfloat16* __restrict__ b,
                                     __nv_bfloat16* bs, int n_pad, int k_pad,
                                     int k_chunk, int cb, int kc) {
  const int kg = k_pad / 8, kgc = k_chunk / 8, row = kgc * 8;  // uint4s
  for (int i = threadIdx.x; i < P * NT * row; i += UF_THREADS) {
    const int pn = i / row, r = i - pn * row;
    const int p = pn / NT, n = pn - p * NT;
    const uint4* src = reinterpret_cast<const uint4*>(
        b + (((long long)p * (n_pad / 8) + cb * NT + n) * kg + kc * kgc) *
                64);
    reinterpret_cast<uint4*>(bs + pn * kgc * 64)[r] = src[r];
  }
}

// (UF_THREADS, 1): left to its default, ptxas held the wide instances to
// 128 registers and spilled. FLUSH: the hi*hi sum restarts every g.flush
// 16-deep steps (deep bands; its total costs the registers that held the
// chain head's bf16x3 instance 20% slower on an H100, so it is an instance
// of its own)
template <int ALG, int NT, int MT, bool FLUSH>
__global__ void __launch_bounds__(UF_THREADS, 1)
upfirdn_mma_kernel(const UfArgs g) {
  constexpr int P = Tier<ALG>::PARTS;
  constexpr int BM = 16 * MT * UF_WARPS;
  extern __shared__ __align__(16) __nv_bfloat16 uf_smem[];
  const int kgc = g.k_chunk / 8, chunks = g.k_pad / g.k_chunk;
  const int b_elems = NT * kgc * 64;          // one part of a B chunk
  __nv_bfloat16* bs = uf_smem;                // [P][NT][kgc][8][8]
  __nv_bfloat16* ws = uf_smem + P * b_elems;  // [P][win]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cb = blockIdx.y, items = g.row_tiles * g.channels;

  // B's column slice, once, where it is resident
  if (chunks == 1) stage_b<P, NT>(g.b, bs, g.n_pad, g.k_pad, g.k_chunk, cb, 0);

  // lane addresses of part p at depth 0: A at this warp's first row, B
  uint32_t a_base[3], b_base[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int q = p < P ? p : 0;
    a_base[p] = smem_addr(ws + q * g.win + a_lane_offset(lane, g.a_pitch) +
                          warp * 16 * MT * g.a_pitch);
    b_base[p] = smem_addr(bs + q * b_elems + b_lane_offset(lane, kgc));
  }
  const uint32_t m_step = 16 * g.a_pitch * 2, pair_step = 2 * kgc * 64 * 2;
  const long long frames = (g.n_out + g.n_real - 1) / g.n_real;

  // first sample of depth chunk kc of a tile
  auto pass_start = [&](int tile, int kc) {
    const int c = tile / g.row_tiles;
    return g.c_lo + (long long)(tile - c * g.row_tiles) * BM * g.stride +
           (long long)kc * g.k_chunk;
  };
  // a thread's first UF_PF sample pairs of a pass's window, loaded while
  // the pass before it is multiplied (none where A's rows are copied)
  const bool window = g.a_pitch == g.stride;
  const int pf_elems = window ? 2 * UF_PF * UF_THREADS : 0;
  float pf[2 * UF_PF];
  auto prefetch = [&](int tile, int kc) {
    if (tile >= items || !window) return;
    const float* xc = g.x + (long long)(tile / g.row_tiles) * g.n_in;
    const long long s0 = pass_start(tile, kc);
#pragma unroll
    for (int u = 0; u < UF_PF; ++u) {
      const int j = 2 * (threadIdx.x + u * UF_THREADS);
      const long long s = s0 + j;
      pf[2 * u] = (j < g.win && s >= 0 && s < g.n_in) ? xc[s] : 0.f;
      pf[2 * u + 1] =
          (j < g.win && s + 1 >= 0 && s + 1 < g.n_in) ? xc[s + 1] : 0.f;
    }
  };

  prefetch(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < items; tile += gridDim.x) {
    const int c = tile / g.row_tiles;
    const long long f0 = (long long)(tile - c * g.row_tiles) * BM;
    const bool active = f0 + warp * 16 * MT < frames;
    WarpAcc<MT, NT> acc;
    acc.zero();
    for (int kc = 0; kc < chunks; ++kc) {
      __syncthreads();  // the previous pass's A and B are no longer read
#pragma unroll
      for (int u = 0; u < UF_PF; ++u) {
        const int j = 2 * (threadIdx.x + u * UF_THREADS);
        if (j < pf_elems && j < g.win) {
          uint32_t parts[P];
          split_parts<P>(pf[2 * u], pf[2 * u + 1], parts);
#pragma unroll
          for (int p = 0; p < P; ++p)
            *reinterpret_cast<uint32_t*>(ws + p * g.win + j) = parts[p];
        }
      }
      if (g.win > pf_elems)
        stage_window<P>(g.x + (long long)c * g.n_in, g.n_in,
                        pass_start(tile, kc), ws, g.win, pf_elems,
                        g.a_pitch, g.stride);
      if (chunks > 1)
        stage_b<P, NT>(g.b, bs, g.n_pad, g.k_pad, g.k_chunk, cb, kc);
      __syncthreads();
      if (kc + 1 < chunks)
        prefetch(tile, kc + 1);
      else
        prefetch(tile + gridDim.x, 0);
      if (!active) continue;
      auto step = [&](int ks) {
        uint32_t a_s[3], b_s[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          a_s[p] = a_base[p] + ks * 32;
          b_s[p] = b_base[p] + ks * 256;
        }
        tier_step<ALG, MT, NT>(acc, a_s, b_s, m_step, pair_step);
      };
      if constexpr (FLUSH) {
        for (int k0 = 0; k0 < kgc / 2; k0 += g.flush) {
          const int k1 = min(k0 + g.flush, kgc / 2);
          for (int ks = k0; ks < k1; ++ks) step(ks);
          acc.flush();
        }
      } else {
        // one flat loop: split into blocks, it ran 10% slower on an H100
        for (int ks = 0; ks < kgc / 2; ++ks) step(ks);
      }
    }
    if (!active) continue;

    // a thread's two adjacent columns are one 8-byte store where every
    // output pair is aligned (n_out and n_real even)
    float* yc = g.y + (long long)c * g.n_out;
    const bool pairs = (g.n_out & 1) == 0 && (g.n_real & 1) == 0;
    const int gi = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long f = f0 + warp * 16 * MT + m * 16 + gi + h * 8;
          const int col = (cb * NT + n) * 8 + 2 * t;
          const long long k = f * g.n_real + col;
          const float v0 = acc.sum(m, n, 2 * h), v1 = acc.sum(m, n, 2 * h + 1);
          if (pairs && col < g.n_real && k + 1 < g.n_out) {
            *reinterpret_cast<float2*>(yc + k) = make_float2(v0, v1);
          } else {
            if (col < g.n_real && k < g.n_out) yc[k] = v0;
            if (col + 1 < g.n_real && k + 1 < g.n_out) yc[k + 1] = v1;
          }
        }
  }
}

template <int ALG, int NT, int MT, bool FLUSH>
static cudaError_t launch_mma(UfArgs g, int device, cudaStream_t s) {
  constexpr int P = Tier<ALG>::PARTS;
  constexpr int BM = 16 * MT * UF_WARPS;
  if ((long long)(BM - 1) * g.a_pitch + g.k_chunk > g.win)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * P * ((size_t)NT * g.k_chunk * 8 + g.win);
  // the plan's count of these bytes (ops/mma_plan.py upfirdn_smem_bytes)
  // must be this layout's, or what it reports is not what runs
  if (smem != (size_t)g.smem) return cudaErrorInvalidValue;
  auto kern = upfirdn_mma_kernel<ALG, NT, MT, FLUSH>;
  // a layout beyond what one block may hold is refused here
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, UF_THREADS,
                                                smem);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int col_blocks = g.n_pad / (8 * NT);
  const long long frames = (g.n_out + g.n_real - 1) / g.n_real;
  g.row_tiles = (int)((frames + BM - 1) / BM);
  const long long want = (long long)g.row_tiles * g.channels;
  const long long room = std::max(1LL, (long long)sms * per_sm / col_blocks);
  const dim3 grid((unsigned)std::min(want, room), (unsigned)col_blocks);
  kern<<<grid, UF_THREADS, smem, s>>>(g);
  return cudaGetLastError();
}

// MT = 2 exists where its accumulators and fragments fit the registers
// (NT * parts <= 12) and the hi*hi sum runs the whole depth; a flushed one
// runs MT = 1
template <int ALG, int NT>
static cudaError_t launch_nt(int mt, const UfArgs& g, int device,
                             cudaStream_t s) {
  if (g.flush > 0)
    return mt == 1 ? launch_mma<ALG, NT, 1, true>(g, device, s)
                   : cudaErrorInvalidValue;
  if (mt == 1) return launch_mma<ALG, NT, 1, false>(g, device, s);
  if constexpr (NT * Tier<ALG>::PARTS <= 12) {
    if (mt == 2) return launch_mma<ALG, NT, 2, false>(g, device, s);
  }
  return cudaErrorInvalidValue;
}

template <int ALG>
static cudaError_t launch_alg(int nt, int mt, const UfArgs& g, int device,
                              cudaStream_t s) {
#define VV_UF_NT(NT) \
  case NT: return launch_nt<ALG, NT>(mt, g, device, s)
  switch (nt) {
    VV_UF_NT(1); VV_UF_NT(2); VV_UF_NT(3); VV_UF_NT(4);
    VV_UF_NT(5); VV_UF_NT(6); VV_UF_NT(7); VV_UF_NT(8);
    default: return cudaErrorInvalidValue;
  }
#undef VV_UF_NT
}

// x: (channels, n_in) float32; bparts: the tier's parts of B, (parts,
// n_pad/8, k_pad/8, 8, 8) bf16 (ops/mma_plan.py band_parts); y: (channels,
// n_out). The rest is the plan (ops/mma_plan.py upfirdn_plan): n_tiles n8
// tiles a block, n_pad / (8 n_tiles) column blocks, m_tiles 16-row tiles a
// warp, the depth in k_pad / k_chunk chunks, A's rows a_pitch elements
// apart in a staged pass of win elements, the hi*hi sum restarted every
// flush 16-deep steps (0: one sum), smem bytes of shared memory.
extern "C" int vv_upfirdn(const float* x, const void* bparts, float* y,
                          int channels, long long n_in, long long n_out,
                          int up, int down, long long offset, int taps_pp,
                          int n_real, int n_tiles, int n_pad, int stride,
                          int k_pad, int k_chunk, int m_tiles, int a_pitch,
                          int win, int flush, int smem, long long c_lo,
                          int algorithm,
                          int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (up < 1 || down < 1 || offset < 0 || taps_pp < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles < 1 || n_tiles > 8 || n_pad % (8 * n_tiles) ||
      n_real > n_pad || n_real != n_real / up * up ||
      stride != n_real / up * down || k_chunk < 16 || k_chunk % 16 ||
      k_pad < k_chunk || k_pad % k_chunk || a_pitch % 8 ||
      (a_pitch != stride && a_pitch < k_chunk) || win % 8 || flush < 0 ||
      channels < 1 || channels > 65535 || n_in < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const UfArgs g{x, static_cast<const __nv_bfloat16*>(bparts), y, n_in,
                 n_out, c_lo, channels, n_real, n_pad, stride, k_pad,
                 k_chunk, a_pitch, win, flush, smem, 0};
  switch (algorithm) {
    case ALG_F32:
      return (int)launch_alg<ALG_F32>(n_tiles, m_tiles, g, device, s);
    case ALG_BF16X3:
      return (int)launch_alg<ALG_BF16X3>(n_tiles, m_tiles, g, device, s);
    case ALG_BF16:
      return (int)launch_alg<ALG_BF16>(n_tiles, m_tiles, g, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
