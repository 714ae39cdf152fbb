// Power spectrogram as a windowed-DFT product: |rfft(w * frame)|^2 of every
// frame, the frames never formed, on the tensor cores.
//
// dft_power_kernel replaces _stft_power_kernel of
// vv_dsp_tpu/ops/pallas_kernels.py (launcher stft_power_pallas).
//
// Frame f of channel c is x[f*hop, f*hop + nfft), zero past n. With the
// window folded into the r2c basis (built in float64 on the host and cast
// once), the spectrum is one product
//   X[f, :] = sum_j A[f, j] B[j, :],  A[f, j] = x[f*hop + j],
// A a view of the signal with row stride hop: the TPU kernel's q =
// nfft/hop shifted (frames x hop) @ (hop x bins) products of the
// hop-blocked signal are the q hop-long stretches of the depth here. B
// interleaves the basis's columns, B[j, 2k] = Re, B[j, 2k + 1] = Im, so a
// thread's accumulator holds both parts of a bin in adjacent registers and
// writes re^2 + im^2 from them. The product runs at the f32 tier of
// mma_tiers.cuh: six bf16 products of three-part operands, the JAX
// kernel's default HIGHEST.
//
// Bound. The function reads the signal and writes the power, 92 MB at
// 1024/256 on 16 x 1873 frames (0.028 ms at 3.35 TB/s): device memory
// bounds it, as it does the packed power kernel of stft.cu. This form does
// 2 x 2 x nfft operations a bin, O(nfft) where an FFT does O(log nfft):
// 62.97 GFLOP a product, six products 378 GFLOP, 0.382 ms at the tensor
// cores' 989 TFLOP/s, a floor of the form, not of the function. The form
// exists because it is one GEMM (the TPU's matrix unit runs it at its full
// rate); on the CUDA cores it ran at their float32 ceiling, so the product
// moves to the tensor cores.
//
// Design: a block computes 128 frames x 96 interleaved columns (48 bins)
// as two warpgroups of 64 x 96, each issuing wgmma.mma_async m64n96k16
// with A from registers and B from shared memory (mma_tiers.cuh). It steps
// through the depth 32 samples (a chunk) at a time, in the order that lets
// one tile of signal serve up to q = nfft/hop chunks (see
// dft_power_kernel): the tile (128 + q - 1 rows of 32 samples, one 16-byte
// cp.async a thread and row where aligned) is copied in once, split once
// into its bf16 parts (rows padded to 40 elements, so ldmatrix's 8 rows
// hit 8 distinct bank groups), and read q times, so the signal crosses
// from L2 once per column block and not q times. Where q is too large for
// such a tile to fit a block (q >= 104), the host plan splits the q
// chunks over the fewest tiles that fit (ops/mma_plan.py dft_plan). B's parts (built on the host in core-matrix
// layout, 18 KB a chunk) arrive by three bulk copies (cp.async.bulk, one
// thread, an mbarrier a buffer) three chunks ahead (cp.async of 16 bytes
// a thread ran slower on an H100). A chunk's products are issued from one
// of two sets of fragment registers while the previous chunk's still run.
// The hi*hi sum restarts every 4 chunks and is added into a float32
// total: the tensor cores round a running sum toward zero at each
// product, a bias that grew with nfft (9e-6 of max power at 4096 points
// over one running sum). The basis's columns past bin nfft/2 are zero and
// their power is never written.
#include "mma_tiers.cuh"

constexpr int DP_THREADS = 256;           // two warpgroups
constexpr int DP_BM = 128;                // frames a block, 64 a warpgroup
constexpr int DP_BN = 96;                 // interleaved columns a block
constexpr int DP_KC = 32;                 // depth a chunk
constexpr int DP_AHEAD = 3;               // chunks in flight ahead
constexpr int DP_BBUFS = DP_AHEAD + 2;    // B chunks: + the one read, the
                                          // one whose products may run
constexpr int DP_FLUSH = 4;               // chunks a hi*hi partial sum
constexpr int DP_ASTRIDE = DP_KC + 8;     // A row in shared memory
constexpr int DP_B_ELEMS = DP_KC * DP_BN;        // one part of a B chunk
constexpr int DP_ACC = DP_BN / 2;                // accumulator registers

// The shared memory of a launch with q = nfft / hop chunks served by
// `tiles` sample tiles, each serving q / tiles of them (rounded up or
// down): two tiles of A's parts and raw_bufs tiles of its samples (as many
// as may be in flight DP_AHEAD chunks ahead), rows each, and DP_BBUFS B
// chunks.
struct DpLayout {
  int rows, raw_bufs, parts_elems, raw_floats;
  size_t bytes;
  __host__ __device__ DpLayout(int q, int tiles)
      : rows(DP_BM + (q + tiles - 1) / tiles - 1),
        raw_bufs((DP_AHEAD + q / tiles - 1) / (q / tiles)),
        parts_elems(rows * DP_ASTRIDE),
        raw_floats(rows * DP_KC),
        bytes((size_t)2 * (2 * 3 * parts_elems + DP_BBUFS * 3 * DP_B_ELEMS) +
              (size_t)4 * raw_bufs * raw_floats) {}
};

// 16 bytes, of which the first `bytes` are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes, or zeros where ok is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Chunk i of the depth order -> o, r, its sample tile and that tile's
// first r (ops/mma_plan.py dft_chunk_tile): the q chunks of stretch o are
// split over `tiles` tiles, the first q % tiles of them one chunk longer
// (MULTI), or all served by tile o.
template <bool MULTI>
struct DpChunk {
  int o, r, tile, r0;
  __device__ DpChunk(int i, int q, int tiles) {
    o = i / q;
    r = i - o * q;
    if (!MULTI) {
      tile = o;
      r0 = 0;
      return;
    }
    const int base = q / tiles, extra = q - base * tiles;
    const int t = r < extra * (base + 1)
                      ? r / (base + 1)
                      : extra + (r - extra * (base + 1)) / base;
    tile = o * tiles + t;
    r0 = t * base + min(t, extra);
  }
};

// x: (channels, n); bparts: (3, cols/DP_BN, nfft/DP_KC, DP_BN/8, DP_KC/8,
// 8, 8) bf16 (ops/mma_plan.py dft_parts_np); out: (channels, nf, bins).
// The depth runs in the order of chunk i = o q + r: samples o DP_KC ..
// o DP_KC + 31 of hop block r of every frame, so frame f's samples of
// chunk i are the samples of frame f + r at chunk o q: one tile of rows
// (f_base + r0 + R) hop + o DP_KC serves a run of chunks r0 <= r of
// stretch o, frame f reading row f - f_base + r - r0.
template <bool MULTI>
__global__ void __launch_bounds__(DP_THREADS, 1)
dft_power_kernel(const float* __restrict__ x,
                 const __nv_bfloat16* __restrict__ bparts,
                 float* __restrict__ out, long long n, int nf, int nfft,
                 int hop, int bins, int cols, int tiles) {
  extern __shared__ __align__(128) __nv_bfloat16 dp_smem[];
  const int q = nfft / hop, per_hop = hop / DP_KC;
  const DpLayout lay(q, MULTI ? tiles : 1);
  // [2][3] A parts | [DP_BBUFS][3] B chunks | [raw_bufs] sample tiles
  __nv_bfloat16* a_parts = dp_smem;
  __nv_bfloat16* b_bufs = dp_smem + 2 * 3 * lay.parts_elems;
  float* raw = reinterpret_cast<float*>(b_bufs + DP_BBUFS * 3 * DP_B_ELEMS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f_base = blockIdx.x * DP_BM, nt = blockIdx.y, c = blockIdx.z;
  const int chunks = nfft / DP_KC;
  // b_bar[k]: B buffer k's bulk copies have landed (one phase a use)
  __shared__ __align__(8) uint64_t b_bar[DP_BBUFS];
  if (tid == 0) {
    for (int k = 0; k < DP_BBUFS; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_addr(&b_bar[k])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const float* xc = x + (long long)c * n;
  // a thread's 4 samples of a row are one 16-byte copy where aligned
  const bool wide = ((uintptr_t)xc & 15) == 0 && (hop & 3) == 0;
  const long long part_stride = (long long)(cols / DP_BN) * chunks *
                                DP_B_ELEMS;
  const __nv_bfloat16* bsrc = bparts + (long long)nt * chunks * DP_B_ELEMS;

  // a thread's samples of a tile: rows tid/8 + 32 i, columns 4 (tid % 8)
  // .. + 3; it copies them in (cp.async) and later splits them itself
  const int a_row = tid >> 3, a_col = (tid & 7) * 4;
  // the group of chunk i: its B parts and, at a tile's first chunk, that
  // tile's samples
  auto issue = [&](int i) {
    if (i < chunks) {
      const DpChunk<MULTI> k(i, q, tiles);
      const int o = k.o, r = k.r;
      if (r == k.r0) {
        float* t = raw + (k.tile % lay.raw_bufs) * lay.raw_floats;
        for (int row = a_row; row < lay.rows; row += DP_THREADS / 8) {
          const long long s0 = (long long)(f_base + k.r0 + row) * hop +
                               o * DP_KC + a_col;
          float* dst = t + row * DP_KC + a_col;
          if (wide) {
            const long long left = n - s0;
            const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
            cp_async16(dst, bytes ? xc + s0 : xc, bytes);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cp_async4(dst + e, s0 + e < n ? xc + s0 + e : xc, s0 + e < n);
          }
        }
      }
      __nv_bfloat16* b = b_bufs + (i % DP_BBUFS) * 3 * DP_B_ELEMS;
      const long long kc = (long long)r * per_hop + o;   // depth chunk
      if (tid == 0) {
        const uint32_t bar = smem_addr(&b_bar[i % DP_BBUFS]);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(3 * DP_B_ELEMS * 2));
        for (int p = 0; p < 3; ++p)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                  smem_addr(b + p * DP_B_ELEMS)),
              "l"(bsrc + p * part_stride + kc * DP_B_ELEMS),
              "r"(DP_B_ELEMS * 2), "r"(bar)
              : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // tile `tile`'s samples, this thread's, into their bf16 parts
  auto split = [&](int tile) {
    const float* t = raw + (tile % lay.raw_bufs) * lay.raw_floats;
    __nv_bfloat16* a = a_parts + (tile & 1) * 3 * lay.parts_elems;
    for (int row = a_row; row < lay.rows; row += DP_THREADS / 8) {
      const float4 v = *reinterpret_cast<const float4*>(
          t + row * DP_KC + a_col);
      uint32_t lo[3], hi[3];
      split_parts<3>(v.x, v.y, lo);
      split_parts<3>(v.z, v.w, hi);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(a + p * lay.parts_elems +
                                  row * DP_ASTRIDE + a_col) =
            make_uint2(lo[p], hi[p]);
    }
  };

  // hh: the hi*hi sum of DP_FLUSH chunks; total: those sums, added in
  // float32 (rounded to nearest); corr: the other products
  float hh[DP_ACC], corr[DP_ACC], total[DP_ACC];
#pragma unroll
  for (int i = 0; i < DP_ACC; ++i) hh[i] = corr[i] = total[i] = 0.f;
  // warp w's 16 rows: frames 16 w + (lane & 15) of the block
  const int a_off = a_lane_offset(lane, DP_ASTRIDE) + warp * 16 * DP_ASTRIDE;
  // two sets of A fragments: chunk i's products read set i & 1
  uint32_t af[2][DP_KC / 16][3][4];
  auto run = [&](int set, int i) {
    const DpChunk<MULTI> k(i, q, tiles);
    const __nv_bfloat16* a = a_parts + (k.tile & 1) * 3 * lay.parts_elems +
                             (k.r - k.r0) * DP_ASTRIDE;
    const __nv_bfloat16* b = b_bufs + (i % DP_BBUFS) * 3 * DP_B_ELEMS;
#pragma unroll
    for (int ks = 0; ks < DP_KC / 16; ++ks)
#pragma unroll
      for (int p = 0; p < 3; ++p)
        ldmatrix_x4(af[set][ks][p],
                    smem_addr(a + p * lay.parts_elems + a_off) + ks * 32);
    if (i % DP_FLUSH == 0 && i > 0) {
      wgmma_wait<0>();
      fence_regs(hh);
#pragma unroll
      for (int k = 0; k < DP_ACC; ++k) total[k] += hh[k];
    }
    fence_regs(corr);
    fence_regs(hh);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP_KC / 16; ++ks) {
      uint64_t bd[3];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        bd[p] = wgmma_desc(smem_addr(b + p * DP_B_ELEMS) + ks * 256, 128,
                           (DP_KC / 8) * 128);
      tier_wgmma<ALG_F32>(hh, corr, af[set][ks], bd,
                          ks > 0 || i % DP_FLUSH != 0);
    }
    wgmma_commit();
  };

  // group g holds chunk g's B and, where g starts a tile, that tile's
  // samples; the tile is split once group g has arrived, before chunk g
  for (int i = 0; i < DP_AHEAD; ++i) issue(i);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(DP_AHEAD - 1));
  split(0);
  for (int i0 = 0; i0 < chunks; i0 += 2) {
#pragma unroll
    for (int set = 0; set < 2; ++set) {
      const int i = i0 + set;
      if (i >= chunks) break;
      // groups up to i + 1 have arrived: chunk i's B, and the samples of
      // the tile chunk i + 1 starts, if it starts one
      asm volatile("cp.async.wait_group %0;\n" ::"n"(DP_AHEAD - 2));
      {
        const uint32_t bar = smem_addr(&b_bar[i % DP_BBUFS]);
        const uint32_t phase = (i / DP_BBUFS) & 1;
        uint32_t done = 0;
        while (!done)
          asm volatile(
              "{\n.reg .pred p;\n"
              "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              "selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(bar), "r"(phase)
              : "memory");
      }
      __syncthreads();
      // buffers of chunk i - 1, whose products completed (wait_group 1)
      // before every thread reached the barrier, take chunk i + DP_AHEAD;
      // a sample buffer is reused raw_bufs tiles later, after its split
      issue(i + DP_AHEAD);
      run(set, i);
      // the next tile's parts go to the other parts buffer, last read by
      // the chunks before this barrier
      if (i + 1 < chunks) {
        const DpChunk<MULTI> k(i + 1, q, tiles);
        if (k.r == k.r0) split(k.tile);
      }
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  fence_regs(corr);
  fence_regs(hh);
#pragma unroll
  for (int i = 0; i < DP_ACC; ++i) total[i] += hh[i];

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f_base + warp * 16 + g + 8 * h;
    if (f >= nf) continue;
    float* o = out + ((long long)c * nf + f) * bins;
#pragma unroll
    for (int j = 0; j < DP_BN / 8; ++j) {
      const int k = (nt * DP_BN + j * 8) / 2 + t;
      const float re = total[4 * j + 2 * h] + corr[4 * j + 2 * h];
      const float im = total[4 * j + 2 * h + 1] + corr[4 * j + 2 * h + 1];
      if (k < bins) o[k] = re * re + im * im;
    }
  }
}

// tiles: the sample tiles a stretch's q = nfft / hop chunks are split over,
// smem: the layout's shared memory, both from ops/mma_plan.py dft_plan
extern "C" int vv_dft_power(const float* x, const void* bparts, float* out,
                            int channels, long long n, int nf, int nfft,
                            int hop, int bins, int cols, int tiles, int smem,
                            int device, void* stream) {
  if (hop < DP_KC || hop % DP_KC || nfft % hop || nf < 1 || n < 1 ||
      channels < 1 || channels > 65535 || cols % DP_BN || bins < 1 ||
      2 * bins > cols || tiles < 1 || tiles > nfft / hop)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const DpLayout lay(nfft / hop, tiles);
  // the plan's count must be this layout's, or what it reports is not
  // what runs
  if (lay.bytes != (size_t)smem) return (int)cudaErrorInvalidValue;
  // one tile serves a stretch's q chunks (q <= 103), or several
  auto kern = tiles == 1 ? dft_power_kernel<false> : dft_power_kernel<true>;
  // a layout beyond what one block may hold is refused here
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid((unsigned)((nf + DP_BM - 1) / DP_BM),
                  (unsigned)(cols / DP_BN), (unsigned)channels);
  kern<<<grid, DP_THREADS, lay.bytes, (cudaStream_t)stream>>>(
      x, static_cast<const __nv_bfloat16*>(bparts), out, n, nf, nfft, hop,
      bins, cols, tiles);
  return (int)cudaGetLastError();
}
