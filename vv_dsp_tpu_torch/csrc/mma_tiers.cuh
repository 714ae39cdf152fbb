// The tensor-core product core of the banded upfirdn (upfirdn.cu) and the
// windowed-DFT power (dft_power.cu): the dot-algorithm tiers as bf16
// operand parts, bf16 in and float32 accumulate, multiplied by
// mma.sync.m16n8k16 on a warp's 16 x 8 tiles (upfirdn) or by
// wgmma.mma_async m64n96k16 on a warpgroup's 64 x 96 tile (DFT power).
// Host side: ops/mma_plan.py.
//
// Tiers. A float32 operand splits into bf16 parts, rounded to nearest
// even (split_parts): hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), which sum back to v exactly. A product of two bf16 values is exact
// in float32, so each tier rounds only at the split and in the sum:
//   ALG_BF16    1 part:  hi*hi
//   ALG_BF16X3  2 parts: hi*hi + hi*lo + lo*hi (its lo is the mid above)
//   ALG_F32     3 parts: hi*hi + hi*mid + mid*hi + hi*lo + lo*hi + mid*mid,
//               the TPU's six-pass HIGHEST; the dropped mid*lo, lo*mid and
//               lo*lo are below 2 * 2^-24 of |a b|.
// hi*hi goes to the main accumulator and the other products, smallest
// first, to a second one; the two are added once, in float32, at the end,
// so the small products never pass through the rounding of the large sum
// (the tensor cores round each accumulation toward zero).
//
// Operands. A (16 x 16, row-major) comes from shared memory by ldmatrix.x4,
// one 16-byte row of 8 depths a lane: the kernels read A as a Hankel view
// of the signal, rows a fixed stride apart that overlap, so each lane
// points at its row's start and nothing is copied. B (16 x 8 per n-tile)
// sits in shared memory as 8 x 8 core matrices, one row of 8 depths per
// column n, 16 contiguous bytes (ops/mma_plan.py core_layout_np), so
// ldmatrix.x4 gives the fragments of two n-tiles, and the 8 rows of a core
// matrix lie on 8 distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

template <int ALG>
struct Tier {
  static constexpr int PARTS = ALG == ALG_F32 ? 3 : ALG == ALG_BF16X3 ? 2 : 1;
};

// The first P bf16 parts of v0 and v1, packed in pairs: v0's in the low
// half, v1's in the high half (cvt.rn: round to nearest even)
template <int P>
__device__ __forceinline__ void split_parts(float v0, float v1,
                                            uint32_t (&out)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t u;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(v1), "f"(v0));
    out[p] = u;
    v0 -= __uint_as_float(u << 16);
    v1 -= __uint_as_float(u & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

// d += a b on one 16 x 8 x 16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's ldmatrix.x4 row of A's 16 x 16 tile: row (lane & 15), depth
// 8 * (lane >> 4) — as an offset in elements, given the row stride.
__device__ __forceinline__ int a_lane_offset(int lane, int stride) {
  return (lane & 15) * stride + ((lane >> 4) << 3);
}

// The lane's ldmatrix.x4 row of B: core matrices (n-tile j + (lane >> 4),
// depth group 2 ks + ((lane >> 3) & 1)) of a part laid out [n-tile]
// [depth group kg < KG][8][8], in elements from the tile (j, ks) = (0, 0).
__device__ __forceinline__ int b_lane_offset(int lane, int kg_count) {
  return (((lane >> 4) * kg_count + ((lane >> 3) & 1)) << 6) +
         ((lane & 7) << 3);
}

// A warp's accumulators: MT x NT tiles of 16 x 8, the main (hi*hi) and the
// correction products apart, and the total of the main sums flushed so far
// (flush: the tensor cores round a running sum toward zero at each
// product, a bias that grows with the depth, so the main sum restarts every
// few steps and is added into the total in float32, rounded to nearest).
template <int MT, int NT>
struct WarpAcc {
  float main[MT][NT][4];
  float corr[MT][NT][4];
  float total[MT][NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          main[m][n][e] = corr[m][n][e] = total[m][n][e] = 0.f;
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[m][n][e] += main[m][n][e];
          main[m][n][e] = 0.f;
        }
  }
  // the tier's sum of element e of tile (m, n)
  __device__ __forceinline__ float sum(int m, int n, int e) const {
    return (total[m][n][e] + main[m][n][e]) + corr[m][n][e];
  }
};

// One 16-deep step of a warp's MT x NT tile at tier ALG. a_smem[p] and
// b_smem[p]: part p's lane addresses (a_lane_offset, b_lane_offset applied,
// shared-space bytes) at this depth step; m-tile m of A lies
// m_step_bytes further, n-tile pair j of B j * nt_pair_bytes further.
template <int ALG, int MT, int NT>
__device__ __forceinline__ void tier_step(WarpAcc<MT, NT>& acc,
                                          const uint32_t (&a_smem)[3],
                                          const uint32_t (&b_smem)[3],
                                          uint32_t m_step_bytes,
                                          uint32_t nt_pair_bytes) {
  constexpr int P = Tier<ALG>::PARTS;
  uint32_t a[P][MT][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldmatrix_x4(a[p][m], a_smem[p] + m * m_step_bytes);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t b[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (j + 1 < NT)
        ldmatrix_x4(b[p], b_smem[p] + (j >> 1) * nt_pair_bytes);
      else
        ldmatrix_x2(b[p][0], b[p][1], b_smem[p] + (j >> 1) * nt_pair_bytes);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j + h >= NT) break;
      const int n = j + h;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint32_t b0 = b[0][2 * h], b1 = b[0][2 * h + 1];
        if (ALG == ALG_F32) {
          mma_bf16(acc.corr[m][n], a[1 % P][m], b[1 % P][2 * h],
                   b[1 % P][2 * h + 1]);                     // mid*mid
          mma_bf16(acc.corr[m][n], a[2 % P][m], b0, b1);     // lo*hi
          mma_bf16(acc.corr[m][n], a[0][m], b[2 % P][2 * h],
                   b[2 % P][2 * h + 1]);                     // hi*lo
        }
        if (ALG != ALG_BF16) {
          mma_bf16(acc.corr[m][n], a[1 % P][m], b0, b1);     // mid*hi
          mma_bf16(acc.corr[m][n], a[0][m], b[1 % P][2 * h],
                   b[1 % P][2 * h + 1]);                     // hi*mid
        }
        mma_bf16(acc.main[m][n], a[0][m], b0, b1);           // hi*hi
      }
    }
  }
}

// ---- warpgroup products (wgmma, sm_90a) ----------------------------------
//
// wgmma.mma_async m64nNk16 with A from registers: each warp of the
// warpgroup holds 16 rows of A as the mma.sync fragment above (ldmatrix.x4
// from the Hankel view) and B is read from shared memory through a
// descriptor: no swizzle, B K-major in 8 x 8 core matrices of 128 bytes,
// LBO the byte step between core matrices along K, SBO along N. The
// accumulator of an m64nN tile is the mma.sync layout repeated over N/8
// tiles: d[4j + e] is row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
// for warp w, g = lane / 4, t = lane % 4.

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across the async
// products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b on the warpgroup's 64 x 96 x 16 tile: a from registers, b
// from shared memory (descriptor); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n96(float (&d)[48],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// One 16-deep step of the warpgroup's 64 x 96 tile at tier ALG: a[p] this
// warp's fragment of A's part p, b[p] the descriptor of B's part p at this
// depth. The correction products first, smallest first, then hi*hi, which
// overwrites hh where scale_hh is 0.
template <int ALG>
__device__ __forceinline__ void tier_wgmma(float (&hh)[48], float (&corr)[48],
                                           const uint32_t (&a)[3][4],
                                           const uint64_t (&b)[3],
                                           int scale_hh) {
  if (ALG == ALG_F32) {
    wgmma_n96(corr, a[1], b[1], 1);   // mid*mid
    wgmma_n96(corr, a[2], b[0], 1);   // lo*hi
    wgmma_n96(corr, a[0], b[2], 1);   // hi*lo
  }
  if (ALG != ALG_BF16) {
    wgmma_n96(corr, a[1], b[0], 1);   // mid*hi
    wgmma_n96(corr, a[0], b[1], 1);   // hi*mid
  }
  wgmma_n96(hh, a[0], b[0], scale_hh);
}
