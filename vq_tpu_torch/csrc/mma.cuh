// Tensor-core device code of the PQ scan kernels (pq_scan.cu): ldmatrix,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators, and the
// product of one shared-memory stage.
//
// A stage holds two bf16 tiles, K-contiguous with a row stride of SA
// elements (SA = KDK + 8, 144 bytes at KDK = 64, so ldmatrix reads 8 rows
// of 16 bytes from 8 distinct bank groups): a_s, the corpus rows (the M
// side of the product), and q_s, the queries (the N side); dimensions are
// K.  The block's warps form a ROW_GROUPS x (warps / ROW_GROUPS) grid: warp
// w takes rows 32*(w % ROW_GROUPS) + [0, 32) (two m16 tiles) x queries
// WARP_Q*(w / ROW_GROUPS) + [0, WARP_Q) (WARP_Q / 8 n8 tiles).  Lane
// (g = lane/4, t = lane%4) holds rows g and g+8 x queries 2t and 2t+1 of
// each (m, n) tile: acc[(mt * NT + nt) * 4 + i], i = 2 * (row g+8) + (query
// 2t+1).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 products of one stage, every k-step of 16 dims (the tiles are zero
// where the data ends); a_s (rows, SA), q_s (queries, SA).
template <int SA, int KDK, int ROW_GROUPS, int WARP_Q>
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* a_s, const __nv_bfloat16* q_s,
                                          float (&acc)[2 * (WARP_Q / 8) * 4]) {
  constexpr int NT = WARP_Q / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix row addresses: A, lanes 0-15 rows 0-15 at k 0, lanes 16-31 at
  // k 8 (a0..a3); B, lanes 0-7 / 8-15 queries 0-7 at k 0 / 8, lanes 16-31
  // queries 8-15 (b0, b1 of two n8 tiles)
  const uint32_t a_addr =
      smem_u32(a_s + ((warp % ROW_GROUPS) * 32 + (lane & 15)) * SA + (lane >> 4) * 8);
  const uint32_t b_addr = smem_u32(
      q_s + ((warp / ROW_GROUPS) * WARP_Q + (lane & 7) + ((lane >> 4) << 3)) * SA +
      ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int ks = 0; ks < KDK / 16; ++ks) {
    uint32_t a[2][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(a_addr + (mt * 16 * SA + ks * 16) * 2, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldsm_x4(b_addr + (np * 16 * SA + ks * 16) * 2, b[2 * np][0], b[2 * np][1],
              b[2 * np + 1][0], b[2 * np + 1][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(&acc[(mt * NT + nt) * 4], a[mt], b[nt][0], b[nt][1]);
  }
}

}  // namespace
