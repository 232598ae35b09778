// Exact top-k device code shared by the scan kernels (pq_scan.cu,
// packed_scan.cu): the (score desc, id asc) order, a bitonic sort, the warp
// merge of a per-query candidate buffer into its running top-k, and the
// kernel that merges the per-chunk top-k lists of one query.
//
// Running top-k protocol (per query, in shared memory): s[0, k) holds the
// sorted top-k so far, (-inf, INT_MAX) where empty; a row is admitted only
// if it beats s[k-1] (rows arrive in id order within a block, so an equal
// score never wins) and is appended at s[k + slot]; a warp then sorts the
// buffer.  Blocks own disjoint row chunks and write their chunk's sorted
// top-k; merge_kernel sorts the chunks' lists of one query.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kMaxK = 128;       // largest k (the TPU kernels' _KPAD)
constexpr int kMergeCap = 4096;  // chunks * k the merge kernel sorts

__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// (sa, ia) ranks before (sb, ib): score descending, then id ascending
__device__ __forceinline__ bool ranks_before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of p (a power of two) entries into ranks_before order, by
// `nt` cooperating threads starting at thread `t0`.  BLOCK selects the
// barrier: __syncthreads for a whole block, __syncwarp for one warp.
template <bool BLOCK>
__device__ void bitonic_sort(float* s, int* id, int p, int t0, int nt) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = t0; t < (p >> 1); t += nt) {
        int lo = 2 * stride * (t / stride) + (t % stride);
        int hi = lo + stride;
        float a = s[lo], b = s[hi];
        int ia = id[lo], ib = id[hi];
        bool forward = (lo & size) == 0;
        bool swap = forward ? ranks_before(b, ib, a, ia) : ranks_before(a, ia, b, ib);
        if (swap) {
          s[lo] = b; s[hi] = a;
          id[lo] = ib; id[hi] = ia;
        }
      }
      if (BLOCK) __syncthreads(); else __syncwarp();
    }
  }
}

// One warp merges the nc candidates at s[k, k+nc) into the sorted top-k at
// s[0, k), clears the buffer tail and returns the new k-th score.  The
// buffer must hold the next power of two >= max(32, k + nc) entries.
__device__ __forceinline__ float warp_merge_candidates(float* s, int* id, int k, int nc,
                                                       int lane) {
  int p = 32;
  while (p < k + nc) p <<= 1;
  bitonic_sort<false>(s, id, p, lane, 32);
  for (int i = k + lane; i < p; i += 32) {
    s[i] = -INFINITY;
    id[i] = INT_MAX;
  }
  __syncwarp();
  return s[k - 1];
}

// grid (Q); merges the query's n_cand = chunks * k candidates into its
// top-k; empty slots get id 0.
__global__ void merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
                             float* __restrict__ out_s, int* __restrict__ out_i,
                             int n_cand, int k) {
  __shared__ float s[kMergeCap];
  __shared__ int id[kMergeCap];
  const int q = blockIdx.x;
  int p = 32;
  while (p < n_cand) p <<= 1;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    const bool in = i < n_cand;
    s[i] = in ? cand_s[(size_t)q * n_cand + i] : -INFINITY;
    id[i] = in ? cand_i[(size_t)q * n_cand + i] : INT_MAX;
  }
  __syncthreads();
  bitonic_sort<true>(s, id, p, threadIdx.x, blockDim.x);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const float v = s[r];
    out_s[(size_t)q * k + r] = v;
    out_i[(size_t)q * k + r] = v > -INFINITY ? id[r] : 0;
  }
}

}  // namespace
