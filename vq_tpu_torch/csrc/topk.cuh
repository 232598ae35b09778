// Exact top-k device code shared by the scan kernels (pq_scan.cu,
// packed_scan.cu): the (score desc, id asc) order, a bitonic sort, the warp
// merges of a per-query candidate buffer into its running top-k (in shared
// memory, or in registers from lists anywhere: warp_fold_regs), the kernel
// that merges the per-chunk top-k lists of one query, and the host code
// that launches it once or twice.
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

// float <-> unsigned int with the floats' order (atomicMax on the published
// k-th scores of a scan, kth_g)
__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
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

// Number of the n sorted entries (s, id) that rank before (vs, vi)
__device__ __forceinline__ int rank_in(const float* s, const int* id, int n, float vs, int vi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ranks_before(s[mid], id[mid], vs, vi)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// warp_merge_sorted for nc <= 32, in registers: lane l holds candidate l
// and top-k entries l + 32u; a candidate's place is its rank among the
// candidates (shuffles) plus its rank in the top-k (binary search), an
// entry's place its index plus the candidates that rank before it.
__device__ __forceinline__ float warp_merge_few(float* s, int* id, int k, int nc, int lane) {
  float* cs = s + k;
  int* ci = id + k;
  const bool has = lane < nc;
  const float vs = has ? cs[lane] : -INFINITY;
  const int vi = has ? ci[lane] : INT_MAX;
  float ts[4];
  int ti[4], tp[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = lane + 32 * u;
    ts[u] = m < k ? s[m] : -INFINITY;
    ti[u] = m < k ? id[m] : INT_MAX;
    tp[u] = m < k ? m : kMaxK + 32;  // past k whatever it gains
  }
  int pc = has ? rank_in(s, id, k, vs, vi) : kMaxK + 32;
#pragma unroll 4
  for (int m = 0; m < nc; ++m) {
    const float os = __shfl_sync(0xffffffffu, vs, m);
    const int oi = __shfl_sync(0xffffffffu, vi, m);
    pc += ranks_before(os, oi, vs, vi);
#pragma unroll
    for (int u = 0; u < 4; ++u) tp[u] += ranks_before(os, oi, ts[u], ti[u]);
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (tp[u] < k) {
      s[tp[u]] = ts[u];
      id[tp[u]] = ti[u];
    }
  }
  if (pc < k) {
    s[pc] = vs;
    id[pc] = vi;
  }
  if (has) {
    cs[lane] = -INFINITY;
    ci[lane] = INT_MAX;
  }
  __syncwarp();
  return s[k - 1];
}

// The same merge as warp_merge_candidates at a cost that follows nc, not
// k: up to 32 candidates by warp_merge_few; more, one warp sorts the nc
// candidates at s[k, k+nc) alone (bitonic over the next power of two >= nc
// entries, whose tail past nc holds (-inf, INT_MAX)), places each entry of
// the two sorted lists at its index plus its rank in the other list (binary
// search), keeps the first k, clears the candidates and returns the new
// k-th score.  Needs k <= 128, nc <= 128, candidate scores > -inf and ids
// unique between the lists; the buffer must hold k + (nc rounded up to a
// power of two) entries.
__device__ __forceinline__ float warp_merge_sorted(float* s, int* id, int k, int nc, int lane) {
  if (nc <= 32) return warp_merge_few(s, id, k, nc, lane);
  int p = 64;
  while (p < nc) p <<= 1;
  float* cs = s + k;
  int* ci = id + k;
  bitonic_sort<false>(cs, ci, p, lane, 32);
  float vs[8];
  int vi[8], pos[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = lane + 32 * u;
    pos[u] = pos[4 + u] = INT_MAX;
    if (m < k) {
      vs[u] = s[m], vi[u] = id[m];
      pos[u] = m + rank_in(cs, ci, nc, vs[u], vi[u]);
    }
    if (m < nc) {
      vs[4 + u] = cs[m], vi[4 + u] = ci[m];
      pos[4 + u] = m + rank_in(s, id, k, vs[4 + u], vi[4 + u]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (pos[u] < k) {
      s[pos[u]] = vs[u];
      id[pos[u]] = vi[u];
    }
  }
  for (int i = lane; i < nc; i += 32) {
    cs[i] = -INFINITY;
    ci[i] = INT_MAX;
  }
  __syncwarp();
  return s[k - 1];
}

// One compare-exchange step of a warp's bitonic network over 128 entries,
// entry e = 32 u + lane in register u: e and e ^ stride exchange into
// ranks_before order where (e & size) == 0, the reverse elsewhere.  Called
// from fully unrolled loops, so stride and size are constants.
__device__ __forceinline__ void bitonic_step(float (&s)[4], int (&id)[4], int lane, int size,
                                             int stride) {
  float ps[4];
  int pi[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ps[u] = stride < 32 ? __shfl_xor_sync(0xffffffffu, s[u], stride) : s[u ^ (stride >> 5)];
    pi[u] = stride < 32 ? __shfl_xor_sync(0xffffffffu, id[u], stride) : id[u ^ (stride >> 5)];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = 32 * u + lane;
    const bool first = ((e & size) == 0) == ((e & stride) == 0);  // e keeps the one ranking first
    if (first ? ranks_before(ps[u], pi[u], s[u], id[u]) : ranks_before(s[u], id[u], ps[u], pi[u])) {
      s[u] = ps[u];
      id[u] = pi[u];
    }
  }
}

// One warp merges nc <= 128 candidates (cs, ci) into the sorted top-k at
// s[0, k), k <= 128, in registers: the candidates are sorted by a bitonic
// network, the better of top-k entry i and candidate 127 - i is kept (the
// first 128 of both lists, a bitonic sequence), that is sorted, and its
// first k written back.  Returns the new k-th score.  The lists may live in
// global memory: one load and one store an entry.
__device__ __forceinline__ float warp_fold_regs(float* s, int* id, int k, const float* cs,
                                                const int* ci, int nc, int lane) {
  float cand_s[4], top_s[4];
  int cand_i[4], top_i[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = 32 * u + lane;
    cand_s[u] = e < nc ? cs[e] : -INFINITY;
    cand_i[u] = e < nc ? ci[e] : INT_MAX;
    top_s[u] = e < k ? s[e] : -INFINITY;
    top_i[u] = e < k ? id[e] : INT_MAX;
  }
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_step(cand_s, cand_i, lane, size, stride);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float rv = __shfl_sync(0xffffffffu, cand_s[3 - u], 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, cand_i[3 - u], 31 - lane);
    if (ranks_before(rv, ri, top_s[u], top_i[u])) {
      top_s[u] = rv;
      top_i[u] = ri;
    }
  }
#pragma unroll
  for (int stride = 64; stride > 0; stride >>= 1) bitonic_step(top_s, top_i, lane, 128, stride);
  __syncwarp();
  float kth = -INFINITY;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = 32 * u + lane;
    if (e < k) {
      s[e] = top_s[u];
      id[e] = top_i[u];
    }
    if ((k - 1) >> 5 == u) kth = __shfl_sync(0xffffffffu, top_s[u], (k - 1) & 31);
  }
  __syncwarp();
  return kth;
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

constexpr int kMergeThreads = 512;

// Whether merge_chunks takes (chunks, k): one launch sorts chunks * k <=
// kMergeCap candidates a query, or the lists merge in groups of g =
// kMergeCap / k first (chunks a multiple of g, at most g groups).
inline bool merge_shape_ok(int chunks, int k) {
  if (k < 1 || k > kMaxK || chunks < 1) return false;
  const int g = kMergeCap / k;
  return chunks <= g || (chunks % g == 0 && chunks / g <= g);
}

// A scan's (Q, chunks, k) sorted chunk lists -> out (Q, k), in one merge
// launch, or, past the cap, in two: groups of g lists first into cand's
// tail (Q, chunks / g, k), so cand then holds Q * (chunks + chunks / g) * k
// entries.  Returns cudaGetLastError().
inline cudaError_t merge_chunks(float* cand_s, int* cand_i, float* out_s, int* out_i, int Q,
                                int chunks, int k, cudaStream_t stream) {
  const int g = kMergeCap / k;
  if (chunks > g) {
    const int groups = chunks / g;
    float* mid_s = cand_s + (size_t)Q * chunks * k;
    int* mid_i = cand_i + (size_t)Q * chunks * k;
    merge_kernel<<<Q * groups, kMergeThreads, 0, stream>>>(cand_s, cand_i, mid_s, mid_i, g * k,
                                                           k);
    merge_kernel<<<Q, kMergeThreads, 0, stream>>>(mid_s, mid_i, out_s, out_i, groups * k, k);
  } else {
    merge_kernel<<<Q, kMergeThreads, 0, stream>>>(cand_s, cand_i, out_s, out_i, chunks * k, k);
  }
  return cudaGetLastError();
}

}  // namespace
