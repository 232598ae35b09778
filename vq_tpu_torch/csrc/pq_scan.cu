// PQ ADC scan kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces vq_tpu/kernels/pallas_scan.py:
//   pq_scan_topk_fused  (_scan_topk_kernel + fold_running_topk[_merge])
//                        -> vq_pq_lut + vq_pq_scan_topk + vq_topk_merge
//   pq_score_all        (_scan_kernel) -> vq_pq_lut + vq_pq_score_all
//
// What they compute (the same contract as the TPU kernels): maximize-form
// scores, 2*q.x^ - |x^|^2 for L2 or q.x^ for IP, where x^ is the PQ
// decoding of a row's uint8 codes against codebooks (M, K <= 256, dsub).
// Top-k results are ordered by score descending, then row id ascending;
// empty slots hold -inf with id 0; rows at or past `limit` are skipped.
//
// Design.  The TPU kernel decodes a tile of rows with one-hot x codebook
// matmuls and scores it against the queries on the MXU, keeping the whole
// stacked codebook resident in VMEM.  On the H100 that codebook (786 KB in
// bf16 at M=16, dsub=96) is far over the 227 KB of shared memory a block
// may use, and decoding every row to D values is D/M times more work than
// needed.  These kernels use a per-query lookup table instead (the design
// of the reference's CUDA searcher):
//
//   LUT[q, m, c] = 2 * q_m . c_{m,c} - |c_{m,c}|^2     (L2)
//                  q_m . c_{m,c}                       (IP)
//   score(q, row) = sum_m LUT[q, m, codes[row, m]]
//
// 1. vq_pq_lut builds the LUT: Q*M*K*dsub FMAs, a small fraction of the
//    scan.  In bf16 mode queries and codebooks are rounded to bf16 first
//    and products accumulate in f32, as the TPU kernel does on the MXU.
// 2. vq_pq_scan_topk: one block owns QB queries x one chunk of rows.  The
//    QB queries' LUTs live in shared memory; each thread scores one row
//    per step (M shared-memory lookups per query, one code byte per m read
//    once for all QB queries).  A running top-k per query is kept in shared
//    memory: a row enters a candidate buffer only if it beats the current
//    k-th score (rows arrive in id order, so an equal score never wins),
//    and a warp merges the buffer into the sorted list with a bitonic sort
//    when it is non-empty.  Blocks run in parallel, so nothing carries
//    across them: each writes its chunk's sorted top-k.
//    When one query's table does not fit shared memory (M*K above ~56k,
//    e.g. M > 220 at K=256), the caller passes qb = 0: each block then
//    serves one query and reads its table from global memory (L1/L2).
// 3. vq_topk_merge: one block per query sorts the chunks' candidates.
//
// What bounds it on the H100: the scan does Q*N*M shared-memory lookups
// and adds (1.6e10 at Q=1024, N=1M, M=16); the codes (N*M bytes, 16 MB at
// N=1M) stay in the 50 MB L2 across query blocks, so device memory is not
// the limit.  Shared-memory load throughput is: this first kernel reads
// codes as 32-bit words but makes no attempt at bank-conflict-free
// lookups or at sharing one code read across more queries (later work).
// vq_pq_score_all writes Q*N*4 bytes and is bound by those writes at
// large N.
//
// Every entry point returns cudaGetLastError() after its launches; the
// caller raises if it is not 0.  Nothing here allocates or synchronizes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 256;       // threads per block in every kernel
constexpr int kSortCap = 512;       // per-query buffer: k + kThreads <= 512
constexpr int kLutQ = 32;           // queries per LUT-build block
constexpr int kLutD = 32;           // dsub chunk staged in shared memory

// ---------------------------------------------------------------- LUT build
// grid (ceil(Q / kLutQ), M); thread c owns codeword c of subquantizer m.
__global__ void lut_kernel(const float* __restrict__ q, const float* __restrict__ cb,
                           float* __restrict__ lut, int Q, int D, int M, int K,
                           int dsub, int l2, int bf16) {
  __shared__ float cb_s[256][kLutD + 1];   // +1: no bank conflicts on rows
  __shared__ float q_s[kLutQ][kLutD];
  const int m = blockIdx.y;
  const int q0 = blockIdx.x * kLutQ;
  const int nq = min(kLutQ, Q - q0);
  const int c = threadIdx.x;
  float acc[kLutQ];
#pragma unroll
  for (int j = 0; j < kLutQ; ++j) acc[j] = 0.f;
  float c2 = 0.f;
  for (int d0 = 0; d0 < dsub; d0 += kLutD) {
    const int dc = min(kLutD, dsub - d0);
    for (int i = threadIdx.x; i < K * dc; i += blockDim.x) {
      int r = i / dc, j = i % dc;
      cb_s[r][j] = rnd(cb[((size_t)m * K + r) * dsub + d0 + j], bf16);
    }
    for (int i = threadIdx.x; i < kLutQ * dc; i += blockDim.x) {
      int r = i / dc, j = i % dc;
      q_s[r][j] = r < nq ? rnd(q[(size_t)(q0 + r) * D + m * dsub + d0 + j], bf16) : 0.f;
    }
    __syncthreads();
    if (c < K) {
      for (int j = 0; j < dc; ++j) {
        float v = cb_s[c][j];
        c2 += v * v;
#pragma unroll
        for (int r = 0; r < kLutQ; ++r) acc[r] += q_s[r][j] * v;
      }
    }
    __syncthreads();
  }
  if (c < K) {
    for (int r = 0; r < nq; ++r) {
      float v = l2 ? 2.f * acc[r] - c2 : acc[r];
      lut[((size_t)(q0 + r) * M + m) * K + c] = v;
    }
  }
}

// Copy QB queries' LUTs (contiguous in global memory) into shared memory.
__device__ __forceinline__ void load_lut(float* lut_s, const float* lut, int q0, int nq,
                                         int M, int K) {
  const size_t n = (size_t)nq * M * K;
  const float* src = lut + (size_t)q0 * M * K;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) lut_s[i] = src[i];
}

// Score one row against QB queries from the shared LUTs.  When M % 4 == 0
// (and the codes are 4-byte aligned) the row's codes are read as 32-bit
// words, a quarter of the load instructions of byte reads.
template <int QB>
__device__ __forceinline__ void score_row(float (&acc)[QB], const float* lut_s,
                                          const uint8_t* __restrict__ code, int M, int K,
                                          bool words) {
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0.f;
  const int stride = M * K;
  if (words) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(code);
    for (int m4 = 0; m4 < (M >> 2); ++m4) {
      const uint32_t v = __ldg(w + m4);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int off = (4 * m4 + b) * K + ((v >> (8 * b)) & 0xFF);
#pragma unroll
        for (int j = 0; j < QB; ++j) acc[j] += lut_s[j * stride + off];
      }
    }
    return;
  }
  for (int m = 0; m < M; ++m) {
    const int off = m * K + code[m];
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[j] += lut_s[j * stride + off];
  }
}

// ------------------------------------------------------------ score-all scan
// grid (ceil(Q / QB), chunks); out (Q, N) maximize-form scores.  SMEM_LUT:
// the QB tables are copied to shared memory, else read from global memory.
template <int QB, bool SMEM_LUT>
__global__ void score_all_kernel(const float* __restrict__ lut,
                                 const uint8_t* __restrict__ codes,
                                 float* __restrict__ out, int Q, int N, int M, int K,
                                 int rows_per_chunk, bool words) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Q - q0);
  if (SMEM_LUT) load_lut(smem, lut, q0, nq, M, K);
  const float* lut_s = SMEM_LUT ? smem : lut + (size_t)q0 * M * K;
  __syncthreads();
  const int row_begin = blockIdx.y * rows_per_chunk;
  const int row_end = min(N, row_begin + rows_per_chunk);
  for (int row = row_begin + threadIdx.x; row < row_end; row += blockDim.x) {
    float acc[QB];
    score_row<QB>(acc, lut_s, codes + (size_t)row * M, M, K, words);
#pragma unroll
    for (int j = 0; j < QB; ++j)
      if (j < nq) out[(size_t)(q0 + j) * N + row] = acc[j];
  }
}

// ------------------------------------------------------- fused scan + top-k
// grid (ceil(Q / QB), chunks).  Writes each (query, chunk) sorted top-k to
// cand_s / cand_i (Q, chunks, k); empty slots are (-inf, INT_MAX).
template <int QB, bool SMEM_LUT>
__global__ void scan_topk_kernel(const float* __restrict__ lut,
                                 const uint8_t* __restrict__ codes,
                                 float* __restrict__ cand_s, int* __restrict__ cand_i,
                                 int Q, int N, int M, int K, int k, int limit,
                                 int rows_per_chunk, bool words) {
  extern __shared__ float smem[];
  __shared__ int n_cand[QB];
  __shared__ float thr[QB];
  float* buf_s = smem + (SMEM_LUT ? (size_t)QB * M * K : 0);
  int* buf_i = reinterpret_cast<int*>(buf_s + QB * kSortCap);

  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Q - q0);
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  if (SMEM_LUT) load_lut(smem, lut, q0, nq, M, K);
  const float* lut_s = SMEM_LUT ? smem : lut + (size_t)q0 * M * K;
  for (int i = threadIdx.x; i < QB * kSortCap; i += blockDim.x) {
    buf_s[i] = -INFINITY;
    buf_i[i] = INT_MAX;
  }
  if (threadIdx.x < QB) {
    n_cand[threadIdx.x] = 0;
    thr[threadIdx.x] = -INFINITY;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(min(N, limit), row_begin + rows_per_chunk);
  for (int base = row_begin; base < row_end; base += blockDim.x) {
    const int row = base + threadIdx.x;
    if (row < row_end) {
      float acc[QB];
      score_row<QB>(acc, lut_s, codes + (size_t)row * M, M, K, words);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        if (j < nq && acc[j] > thr[j]) {
          const int slot = k + atomicAdd(&n_cand[j], 1);
          buf_s[j * kSortCap + slot] = acc[j];
          buf_i[j * kSortCap + slot] = row;
        }
      }
    }
    __syncthreads();
    // warp j merges query j's candidates into its sorted list (QB <= 8 warps)
    if (warp < nq) {
      const int nc = n_cand[warp];
      if (nc > 0) {
        const float kth = warp_merge_candidates(buf_s + warp * kSortCap,
                                                buf_i + warp * kSortCap, k, nc, lane);
        if (lane == 0) {
          thr[warp] = kth;
          n_cand[warp] = 0;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nq * k; i += blockDim.x) {
    const int j = i / k, r = i % k;
    const size_t o = ((size_t)(q0 + j) * chunks + chunk) * k + r;
    cand_s[o] = buf_s[j * kSortCap + r];
    cand_i[o] = buf_i[j * kSortCap + r];
  }
}

template <int QB, bool SMEM_LUT>
cudaError_t launch_scan(const float* lut, const uint8_t* codes, float* cand_s, int* cand_i,
                        float* out, int Q, int N, int M, int K, int k, int limit,
                        int chunks, cudaStream_t stream) {
  const int rows_per_chunk = (N + chunks - 1) / chunks;
  const bool words = (M & 3) == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  dim3 grid((Q + QB - 1) / QB, chunks);
  size_t lut_bytes = SMEM_LUT ? (size_t)QB * M * K * sizeof(float) : 0;
  if (out != nullptr) {
    cudaFuncSetAttribute(score_all_kernel<QB, SMEM_LUT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lut_bytes);
    score_all_kernel<QB, SMEM_LUT><<<grid, kThreads, lut_bytes, stream>>>(
        lut, codes, out, Q, N, M, K, rows_per_chunk, words);
    return cudaGetLastError();
  }
  size_t smem = lut_bytes + (size_t)QB * kSortCap * (sizeof(float) + sizeof(int));
  cudaFuncSetAttribute(scan_topk_kernel<QB, SMEM_LUT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  scan_topk_kernel<QB, SMEM_LUT><<<grid, kThreads, smem, stream>>>(
      lut, codes, cand_s, cand_i, Q, N, M, K, k, limit, rows_per_chunk, words);
  return cudaGetLastError();
}

// qb = queries per block with their tables in shared memory; 0 = one query
// per block, table read from global memory
template <typename... A>
cudaError_t dispatch_qb(int qb, A... args) {
  switch (qb) {
    case 8: return launch_scan<8, true>(args...);
    case 4: return launch_scan<4, true>(args...);
    case 2: return launch_scan<2, true>(args...);
    case 1: return launch_scan<1, true>(args...);
    case 0: return launch_scan<1, false>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory layout constants, read by the Python wrapper to size QB
// and the number of chunks.
int vq_sort_cap() { return kSortCap; }
int vq_merge_cap() { return kMergeCap; }

// q (Q, D) f32, cb (M, K, dsub) f32 -> lut (Q, M, K) f32
int vq_pq_lut(const float* q, const float* cb, float* lut, int Q, int D, int M, int K,
              int dsub, int l2, int bf16, void* stream) {
  if (K > 256 || M * dsub != D) return (int)cudaErrorInvalidValue;
  dim3 grid((Q + kLutQ - 1) / kLutQ, M);
  lut_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(q, cb, lut, Q, D, M, K, dsub, l2,
                                                          bf16);
  return (int)cudaGetLastError();
}

// lut (Q, M, K), codes (N, M) u8 -> out (Q, N) f32
int vq_pq_score_all(const float* lut, const uint8_t* codes, float* out, int Q, int N, int M,
                    int K, int qb, int chunks, void* stream) {
  return (int)dispatch_qb(qb, lut, codes, (float*)nullptr, (int*)nullptr, out, Q, N, M, K, 0,
                          0, chunks, (cudaStream_t)stream);
}

// lut (Q, M, K), codes (N, M) u8 -> cand (Q, chunks, k) -> out (Q, k)
int vq_pq_scan_topk(const float* lut, const uint8_t* codes, float* cand_s, int* cand_i,
                    float* out_s, int* out_i, int Q, int N, int M, int K, int k, int limit,
                    int qb, int chunks, void* stream) {
  if (k < 1 || k > kMaxK || chunks * k > kMergeCap) return (int)cudaErrorInvalidValue;
  cudaError_t err = dispatch_qb(qb, lut, codes, cand_s, cand_i, (float*)nullptr, Q, N, M, K,
                                k, limit, chunks, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, kThreads, 0, (cudaStream_t)stream>>>(cand_s, cand_i, out_s, out_i,
                                                         chunks * k, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
