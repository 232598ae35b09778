// PQ ADC scan kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces vq_tpu/kernels/pallas_scan.py:
//   pq_scan_topk_fused  (_scan_topk_kernel + fold_running_topk[_merge])
//   pq_score_all        (_scan_kernel)
// by two routes, each serving both functions (the wrapper picks the route
// from the shapes, kernels/pq_scan.py::pq_route):
//   decode  vq_pq_decode_scan: rounding pre-passes + decode_scan_kernel
//   table   vq_pq_table_scan:  lut_kernel + table_scan_kernel
// and, for the fused function, merge_chunks (topk.cuh).
//
// What they compute (the TPU kernels' contract): maximize-form scores,
// 2*q.x^ - |x^|^2 for L2 or q.x^ for IP, where x^ is the PQ decoding of a
// row's uint8 codes against codebooks (M, K <= 256, dsub).  bf16 mode
// rounds queries and codebooks to bf16 and sums the products in f32, as the
// TPU kernel feeds its MXU; f32 mode computes in f32 throughout.  Top-k
// results are ordered by score descending, then row id ascending; empty
// slots hold -inf with id 0; rows at or past `limit` are skipped.
//
// Decode route (bf16 mode at small dsub: M=192, dsub=8 is the case that
// matters): decoded rows x queries on the tensor cores, the TPU kernel's
// design, by one of two kernels the wrapper picks from Q.  Pre-passes round
// the codebooks to bf16 and tabulate the f32 squared norm of every rounded
// codeword and of every row (sum over its codes, for L2) once a call, and
// round the queries into a zero-padded scratch laid out stage-major and
// 128-byte swizzled, tiles of qn queries x 64 dims.  Both kernels copy a row
// tile's codes (128 x M bytes) into shared memory and, each stage of 64
// dims, gather every (row, 8 dims) of the decoded tile from the bf16
// codebook (L2-resident: D*K*2 bytes, 786 KB at D=1536) in 16-byte pieces.
//
//   decode_scan_kernel (Q > 64: tiles of kQN = 256 queries), warp-specialised
//   on Hopper's wgmma.  A producer warpgroup fills a ring of up to 4 stages:
//   its threads gather the row tile by cp.async straight into the swizzled
//   layout wgmma reads (announced on the stage's mbarrier one stage later,
//   once landed), and one thread starts the stage's query tile as one bulk
//   copy.  Two consumer warpgroups each multiply 64 rows (M side) by the 256
//   queries (N side), wgmma.m64n256k16 from shared memory into f32 registers
//   that stay across the stages, and free a slot when its products are done.
//   Where the query tiles come in fours (or twos), that many blocks, one a
//   query tile, run as a cluster over one chunk's rows: each gathers its
//   quarter (half) of every row tile and copies it into the others' rings
//   (bulk copies between the CTAs' shared memory, counted on their
//   mbarriers), and a slot is freed only when every block's consumers are
//   done with it; so a row is gathered once for 1,024 queries at Q=1024.
//   The fold keeps, per query, a top-k and k + 192 candidate slots in a
//   global scratch (L2; shared memory holds only each query's threshold and
//   count, so 256 queries fit beside the ring): the epilogue compares every
//   score with the query's cut first and appends the admitted ones after,
//   and a warp merges a query's candidates in registers (bitonic) once it
//   holds 64.  Per stage the 128 x 256 tile writes 48 KB into shared memory
//   and wgmma reads 80 KB out of it for 4.2 MFLOP: 0.012 and 0.019 bytes a
//   FLOP, against 0.023 and 0.092 for the 64-query tile below.
//   decode_mma_kernel (Q <= 64: tiles of kQB = 64 queries), the design this
//   replaced at large Q: 16 warps gather into registers and mma.sync
//   (csrc/mma.cuh) multiplies each warp's ldmatrix fragments, the stages
//   double-buffered, one barrier a stage; the fold's buffers of k + 128 a
//   query in shared memory.  At few queries the gathers are the whole cost
//   and its 512 threads issue them faster than one producer warpgroup.
//
// Both: the epilogue forms 2*ip - |x^|^2 (L2) or ip (IP), masks `limit`,
// and writes the (Q, tile) scores or admits what beats the block's k-th and
// reaches the k-th any block has published (kth_g).  Bound: 2*Q*N*D bf16
// operations on the tensor cores (3.18 ms at Q=1024, N=1M, D=1536).  What
// bounds the kernels instead: an SM issues ~0.3 random 16-byte gathers a
// clock (N x D/8 of them for each cluster of query tiles: 192 M at Q=1024,
// N=1M, D=1536), the L2 serves the query tiles again for every row tile
// (24.6 GB there), and a cluster runs at its slowest block's pace, folds
// included; see PERF.md.
//
// Table route (f32 mode always; bf16 mode at large dsub: M=16, dsub=96).
// Per-query lookup tables, LUT[q, m, c] = 2*q_m.c_mc - |c_mc|^2 (L2) or
// q_m.c_mc (IP), score = sum_m LUT[q, m, codes[row, m]].  lut_kernel builds
// them (Q*K*D products) query-interleaved, (Q/4, M, K, 4): one 16-byte load
// gives 4 queries' entries, a quarter of the load instructions, and bank
// conflicts arise only within a quarter-warp.  A block of 16 warps holds
// QB = 8 or 4 queries' tables in shared memory; where 4 tables do not fit
// (M*K above ~13k) it holds one query's table, one entry a load, or (qb =
// 0, M*K above ~56k) reads it from global memory; and each
// thread scores one row per step of 512 rows, its codes read as 16-byte
// words where M % 16 == 0 (a warp's 32 rows contiguous at M = 16).  The
// top-k buffers hold k + 128 entries a query, so a step folds in four
// rounds of 128 rows, each admitting rows above the block's k-th and at or
// above the published one and merging what it admitted; most steps admit
// no row, and one barrier shows that (the rounds run only when one does,
// with the published k-th read anew).  Bound:
// Q*N*M f32 adds (33.5e12 a second: the 67 TFLOP/s FP32 peak counts an FMA
// as two) and the shared-memory loads behind them, 4 bytes a (query, row,
// subspace) at ~30 TB/s over the card.
//
// Crossover.  Per (query, row, subspace) the table route loads 4 bytes of
// shared memory and the decode route does 2*dsub bf16 operations on the
// tensor cores plus its share of the decode, so the table route wins at
// large dsub and the decode route at small.  chip_smoke.py phase 3 times
// both at dsub 8, 16, 32, 96 (D=1536, N=100k, Q=1024): the mma.sync decode
// took ~3 ms at every dsub, tables 1.4 ms at dsub 96, 2.3 at 32 and 5.7 at
// 16, where 4 queries' tables no longer fit a block; the rule decodes at
// dsub <= 24.
// f32 stays on tables: TF32 products would break the 1e-4
// term-relative tolerance f32 scores are held to, and f32 products on the
// CUDA cores lose to the lookups at the main path's dsub.
//
// The sums of both functions are the same code in the same order within a
// route (on the decode route, the same instance: the width follows Q), so
// the fused top-k equals the top-k of pq_score_all's scores bit for bit.
// The wrapper sizes the grid from the resident blocks the library reports
// (vq_pq_table_blocks_per_sm, vq_pq_decode_slots), query blocks fastest
// within a chunk (a chunk's codes come from device memory once for all of
// them).
// Every entry point returns cudaGetLastError() after its launches; the
// caller raises if it is not 0.  Nothing here allocates or synchronizes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "topk.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 512;       // 16 warps in the table and mma.sync decode kernels
constexpr int kWarps = kThreads / 32;
constexpr int kFoldRows = 128;      // rows one fold admits at most: buffers of k + 128
constexpr size_t kSmemCap = 232448; // shared memory a block can have
// decode route, both kernels
constexpr int kTR = 128;            // rows a row tile
constexpr int kKDK = 64;            // dims a stage: 4 k-steps of 16, one 128-byte swizzled row
constexpr int kMaxStagedM = 256;    // a row tile's codes in shared memory up to 32 KB
// decode route, mma.sync kernel (Q <= kQB)
constexpr int kQB = 64;             // queries a block
constexpr int kSA = kKDK + 8;       // bf16 row stride (144 B) of the stage tiles
constexpr int kRowGroups = 4;
constexpr int kWarpQ = kQB / (kWarps / kRowGroups);  // 16 queries a warp
constexpr int kNT = kWarpQ / 8;
constexpr int kAcc = 2 * kNT * 4;
constexpr int kFQ = kAcc / 4;       // queries a thread holds scores of
constexpr int kStageBytes = (kTR + kQB) * kSA * 2;
constexpr int kVChunks = kTR * kKDK / 8 / kThreads;  // 8-dim value chunks a thread a stage
constexpr int kQChunks = kQB * kKDK / 8 / kThreads;  // 8-dim query chunks a thread a stage
// decode route, wgmma kernel (Q > kQB)
constexpr int kQN = 256;            // queries a block
constexpr int kRowTileBytes = kTR * kKDK * 2;
constexpr int kConsumers = 256;     // warpgroups 0 and 1
constexpr int kProducers = 128;     // warpgroup 2
constexpr int kDecThreads = kConsumers + kProducers;
constexpr int kConsumerRegs = 224;  // setmaxnreg: 2 x 128 x 224 + 128 x 56 <= 65536
constexpr int kProducerRegs = 56;
constexpr int kBarProducer = 1;     // named barriers (0 is __syncthreads)
constexpr int kBarConsumer = 2;
constexpr int kMaxStages = 4;       // ring depth, fewer where shared memory runs out
constexpr int kFoldAt = 64;         // a query's candidates are merged from 64 on
constexpr int kFoldSlots = kFoldRows + kFoldAt;  // candidate slots a query
static_assert(kTR == kFoldRows, "a fold admits at most one row tile");
// table route
constexpr int kG = 4;               // queries interleaved in a table entry (a float4)
constexpr int kLutQ = 32;           // queries per table-build block
constexpr int kLutD = 32;           // dsub chunk staged in shared memory
constexpr int kLutThreads = 256;

// ---------------------------------------------------------------- decode route
struct DecodeParams {
  const __nv_bfloat16* q16;   // (ceil(Q / qn), nst, qn, 64) rounded queries, stage-major, swizzled
  const __nv_bfloat16* cb16;  // (M, K, dsub) rounded codebooks
  const float* rn;            // (N,) |x^|^2 of each row (L2)
  const uint8_t* codes;       // (N, M)
  float* out;                 // score_all: (Q, N)
  float* cand_s;              // fused: (Q, chunks, k)
  int* cand_i;
  float* fold_s;              // fused, wgmma: (blocks, kQN, k + kFoldSlots) top-k + candidates
  int* fold_i;
  unsigned int* kth_g;        // fused: (Q,) published k-th scores (ordered ints)
  int Q, N, M, K, dsub, D, nst, k, limit, l2, tiles_per_chunk, staged, codes16, vec8, stages;
  int cluster;                // wgmma: query tiles of a cluster sharing each row tile's gathers
};

// grid (Q / qn rounded up, times qn): query row j into its tile's stages,
// q16[((j / qn * nst + s) * qn + j % qn) * 64 + swizzled d % 64] =
// bf16(q[j, 64 s + d % 64]), 0 past Q and D
__global__ void round_pq_queries_kernel(const float* __restrict__ q,
                                        __nv_bfloat16* __restrict__ q16, int Q, int D, int nst,
                                        int qn) {
  const int j = blockIdx.x, jj = j % qn;
  __nv_bfloat16* dst = q16 + (size_t)(j / qn) * nst * qn * kKDK + (size_t)jj * kKDK;
  for (int d = threadIdx.x; d < nst * kKDK; d += blockDim.x) {
    const int dd = d % kKDK;
    dst[(size_t)(d / kKDK) * qn * kKDK + (((dd >> 3) ^ (jj & 7)) << 3) + (dd & 7)] =
        __float2bfloat16(j < Q && d < D ? q[(size_t)j * D + d] : 0.f);
  }
}

// grid (ceil(M*K / 256)): cb16 = bf16(cb); cnorm[m, c] = sum_d bf16(cb[m, c, d])^2
__global__ void round_codebook_kernel(const float* __restrict__ cb,
                                      __nv_bfloat16* __restrict__ cb16,
                                      float* __restrict__ cnorm, int MK, int dsub) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= MK) return;
  float s = 0.f;
  for (int d = 0; d < dsub; ++d) {
    const __nv_bfloat16 h = __float2bfloat16(cb[(size_t)e * dsub + d]);
    cb16[(size_t)e * dsub + d] = h;
    const float v = __bfloat162float(h);
    s += v * v;
  }
  cnorm[e] = s;
}

// grid (ceil(N / 256)): rn[n] = sum_m cnorm[m, codes[n, m]], m ascending
__global__ void row_norms_kernel(const uint8_t* __restrict__ codes,
                                 const float* __restrict__ cnorm, float* __restrict__ rn, int N,
                                 int M, int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint8_t* c = codes + (size_t)n * M;
  float s = 0.f;
  for (int m = 0; m < M; ++m) s += __ldg(cnorm + m * K + c[m]);
  rn[n] = s;
}

// Shared memory of an mma.sync decode block: two stages, the row tile's
// codes, the fold's buffers of k + kFoldRows entries a query (k = 0: none)
size_t decode_mma_smem(int M, int k) {
  return 2 * (size_t)kStageBytes + (M <= kMaxStagedM ? (size_t)(kTR * M + 15) / 16 * 16 : 0) +
         (k ? (size_t)kQB * (k + kFoldRows) * (sizeof(float) + sizeof(int)) : 0);
}

// grid (ceil(Q / kQB), chunks); SCORE_ALL writes out (Q, N), else each
// (query, chunk) sorted top-k to cand_s / cand_i, empty slots (-inf, INT_MAX)
template <bool SCORE_ALL>
__global__ void __launch_bounds__(kThreads, 1)
decode_mma_kernel(const __grid_constant__ DecodeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage_s = smem;
  uint8_t* codes_s = stage_s + 2 * kStageBytes;
  const int kbuf = p.k + kFoldRows;
  float* buf_s = reinterpret_cast<float*>(codes_s + (p.staged ? (kTR * p.M + 15) / 16 * 16 : 0));
  int* buf_i = reinterpret_cast<int*>(buf_s + kQB * kbuf);
  __shared__ float thr[kQB];
  __shared__ float gthr[kQB];
  __shared__ int n_cand[kQB];
  __shared__ float term_s[kTR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQB;
  const int nq = min(kQB, p.Q - q0);
  const int end = SCORE_ALL ? p.N : min(p.N, p.limit);
  const int t_begin = blockIdx.y * p.tiles_per_chunk;
  const int t_end = min((end + kTR - 1) / kTR, t_begin + p.tiles_per_chunk);
  if (!SCORE_ALL) {
    for (int i = tid; i < kQB * kbuf; i += kThreads) {
      buf_s[i] = -INFINITY;
      buf_i[i] = INT_MAX;
    }
    if (tid < kQB) {
      thr[tid] = -INFINITY;
      n_cand[tid] = 0;
    }
  }

  uint4 raw[kVChunks], qh[kQChunks];
  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = t * kTR;
    const int nrows = min(kTR, p.N - row0);  // rows with codes
    if (p.staged) {  // the tile's codes, contiguous; rows past N read codeword 0
      const int nbytes = nrows * p.M;
      const uint8_t* src = p.codes + (size_t)row0 * p.M;
      int i0 = 0;
      if (p.codes16) {
        for (int i = tid; i < nbytes / 16; i += kThreads)
          reinterpret_cast<uint4*>(codes_s)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
        i0 = nbytes / 16 * 16;
      }
      for (int i = i0 + tid; i < nbytes; i += kThreads) codes_s[i] = src[i];
      for (int i = nbytes + tid; i < kTR * p.M; i += kThreads) codes_s[i] = 0;
    }
    __syncthreads();
    // the rows' norms stay in flight during the stages
    const float term = p.l2 && tid < nrows ? __ldg(p.rn + row0 + tid) : 0.f;
    // stage (c0): dims [c0, c0 + 64) of rows and queries, into registers
    auto fetch = [&](int c0) {
#pragma unroll
      for (int i = 0; i < kVChunks; ++i) {
        const int c = tid + i * kThreads, r = c >> 3, d0 = c0 + 8 * (c & 7);
        const uint8_t* crow = p.codes + (size_t)(row0 + min(r, nrows - 1)) * p.M;
        auto code = [&](int m) -> int {
          return p.staged ? codes_s[r * p.M + m] : __ldg(crow + m);
        };
        raw[i] = make_uint4(0u, 0u, 0u, 0u);
        if (p.vec8) {  // dsub % 8 == 0: 8 dims of one codeword, 16-byte aligned
          if (d0 < p.D) {
            const int m = d0 / p.dsub;
            raw[i] = __ldg(reinterpret_cast<const uint4*>(
                p.cb16 + ((size_t)m * p.K + code(m)) * p.dsub + (d0 - m * p.dsub)));
          }
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int d = d0 + e;
            if (d < p.D) {
              const int m = d / p.dsub;
              const uint32_t h = __bfloat16_as_ushort(
                  p.cb16[((size_t)m * p.K + code(m)) * p.dsub + (d - m * p.dsub)]);
              w[e >> 1] |= h << (16 * (e & 1));
            }
          }
          raw[i] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kQChunks; ++i) {
        const int c = tid + i * kThreads;
        const int jj = c >> 3;  // chunk c & 7 of query jj, where the swizzle put it
        qh[i] = __ldg(reinterpret_cast<const uint4*>(
                          p.q16 + (((size_t)blockIdx.x * p.nst + c0 / kKDK) * kQB + jj) * kKDK) +
                      ((c & 7) ^ (jj & 7)));
      }
    };
    auto store = [&](int b) {
      __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage_s + b * kStageBytes);
      __nv_bfloat16* q_s = a_s + kTR * kSA;
#pragma unroll
      for (int i = 0; i < kVChunks; ++i) {
        const int c = tid + i * kThreads;
        *reinterpret_cast<uint4*>(a_s + (c >> 3) * kSA + (c & 7) * 8) = raw[i];
      }
#pragma unroll
      for (int i = 0; i < kQChunks; ++i) {
        const int c = tid + i * kThreads;
        *reinterpret_cast<uint4*>(q_s + (c >> 3) * kSA + (c & 7) * 8) = qh[i];
      }
    };
    float acc[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
    fetch(0);
    store(0);
    __syncthreads();
    // software pipeline: load stage s+1 into registers, run stage s's
    // products, store stage s+1 into the other buffer; one barrier a stage
    const int nst = p.nst;
    for (int s = 0; s < nst; ++s) {
      const __nv_bfloat16* a_s =
          reinterpret_cast<const __nv_bfloat16*>(stage_s + (s & 1) * kStageBytes);
      if (s + 1 < nst) {
        fetch((s + 1) * kKDK);
        mma_stage<kSA, kKDK, kRowGroups, kWarpQ>(a_s, a_s + kTR * kSA, acc);
        store((s + 1) & 1);
      } else {
        mma_stage<kSA, kKDK, kRowGroups, kWarpQ>(a_s, a_s + kTR * kSA, acc);
      }
      __syncthreads();
    }
    if (tid < kTR) term_s[tid] = term;
    if (!SCORE_ALL && tid < nq) gthr[tid] = from_ordered_bits(__ldcg(p.kth_g + q0 + tid));
    __syncthreads();
    // epilogue: a thread's kFQ queries (a) x 4 rows (bb) of its accumulators
#pragma unroll
    for (int a = 0; a < kFQ; ++a) {
      const int j = (warp / kRowGroups) * kWarpQ + (a >> 1) * 8 + 2 * (lane & 3) + (a & 1);
      const float thr_j = SCORE_ALL ? 0.f : thr[j], g_j = SCORE_ALL ? 0.f : gthr[j];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int r = (warp % kRowGroups) * 32 + (bb >> 1) * 16 + (lane >> 2) + (bb & 1) * 8;
        const int row = row0 + r;
        const float ip = acc[((bb >> 1) * kNT + (a >> 1)) * 4 + (bb & 1) * 2 + (a & 1)];
        const float sc = p.l2 ? 2.f * ip - term_s[r] : ip;
        if (SCORE_ALL) {
          if (j < nq && row < p.N) p.out[(size_t)(q0 + j) * p.N + row] = sc;
        } else if (j < nq && row < end && sc > thr_j && sc >= g_j) {
          const int slot = p.k + atomicAdd(&n_cand[j], 1);
          buf_s[j * kbuf + slot] = sc;
          buf_i[j * kbuf + slot] = row;
        }
      }
    }
    if (!SCORE_ALL) {
      __syncthreads();
      for (int j = warp; j < nq; j += kWarps) {
        const int nc = n_cand[j];
        if (nc > 0) {
          const float kth = warp_merge_sorted(buf_s + j * kbuf, buf_i + j * kbuf, p.k, nc, lane);
          if (lane == 0) {
            thr[j] = kth;
            n_cand[j] = 0;
            if (kth > -INFINITY) atomicMax(p.kth_g + q0 + j, ordered_bits(kth));
          }
        }
      }
    }
    __syncthreads();
  }
  if (!SCORE_ALL) {
    __syncthreads();  // the buffers' initial fill, where the block had no tile
    const int chunks = gridDim.y;
    for (int i = tid; i < nq * p.k; i += kThreads) {
      const int j = i / p.k, r = i % p.k;
      const size_t o = ((size_t)(q0 + j) * chunks + blockIdx.y) * p.k + r;
      p.cand_s[o] = buf_s[j * kbuf + r];
      p.cand_i[o] = buf_i[j * kbuf + r];
    }
  }
}

// Shared memory of a wgmma decode block: a ring of `stages` (row tile,
// query tile) stage pairs, the row tile's codes (M <= kMaxStagedM), the
// fold's per-query thresholds and counts, the ring's barriers; 1 KB to
// align.
size_t decode_smem(int M, int stages) {
  return 1024 + (size_t)stages * (kRowTileBytes + kQN * kKDK * 2) +
         (M <= kMaxStagedM ? (size_t)(kTR * M + 15) / 16 * 16 : 0) + 3 * (size_t)kQN * 4 +
         2 * kMaxStages * sizeof(uint64_t);
}

// The deepest ring (kMaxStages down to 2) that fits a block; 0: none does
int decode_stages(int M) {
  for (int s = kMaxStages; s >= 2; --s)
    if (decode_smem(M, s) <= kSmemCap) return s;
  return 0;
}

// grid (ceil(Q / kQN), chunks), kDecThreads threads: consumer warpgroups 0
// and 1 multiply rows 64w + [0, 64) of each row tile by the block's kQN
// queries, the producer warpgroup fills the ring.  SCORE_ALL writes out (Q,
// N), else each (query, chunk) sorted top-k to cand_s / cand_i, empty slots
// (-inf, INT_MAX).
template <bool SCORE_ALL>
__global__ void __launch_bounds__(kDecThreads, 1)
decode_scan_kernel(const __grid_constant__ DecodeParams p) {
  constexpr int QN = kQN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* a_ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  unsigned char* b_ring = a_ring + S * kRowTileBytes;
  uint8_t* codes_s = b_ring + S * QN * kKDK * 2;
  float* thr = reinterpret_cast<float*>(codes_s + (p.staged ? (kTR * p.M + 15) / 16 * 16 : 0));
  float* cut = thr + QN;
  int* n_cand = reinterpret_cast<int*>(cut + QN);
  uint64_t* full = reinterpret_cast<uint64_t*>(n_cand + QN);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QN;
  const int nq = min(QN, p.Q - q0);
  const int end = SCORE_ALL ? p.N : min(p.N, p.limit);
  const int t_begin = blockIdx.y * p.tiles_per_chunk;
  const int t_end = min((end + kTR - 1) / kTR, t_begin + p.tiles_per_chunk);
  // the cluster's blocks hold one chunk's rows for C query tiles: each
  // gathers rows [128 c / C, 128 (c + 1) / C) of a row tile and copies them
  // to the others' rings, so every row is gathered once for C * 256 queries
  const int C = p.cluster;
  const uint32_t crank = C > 1 ? cluster_rank() : 0;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, kProducers + 1);  // every producer thread, and the copies' bytes
      mbar_init(empty + i, kConsumers / 32 * C);  // every consumer warp of the cluster
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (C > 1) cluster_sync();  // the peers' barriers are set up

  if (tid >= kConsumers) {
    // ---- producer: each thread gathers the 16-byte chunk j of rows
    // pt / 8 + 16 i of every stage, by cp.async straight into the swizzled
    // tile (dsub % 8 == 0) or by element (else); a stage's arrivals wait
    // one stage, for its copies to land; thread 0 starts the query tile's
    // bulk copy.
    warpgroup_regs_dec<kProducerRegs>();
    const int pt = tid - kConsumers, j = pt & 7;
    const int i0 = crank * (kTR / 16) / C, i1 = (crank + 1) * (kTR / 16) / C;  // rows 16 i + pt / 8
    const int block_bytes = kRowTileBytes / C;  // this block's rows of a row tile
    int it = 0, pending = -1;  // ring slot whose chunks are not yet announced
    auto announce = [&]() {  // and, in a cluster, copy this block's rows to the others
      fence_proxy_async();
      mbar_arrive(full + pending);
      if (C > 1) {
        named_sync(kBarProducer, kProducers);
        if (pt == 0)
          for (int c = 1; c < C; ++c)
            bulk_copy_s2cluster(a_ring + pending * kRowTileBytes + crank * block_bytes,
                                block_bytes, full + pending, (crank + c) % C);
      }
    };
    for (int t = t_begin; t < t_end; ++t) {
      const int row0 = t * kTR, nrows = min(kTR, p.N - row0);
      const uint8_t* tile_codes = p.codes + (size_t)row0 * p.M;
      if (p.staged) {  // the tile's codes, contiguous; rows past N read codeword 0
        if (pending >= 0) {
          cp_async_wait<0>();
          announce();
          pending = -1;
        }
        named_sync(kBarProducer, kProducers);  // every thread is done with the last tile's
        const int nbytes = nrows * p.M, tbytes = kTR * p.M;
        if (p.codes16) {
          for (int i = pt; i < (tbytes + 15) / 16; i += kProducers) {
            const int b = min(16, nbytes - 16 * i);
            cp_async16(codes_s + 16 * i, b > 0 ? tile_codes + 16 * i : tile_codes, max(b, 0));
          }
          cp_async_commit();
          cp_async_wait<0>();
        } else {
          for (int i = pt; i < tbytes; i += kProducers) codes_s[i] = i < nbytes ? tile_codes[i] : 0;
        }
        named_sync(kBarProducer, kProducers);
        const int next = min(kTR, p.N - row0 - kTR) * p.M / 16 * 16;
        if (pt == 0 && p.codes16 && t + 1 < t_end && next > 0)
          bulk_prefetch_l2(tile_codes + tbytes, next);
      }
      auto code = [&](int r, int m) -> int {
        return p.staged ? codes_s[r * p.M + m]
                        : __ldg(tile_codes + (size_t)min(r, nrows - 1) * p.M + m);
      };
      for (int s = 0; s < p.nst; ++s, ++it) {
        const int slot = it % S;
        mbar_wait(empty + slot, ((it / S) & 1) ^ 1);
        unsigned char* a_s = a_ring + slot * kRowTileBytes;
        if (pt == 0) {
          mbar_arrive_expect_tx(full + slot, QN * kKDK * 2 + (C - 1) * block_bytes);
          bulk_copy_g2s(b_ring + slot * QN * kKDK * 2,
                        p.q16 + ((size_t)blockIdx.x * p.nst + s) * QN * kKDK, QN * kKDK * 2,
                        full + slot);
        }
        const int d0 = s * kKDK + 8 * j;
#pragma unroll
        for (int i = 0; i < kTR / 16; ++i) {
          if (i < i0 || i >= i1) continue;
          const int r = (pt >> 3) + 16 * i;
          unsigned char* dst = a_s + r * (kKDK * 2) + ((j ^ (r & 7)) << 4);
          if (p.vec8) {  // 8 dims of one codeword, 16-byte aligned
            const __nv_bfloat16* src = p.cb16;
            int bytes = 0;
            if (d0 < p.D) {
              const int m = d0 / p.dsub;
              src = p.cb16 + ((size_t)m * p.K + code(r, m)) * p.dsub + (d0 - m * p.dsub);
              bytes = 16;
            }
            cp_async16(dst, src, bytes);
          } else {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int d = d0 + e;
              if (d < p.D) {
                const int m = d / p.dsub;
                const uint32_t h = __bfloat16_as_ushort(
                    p.cb16[((size_t)m * p.K + code(r, m)) * p.dsub + (d - m * p.dsub)]);
                w[e >> 1] |= h << (16 * (e & 1));
              }
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        cp_async_commit();
        if (pending >= 0) {
          cp_async_wait<1>();
          announce();
        }
        pending = slot;
      }
    }
    if (pending >= 0) {
      cp_async_wait<0>();
      announce();
    }
    if (C > 1) cluster_sync();  // no peer still copies into or arrives on this block
  } else {
    // ---- consumers: warpgroup w multiplies rows 64w + [0, 64) by the QN
    // queries, one wgmma m64nQNk16 a k-step, the accumulators in registers
    // across the stages; a stage's slot is released when its products are
    // done (one group in flight).  Then the epilogue and the fold.
    warpgroup_regs_inc<kConsumerRegs>();
    const int warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
    const int r_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows r_lo, r_lo + 8
    const int c0 = 2 * (lane & 3);  // queries c0, c0 + 1 of each 8
    const int kbuf = p.k + kFoldSlots;
    const size_t fold0 = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * QN * kbuf;
    float* fs = SCORE_ALL ? nullptr : p.fold_s + fold0;
    int* fi = SCORE_ALL ? nullptr : p.fold_i + fold0;
    if (!SCORE_ALL) {  // the top-k lists empty; candidate slots are read only once written
      for (int i = tid; i < QN * p.k; i += kConsumers) {
        fs[i / p.k * kbuf + i % p.k] = -INFINITY;
        fi[i / p.k * kbuf + i % p.k] = INT_MAX;
      }
      if (tid < QN) {
        thr[tid] = -INFINITY;
        n_cand[tid] = 0;
      }
    }
    // merge each query's candidates into its top-k where it holds `at` or
    // more: at most kFoldAt - 1 + a tile's rows, so in two rounds past 128
    auto fold = [&](int at) {
      for (int j = warp; j < nq; j += kConsumers / 32) {
        const int nc = n_cand[j];
        if (nc < max(at, 1)) continue;
        float* s = fs + j * kbuf;
        int* id = fi + j * kbuf;
        float kth = warp_fold_regs(s, id, p.k, s + p.k, id + p.k, min(nc, 128), lane);
        if (nc > 128)
          kth = warp_fold_regs(s, id, p.k, s + p.k + 128, id + p.k + 128, nc - 128, lane);
        if (lane == 0) {
          thr[j] = kth;
          n_cand[j] = 0;
          if (kth > -INFINITY) atomicMax(p.kth_g + q0 + j, ordered_bits(kth));
        }
      }
    };
    auto release = [&](int slot) {  // lane 0 of each warp: the slot is free here
      if (C == 1) {
        mbar_arrive(empty + slot);
        return;
      }
      for (int c = 0; c < C; ++c) mbar_arrive_cluster(empty + slot, c);
    };
    float acc[QN / 2];
#pragma unroll
    for (int a = 0; a < QN / 2; ++a) acc[a] = 0.f;
    int it = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int row_lo = t * kTR + r_lo, row_hi = row_lo + 8;
      // the rows' norms stay in flight during the stages
      const float term_lo = p.l2 && row_lo < p.N ? __ldg(p.rn + row_lo) : 0.f;
      const float term_hi = p.l2 && row_hi < p.N ? __ldg(p.rn + row_hi) : 0.f;
      for (int s = 0; s < p.nst; ++s, ++it) {
        const int slot = it % S;
        mbar_wait(full + slot, (it / S) & 1);
        const uint64_t da = sw128_desc(smem_addr(a_ring + slot * kRowTileBytes + wg * 64 * kKDK * 2));
        const uint64_t db = sw128_desc(smem_addr(b_ring + slot * QN * kKDK * 2));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKDK / 16; ++ks)
          wgmma_bf16<QN>(acc, da + 2 * ks, db + 2 * ks, s > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (s > 0 && lane == 0) release((it - 1) % S);
      }
      wgmma_wait<0>();
      if (lane == 0) release((it - 1) % S);
      if (!SCORE_ALL) {
        // a row is a candidate when it beats the block's k-th and reaches
        // the published one: score >= cut (+inf past the block's queries)
        if (tid < QN)
          cut[tid] = tid < nq ? fmaxf(nextafterf(thr[tid], INFINITY),
                                      from_ordered_bits(__ldcg(p.kth_g + q0 + tid)))
                              : INFINITY;
        named_sync(kBarConsumer, kConsumers);
      }
      // epilogue: 2 rows x QN / 4 queries a thread.  The fused kernel
      // compares first and appends after: admitted scores wait in `held`
      // (local memory, stored only where admitted), so a warp takes one
      // append round per candidate of its busiest lane, not one per
      // accumulator that some lane admits.
      const bool in_lo = row_lo < end, in_hi = row_hi < end;
      constexpr int kWords = (QN / 2 + 31) / 32;
      uint32_t adm[kWords];
      float held[QN / 2];
#pragma unroll
      for (int w = 0; w < kWords; ++w) adm[w] = 0u;
#pragma unroll
      for (int jb = 0; jb < QN / 8; ++jb) {
        const float2 cj = SCORE_ALL ? float2{} : *reinterpret_cast<const float2*>(cut + 8 * jb + c0);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int a = 4 * jb + v, qj = 8 * jb + c0 + (v & 1), row = v & 2 ? row_hi : row_lo;
          const float sc = p.l2 ? 2.f * acc[a] - (v & 2 ? term_hi : term_lo) : acc[a];
          if (SCORE_ALL) {
            if (qj < nq && row < p.N) p.out[(size_t)(q0 + qj) * p.N + row] = sc;
          } else if ((v & 2 ? in_hi : in_lo) && sc >= (v & 1 ? cj.y : cj.x)) {
            held[a] = sc;
            adm[a >> 5] |= 1u << (a & 31);
          }
        }
      }
      if (!SCORE_ALL) {
        bool any = false;
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          any |= adm[w] != 0u;
          for (uint32_t m = adm[w]; m; m &= m - 1) {
            const int a = 32 * w + __ffs(m) - 1, qj = 8 * (a >> 2) + c0 + (a & 1);
            const int slot = p.k + atomicAdd(&n_cand[qj], 1);
            fs[qj * kbuf + slot] = held[a];
            fi[qj * kbuf + slot] = a & 2 ? row_hi : row_lo;
          }
        }
        if (named_sync_or(kBarConsumer, kConsumers, any)) {
          fold(kFoldAt);
          named_sync(kBarConsumer, kConsumers);
        }
      }
    }
    if (!SCORE_ALL) {
      named_sync(kBarConsumer, kConsumers);
      fold(1);  // what is left
      named_sync(kBarConsumer, kConsumers);  // and the buffers' initial fill, where the block had no tile
      const int chunks = gridDim.y;
      for (int i = tid; i < nq * p.k; i += kConsumers) {
        const int j = i / p.k, r = i % p.k;
        const size_t o = ((size_t)(q0 + j) * chunks + blockIdx.y) * p.k + r;
        p.cand_s[o] = fs[j * kbuf + r];
        p.cand_i[o] = fi[j * kbuf + r];
      }
    }
    if (C > 1) cluster_sync();
  }
}

// ----------------------------------------------------------------- table route
// grid (ceil(Q / kLutQ), M); thread c owns codeword c of subquantizer m and
// writes entry (q, m, c) to lut[((q / g * M + m) * K + c) * g + q % g]: g = 4,
// one float4 a (m, c) for 4 queries, or g = 1, one table a query
__global__ void lut_kernel(const float* __restrict__ q, const float* __restrict__ cb,
                           float* __restrict__ lut, int Q, int D, int M, int K, int dsub,
                           int l2, int bf16, int g) {
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
  if (c >= K) return;
  if (g == kG) {
    float4* lut4 = reinterpret_cast<float4*>(lut);
#pragma unroll
    for (int j = 0; j < kLutQ / kG; ++j) {
      if (kG * j >= nq) break;
      float v[kG];
#pragma unroll
      for (int i = 0; i < kG; ++i) v[i] = l2 ? 2.f * acc[kG * j + i] - c2 : acc[kG * j + i];
      lut4[((size_t)(q0 / kG + j) * M + m) * K + c] = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kLutQ; ++r)
    if (r < nq) lut[((size_t)(q0 + r) * M + m) * K + c] = l2 ? 2.f * acc[r] - c2 : acc[r];
}

struct TableParams {
  const float* lut;       // QB >= 4: (ceil(Q / 4), M, K, 4), else (Q, M, K)
  const uint8_t* codes;   // (N, M)
  float* out;             // score_all: (Q, N)
  float* cand_s;          // fused: (Q, chunks, k)
  int* cand_i;
  unsigned int* kth_g;    // fused: (Q,) published k-th scores (ordered ints)
  int Q, N, M, K, k, limit, rows_per_chunk;
};

// Score one row against the block's QB queries: acc[j] = sum_m entry (m,
// code m) of query j, m ascending; the tables are 4-query interleaved (one
// float4 an entry) for QB >= 4, one query's for QB = 1.  VEC 16: codes read
// as 16-byte words.
template <int QB, bool SMEM, int VEC>
__device__ __forceinline__ void score_row(float (&acc)[QB], const float* lut,
                                          const uint8_t* __restrict__ code, int M, int K) {
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0.f;
  const int gstride = M * K;
  auto add = [&](int m, uint32_t c) {
    const int off = m * K + (int)c;
    if constexpr (QB >= kG) {
      const float4* lut4 = reinterpret_cast<const float4*>(lut);
#pragma unroll
      for (int g = 0; g < QB / kG; ++g) {
        const float4 v = SMEM ? lut4[g * gstride + off] : __ldg(lut4 + g * gstride + off);
        acc[kG * g] += v.x;
        acc[kG * g + 1] += v.y;
        acc[kG * g + 2] += v.z;
        acc[kG * g + 3] += v.w;
      }
    } else {
      acc[0] += SMEM ? lut[off] : __ldg(lut + off);
    }
  };
  if (VEC == 16) {
    const uint4* w = reinterpret_cast<const uint4*>(code);
    for (int m16 = 0; m16 < (M >> 4); ++m16) {
      const uint4 v = __ldg(w + m16);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) add(16 * m16 + b, (words[b >> 2] >> (8 * (b & 3))) & 0xFFu);
    }
  } else {
    for (int m = 0; m < M; ++m) add(m, __ldg(code + m));
  }
}

// grid (ceil(Q / QB), chunks); QB queries' tables in shared memory (SMEM),
// else one query's read from global memory.  SCORE_ALL writes out (Q, N),
// else each (query, chunk) sorted top-k to cand_s / cand_i.
template <int QB, bool SMEM, int VEC, bool SCORE_ALL>
__global__ void __launch_bounds__(kThreads, 1)
table_scan_kernel(const __grid_constant__ TableParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  const int kbuf = p.k + kFoldRows;
  float* buf_s = lut_s + (SMEM ? (size_t)QB * p.M * p.K : 0);
  int* buf_i = reinterpret_cast<int*>(buf_s + QB * kbuf);
  __shared__ float thr[QB];
  __shared__ float gthr[QB];
  __shared__ int n_cand[QB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, p.Q - q0);
  constexpr int G = QB >= kG ? kG : 1;  // queries interleaved in an entry
  const float* src = p.lut + (size_t)q0 * p.M * p.K;
  if (SMEM) {  // the block's tables (whole groups of G queries)
    const size_t n = (size_t)(nq + G - 1) / G * G * p.M * p.K;
    if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (size_t i = tid; i < n / 4; i += kThreads)
        reinterpret_cast<float4*>(lut_s)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
    } else {
      for (size_t i = tid; i < n; i += kThreads) lut_s[i] = __ldg(src + i);
    }
  }
  const float* lut = SMEM ? lut_s : src;
  if (!SCORE_ALL) {
    for (int i = tid; i < QB * kbuf; i += kThreads) {
      buf_s[i] = -INFINITY;
      buf_i[i] = INT_MAX;
    }
    if (tid < QB) {
      thr[tid] = -INFINITY;
      gthr[tid] = -INFINITY;
      n_cand[tid] = 0;
    }
  }
  __syncthreads();

  const int end = SCORE_ALL ? p.N : min(p.N, p.limit);
  const int row_begin = blockIdx.y * p.rows_per_chunk;
  const int row_end = min(end, row_begin + p.rows_per_chunk);
  for (int base = row_begin; base < row_end; base += kThreads) {
    const int row = base + tid;
    float acc[QB];
    if (row < row_end) score_row<QB, SMEM, VEC>(acc, lut, p.codes + (size_t)row * p.M, p.M, p.K);
    if (SCORE_ALL) {
#pragma unroll
      for (int j = 0; j < QB; ++j)
        if (j < nq && row < row_end) p.out[(size_t)(q0 + j) * p.N + row] = acc[j];
      continue;
    }
    // a row is a candidate when it beats the block's k-th and reaches the
    // published one (gthr: a lower bound on the final k-th however stale)
    auto admits = [&](int j) { return j < nq && acc[j] > thr[j] && acc[j] >= gthr[j]; };
    bool any = false;
    if (row < row_end) {
#pragma unroll
      for (int j = 0; j < QB; ++j) any |= admits(j);
    }
    if (!__syncthreads_or(any)) continue;  // most steps: one barrier
    if (tid < nq) gthr[tid] = from_ordered_bits(__ldcg(p.kth_g + q0 + tid));
    __syncthreads();
    // four rounds of kFoldRows rows: admit, then merge when any row was
    // admitted
    for (int f = 0; f < kThreads / kFoldRows; ++f) {
      bool added = false;
      if (tid / kFoldRows == f && row < row_end) {
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          if (admits(j)) {
            const int slot = p.k + atomicAdd(&n_cand[j], 1);
            buf_s[j * kbuf + slot] = acc[j];
            buf_i[j * kbuf + slot] = row;
            added = true;
          }
        }
      }
      if (!__syncthreads_or(added)) continue;
      for (int j = warp; j < nq; j += kWarps) {
        const int nc = n_cand[j];
        if (nc > 0) {
          const float kth = warp_merge_sorted(buf_s + j * kbuf, buf_i + j * kbuf, p.k, nc, lane);
          if (lane == 0) {
            thr[j] = kth;
            n_cand[j] = 0;
            if (kth > -INFINITY) atomicMax(p.kth_g + q0 + j, ordered_bits(kth));
          }
        }
      }
      __syncthreads();
    }
  }
  if (!SCORE_ALL) {
    const int chunks = gridDim.y;
    for (int i = tid; i < nq * p.k; i += kThreads) {
      const int j = i / p.k, r = i % p.k;
      const size_t o = ((size_t)(q0 + j) * chunks + blockIdx.y) * p.k + r;
      p.cand_s[o] = buf_s[j * kbuf + r];
      p.cand_i[o] = buf_i[j * kbuf + r];
    }
  }
}

// ------------------------------------------------------------------- launches
size_t table_smem(int qb, int M, int K, int k, bool score_all) {
  return (size_t)qb * M * K * sizeof(float) +
         (score_all ? 0 : (size_t)max(qb, 1) * (k + kFoldRows) * (sizeof(float) + sizeof(int)));
}

// The decode kernel of a query-tile width, its threads and shared memory
// (kernel null: no such width or no block fits)
struct DecodeLaunch {
  const void* kernel;
  int threads, stages;
  size_t smem;
};

// Its configuration on `grid` in clusters of (cluster, 1) blocks; `attr`
// holds the cluster's shape.
cudaLaunchConfig_t decode_config(const DecodeLaunch& l, dim3 grid, int cluster, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

DecodeLaunch decode_launch(int qn, int M, int k, bool score_all) {
  if (qn == kQB)
    return {score_all ? (const void*)decode_mma_kernel<true> : (const void*)decode_mma_kernel<false>,
            kThreads, 0, decode_mma_smem(M, score_all ? 0 : k)};
  const int stages = decode_stages(M);
  if (qn != kQN || stages == 0) return {nullptr, 0, 0, 0};
  return {score_all ? (const void*)decode_scan_kernel<true> : (const void*)decode_scan_kernel<false>,
          kDecThreads, stages, decode_smem(M, stages)};
}

// The table kernel instance of a launch (null: no such instance)
template <bool SCORE_ALL>
const void* table_kernel(int qb, int vec16) {
  switch (qb * 2 + (vec16 ? 1 : 0)) {
    case 16: return (const void*)table_scan_kernel<8, true, 1, SCORE_ALL>;
    case 17: return (const void*)table_scan_kernel<8, true, 16, SCORE_ALL>;
    case 8: return (const void*)table_scan_kernel<4, true, 1, SCORE_ALL>;
    case 9: return (const void*)table_scan_kernel<4, true, 16, SCORE_ALL>;
    case 2: return (const void*)table_scan_kernel<1, true, 1, SCORE_ALL>;
    case 3: return (const void*)table_scan_kernel<1, true, 16, SCORE_ALL>;
    case 0: return (const void*)table_scan_kernel<1, false, 1, SCORE_ALL>;
    case 1: return (const void*)table_scan_kernel<1, false, 16, SCORE_ALL>;
    default: return nullptr;
  }
}

// Set the launch's dynamic shared memory; resident blocks per SM at it (0:
// the launch cannot run)
int occupancy(const void* kernel, int threads, size_t smem) {
  int n = 0;
  cudaError_t err = kernel == nullptr ? cudaErrorInvalidValue
                                      : cudaFuncSetAttribute(kernel,
                                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the caller sees 0, not a stale error at its next launch
    return 0;
  }
  return n;
}

}  // namespace

extern "C" {

// Layout constants, read by the Python wrapper.
int vq_merge_cap() { return kMergeCap; }
int vq_pq_decode_tile_rows() { return kTR; }
int vq_pq_decode_stage_dims() { return kKDK; }
int vq_pq_decode_fold_slots(int qn) { return qn == kQN ? kFoldSlots : 0; }
int vq_pq_table_step_rows() { return kThreads; }
int vq_pq_table_group() { return kG; }

// Resident blocks per SM of a table-route launch with qb = 8 / 4 / 1
// queries' tables in shared memory or 0 (one query's, global memory);
// vec16: 16-byte code loads.  0 if it cannot run.  The wrapper sizes the
// grid from it.
int vq_pq_table_blocks_per_sm(int qb, int M, int K, int k, int score_all, int vec16) {
  const void* kern = score_all ? table_kernel<true>(qb, vec16) : table_kernel<false>(qb, vec16);
  return occupancy(kern, kThreads, table_smem(qb, M, K, k, score_all));
}

// Blocks a decode launch with query tiles of qn = 64 (mma.sync) or 256
// (wgmma, in clusters of `cluster` = 1, 2 or 4 query tiles) keeps resident
// on the card at once; 0 if it cannot run.  The wrapper sizes the grid
// from it.
int vq_pq_decode_slots(int qn, int M, int k, int score_all, int cluster) {
  const DecodeLaunch l = decode_launch(qn, M, k, score_all);
  int dev = 0, sms = 0, n = 0;
  if (l.kernel == nullptr || (cluster > 1 && qn != kQN) || cluster < 1 || cluster > 4 ||
      kQN % cluster != 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (cluster == 1) return occupancy(l.kernel, l.threads, l.smem) * sms;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = decode_config(l, dim3(cluster, 1), cluster, 0, &attr);
  if (cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, l.kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n * cluster;
}

// Decode route.  q (Q, D), cb (M, K, dsub) f32, codes (N, M) u8, query
// tiles of qn = 64 (mma.sync) or 256 (wgmma); scratch q16 (Qp, Dp) bf16 (Qp
// = Q rounded up to qn, Dp = D rounded up to vq_pq_decode_stage_dims()),
// cb16 (M, K, dsub) bf16, cnorm (M, K) f32, rn (N,) f32 (L2).  out != null:
// out (Q, N) scores; else cand (Q, chunks + merge groups, k) -> out_s /
// out_i (Q, k), at qn = 256 fold (Qp / qn * chunks, qn, k +
// vq_pq_decode_fold_slots(qn)) f32 / i32 the blocks' running top-k and
// candidates, kth_g (Q,) u32 set by the caller to vq_ordered_neg_inf().
// The wgmma kernel runs in clusters of `cluster` query tiles (dividing
// their count) that share each row tile's gathers.
int vq_pq_decode_scan(const float* q, const float* cb, const uint8_t* codes, void* q16,
                      void* cb16, float* cnorm, float* rn, float* out, float* cand_s,
                      int* cand_i, float* fold_s, int* fold_i, float* out_s, int* out_i,
                      unsigned int* kth_g, int Q, int N, int M, int K, int dsub, int k,
                      int limit, int l2, int qn, int chunks, int cluster, void* stream) {
  const bool score_all = out != nullptr;
  const DecodeLaunch l = decode_launch(qn, M, k, score_all);
  const int qblocks = (Q + qn - 1) / qn;
  if (K < 1 || K > 256 || M < 1 || dsub < 1 || Q < 1 || chunks < 1 || l.kernel == nullptr ||
      (!score_all && !merge_shape_ok(chunks, k)) || cluster < 1 || cluster > 4 ||
      kQN % cluster != 0 || qblocks % cluster != 0 || (cluster > 1 && qn != kQN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DecodeParams p;
  p.q16 = static_cast<const __nv_bfloat16*>(q16);
  p.cb16 = static_cast<const __nv_bfloat16*>(cb16);
  p.rn = rn; p.codes = codes; p.out = out; p.cand_s = cand_s; p.cand_i = cand_i;
  p.fold_s = fold_s; p.fold_i = fold_i; p.kth_g = kth_g;
  p.Q = Q; p.N = N; p.M = M; p.K = K; p.dsub = dsub; p.D = M * dsub;
  p.nst = (p.D + kKDK - 1) / kKDK;
  p.k = score_all ? 0 : k; p.limit = limit; p.l2 = l2;
  p.tiles_per_chunk = ((N + kTR - 1) / kTR + chunks - 1) / chunks;
  p.staged = M <= kMaxStagedM;
  p.codes16 = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  p.vec8 = dsub % 8 == 0;
  p.stages = l.stages;
  p.cluster = cluster;
  round_pq_queries_kernel<<<qblocks * qn, 256, 0, st>>>(q, static_cast<__nv_bfloat16*>(q16), Q,
                                                       p.D, p.nst, qn);
  round_codebook_kernel<<<(M * K + 255) / 256, 256, 0, st>>>(
      cb, static_cast<__nv_bfloat16*>(cb16), cnorm, M * K, dsub);
  if (l2 && N > 0) row_norms_kernel<<<(N + 255) / 256, 256, 0, st>>>(codes, cnorm, rn, N, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  void* args[] = {&p};
  if (cluster == 1) {
    err = cudaLaunchKernel(l.kernel, dim3(qblocks, chunks), dim3(l.threads), args, l.smem, st);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = decode_config(l, dim3(qblocks, chunks), cluster, st, &attr);
    err = cudaLaunchKernelExC(&cfg, l.kernel, args);
  }
  if (err != cudaSuccess || score_all) return (int)err;
  return (int)merge_chunks(cand_s, cand_i, out_s, out_i, Q, chunks, k, st);
}

// Table route.  q (Q, D), cb (M, K, dsub) f32, codes (N, M) u8; scratch lut
// (ceil(Q / 4) * 4, M, K) f32; qb = 8 / 4 / 1 queries' tables in shared
// memory, 0 one query's in global memory; vec16: codes 16-byte aligned and
// M % 16 == 0.  out / cand / kth_g as vq_pq_decode_scan.
int vq_pq_table_scan(const float* q, const float* cb, const uint8_t* codes, float* lut,
                     float* out, float* cand_s, int* cand_i, float* out_s, int* out_i,
                     unsigned int* kth_g, int Q, int N, int M, int K, int dsub, int k, int limit,
                     int l2, int bf16, int qb, int vec16, int chunks, void* stream) {
  const bool score_all = out != nullptr;
  const void* kern = score_all ? table_kernel<true>(qb, vec16) : table_kernel<false>(qb, vec16);
  if (K < 1 || K > 256 || M < 1 || dsub < 1 || Q < 1 || chunks < 1 || kern == nullptr ||
      (vec16 && (M % 16 != 0 || (reinterpret_cast<uintptr_t>(codes) & 15) != 0)) ||
      (!score_all && !merge_shape_ok(chunks, k)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  lut_kernel<<<dim3((Q + kLutQ - 1) / kLutQ, M), kLutThreads, 0, st>>>(
      q, cb, lut, Q, M * dsub, M, K, dsub, l2, bf16, qb >= kG ? kG : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  TableParams p;
  p.lut = lut;
  p.codes = codes; p.out = out; p.cand_s = cand_s; p.cand_i = cand_i; p.kth_g = kth_g;
  p.Q = Q; p.N = N; p.M = M; p.K = K; p.k = score_all ? 0 : k; p.limit = limit;
  p.rows_per_chunk = ((N + kThreads - 1) / kThreads + chunks - 1) / chunks * kThreads;
  const size_t smem = table_smem(qb, M, K, p.k, score_all);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int per = max(qb, 1);
  void* args[] = {&p};
  err = cudaLaunchKernel(kern, dim3((Q + per - 1) / per, chunks), dim3(kThreads), args, smem, st);
  if (err != cudaSuccess || score_all) return (int)err;
  return (int)merge_chunks(cand_s, cand_i, out_s, out_i, Q, chunks, k, st);
}

}  // extern "C"
