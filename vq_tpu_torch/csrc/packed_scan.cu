// Packed-code scan + top-k for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces vq_tpu/kernels/pallas_packed.py::packed_scan_topk, dense grid
// and prune=True (_packed_kernel with _unpack_words, _dequant_seg, the
// variance-prune bound and the running top-k folds), and its tile-gather
// mode (tile_mask / mask_cap, _packed_kernel_gather)
//   -> vq_packed_scan_topk = packed_scan_kernel + merge_kernel (topk.cuh).
//
// What it computes (the TPU kernel's contract).  The corpus is S segments
// of B_s-bit per-dimension codes, packed as "tile-ordered bitplane words":
// in each 512-row tile, int32 word r, shift slot j (B_eff bits wide) holds
// tile-local row j*(512/u) + r, u = 32/B_eff.  A row's value in a segment
// dimension is dequantized by the segment's kind:
//   uniform  (c + .5) * 2/2^B - 1           (the CAQ mid-rise grid)
//   perdim   lv[dim, c]   (ln, 2^B) table   shared  lv[c]  (1, 2^B) table
//   values   an f32 value plane (N, ln) stored as it is
// then multiplied by the row's scale factor (factor column scale_col).
// With ip = q . x^ over the D = sum ln_s dimensions the maximize-form score
// is  L2 2*ip + qa - sum_{c in r2} fac[c]   IP ip + qa   NIP (ip + qa)/fac[norm]
// and rows at or past `limit` are masked.  bf16 mode rounds queries and the
// scaled values to bf16 and accumulates in f32 (the MXU's numbers up to
// summation order); f32 mode computes in f32 throughout.  The result is the
// exact top-k per query, score descending then id ascending, empty slots
// -inf with id 0.
//
// Variance prune (prune != 0): before a 512-row tile, each of the block's
// queries bounds every score in the tile from the tile's stats (min |r^|,
// max |r^|, CAQ margin, norm envelope) and its (A, B) row, with the four
// bound shapes of family x metric; the tile is skipped when no query's
// bound reaches its k-th score threshold.  The TPU kernel walks tiles in
// order and holds the running k-th over all earlier tiles.  Here blocks run
// in parallel, each over its own chunk, so a block's own k-th is weak on a
// norm-ordered corpus; every block therefore also publishes its running
// k-th per query to `kth_g` (atomicMax on an order-preserving integer): the
// largest k-th of any block's rows is a lower bound on the final k-th, and a
// tile whose bound is strictly below it holds no result row.  Pruning stays
// exact; how much it skips depends on the order blocks run in, and
// `scanned` counts (query block, tile) pairs whose tile was scanned, not
// tiles.
//
// What bounds it on the H100: arithmetic.  The scan is 2*Q*N*D flops
// (5.5e11 at Q=256, N=1M, D=1024) against ~0.3 GB of codes at 2 bits a
// dimension, ~1800 flops a byte.  This first kernel runs the products on
// the CUDA cores in f32 (FFMA), so it cannot beat ~8 ms per such batch
// (published FP32 rate); tensor cores (mma.sync / wgmma on bf16 tiles) are
// the later fix.
//
// Gather mode (tiles != nullptr): the caller compacts the tile mask on the
// card into an ascending list of masked-in tile ids and their count `cnt`,
// both in device memory (no host sync).  Block (query block, y) walks list
// entries [y*c, (y+1)*c), c = ceil(cnt/chunks) read from device memory: the
// LIST is split, not the grid, so at 5% of tiles masked in the work still
// spreads over the blocks, masked-out tiles cost neither memory traffic nor
// compute, and a full list splits exactly as the dense grid does.
// Row offsets, the tile-stats lookup, the `limit` mask and the ids written
// into the top-k all use the global tile id list[i]; the list is ascending,
// so rows still reach a block's running top-k in id order.  Composes with
// prune (a tile scans when it is masked in and its bound survives); with
// cnt = 0 every block writes empty candidates and the merge launch still
// writes the (-inf, id 0) result.
//
// Design.  A block owns kQB = 32 queries x a chunk of whole 512-row tiles
// (a prune tile is never split).  It walks its tiles in order (tile = chunk
// start + i, or list[i] in the gather mode) and each tile in kTR = 128-row
// register tiles.  For each 32-dimension stage it
// unpacks and dequantizes the 128 x 32 value tile ONCE into shared memory
// (lanes on consecutive dimensions: the word loads are coalesced) and
// stages the 32 x 32 query tile; each thread then accumulates a 4-query x
// 4-row block of dot products in registers, so every dequantized value is
// reused by all 32 queries.  The stages are software-pipelined: the next
// stage's words and queries are loaded into registers while the current
// stage's products run, so the loads' latency hides behind arithmetic.  Level tables are copied to shared memory when
// they fit (<= 64 KB; the main path's uniform grid needs none), else read
// through the read-only cache.  Factors are feature-major (F, N), so a
// factor column of consecutive rows is one contiguous run.  After each
// 128-row tile the scores enter the per-query running top-k of topk.cuh.
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

constexpr int kThreads = 256;          // 8 warps
constexpr int kTile = 512;             // word-layout and prune tile (rows)
constexpr int kQB = 32;                // queries per block (4 per warp)
constexpr int kTR = 128;               // rows per register tile (4 per lane)
constexpr int kDK = 32;                // dimensions per shared-memory stage
constexpr int kBuf = 256;              // per-query candidate buffer >= k + kTR
constexpr int kMaxSegs = 48;
constexpr int kLvSmemFloats = 16384;   // level tables in shared memory up to 64 KB

enum Kind { kUniform = 0, kPerdim = 1, kShared = 2, kValues = 3 };
enum MetricKind { kL2 = 0, kIP = 1, kNIP = 2 };

struct Seg {
  const void* data;  // int32 words (N/u, ln), or f32 values (N, ln)
  const float* lv;   // level table, (ln, 2^bits) perdim / (1, 2^bits) shared
  int bits, beff, ln, kind, scale_col, lv_off;
  int rt_shift;      // log2 of the word rows per tile (512 / u)
  float delta;       // uniform grid step 2 / 2^bits
};

struct Params {
  const float* q;       // (Q, D)
  const float* qa;      // (Q,)
  const float* fac;     // (F, N) feature-major
  const float* stats;   // (nb, 5)
  const float* qprune;  // (Q, 2)
  float* cand_s;        // (Q, chunks, k)
  int* cand_i;
  int* scanned;         // (query block, tile) pairs scanned
  unsigned int* kth_g;  // (Q,) published k-th scores (ordered ints), prune only
  const int* tiles;     // gather mode: (nb,) ascending masked-in tile ids; else null
  const int* cnt;       // gather mode: (1,) number of valid entries of `tiles`
  int Q, D, N, k, limit, metric, family, norm_col, bf16, prune, nb;
  int nseg, n_r2, lv_smem;
  int r2[kMaxSegs];
  Seg seg[kMaxSegs];
};

// float <-> unsigned int with the floats' order (for atomicMax)
__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Upper bound on query qi's maximize-form score over tile t (family x metric)
__device__ float tile_bound(const Params& p, int t, int qi) {
  const float* st = p.stats + (size_t)t * 5;
  const float rmin = st[0], rmax = st[1], me = st[2];
  const float a = p.qprune[2 * qi], b = p.qprune[2 * qi + 1];
  if (p.metric == kL2 && p.family == 0) {
    const float c = fminf(fmaxf(b, rmin), rmax);
    return a + b * b - (b - c) * (b - c) + 2.f * b * me;
  }
  if (p.metric == kL2) return a - rmin * rmin + 2.f * b * (rmax + me);
  const float u = a + b * (rmax + me);
  if (p.metric == kNIP) return fmaxf(u / fmaxf(st[3], 1e-30f), u / fmaxf(st[4], 1e-30f));
  return u;
}

constexpr int kRowsPerThread = kTR / (kThreads / 32);   // 16 staged rows a thread
constexpr int kQPerThread = kQB * kDK / kThreads;       // 4 staged query values

// Issue the global loads of one stage -- segment dims [c0, c0 + kDK) of the
// kTR rows from row0 (in tile t) and of the block's queries -- into
// registers: lanes on consecutive dims (coalesced), warps on rows.  The
// loads complete while the previous stage's products run.
__device__ __forceinline__ void fetch_stage(const Params& p, const Seg& sg, int t, int row0,
                                            int c0, int doff, int q0, int nq,
                                            uint32_t (&raw)[kRowsPerThread],
                                            float (&qv)[kQPerThread]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = c0 + lane, ln = sg.ln;
  if (col < ln) {
    if (sg.kind == kValues) {
      const float* vals = static_cast<const float*>(sg.data) + (size_t)row0 * ln + col;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        raw[i] = __float_as_uint(__ldg(vals + (size_t)(warp + 8 * i) * ln));
    } else {
      const int sh = sg.rt_shift, tl0 = row0 - t * kTile;
      const uint32_t* words =
          static_cast<const uint32_t*>(sg.data) + ((size_t)t << sh) * ln + col;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)  // word row: tile-local row mod 512/u
        raw[i] = __ldg(words + (size_t)((tl0 + warp + 8 * i) & ((1 << sh) - 1)) * ln);
    }
  }
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    const int j = warp + 8 * i;
    qv[i] = (j < nq && col < ln) ? __ldg(p.q + (size_t)(q0 + j) * p.D + doff + col) : 0.f;
  }
}

// Dequantize a fetched stage -- shift slot, level, row scale, bf16 rounding
// -- into x_s[dim][row], and the queries into q_s[dim][query].
__device__ __forceinline__ void store_stage(const Params& p, const Seg& sg, const float* lv,
                                            const float* scale_s, int t, int row0, int c0,
                                            const uint32_t (&raw)[kRowsPerThread],
                                            const float (&qv)[kQPerThread],
                                            float (*x_s)[kTR + 1], float (*q_s)[kQB + 4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = c0 + lane;
  const int kind = sg.kind, beff = sg.beff, sh = sg.rt_shift;
  const uint32_t mask = (1u << sg.bits) - 1u;
  const bool scaled = sg.scale_col >= 0;
  const int tl0 = row0 - t * kTile;
  const float* lv_col = lv + (kind == kPerdim ? col << sg.bits : 0);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = warp + 8 * i;
    float v = 0.f;
    if (col < sg.ln) {
      if (kind == kValues) {
        v = __uint_as_float(raw[i]);
      } else {  // shift slot: tile-local row / (512/u)
        const int c = (raw[i] >> (beff * ((tl0 + r) >> sh))) & mask;
        v = kind == kUniform ? ((float)c + 0.5f) * sg.delta - 1.f : lv_col[c];
      }
      if (scaled) v *= scale_s[r];
      v = rnd(v, p.bf16);
    }
    x_s[lane][r] = v;
  }
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) q_s[lane][warp + 8 * i] = rnd(qv[i], p.bf16);
}

// Row scales of segment s for rows [row0, row0 + kTR), by threads < kTR
__device__ __forceinline__ void load_scales(const Params& p, int s, int row0, float* scale_s) {
  const int col = p.seg[s].scale_col;
  if (col >= 0 && threadIdx.x < kTR)
    scale_s[threadIdx.x] = __ldg(p.fac + (size_t)col * p.N + row0 + threadIdx.x);
}

// Per-row score term: the summed L2 shift, or the NIP divisor
__device__ __forceinline__ float row_term(const Params& p, int row) {
  if (p.metric == kL2) {
    float shift = __ldg(p.fac + (size_t)p.r2[0] * p.N + row);
    for (int i = 1; i < p.n_r2; ++i) shift = shift + __ldg(p.fac + (size_t)p.r2[i] * p.N + row);
    return shift;
  }
  if (p.metric == kNIP) return fmaxf(__ldg(p.fac + (size_t)p.norm_col * p.N + row), 1e-30f);
  return 0.f;
}

// grid (ceil(Q / kQB), chunks); writes each (query, chunk) sorted top-k to
// cand_s / cand_i; empty slots are (-inf, INT_MAX).
__global__ void __launch_bounds__(kThreads, 2)
packed_scan_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  float* buf_s = smem;
  int* buf_i = reinterpret_cast<int*>(buf_s + kQB * kBuf);
  float* lv_s = reinterpret_cast<float*>(buf_i + kQB * kBuf);
  __shared__ __align__(16) float q_s[kDK][kQB + 4];  // +4: 16-byte rows, 4-way stores
  __shared__ float x_s[kDK][kTR + 1];                // +1: conflict-free both ways
  __shared__ float qa_s[kQB];
  __shared__ float thr[kQB];
  __shared__ int n_cand[kQB];
  __shared__ float term_s[kTR];
  __shared__ float scale_s[2][kTR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQB;
  const int nq = min(kQB, p.Q - q0);
  // this block's range of tiles (dense) or of list entries (gather): chunks
  // of ceil(count / chunks), so a full list splits as the dense grid does
  const int count = p.tiles != nullptr ? p.cnt[0] : p.nb;
  const int per = (count + (int)gridDim.y - 1) / (int)gridDim.y;
  const int i_begin = min(count, (int)blockIdx.y * per);
  const int i_end = min(count, i_begin + per);

  for (int i = tid; i < kQB * kBuf; i += kThreads) {
    buf_s[i] = -INFINITY;
    buf_i[i] = INT_MAX;
  }
  if (tid < kQB) {
    qa_s[tid] = tid < nq ? p.qa[q0 + tid] : 0.f;
    thr[tid] = -INFINITY;
    n_cand[tid] = 0;
  }
  if (p.lv_smem) {
    for (int s = 0; s < p.nseg; ++s) {
      const Seg& sg = p.seg[s];
      if (sg.kind != kPerdim && sg.kind != kShared) continue;
      const int n = (sg.kind == kPerdim ? sg.ln : 1) << sg.bits;
      for (int i = tid; i < n; i += kThreads) lv_s[sg.lv_off + i] = sg.lv[i];
    }
  }
  __syncthreads();

  for (int i = i_begin; i < i_end; ++i) {
    const int t = p.tiles != nullptr ? p.tiles[i] : i;  // global tile id
    if (p.prune) {
      bool keep = false;
      if (tid < nq) {
        const float kth = fmaxf(thr[tid], from_ordered_bits(__ldcg(p.kth_g + q0 + tid)));
        keep = !(tile_bound(p, t, q0 + tid) < kth);
      }
      if (!__syncthreads_or(keep)) continue;
      if (tid == 0) atomicAdd(p.scanned, 1);
    }
    for (int row0 = t * kTile; row0 < (t + 1) * kTile && row0 < p.limit; row0 += kTR) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      // software pipeline over the stages (segment s, dims c0..c0+kDK):
      // store stage i, then fetch stage i+1 while stage i's products run.
      // Row scales are double-buffered by segment parity.
      int s = 0, c0 = 0, doff = 0;
      uint32_t raw[kRowsPerThread] = {};
      float qv[kQPerThread];
      load_scales(p, 0, row0, scale_s[0]);
      fetch_stage(p, p.seg[0], t, row0, 0, 0, q0, nq, raw, qv);
      __syncthreads();
      while (true) {
        const Seg& sg = p.seg[s];
        store_stage(p, sg, p.lv_smem ? lv_s + sg.lv_off : sg.lv, scale_s[s & 1], t, row0, c0,
                    raw, qv, x_s, q_s);
        __syncthreads();
        int ns = s, nc0 = c0 + kDK, ndoff = doff;
        if (nc0 >= sg.ln) ns = s + 1, nc0 = 0, ndoff = doff + sg.ln;
        const bool more = ns < p.nseg;
        if (more) {
          if (ns != s) load_scales(p, ns, row0, scale_s[ns & 1]);
          fetch_stage(p, p.seg[ns], t, row0, nc0, ndoff, q0, nq, raw, qv);
        }
#pragma unroll 8
        for (int d = 0; d < kDK; ++d) {
          const float4 qd = *reinterpret_cast<const float4*>(&q_s[d][warp * 4]);
          const float qq[4] = {qd.x, qd.y, qd.z, qd.w};
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float xv = x_s[d][lane + 32 * b];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(qq[a], xv, acc[a][b]);
          }
        }
        __syncthreads();
        if (!more) break;
        s = ns, c0 = nc0, doff = ndoff;
      }
      if (tid < kTR) term_s[tid] = row_term(p, row0 + tid);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = warp * 4 + a;
        if (j >= nq) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = lane + 32 * b;
          const int row = row0 + r;
          const float ip = acc[a][b];
          float sc;
          if (p.metric == kL2) sc = 2.f * ip + qa_s[j] - term_s[r];
          else if (p.metric == kIP) sc = ip + qa_s[j];
          else sc = (ip + qa_s[j]) / term_s[r];
          if (row < p.limit && sc > thr[j]) {
            const int slot = p.k + atomicAdd(&n_cand[j], 1);
            buf_s[j * kBuf + slot] = sc;
            buf_i[j * kBuf + slot] = row;
          }
        }
      }
      __syncthreads();
      for (int j = warp; j < nq; j += kThreads / 32) {
        const int nc = n_cand[j];
        if (nc > 0) {
          const float kth = warp_merge_candidates(buf_s + j * kBuf, buf_i + j * kBuf, p.k, nc,
                                                  lane);
          if (lane == 0) {
            thr[j] = kth;
            n_cand[j] = 0;
            if (p.prune && kth > -INFINITY) atomicMax(p.kth_g + q0 + j, ordered_bits(kth));
          }
        }
      }
      __syncthreads();
    }
  }
  const int chunks = gridDim.y;
  for (int i = tid; i < nq * p.k; i += kThreads) {
    const int j = i / p.k, r = i % p.k;
    const size_t o = ((size_t)(q0 + j) * chunks + blockIdx.y) * p.k + r;
    p.cand_s[o] = buf_s[j * kBuf + r];
    p.cand_i[o] = buf_i[j * kBuf + r];
  }
}

}  // namespace

extern "C" {

// Layout constants, read by the Python wrapper.
int vq_packed_queries_per_block() { return kQB; }
int vq_packed_max_segments() { return kMaxSegs; }
int vq_ordered_neg_inf() { return (int)~0xff800000u; }  // ordered bits of -inf

// segs: nseg rows of 8 int64 = (data ptr, level-table ptr or 0, bits, beff,
// ln, kind, scale_col, unused); r2: the L2 shift factor columns.
// q (Q, D), qa (Q,), fac (F, N), stats (N/512, 5), qprune (Q, 2) f32
//   -> cand (Q, chunks, k) -> out (Q, k); scanned (1,) i32, zeroed by the
// caller; kth_g (Q,) u32 set by the caller to vq_ordered_neg_inf() (prune only);
// tiles (N/512,) i32 ascending masked-in tile ids and cnt (1,) i32 their
// count, both on the card, select the gather mode (null: the dense grid)
int vq_packed_scan_topk(const float* q, const float* qa, const float* fac, const float* stats,
                        const float* qprune, const long long* segs, int nseg, const int* r2,
                        int n_r2, float* cand_s, int* cand_i, float* out_s, int* out_i,
                        int* scanned, unsigned int* kth_g, const int* tiles, const int* cnt,
                        int Q, int D, int N, int k,
                        int limit, int metric,
                        int family, int norm_col, int prune, int bf16, int chunks,
                        void* stream) {
  if (k < 1 || k > kMaxK || k + kTR > kBuf || chunks < 1 || chunks * k > kMergeCap ||
      nseg < 1 || nseg > kMaxSegs || n_r2 > kMaxSegs || N % kTile != 0 ||
      (metric == kL2 && n_r2 < 1) || ((tiles == nullptr) != (cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.qa = qa; p.fac = fac; p.stats = stats; p.qprune = qprune;
  p.cand_s = cand_s; p.cand_i = cand_i; p.scanned = scanned; p.kth_g = kth_g;
  p.tiles = tiles; p.cnt = cnt;
  p.Q = Q; p.D = D; p.N = N; p.k = k; p.limit = limit; p.metric = metric;
  p.family = family; p.norm_col = norm_col; p.bf16 = bf16; p.prune = prune;
  p.nb = N / kTile;
  p.nseg = nseg; p.n_r2 = n_r2;
  for (int i = 0; i < n_r2; ++i) p.r2[i] = r2[i];
  int d = 0, lv_floats = 0;
  for (int s = 0; s < nseg; ++s) {
    const long long* r = segs + 8 * s;
    Seg& sg = p.seg[s];
    sg.data = reinterpret_cast<const void*>(r[0]);
    sg.lv = reinterpret_cast<const float*>(r[1]);
    sg.bits = (int)r[2]; sg.beff = (int)r[3]; sg.ln = (int)r[4];
    sg.kind = (int)r[5]; sg.scale_col = (int)r[6]; sg.lv_off = lv_floats;
    sg.rt_shift = 0;
    while ((1 << sg.rt_shift) < kTile * sg.beff / 32) ++sg.rt_shift;
    sg.delta = 2.f / (float)(1 << sg.bits);
    if (sg.kind < kUniform || sg.kind > kValues || sg.ln < 1) return (int)cudaErrorInvalidValue;
    if (sg.kind != kValues && (sg.bits < 1 || sg.bits > sg.beff || 32 % sg.beff != 0 ||
                               (1 << sg.rt_shift) != kTile * sg.beff / 32))
      return (int)cudaErrorInvalidValue;
    if (sg.kind == kPerdim || sg.kind == kShared) {
      if (sg.lv == nullptr) return (int)cudaErrorInvalidValue;
      lv_floats += (sg.kind == kPerdim ? sg.ln : 1) << sg.bits;
    }
    d += sg.ln;
  }
  if (d != D) return (int)cudaErrorInvalidValue;
  p.lv_smem = lv_floats <= kLvSmemFloats;
  const size_t smem = (size_t)kQB * kBuf * (sizeof(float) + sizeof(int)) +
                      (p.lv_smem ? (size_t)lv_floats * sizeof(float) : 0);
  cudaFuncSetAttribute(packed_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Q + kQB - 1) / kQB, chunks);
  packed_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, kThreads, 0, (cudaStream_t)stream>>>(cand_s, cand_i, out_s, out_i,
                                                         chunks * k, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
