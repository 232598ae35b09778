// Packed-code scan + top-k for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces vq_tpu/kernels/pallas_packed.py::packed_scan_topk, dense grid
// and prune=True (_packed_kernel with _unpack_words, _dequant_seg, the
// variance-prune bound and the running top-k folds), and its tile-gather
// mode (tile_mask / mask_cap, _packed_kernel_gather)
//   -> vq_packed_scan_topk = packed_scan_kernel<bf16> + merge_kernel (topk.cuh).
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
// Published k-th.  Blocks run in parallel, each over its own chunk of
// tiles, so a block's own running k-th is weak at first; every block
// publishes its running k-th per query to `kth_g` (atomicMax on an
// order-preserving integer).  The largest k-th of any block's rows is a
// lower bound on the final k-th, so a row scoring below it holds no result:
// the epilogue admits a row only if it beats the block's own k-th and
// reaches the published one (an equal score may still win by its id).
//
// Variance prune (prune != 0): before a 512-row tile, each of the block's
// queries bounds every score in the tile from the tile's stats (min |r^|,
// max |r^|, CAQ margin, norm envelope) and its (A, B) row, with the four
// bound shapes of family x metric; the tile is skipped when no query's
// bound reaches the larger of its own and the published k-th.  The TPU
// kernel walks tiles in order and holds the running k-th over all earlier
// tiles; here pruning stays exact, how much it skips depends on the order
// blocks run in, and `scanned` counts (query block, tile) pairs whose tile
// was scanned, not tiles.
//
// What bounds it on the H100.  The products are 2*Q*N*D flops (5.5e11 at
// Q=256, N=1M, D=1024): ~0.56 ms at the tensor cores' published 989
// TFLOP/s bf16 rate, ~8 ms on the CUDA cores at 67 TFLOP/s FP32.  On the
// tensor cores they stop being the bound; the dequantization and its
// shared-memory traffic set the pace.  A block unpacks, looks up, scales
// and rounds its rows' values once for its kQB = 64 queries, so a batch
// decodes N * D * ceil(Q/64) values (~7 integer/float operations a value,
// one 4-byte store a dim pair), and every warp reads back the fragments it
// needs with ldmatrix: 96 KB a stage of 128 rows x 64 dims against the
// 24 KB of values and queries written.  The bytes that must move (~0.3 GB
// of 2-bit codes at N=1M) take ~0.1 ms at 3.35 TB/s.
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
// Design.  A block of 16 warps owns kQB = 64 queries x a chunk of whole
// 512-row tiles (a prune tile is never split).  It walks its tiles in order
// (tile = chunk start + i, or list[i] in the gather mode) and each tile in
// kTR = 128-row row tiles; a row tile's dimensions go by stages of KDK
// dimensions of one segment.  A stage's words are loaded once (a thread
// takes a pair of consecutive dimensions: coalesced; every shift slot of a
// word that falls in the row tile is extracted) and dequantized ONCE into
// shared memory beside the block's queries for the same dimensions.  The
// stages are double-buffered and software-pipelined: stage i+1's loads are
// issued into registers, then one basic block runs stage i's products and
// dequantizes stage i+1 into the other buffer (the products are passed into
// the dequant loop, so the compiler interleaves the two), and one barrier a
// stage separates them; row scales are loaded one segment ahead.  Two
// product paths share the word fetch, the prune test, the epilogue, the
// fold and the output:
//   bf16 (KDK = 64): values are rounded to bf16 where the plain version
//     rounds, round(value x scale), and stored as __nv_bfloat162 pairs; the
//     queries are rounded once a call (round_queries_kernel, into a scratch
//     of whole query blocks and 64-dim multiples per segment, zero-padded)
//     and copied 16 bytes at a time.  Rows and queries are K-contiguous with
//     a 144-byte row stride, so ldmatrix reads 8 rows of 16 bytes from 8
//     distinct bank groups.  The product is
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: corpus rows are the M
//     side, queries the N side, dimensions K.  The warps form a 4 x 4 grid:
//     warp w takes rows 32*(w%4) + [0, 32) (2 m16 tiles) x queries
//     16*(w/4) + [0, 16) (2 n8 tiles), per k-step 2 + 1 ldmatrix.x4 and 4
//     MMAs into 16 f32 accumulators; lane (g = lane/4, t = lane%4) holds
//     rows g and g+8 x queries 2t and 2t+1 of each (m, n) tile.  A
//     segment's last stage is zero-filled to 64 dims (values and queries),
//     so a k-step never spans two segments and every stage runs its 4
//     k-steps without a branch; queries past Q are zero and never reach the
//     top-k.
//   f32 (KDK = 32): x_s[dim][row] and q_s[dim][query] in f32, and FFMA
//     register tiles of 4 queries (one warp) x 4 rows (a lane) a thread.
//     TF32 would break the 1e-4 term-relative tolerance f32 scores are held
//     to, so f32 mode stays on the CUDA cores.
// Level tables are copied to shared memory when they fit (<= 32 KB; the
// main path's uniform grid needs none), else read through the cache.
// Factors are feature-major (F, N), so a factor column of consecutive rows
// is one contiguous run.  After each row tile a query's admitted scores are
// appended to its buffer and one warp merges them (warp_merge_sorted,
// topk.cuh: up to 32 candidates ranked in registers, more sorted alone, the
// two sorted lists placed by binary search), so a fold costs the
// candidates, not k.  The chunks' lists merge in one launch of at most
// kMergeCap candidates a query, or, where few queries leave too few chunks
// to fill the card within that cap, in two.  The wrapper sizes the grid
// from the resident blocks per SM that the library reports
// (vq_packed_blocks_per_sm): one block, ~190-220 KB of shared memory.
// Left for later, by measurement: wgmma (a warpgroup's 64-row product
// reading the query tile once from shared memory, where every warp now
// reads its own fragments) and TMA loads of the words; a chunk's first row
// tile still folds all of its rows.
//
// Every entry point returns cudaGetLastError() after its launches; the
// caller raises if it is not 0.  Nothing here allocates or synchronizes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "topk.cuh"

namespace {

constexpr int kThreads = 512;          // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;             // word-layout and prune tile (rows)
constexpr int kQB = 64;                // queries per block
constexpr int kTR = 128;               // rows per row tile (one fold)
constexpr int kBuf = 256;              // per-query buffer >= k + kTR
constexpr int kMaxSegs = 48;
constexpr int kLvSmemFloats = 8192;    // level tables in shared memory up to 32 KB
// Warp tiling of a row tile: kRowGroups x kQueryGroups warps, each 32 rows
// (two m16 tiles) x kWarpQ queries (bf16: kWarpQ / 8 n8 tiles)
constexpr int kRowGroups = 4;
constexpr int kQueryGroups = kWarps / kRowGroups;
constexpr int kWarpQ = kQB / kQueryGroups;
constexpr int kNT = kWarpQ / 8;
constexpr int kAcc = 2 * kNT * 4;      // accumulators a thread (f32: kAcc/4 queries x 4 rows)

enum Kind { kUniform = 0, kPerdim = 1, kShared = 2, kValues = 3 };
enum MetricKind { kL2 = 0, kIP = 1, kNIP = 2 };

struct Seg {
  const void* data;  // int32 words (N/u, ln), or f32 values (N, ln)
  const float* lv;   // level table, (ln, 2^bits) perdim / (1, 2^bits) shared
  int bits, beff, ln, kind, scale_col, lv_off;
  int doff, poff;    // first column in q, and in the padded bf16 queries
  float delta;       // uniform grid step 2 / 2^bits
};

struct Params {
  const float* q;       // (Q, D)
  const __nv_bfloat16* q16;  // bf16 mode: (Qp, Dp) rounded queries, zero-padded
  const float* qa;      // (Q,)
  const float* fac;     // (F, N) feature-major
  const float* stats;   // (nb, 5)
  const float* qprune;  // (Q, 2)
  float* cand_s;        // (Q, chunks, k), then any first-level merges' (Q, groups, k)
  int* cand_i;
  int* scanned;         // (query block, tile) pairs scanned
  unsigned int* kth_g;  // (Q,) published k-th scores (ordered ints)
  const int* tiles;     // gather mode: (nb,) ascending masked-in tile ids; else null
  const int* cnt;       // gather mode: (1,) number of valid entries of `tiles`
  int Q, D, Dp, N, k, limit, metric, family, norm_col, prune, nb;
  int nseg, n_r2, lv_smem;
  int r2[kMaxSegs];
  Seg seg[kMaxSegs];
};

// Stage shapes of the two product paths.
template <bool BF16> struct Path;
template <> struct Path<true> {
  static constexpr int KDK = 64;           // dims a stage: 4 k-steps of 16
  static constexpr int SA = KDK + 8;       // bf16 row stride (144 B) of both tiles
  static constexpr int STAGE_BYTES = (kTR + kQB) * SA * 2;
};
template <> struct Path<false> {
  static constexpr int KDK = 32;
  static constexpr int SX = kTR + 1;       // x_s[dim][row]: conflict-free both ways
  static constexpr int SQ = kQB + 4;       // q_s[dim][query]: 16-byte rows
  static constexpr int STAGE_BYTES = KDK * (SX + SQ) * 4;
};

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

// The words of one stage -- the kTR rows from row0 (in tile t) x dims
// [c0, c0 + KDK) of a segment stored BEFF bits a row (32: the f32 value
// plane).  A word row of the 512-row tile holds RT = 512*BEFF/32 apart rows
// (shift slot j: tile-local row j*RT + word row), so the row tile reads
// W = min(RT, kTR) word rows per dimension, each word giving SPT = kTR/W
// rows.  Thread tid owns the dim pair c0 + 2*(tid % TPR) + {0, 1}
// (consecutive lanes on consecutive dims: coalesced, and one bf16x2 store
// a pair) and word rows tid / TPR + i * STEP, i < NL.
template <int KDK, int BEFF>
struct WordGrid {
  static constexpr int RT = kTile * BEFF / 32;
  static constexpr int W = RT < kTR ? RT : kTR;
  static constexpr int SPT = kTR / W;
  static constexpr int TPR = KDK / 2;
  static constexpr int STEP = kThreads / TPR;
  static constexpr bool PART = W < STEP;           // threads past W word rows idle
  static constexpr int NL = PART ? 1 : W / STEP;
};

template <int KDK, int BEFF, int NRAW>
__device__ __forceinline__ void fetch_words(const Seg& sg, int t, int row0, int c0,
                                            uint32_t (&raw)[NRAW]) {
  using G = WordGrid<KDK, BEFF>;
  static_assert(2 * G::NL <= NRAW, "stage larger than its registers");
  const int ln = sg.ln, col = c0 + 2 * ((int)threadIdx.x % G::TPR);
  const int wb = (row0 - t * kTile) & (G::RT - 1);  // first word row (BEFF >= 16)
  const int r0 = threadIdx.x / G::TPR;
  if (G::PART && r0 >= G::W) return;
  const uint32_t* w =
      static_cast<const uint32_t*>(sg.data) + ((size_t)t * G::RT + wb + r0) * ln + col;
  const size_t step = (size_t)G::STEP * ln;
#pragma unroll
  for (int i = 0; i < G::NL; ++i, w += step) {
    raw[2 * i] = col < ln ? __ldg(w) : 0u;
    raw[2 * i + 1] = col + 1 < ln ? __ldg(w + 1) : 0u;
  }
}

// Exact float of a code c < 2^23 without the quarter-rate I2F
__device__ __forceinline__ float code_float(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

// Dequantize fetched words -- shift slot, level, row scale -- and hand each
// row's dim pair to put(row in the row tile, value, value); 0 past the
// segment's end.  TABLE: the level-table kinds (BEFF 32: the value plane).
template <int KDK, int BEFF, bool TABLE, int NRAW, class Put, class Pre>
__device__ __forceinline__ void store_words(const Seg& sg, const float* lv, const float* scale_s,
                                            int t, int row0, int c0,
                                            const uint32_t (&raw)[NRAW], Put put, Pre pre) {
  using G = WordGrid<KDK, BEFF>;
  const int ln = sg.ln, bits = sg.bits, col = c0 + 2 * ((int)threadIdx.x % G::TPR);
  const bool in0 = col < ln, in1 = col + 1 < ln;
  const int slot0 = (row0 - t * kTile) / G::RT;
  const uint32_t mask = BEFF == 32 ? 0u : (1u << bits) - 1u;
  const float delta = sg.delta, off = 0.5f * delta - 1.f;  // (c + .5)*delta - 1, exactly
  const bool perdim = sg.kind == kPerdim;
  const float* lv0 = lv + (perdim && in0 ? col << bits : 0);
  const float* lv1 = lv + (perdim && in1 ? (col + 1) << bits : 0);
  const bool scaled = sg.scale_col >= 0;
  const int r0 = threadIdx.x / G::TPR;
  pre();  // the current stage's products, in the same basic block as the dequant
  if (G::PART && r0 >= G::W) return;
#pragma unroll
  for (int i = 0; i < G::NL; ++i) {
#pragma unroll
    for (int jj = 0; jj < G::SPT; ++jj) {
      const int r = jj * G::W + r0 + i * G::STEP;
      float v0, v1;
      if constexpr (BEFF == 32) {
        v0 = __uint_as_float(raw[2 * i]);
        v1 = __uint_as_float(raw[2 * i + 1]);
      } else {
        const int sh = BEFF * (slot0 + jj);
        const uint32_t c0_ = (raw[2 * i] >> sh) & mask, c1_ = (raw[2 * i + 1] >> sh) & mask;
        if constexpr (TABLE) {
          v0 = lv0[c0_];
          v1 = lv1[c1_];
        } else {
          v0 = fmaf(code_float(c0_), delta, off);
          v1 = fmaf(code_float(c1_), delta, off);
        }
      }
      const float sc = scaled ? scale_s[r] : 1.f;
      put(r, in0 ? v0 * sc : 0.f, in1 ? v1 * sc : 0.f);
    }
  }
}

template <int KDK, int NRAW>
__device__ __forceinline__ void fetch_seg(const Seg& sg, int t, int row0, int c0,
                                          uint32_t (&raw)[NRAW]) {
  switch (sg.beff) {
    case 1: fetch_words<KDK, 1>(sg, t, row0, c0, raw); break;
    case 2: fetch_words<KDK, 2>(sg, t, row0, c0, raw); break;
    case 4: fetch_words<KDK, 4>(sg, t, row0, c0, raw); break;
    case 8: fetch_words<KDK, 8>(sg, t, row0, c0, raw); break;
    case 16: fetch_words<KDK, 16>(sg, t, row0, c0, raw); break;
    default: fetch_words<KDK, 32>(sg, t, row0, c0, raw); break;
  }
}

template <int KDK, bool TABLE, int NRAW, class Put, class Pre>
__device__ __forceinline__ void store_kind(const Seg& sg, const float* lv, const float* scale_s,
                                           int t, int row0, int c0, const uint32_t (&raw)[NRAW],
                                           Put put, Pre pre) {
  switch (sg.beff) {
    case 1: store_words<KDK, 1, TABLE>(sg, lv, scale_s, t, row0, c0, raw, put, pre); break;
    case 2: store_words<KDK, 2, TABLE>(sg, lv, scale_s, t, row0, c0, raw, put, pre); break;
    case 4: store_words<KDK, 4, TABLE>(sg, lv, scale_s, t, row0, c0, raw, put, pre); break;
    case 8: store_words<KDK, 8, TABLE>(sg, lv, scale_s, t, row0, c0, raw, put, pre); break;
    default: store_words<KDK, 16, TABLE>(sg, lv, scale_s, t, row0, c0, raw, put, pre); break;
  }
}

template <int KDK, int NRAW, class Put, class Pre>
__device__ __forceinline__ void store_seg(const Seg& sg, const float* lv, const float* scale_s,
                                          int t, int row0, int c0, const uint32_t (&raw)[NRAW],
                                          Put put, Pre pre) {
  if (sg.kind == kValues)
    store_words<KDK, 32, false>(sg, lv, scale_s, t, row0, c0, raw, put, pre);
  else if (sg.kind == kUniform)
    store_kind<KDK, false>(sg, lv, scale_s, t, row0, c0, raw, put, pre);
  else
    store_kind<KDK, true>(sg, lv, scale_s, t, row0, c0, raw, put, pre);
}

// f32 mode: the block's queries for dims [c0, c0 + KDK) of a segment
// starting at query column doff: thread tid owns the dim pair of fetch_words and
// queries tid / TPR + i * STEP, i < NQ (qv[2i], qv[2i+1]); 0 past Q or past
// the segment's end.
template <int KDK, int NQV>
__device__ __forceinline__ void fetch_queries(const Params& p, int ln, int c0, int doff, int q0,
                                              int nq, float (&qv)[NQV]) {
  constexpr int TPR = KDK / 2, STEP = kThreads / TPR;
  static_assert(NQV == 2 * kQB / STEP, "query staging");
  const int col = c0 + 2 * ((int)threadIdx.x % TPR), j0 = threadIdx.x / TPR;
#pragma unroll
  for (int i = 0; i < NQV / 2; ++i) {
    const int j = j0 + i * STEP;
    const float* qj = p.q + (size_t)(q0 + j) * p.D + doff + col;
    qv[2 * i] = (j < nq && col < ln) ? __ldg(qj) : 0.f;
    qv[2 * i + 1] = (j < nq && col + 1 < ln) ? __ldg(qj + 1) : 0.f;
  }
}

// bf16 mode: the block's rounded queries for dims [c0, c0 + 64) of segment
// sg, 16 bytes (8 dims) a copy: no bounds checks, the scratch is padded
constexpr int kQChunks = kQB * Path<true>::KDK / 8 / kThreads;  // 16-byte copies a thread
__device__ __forceinline__ void fetch_queries16(const Params& p, const Seg& sg, int c0, int q0,
                                                uint4 (&qh)[kQChunks]) {
  constexpr int CPR = Path<true>::KDK / 8;  // chunks a query row
#pragma unroll
  for (int i = 0; i < kQChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    qh[i] = __ldg(reinterpret_cast<const uint4*>(p.q16 + (size_t)(q0 + c / CPR) * p.Dp +
                                                 sg.poff + c0) + c % CPR);
  }
}

// f32 products of one stage over `width` dims: x_s (KDK, SX), q_s (KDK,
// SQ).  acc[a * 4 + b]: query kFQ * warp + a, row lane + 32 * b.
constexpr int kFQ = kAcc / 4;  // f32 path: queries a warp
__device__ __forceinline__ void ffma_stage(const float* x_s, const float* q_s, int width,
                                           float (&acc)[kAcc]) {
  constexpr int SX = Path<false>::SX, SQ = Path<false>::SQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
  for (int d = 0; d < width; ++d) {
    float qq[kFQ];
#pragma unroll
    for (int a = 0; a < kFQ; a += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(q_s + d * SQ + warp * kFQ + a);
      qq[a] = q4.x, qq[a + 1] = q4.y, qq[a + 2] = q4.z, qq[a + 3] = q4.w;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float xv = x_s[d * SX + lane + 32 * b];
#pragma unroll
      for (int a = 0; a < kFQ; ++a) acc[a * 4 + b] = fmaf(qq[a], xv, acc[a * 4 + b]);
    }
  }
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
// cand_s / cand_i; empty slots are (-inf, INT_MAX).  BF16 selects the
// product path (tensor cores) against f32 (FFMA).
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
packed_scan_kernel(const __grid_constant__ Params p) {
  using P = Path<BF16>;
  constexpr int KDK = P::KDK;
  constexpr int NRAW = kTR * KDK / kThreads;  // words a thread holds at most
  constexpr int NQV = kQB * KDK / kThreads;   // query values a thread stages
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf_s = reinterpret_cast<float*>(smem);
  int* buf_i = reinterpret_cast<int*>(buf_s + kQB * kBuf);
  unsigned char* stage_s = reinterpret_cast<unsigned char*>(buf_i + kQB * kBuf);
  float* lv_s = reinterpret_cast<float*>(stage_s + 2 * P::STAGE_BYTES);
  __shared__ float qa_s[kQB];
  __shared__ float thr[kQB];
  __shared__ float gthr[kQB];
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

  uint32_t raw[NRAW] = {};
  float qv[BF16 ? 1 : NQV];      // f32 path: query values
  uint4 qh[BF16 ? kQChunks : 1];  // bf16 path: rounded query chunks
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
      // stage (s, c0): dims [c0, c0 + KDK) of segment s, written into stage
      // buffer b
      auto store = [&](int s, int c0, int b, auto pre) {
        const Seg& sg = p.seg[s];
        const float* lv = p.lv_smem ? lv_s + sg.lv_off : sg.lv;
        constexpr int TPR = KDK / 2, STEP = kThreads / TPR;
        const int c2 = 2 * (tid % TPR), j0 = tid / TPR;
        if constexpr (BF16) {
          __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage_s + b * P::STAGE_BYTES);
          __nv_bfloat16* q_s = a_s + kTR * P::SA;
          store_seg<KDK>(sg, lv, scale_s[s & 1], t, row0, c0, raw,
                         [&](int r, float v0, float v1) {
                           *reinterpret_cast<__nv_bfloat162*>(a_s + r * P::SA + c2) =
                               __floats2bfloat162_rn(v0, v1);
                         }, pre);
#pragma unroll
          for (int i = 0; i < kQChunks; ++i) {
            const int c = tid + i * kThreads;
            *reinterpret_cast<uint4*>(q_s + (c / (KDK / 8)) * P::SA + (c % (KDK / 8)) * 8) = qh[i];
          }
        } else {
          float* x_s = reinterpret_cast<float*>(stage_s + b * P::STAGE_BYTES);
          float* q_s = x_s + KDK * P::SX;
          store_seg<KDK>(sg, lv, scale_s[s & 1], t, row0, c0, raw,
                         [&](int r, float v0, float v1) {
                           x_s[c2 * P::SX + r] = v0;
                           x_s[(c2 + 1) * P::SX + r] = v1;
                         }, pre);
#pragma unroll
          for (int i = 0; i < NQV / 2; ++i) {
            q_s[c2 * P::SQ + j0 + i * STEP] = qv[2 * i];
            q_s[(c2 + 1) * P::SQ + j0 + i * STEP] = qv[2 * i + 1];
          }
        }
      };
      // the row terms' loads stay in flight during the stages
      const float term = tid < kTR ? row_term(p, row0 + tid) : 0.f;
      float acc[kAcc];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
      int s = 0, c0 = 0, b = 0;
      auto fetch_q = [&](const Seg& sg, int c0) {
        if constexpr (BF16) fetch_queries16(p, sg, c0, q0, qh);
        else fetch_queries<KDK>(p, sg.ln, c0, sg.doff, q0, nq, qv);
      };
      fetch_seg<KDK>(p.seg[0], t, row0, 0, raw);
      fetch_q(p.seg[0], 0);
      // row scales: segments 0 and 1 now, segment s + 1 when s begins
      // (scale_s[s & 1] holds segment s's while its stages are stored)
      for (int s2 = 0; s2 < 2 && s2 < p.nseg; ++s2)
        if (tid < kTR && p.seg[s2].scale_col >= 0)
          scale_s[s2][tid] = __ldg(p.fac + (size_t)p.seg[s2].scale_col * p.N + row0 + tid);
      __syncthreads();
      store(0, 0, 0, [] {});
      __syncthreads();
      // software pipeline: fetch stage i+1 into registers, then in one block
      // run stage i's products and dequantize stage i+1 into the other buffer
      while (true) {
        const Seg& sg = p.seg[s];
        int ns = s, nc0 = c0 + KDK;
        if (nc0 >= sg.ln) ns = s + 1, nc0 = 0;
        const bool more = ns < p.nseg;
        const bool ahead = more && ns != s && ns + 1 < p.nseg && p.seg[ns + 1].scale_col >= 0;
        float sc = 0.f;
        if (ahead && tid < kTR)
          sc = __ldg(p.fac + (size_t)p.seg[ns + 1].scale_col * p.N + row0 + tid);
        auto products = [&] {
          if constexpr (BF16) {
            const __nv_bfloat16* a_s =
                reinterpret_cast<const __nv_bfloat16*>(stage_s + b * P::STAGE_BYTES);
            mma_stage<P::SA, KDK, kRowGroups, kWarpQ>(a_s, a_s + kTR * P::SA, acc);
          } else {
            const float* x_s = reinterpret_cast<const float*>(stage_s + b * P::STAGE_BYTES);
            ffma_stage(x_s, x_s + KDK * P::SX, min(KDK, sg.ln - c0), acc);
          }
        };
        if (more) {
          const Seg& nsg = p.seg[ns];
          fetch_seg<KDK>(nsg, t, row0, nc0, raw);
          fetch_q(nsg, nc0);
          store(ns, nc0, b ^ 1, products);
        } else {
          products();
        }
        if (ahead && tid < kTR) scale_s[(ns + 1) & 1][tid] = sc;
        __syncthreads();
        if (!more) break;
        s = ns, c0 = nc0, b ^= 1;
      }
      if (tid < kTR) term_s[tid] = term;
      if (tid < nq) gthr[tid] = from_ordered_bits(__ldcg(p.kth_g + q0 + tid));
      __syncthreads();
      // epilogue: score, `limit` mask, admit what beats the running k-th and
      // reaches the largest k-th any block has published (rows below it are
      // not in the result; an equal score may be, by its id)
      // a thread's kFQ queries (a) and 4 rows (bb) of its accumulators
      auto query_of = [&](int a) {
        return BF16 ? (warp / kRowGroups) * kWarpQ + (a >> 1) * 8 + 2 * (lane & 3) + (a & 1)
                    : warp * kFQ + a;
      };
      auto row_of = [&](int bb) {
        return BF16 ? (warp % kRowGroups) * 32 + (bb >> 1) * 16 + (lane >> 2) + (bb & 1) * 8
                    : lane + 32 * bb;
      };
      float qa_r[kFQ], thr_r[kFQ], g_r[kFQ], term_r[4];
#pragma unroll
      for (int a = 0; a < kFQ; ++a) {
        const int j = query_of(a);
        qa_r[a] = qa_s[j], thr_r[a] = thr[j], g_r[a] = gthr[j];
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) term_r[bb] = term_s[row_of(bb)];
#pragma unroll
      for (int a = 0; a < kFQ; ++a) {
        const int j = query_of(a);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int r = row_of(bb), row = row0 + r;
          const float ip = acc[BF16 ? ((bb >> 1) * kNT + (a >> 1)) * 4 + (bb & 1) * 2 + (a & 1)
                                    : a * 4 + bb];
          float sc;
          if (p.metric == kL2) sc = 2.f * ip + qa_r[a] - term_r[bb];
          else if (p.metric == kIP) sc = ip + qa_r[a];
          else sc = (ip + qa_r[a]) / term_r[bb];
          if (j < nq && row < p.limit && sc > thr_r[a] && sc >= g_r[a]) {
            const int slot = p.k + atomicAdd(&n_cand[j], 1);
            buf_s[j * kBuf + slot] = sc;
            buf_i[j * kBuf + slot] = row;
          }
        }
      }
      __syncthreads();
      for (int j = warp; j < nq; j += kWarps) {
        const int nc = n_cand[j];
        if (nc > 0) {
          const float kth = warp_merge_sorted(buf_s + j * kBuf, buf_i + j * kBuf, p.k, nc, lane);
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
  const int chunks = gridDim.y;
  for (int i = tid; i < nq * p.k; i += kThreads) {
    const int j = i / p.k, r = i % p.k;
    const size_t o = ((size_t)(q0 + j) * chunks + blockIdx.y) * p.k + r;
    p.cand_s[o] = buf_s[j * kBuf + r];
    p.cand_i[o] = buf_i[j * kBuf + r];
  }
}

// grid (Qp); q16[j, poff_s + d] = bf16(q[j, doff_s + d]) for j < Q and
// d < ln_s, 0 up to Qp rows and each segment's ln_s rounded up to 64
__global__ void round_queries_kernel(const __grid_constant__ Params p) {
  constexpr int KDK = Path<true>::KDK;
  const int j = blockIdx.x;
  __nv_bfloat16* out = const_cast<__nv_bfloat16*>(p.q16) + (size_t)j * p.Dp;
  for (int s = 0; s < p.nseg; ++s) {
    const Seg& sg = p.seg[s];
    const int w = (sg.ln + KDK - 1) / KDK * KDK;
    for (int d = threadIdx.x; d < w; d += blockDim.x)
      out[sg.poff + d] = __float2bfloat16(j < p.Q && d < sg.ln ? p.q[(size_t)j * p.D + sg.doff + d]
                                                                : 0.f);
  }
}

// Floats of the level tables of a segment descriptor list (8 int64 a row)
int lv_floats_of(const long long* segs, int nseg) {
  int n = 0;
  for (int s = 0; s < nseg; ++s) {
    const long long* r = segs + 8 * s;
    if (r[5] == kPerdim) n += (int)r[4] << (int)r[2];
    if (r[5] == kShared) n += 1 << (int)r[2];
  }
  return n;
}

// Dynamic shared memory of a launch: the top-k buffers, two stage buffers
// and the level tables when they fit
template <bool BF16>
size_t dyn_smem(int lv_floats) {
  return (size_t)kQB * kBuf * (sizeof(float) + sizeof(int)) + 2 * Path<BF16>::STAGE_BYTES +
         (lv_floats <= kLvSmemFloats ? (size_t)lv_floats * sizeof(float) : 0);
}

// Resident blocks per SM at that shared memory (0: the launch cannot run)
template <bool BF16>
int blocks_per_sm(int lv_floats) {
  const size_t smem = dyn_smem<BF16>(lv_floats);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(packed_scan_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, packed_scan_kernel<BF16>, kThreads,
                                                        smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the caller sees 0, not a stale error at its next launch
    return 0;
  }
  return n;
}

}  // namespace

extern "C" {

// Layout constants, read by the Python wrapper.
int vq_packed_queries_per_block() { return kQB; }
int vq_packed_stage_dims() { return Path<true>::KDK; }
int vq_packed_max_segments() { return kMaxSegs; }
int vq_ordered_neg_inf() { return (int)~0xff800000u; }  // ordered bits of -inf

// Resident blocks per SM of a launch with these segments (the wrapper sizes
// the grid from it); 0 if such a launch cannot run
int vq_packed_blocks_per_sm(const long long* segs, int nseg, int bf16) {
  const int lv = lv_floats_of(segs, nseg);
  return bf16 ? blocks_per_sm<true>(lv) : blocks_per_sm<false>(lv);
}

// segs: nseg rows of 8 int64 = (data ptr, level-table ptr or 0, bits, beff,
// ln, kind, scale_col, unused); r2: the L2 shift factor columns.
// q (Q, D), qa (Q,), fac (F, N), stats (N/512, 5), qprune (Q, 2) f32
//   -> cand (Q, chunks, k) -> out (Q, k), in one merge launch when
// chunks * k <= kMergeCap, else two: groups of g = kMergeCap / k chunk
// lists first into cand's tail (Q, chunks / g, k), so cand holds
// Q * (chunks + chunks / g) * k entries then; scanned (1,) i32, zeroed by the
// caller; kth_g (Q,) u32 set by the caller to vq_ordered_neg_inf();
// tiles (N/512,) i32 ascending masked-in tile ids and cnt (1,) i32 their
// count, both on the card, select the gather mode (null: the dense grid);
// q16: bf16 mode's (Qp, Dp) scratch, Qp = Q rounded up to
// vq_packed_queries_per_block(), Dp = sum of ln rounded up to
// vq_packed_stage_dims() (null in f32 mode)
int vq_packed_scan_topk(const float* q, void* q16, const float* qa, const float* fac,
                        const float* stats,
                        const float* qprune, const long long* segs, int nseg, const int* r2,
                        int n_r2, float* cand_s, int* cand_i, float* out_s, int* out_i,
                        int* scanned, unsigned int* kth_g, const int* tiles, const int* cnt,
                        int Q, int D, int N, int k,
                        int limit, int metric,
                        int family, int norm_col, int prune, int bf16, int chunks,
                        void* stream) {
  if (k < 1 || k > kMaxK || k + kTR > kBuf || !merge_shape_ok(chunks, k) ||
      nseg < 1 || nseg > kMaxSegs || n_r2 > kMaxSegs || N % kTile != 0 ||
      (metric == kL2 && n_r2 < 1) || ((tiles == nullptr) != (cnt == nullptr)) ||
      (bf16 && q16 == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.q16 = static_cast<const __nv_bfloat16*>(q16);
  p.qa = qa; p.fac = fac; p.stats = stats; p.qprune = qprune;
  p.cand_s = cand_s; p.cand_i = cand_i; p.scanned = scanned; p.kth_g = kth_g;
  p.tiles = tiles; p.cnt = cnt;
  p.Q = Q; p.D = D; p.N = N; p.k = k; p.limit = limit; p.metric = metric;
  p.family = family; p.norm_col = norm_col; p.prune = prune;
  p.nb = N / kTile;
  p.nseg = nseg; p.n_r2 = n_r2;
  for (int i = 0; i < n_r2; ++i) p.r2[i] = r2[i];
  int d = 0, dp = 0, lv_floats = 0;
  for (int s = 0; s < nseg; ++s) {
    const long long* r = segs + 8 * s;
    Seg& sg = p.seg[s];
    sg.data = reinterpret_cast<const void*>(r[0]);
    sg.lv = reinterpret_cast<const float*>(r[1]);
    sg.bits = (int)r[2]; sg.beff = (int)r[3]; sg.ln = (int)r[4];
    sg.kind = (int)r[5]; sg.scale_col = (int)r[6]; sg.lv_off = lv_floats;
    sg.doff = d; sg.poff = dp;
    sg.delta = 2.f / (float)(1 << sg.bits);
    if (sg.kind < kUniform || sg.kind > kValues || sg.ln < 1) return (int)cudaErrorInvalidValue;
    if (sg.kind == kValues) sg.beff = 32;  // one row a "word": the f32 plane
    else if (sg.bits < 1 || sg.bits > sg.beff || sg.beff > 16 || 32 % sg.beff != 0)
      return (int)cudaErrorInvalidValue;
    if (sg.kind == kPerdim || sg.kind == kShared) {
      if (sg.lv == nullptr) return (int)cudaErrorInvalidValue;
      lv_floats += (sg.kind == kPerdim ? sg.ln : 1) << sg.bits;
    }
    d += sg.ln;
    dp += (sg.ln + Path<true>::KDK - 1) / Path<true>::KDK * Path<true>::KDK;
  }
  if (d != D) return (int)cudaErrorInvalidValue;
  p.Dp = dp;
  p.lv_smem = lv_floats <= kLvSmemFloats;
  const size_t smem = bf16 ? dyn_smem<true>(lv_floats) : dyn_smem<false>(lv_floats);
  const auto kernel = bf16 ? packed_scan_kernel<true> : packed_scan_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((Q + kQB - 1) / kQB, chunks);
  if (bf16) {
    round_queries_kernel<<<grid.x * kQB, kThreads, 0, (cudaStream_t)stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)merge_chunks(cand_s, cand_i, out_s, out_i, Q, chunks, k, (cudaStream_t)stream);
}

}  // extern "C"
