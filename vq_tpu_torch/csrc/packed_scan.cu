// Packed-code scan + top-k for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces vq_tpu/kernels/pallas_packed.py::packed_scan_topk, dense grid
// and prune=True (_packed_kernel with _unpack_words, _dequant_seg, the
// variance-prune bound and the running top-k folds), and its tile-gather
// mode (tile_mask / mask_cap, _packed_kernel_gather)
//   -> vq_packed_scan_topk = packed_scan_bf16_kernel<W> (bf16) or
//      packed_scan_f32_kernel (f32), then merge_kernel (topk.cuh).
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
// the epilogue admits a row only if it ranks before the block's own k-th
// entry and reaches the published k-th (an equal score may still win by its
// id).
//
// Variance prune (prune != 0): before a 512-row tile, each of the block's
// queries bounds every score in the tile from the tile's stats (min |r^|,
// max |r^|, CAQ margin, norm envelope) and its (A, B) row, with the four
// bound shapes of family x metric; the tile is skipped when no query's
// bound reaches the larger of its own and the published k-th.  The TPU
// kernel walks tiles in order and holds the running k-th over all earlier
// tiles; here pruning stays exact, how much it skips depends on the order
// blocks run in (and, in bf16 mode, on how far the producer runs ahead of
// the folds), and `scanned` counts (query block, tile) pairs whose tile was
// scanned, not tiles.
//
// Gather mode (tiles != nullptr): the caller compacts the tile mask on the
// card into an ascending list of masked-in tile ids and their count `cnt`,
// both in device memory (no host sync).  Block (query block, y) walks list
// entries [y*c, (y+1)*c), c = ceil(cnt/chunks) read from device memory: the
// LIST is split, not the grid, so at 5% of tiles masked in the work still
// spreads over the blocks, masked-out tiles cost neither memory traffic nor
// compute, and a full list splits exactly as the dense grid does.
// Row offsets, the tile-stats lookup, the `limit` mask and the ids written
// into the top-k all use the global tile id list[i].  Composes with prune
// (a tile scans when it is masked in and its bound survives); with cnt = 0
// every block writes empty candidates and the merge launch still writes the
// (-inf, id 0) result.
//
// bf16: packed_scan_bf16_kernel<W>, a warp-specialised Hopper pipeline.  A
// block owns W = 64 or 128 queries (the wrapper's query-tile width,
// kernels/packed_scan.py::scan_width, from Q) x a chunk of whole 512-row
// tiles.  Its 384 threads are three warpgroups:
//   producers (warpgroup 2): walk the block's tiles (thread 0 runs the
//     prune test and tells the others) and stream each tile into a ring of
//     up to 8 shared-memory stages, completing on the stages' mbarriers: a
//     stage is one segment's next kdk = min(64, 512/B_eff) dims of one pass
//     -- the pass's word rows, 16-byte cp.async copies from all 128
//     threads (4-byte ones where a segment's rows are not 16-byte aligned),
//     each row padded by 8 words so the consumers' 8-byte loads are
//     conflict-free -- and, by the bulk copy engine, the W x 64 query tile
//     holding those dims (bf16, stage-major, 128-byte swizzled, rounded once
//     a call by round_queries_kernel).  The tile's factor columns (row
//     scales, the L2 shift columns or the NIP norm) come once a tile by the
//     bulk copy engine into a ring of two, where they fit.
//   consumers (warpgroups 0 and 1): a 512-row tile goes in two passes of
//     256 rows x the W queries, each warpgroup two m64 tiles of them, f32
//     sums in registers (W a thread).  A pass takes the rows whose
//     tile-local index has row % 16 in its half, so every segment's word
//     rows split between the passes and each word enters the SM once per
//     query block.  A thread's 4 rows lie 64 apart: at B_eff <= 4 they are
//     shift slots of one word, so two 8-byte loads give the 4 dims of a
//     k-step of all of them, and one funnel shift of each word serves them
//     all.  Each k-step of 16 dims, per m64 tile, a thread dequantizes its
//     fragment straight from the staged words into registers -- for the
//     uniform grid one LOP3 puts a row's code into a float's mantissa and one
//     FADD gives (c + .5) * delta - 1 exactly, then the row scale and
//     round(value x scale) to bf16 -- and issues wgmma.m64nWk16 with A from
//     registers and B the swizzled query tile: one group an m64 tile, two
//     fragment buffers, one group in flight while the next is dequantized.
//     A stage's slot is released once the group after its last one is
//     issued.
//   the shared-table dequant (the "shared" kind at B_eff <= 4: RaBitQ B <= 4,
//     at width 64, kRegTableWidth): a thread's 4 rows lie in 4 nibbles of
//     each word it reads, so once a pass, where the uniform grid reads its
//     rows' scales, a thread builds for each row the 16 values round(lv[c] x
//     scale) to bf16 (c the nibble's code) -- the same f32 product and
//     rounding as the table path, so every fragment and score is
//     bit-identical to it -- kept as 16 low and 16 high bytes in 8 registers
//     (32 a thread).  A k-step turns its 4 words into selectors of each row's
//     4 codes (2 PRMT, 4 SHF/LOP3, then a mask and a half pick of each pair of
//     rows), and each row's 4 values into its two fragment words by 8 PRMT:
//     the low and the high bytes looked up among the lower and the upper 8
//     entries (a nibble's bit 3 is prmt's sign mode, so one lookup indexes 8
//     bytes), the half picked by that bit, the bytes interleaved.  No load, no
//     multiply and no convert a value.
//   the pass epilogue: scores, the `limit` mask, and admission against
//     per-query cuts (the larger of the block's k-th and the published one;
//     a score equal to the block's k-th is admitted only where its id ranks
//     before that entry's, since a pass's rows are not in id order); the
//     admitted ones are appended to a global scratch of k + 320 entries a
//     query (L2), and a warp merges a query's candidates in registers
//     (warp_fold_regs) once it holds 64.  The metric is chosen once a pass,
//     outside the round over the pass's W sums a thread.  The published
//     k-th is read once a tile; it and the folds raise the cuts, which are
//     read with no barrier: a cut only rises, so a stale one admits a
//     superset, which the fold sorts out.  Top-k lists of each consumer
//     warpgroup with barriers of their own, and admission appended inside
//     the round instead of through `held` (local memory written only for
//     admitted scores), both measured slower on the SAQ cells' shapes
//     (PERF.md).
// Bound (H100): 2*Q*N*D bf16 operations at 989 TFLOP/s, or the words and
// factors read once at 3.35 TB/s (4.85 ms at Q=64, N=53.2M, D=704 coded
// dims: operations).  What the pipeline spends instead (PERF.md; cycles by
// scripts/packed_scan_cycles.py): the dequantization on the CUDA cores
// (~4 operations a value, N * D * ceil(Q/W) values a call), the epilogue
// and folds a pass, and the query tiles from L2 (W * 128 bytes a stage).
//
// f32: packed_scan_f32_kernel, FFMA on the CUDA cores (TF32 would break the
// 1e-4 term-relative tolerance f32 scores are held to).  A block of 16 warps
// owns kQB = 64 queries x a chunk of tiles; it walks each tile in kTR =
// 128-row row tiles (rows in id order), a row tile's dimensions by stages of
// 32 dims of one segment: a stage's words are loaded once (a thread takes a
// pair of consecutive dimensions) and dequantized ONCE into x_s[dim][row]
// beside the block's queries q_s[dim][query]; the stages are double-buffered
// (stage i+1's loads issued into registers, then stage i's products and
// stage i+1's dequant in one basic block, one barrier a stage); FFMA
// register tiles of 4 queries (one warp) x 4 rows (a lane) a thread.  After
// each row tile a query's admitted scores are appended to its buffer in
// shared memory and one warp merges them (warp_merge_sorted, topk.cuh).
//
// Level tables are copied to shared memory when they fit (<= 32 KB; the
// main path's uniform grid needs none), else read through the cache.
// Factors are feature-major (F, N), so a factor column of consecutive rows
// is one contiguous run.  The chunks' lists merge in one launch of at most
// kMergeCap candidates a query, or, where few queries leave too few chunks
// to fill the card within that cap, in two.  The wrapper sizes the grid
// from the resident blocks per SM that the library reports
// (vq_packed_blocks_per_sm): one block, ~190-225 KB of shared memory.
//
// Every entry point returns cudaGetLastError() after its launches; the
// caller raises if it is not 0.  Nothing here allocates or synchronizes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "topk.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 512;             // word-layout and prune tile (rows)
constexpr int kMaxSegs = 48;
constexpr int kLvSmemFloats = 8192;    // level tables in shared memory up to 32 KB
constexpr size_t kSmemCap = 232448;    // shared memory a block can have

enum Kind { kUniform = 0, kPerdim = 1, kShared = 2, kValues = 3 };
enum MetricKind { kL2 = 0, kIP = 1, kNIP = 2 };

struct Seg {
  const void* data;  // int32 words (N/u, ln), or f32 values (N, ln)
  const float* lv;   // level table, (ln, 2^bits) perdim / (1, 2^bits) shared
  int bits, beff, ln, kind, scale_col, lv_off;
  int doff, poff;    // first column in q, and in the padded bf16 queries
  float delta;       // uniform grid step 2 / 2^bits
  int kdk;           // bf16: dims a stage, min(64, 512 / beff)
  int vec;           // bf16: word rows 16-byte aligned (16-byte copies, else 4-byte)
  int sidx;          // bf16: the scale column's place among the staged factor columns, -1 none
};

struct Params {
  const float* q;       // (Q, D)
  const __nv_bfloat16* q16;  // bf16 mode: (ceil(Q / W), Dp / 64, W, 64) rounded queries, swizzled
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
  float* fold_s;        // bf16: (blocks, W, k + kFoldSlots) top-k lists and candidates
  int* fold_i;
  int Q, D, Dp, N, k, limit, metric, family, norm_col, prune, nb;
  int nseg, n_r2, lv_smem, lv_floats;
  int stages, wslot;    // bf16: ring depth, bytes of a stage's word rows
  int nfc, tcol, fac_smem;  // bf16: factor columns (scales, then from tcol the row term's), staged
  int r2[kMaxSegs];
  int fcol[2 * kMaxSegs + 1];
  Seg seg[kMaxSegs];
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

// This block's range of tiles (dense) or of list entries (gather): chunks
// of ceil(count / chunks), so a full list splits as the dense grid does
__device__ __forceinline__ void tile_range(const Params& p, int& i_begin, int& i_end) {
  const int count = p.tiles != nullptr ? p.cnt[0] : p.nb;
  const int per = (count + (int)gridDim.y - 1) / (int)gridDim.y;
  i_begin = min(count, (int)blockIdx.y * per);
  i_end = min(count, i_begin + per);
}

// Exact float of a code c < 2^23 without the quarter-rate I2F
__device__ __forceinline__ float code_float(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

// ============================================================ f32 (FFMA)
constexpr int kThreads = 512;          // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;                // queries per block
constexpr int kTR = 128;               // rows per row tile (one fold)
constexpr int kBuf = 256;              // per-query buffer >= k + kTR
constexpr int kKDK = 32;               // dims a stage
constexpr int kSX = kTR + 1;           // x_s[dim][row]: conflict-free both ways
constexpr int kSQ = kQB + 4;           // q_s[dim][query]: 16-byte rows
constexpr int kStageBytes = kKDK * (kSX + kSQ) * 4;
constexpr int kFQ = 4;                 // queries a warp
constexpr int kAcc = 16;               // kFQ queries x 4 rows a thread

// The words of one stage -- the kTR rows from row0 (in tile t) x dims
// [c0, c0 + kKDK) of a segment stored BEFF bits a row (32: the f32 value
// plane).  A word row of the 512-row tile holds RT = 512*BEFF/32 apart rows
// (shift slot j: tile-local row j*RT + word row), so the row tile reads
// W = min(RT, kTR) word rows per dimension, each word giving SPT = kTR/W
// rows.  Thread tid owns the dim pair c0 + 2*(tid % TPR) + {0, 1}
// (consecutive lanes on consecutive dims: coalesced) and word rows
// tid / TPR + i * STEP, i < NL.
template <int BEFF>
struct WordGrid {
  static constexpr int RT = kTile * BEFF / 32;
  static constexpr int W = RT < kTR ? RT : kTR;
  static constexpr int SPT = kTR / W;
  static constexpr int TPR = kKDK / 2;
  static constexpr int STEP = kThreads / TPR;
  static constexpr bool PART = W < STEP;           // threads past W word rows idle
  static constexpr int NL = PART ? 1 : W / STEP;
};

template <int BEFF, int NRAW>
__device__ __forceinline__ void fetch_words(const Seg& sg, int t, int row0, int c0,
                                            uint32_t (&raw)[NRAW]) {
  using G = WordGrid<BEFF>;
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

// Dequantize fetched words -- shift slot, level, row scale -- into x_s
// (kKDK, kSX); 0 past the segment's end.  TABLE: the level-table kinds
// (BEFF 32: the value plane).  pre() runs the current stage's products in
// the same basic block as the dequant.
template <int BEFF, bool TABLE, int NRAW, class Pre>
__device__ __forceinline__ void store_words(const Seg& sg, const float* lv, const float* scale_s,
                                            int t, int row0, int c0,
                                            const uint32_t (&raw)[NRAW], float* x_s, Pre pre) {
  using G = WordGrid<BEFF>;
  const int ln = sg.ln, bits = sg.bits, c2 = 2 * ((int)threadIdx.x % G::TPR), col = c0 + c2;
  const bool in0 = col < ln, in1 = col + 1 < ln;
  const int slot0 = (row0 - t * kTile) / G::RT;
  const uint32_t mask = BEFF == 32 ? 0u : (1u << bits) - 1u;
  const float delta = sg.delta, off = 0.5f * delta - 1.f;  // (c + .5)*delta - 1, exactly
  const bool perdim = sg.kind == kPerdim;
  const float* lv0 = lv + (perdim && in0 ? col << bits : 0);
  const float* lv1 = lv + (perdim && in1 ? (col + 1) << bits : 0);
  const bool scaled = sg.scale_col >= 0;
  const int r0 = threadIdx.x / G::TPR;
  pre();
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
      x_s[c2 * kSX + r] = in0 ? v0 * sc : 0.f;
      x_s[(c2 + 1) * kSX + r] = in1 ? v1 * sc : 0.f;
    }
  }
}

template <int NRAW>
__device__ __forceinline__ void fetch_seg(const Seg& sg, int t, int row0, int c0,
                                          uint32_t (&raw)[NRAW]) {
  switch (sg.beff) {
    case 1: fetch_words<1>(sg, t, row0, c0, raw); break;
    case 2: fetch_words<2>(sg, t, row0, c0, raw); break;
    case 4: fetch_words<4>(sg, t, row0, c0, raw); break;
    case 8: fetch_words<8>(sg, t, row0, c0, raw); break;
    case 16: fetch_words<16>(sg, t, row0, c0, raw); break;
    default: fetch_words<32>(sg, t, row0, c0, raw); break;
  }
}

template <bool TABLE, int NRAW, class Pre>
__device__ __forceinline__ void store_kind(const Seg& sg, const float* lv, const float* scale_s,
                                           int t, int row0, int c0, const uint32_t (&raw)[NRAW],
                                           float* x_s, Pre pre) {
  switch (sg.beff) {
    case 1: store_words<1, TABLE>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre); break;
    case 2: store_words<2, TABLE>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre); break;
    case 4: store_words<4, TABLE>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre); break;
    case 8: store_words<8, TABLE>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre); break;
    default: store_words<16, TABLE>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre); break;
  }
}

template <int NRAW, class Pre>
__device__ __forceinline__ void store_seg(const Seg& sg, const float* lv, const float* scale_s,
                                          int t, int row0, int c0, const uint32_t (&raw)[NRAW],
                                          float* x_s, Pre pre) {
  if (sg.kind == kValues)
    store_words<32, false>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre);
  else if (sg.kind == kUniform)
    store_kind<false>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre);
  else
    store_kind<true>(sg, lv, scale_s, t, row0, c0, raw, x_s, pre);
}

// The block's queries for dims [c0, c0 + kKDK) of a segment starting at
// query column doff: thread tid owns the dim pair of fetch_words and queries
// tid / TPR + i * STEP, i < NQV / 2 (qv[2i], qv[2i+1]); 0 past Q or past the
// segment's end.
template <int NQV>
__device__ __forceinline__ void fetch_queries(const Params& p, int ln, int c0, int doff, int q0,
                                              int nq, float (&qv)[NQV]) {
  constexpr int TPR = kKDK / 2, STEP = kThreads / TPR;
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

// f32 products of one stage over `width` dims: x_s (kKDK, kSX), q_s (kKDK,
// kSQ).  acc[a * 4 + b]: query kFQ * warp + a, row lane + 32 * b.
__device__ __forceinline__ void ffma_stage(const float* x_s, const float* q_s, int width,
                                           float (&acc)[kAcc]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
  for (int d = 0; d < width; ++d) {
    float qq[kFQ];
#pragma unroll
    for (int a = 0; a < kFQ; a += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(q_s + d * kSQ + warp * kFQ + a);
      qq[a] = q4.x, qq[a + 1] = q4.y, qq[a + 2] = q4.z, qq[a + 3] = q4.w;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float xv = x_s[d * kSX + lane + 32 * b];
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
// cand_s / cand_i; empty slots are (-inf, INT_MAX).
__global__ void __launch_bounds__(kThreads, 1)
packed_scan_f32_kernel(const __grid_constant__ Params p) {
  constexpr int NRAW = kTR * kKDK / kThreads;  // words a thread holds at most
  constexpr int NQV = kQB * kKDK / kThreads;   // query values a thread stages
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf_s = reinterpret_cast<float*>(smem);
  int* buf_i = reinterpret_cast<int*>(buf_s + kQB * kBuf);
  unsigned char* stage_s = reinterpret_cast<unsigned char*>(buf_i + kQB * kBuf);
  float* lv_s = reinterpret_cast<float*>(stage_s + 2 * kStageBytes);
  __shared__ float qa_s[kQB];
  __shared__ float thr[kQB];
  __shared__ float gthr[kQB];
  __shared__ int n_cand[kQB];
  __shared__ float term_s[kTR];
  __shared__ float scale_s[2][kTR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQB;
  const int nq = min(kQB, p.Q - q0);
  int i_begin, i_end;
  tile_range(p, i_begin, i_end);

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
  float qv[NQV];
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
      // stage (s, c0): dims [c0, c0 + kKDK) of segment s, written into stage
      // buffer b
      auto store = [&](int s, int c0, int b, auto pre) {
        const Seg& sg = p.seg[s];
        const float* lv = p.lv_smem ? lv_s + sg.lv_off : sg.lv;
        constexpr int TPR = kKDK / 2, STEP = kThreads / TPR;
        const int c2 = 2 * (tid % TPR), j0 = tid / TPR;
        float* x_s = reinterpret_cast<float*>(stage_s + b * kStageBytes);
        float* q_s = x_s + kKDK * kSX;
        store_seg(sg, lv, scale_s[s & 1], t, row0, c0, raw, x_s, pre);
#pragma unroll
        for (int i = 0; i < NQV / 2; ++i) {
          q_s[c2 * kSQ + j0 + i * STEP] = qv[2 * i];
          q_s[(c2 + 1) * kSQ + j0 + i * STEP] = qv[2 * i + 1];
        }
      };
      // the row terms' loads stay in flight during the stages
      const float term = tid < kTR ? row_term(p, row0 + tid) : 0.f;
      float acc[kAcc];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
      int s = 0, c0 = 0, b = 0;
      fetch_seg(p.seg[0], t, row0, 0, raw);
      fetch_queries(p, p.seg[0].ln, 0, p.seg[0].doff, q0, nq, qv);
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
        int ns = s, nc0 = c0 + kKDK;
        if (nc0 >= sg.ln) ns = s + 1, nc0 = 0;
        const bool more = ns < p.nseg;
        const bool ahead = more && ns != s && ns + 1 < p.nseg && p.seg[ns + 1].scale_col >= 0;
        float sc = 0.f;
        if (ahead && tid < kTR)
          sc = __ldg(p.fac + (size_t)p.seg[ns + 1].scale_col * p.N + row0 + tid);
        auto products = [&] {
          const float* x_s = reinterpret_cast<const float*>(stage_s + b * kStageBytes);
          ffma_stage(x_s, x_s + kKDK * kSX, min(kKDK, sg.ln - c0), acc);
        };
        if (more) {
          const Seg& nsg = p.seg[ns];
          fetch_seg(nsg, t, row0, nc0, raw);
          fetch_queries(p, nsg.ln, nc0, nsg.doff, q0, nq, qv);
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
      // not in the result; an equal score may be, by its id).  A thread's
      // kFQ queries (a) and 4 rows (bb) of its accumulators.
      float qa_r[kFQ], thr_r[kFQ], g_r[kFQ], term_r[4];
#pragma unroll
      for (int a = 0; a < kFQ; ++a) {
        const int j = warp * kFQ + a;
        qa_r[a] = qa_s[j], thr_r[a] = thr[j], g_r[a] = gthr[j];
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) term_r[bb] = term_s[lane + 32 * bb];
#pragma unroll
      for (int a = 0; a < kFQ; ++a) {
        const int j = warp * kFQ + a;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int row = row0 + lane + 32 * bb;
          const float ip = acc[a * 4 + bb];
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

// Dynamic shared memory of an f32 launch: the top-k buffers, two stage
// buffers and the level tables when they fit
size_t f32_smem(int lv_floats) {
  return (size_t)kQB * kBuf * (sizeof(float) + sizeof(int)) + 2 * kStageBytes +
         (lv_floats <= kLvSmemFloats ? (size_t)lv_floats * sizeof(float) : 0);
}

// ============================================================ bf16 (wgmma)
constexpr int kCThreads = 256;         // consumer warpgroups 0 and 1
constexpr int kBThreads = kCThreads + 128;  // + the producer warpgroup
// setmaxnreg within the block's launch allocation: 384 x 168 = 2 x 128 x 232 + 128 x 40
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kPThreads = kBThreads - kCThreads;
constexpr int kBarConsumer = 1;        // named barriers of the consumers, the producers
constexpr int kBarProducer = 2;        // (0 is __syncthreads)
constexpr int kMaxStages = 8;          // ring depth, fewer where shared memory runs out
constexpr int kPad = 8;                // words after a staged word row: conflict-free 8-byte loads
constexpr int kFoldAt = 64;            // a query's candidates are merged from 64 on

// A 512-row tile goes in kPasses passes of 256 rows: each consumer
// warpgroup kMT m64 tiles of them, a thread kRows rows 64 apart, a pass the
// rows whose (tile row % 16) lies in one kCW-wide half
constexpr int kMT = 2;
constexpr int kPasses = 2;
constexpr int kRows = 2 * kMT;         // rows g, g + 8 of each m64 tile
constexpr int kCW = 16 / kPasses;
constexpr int kFoldSlots = kFoldAt + kTile / kPasses;  // candidate slots a query: 63 + a pass

// Word rows of a 512-row tile (rows of the value plane), 16 * B_eff
__host__ __device__ constexpr int tile_word_rows(int kind, int beff) {
  return kind == kValues ? kTile : kTile * beff / 32;
}

// Bytes a stage's staged word rows take: a pass's 1/NPASS of them, kdk
// words each plus the padding
__host__ __device__ inline int stage_words_bytes(const Seg& sg, int npass) {
  return tile_word_rows(sg.kind, sg.beff) / npass * (sg.kdk + kPad) * 4;
}

// round(v) to bf16 pairs, the lower dim in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Bytes of {b, a} picked by the four selector nibbles of s (bit 3 of a
// nibble replicates the picked byte's sign instead)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// Widest query tile whose consumers keep the shared kind's tables in
// registers.  At W = 128 the 32 table registers beside 128 sums a thread
// spill more (100 / 192 bytes of spill stores / loads against 76 / 128): on
// an H100 the shared kind at Q = 256 ran 1.73x faster with them, but the
// uniform kind's gather at Q = 1024 3-4% slower, so W = 128 keeps the table
// path
constexpr int kRegTableWidth = 64;

// A segment's dequant reads register tables (the "shared" kind at B_eff <= 4)
__host__ __device__ constexpr bool register_table(int kind, int beff, int width) {
  return kind == kShared && beff <= 4 && width <= kRegTableWidth;
}

// A consumer thread's view of one segment: the staged word rows holding its
// rows, their shift slots, their scales.  Tile row of the thread's row s in
// pass pi: rho = r0 + 64 s, r0 = 64 ROWS z + 16 b + CW pi + cq; word row
// rho % RT, shift slot rho / RT, staged at (word row / 16) * CW + cq.  Row s
// lies in word s % NW, D bits past row s - NW.
//   uniform: one rotation of a word puts GG of its rows' codes c at bits
//   1 + D m (m < GG) under the mantissa's top; OR-ed with the exponent of
//   2^e, e = 23 - bits - D m, and bit D m, the float is 2^e + (c + .5) *
//   delta exactly, less 2^e + 1 the value (c + .5) * delta - 1, also exact:
//   one rotation for GG rows, then one LOP3 and one FADD a value.
template <int W, int KIND, int BEFF>
struct SegView {
  static constexpr int RT = KIND == kValues ? kTile : kTile * BEFF / 32;
  static constexpr int NW = RT <= 64 ? 1 : (RT / 64 < kRows ? RT / 64 : kRows);
  static constexpr int D = RT <= 64 ? 4 : BEFF;
  static constexpr int RPW = kRows / NW;  // rows a word
  static constexpr int GG = D == 4 ? (RPW < 4 ? RPW : 4) : D == 8 ? (RPW < 2 ? RPW : 2) : 1;
  static constexpr int NG = RPW / GG;        // rotations a word
  int off[NW];             // word offset of each staged row in a stage
  uint32_t sh[kRows];   // table kinds: the shift of row s
  uint32_t rot[NW * NG];   // uniform: rotate right by (shift of the group's first row - 1) mod 32
  uint32_t msk[GG], kor[GG];
  float sub[GG];
  float sc[kRows];

  __device__ __forceinline__ SegView(const Seg& sg, int r0, int cq,
                                     const float* scale, const float*) {
    const int stride = sg.kdk + kPad;
    auto shift = [&](int s) { return (uint32_t)(BEFF * ((r0 + 64 * s) / RT)); };
#pragma unroll
    for (int i = 0; i < NW; ++i) off[i] = (((r0 + 64 * i) % RT) / 16 * kCW + cq) * stride;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      sh[s] = KIND == kValues ? 0u : shift(s);
      sc[s] = scale != nullptr ? scale[r0 + 64 * s] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g) rot[i * NG + g] = (shift(i + NW * g * GG) + 31u) & 31u;
    const uint32_t m2 = ((1u << sg.bits) - 1u) << 1;
#pragma unroll
    for (int m = 0; m < GG; ++m) {
      const uint32_t ex = (uint32_t)(150 - sg.bits - D * m) << 23;  // 2^e
      msk[m] = m2 << (D * m);
      kor[m] = ex | (1u << (D * m));
      sub[m] = __uint_as_float(ex) + 1.f;
    }
  }
};

// The "shared" kind at B_eff <= 4: RT = 16 B_eff <= 64, so (r0 % 256 < 64)
// row s's code lies in nibble 4z + s of its word, z = r0 / 256, o = B_eff *
// (r0 % 64 / RT) bits into the nibble, and bytes 2z, 2z + 1 of a word hold
// all 4 rows' codes.  Row s's table, indexed by the whole nibble n, holds
// round(lv[(n >> o) & mask] x scale_s) to bf16 -- the f32 product and the
// rounding the table path applies to that code -- as its 16 low bytes and
// its 16 high bytes.
template <int W, int BEFF>
struct SegView<W, kShared, BEFF> {
  static_assert(BEFF <= 4, "one code a nibble");
  static constexpr int RT = kTile * BEFF / 32;
  int off;                                // word offset of the staged row in a stage
  uint32_t pick;                          // prmt: bytes 2z, 2z + 1 of two words
  uint32_t lo[kRows][4], hi[kRows][4];    // row s: bytes of entries 4i .. 4i + 3

  __device__ __forceinline__ SegView(const Seg& sg, int r0, int cq, const float* scale,
                                     const float* lv) {
    off = ((r0 % RT) / 16 * kCW + cq) * (sg.kdk + kPad);
    const int sh = BEFF * (r0 / RT);      // row s's code at bit sh + 4 s
    pick = 0x5140u + 0x2222u * (uint32_t)(sh >> 4);
    const uint32_t o = sh & 3, mask = (1u << sg.bits) - 1u;
    float x[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) x[n] = lv[(n >> o) & mask];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const float sc = scale != nullptr ? scale[r0 + 64 * s] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t e01 = pack_bf16(x[4 * i] * sc, x[4 * i + 1] * sc);
        const uint32_t e23 = pack_bf16(x[4 * i + 2] * sc, x[4 * i + 3] * sc);
        lo[s][i] = prmt(e01, e23, 0x6420u);
        hi[s][i] = prmt(e01, e23, 0x7531u);
      }
    }
  }
};

// The words of one k-step a thread reads -- dims c, c + 1, c + 8, c + 9
// (c = 16 ks + 2 t) of each of its NW staged rows -- rotated once a group
// (uniform), for the fragments of its m64 tiles.
template <int W, int KIND, int BEFF>
struct KWords {
  using V = SegView<W, KIND, BEFF>;
  static constexpr int NG = KIND == kUniform ? V::NG : 1;
  uint32_t w[V::NW][NG][4];

  __device__ __forceinline__ KWords(const V& v, const uint32_t* ws, int c) {
#pragma unroll
    for (int i = 0; i < V::NW; ++i) {
      const uint2 lo = *reinterpret_cast<const uint2*>(ws + v.off[i] + c);
      const uint2 hi = *reinterpret_cast<const uint2*>(ws + v.off[i] + c + 8);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const uint32_t r = KIND == kUniform ? v.rot[i * NG + g] : 0u;
        w[i][g][0] = KIND == kUniform ? __funnelshift_r(lo.x, lo.x, r) : lo.x;
        w[i][g][1] = KIND == kUniform ? __funnelshift_r(lo.y, lo.y, r) : lo.y;
        w[i][g][2] = KIND == kUniform ? __funnelshift_r(hi.x, hi.x, r) : hi.x;
        w[i][g][3] = KIND == kUniform ? __funnelshift_r(hi.y, hi.y, r) : hi.y;
      }
    }
  }
};

// The shared kind's k-step: its 16 codes as prmt selectors, sel[h] holding
// row h in its low half and row 2 + h in its high one, each half the codes
// of dims c, c + 8, c + 1, c + 9; sel7 with bit 3 of every nibble cleared
// (the upper 8 entries), half picking byte i of the lower (i) or the upper
// (4 + i) entries' lookup by that bit.
template <int W, int BEFF>
struct KWords<W, kShared, BEFF> {
  uint32_t sel[2], sel7[2], half[2];

  __device__ __forceinline__ KWords(const SegView<W, kShared, BEFF>& v, const uint32_t* ws,
                                    int c) {
    const uint2 lo = *reinterpret_cast<const uint2*>(ws + v.off + c);
    const uint2 hi = *reinterpret_cast<const uint2*>(ws + v.off + c + 8);
    // nibbles: x rows 0, 1 of dim c, rows 0, 1 of c + 1, rows 2, 3 of c,
    // rows 2, 3 of c + 1; y the same of dims c + 8, c + 9
    const uint32_t x = prmt(lo.x, lo.y, v.pick), y = prmt(hi.x, hi.y, v.pick);
    sel[0] = (x & 0x0F0F0F0Fu) | ((y << 4) & 0xF0F0F0F0u);
    sel[1] = ((x >> 4) & 0x0F0F0F0Fu) | (y & 0xF0F0F0F0u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sel7[h] = sel[h] & 0x77777777u;
      half[h] = ((sel[h] >> 1) & 0x44444444u) | 0x32103210u;
    }
  }
};

// Fragment a of m64 tile mt, rows 2 mt (g) and 2 mt + 1 (g + 8), from the
// k-step's words; dim0: the segment dim of c (perdim tables).
template <int W, int KIND, int BEFF>
__device__ __forceinline__ void dequant_tile(const SegView<W, KIND, BEFF>& v,
                                             const KWords<W, KIND, BEFF>& kw, const Seg& sg,
                                             const float* lv, int dim0, int mt, uint32_t (&a)[4]) {
  using V = SegView<W, KIND, BEFF>;
  if constexpr (KIND == kShared) {
    // each row's table: the lower and the upper 8 entries' bytes looked
    // up, the right ones kept, low and high bytes interleaved into pairs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * mt + h, sh = 16 * mt;
      const uint32_t sel = kw.sel[h] >> sh, sel7 = kw.sel7[h] >> sh, half = kw.half[h] >> sh;
      const uint32_t lo = prmt(prmt(v.lo[s][0], v.lo[s][1], sel),
                               prmt(v.lo[s][2], v.lo[s][3], sel7), half);
      const uint32_t hi = prmt(prmt(v.hi[s][0], v.hi[s][1], sel),
                               prmt(v.hi[s][2], v.hi[s][3], sel7), half);
      a[h] = prmt(lo, hi, 0x6240u);      // dims c, c + 1
      a[2 + h] = prmt(lo, hi, 0x7351u);  // dims c + 8, c + 9
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * mt + h, i = s % V::NW, m = s / V::NW;
      float x[4];
      if constexpr (KIND == kUniform) {
        const int g = m / V::GG, mm = m % V::GG;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = __uint_as_float((kw.w[i][g][e] & v.msk[mm]) | v.kor[mm]) - v.sub[mm];
      } else if constexpr (KIND == kValues) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(kw.w[i][0][e]);
      } else {
        // perdim: the table rows of the 4 dims (the last one past the
        // segment's end: those dims meet zero queries)
        const uint32_t mask = (1u << sg.bits) - 1u;
        const bool perdim = sg.kind == kPerdim;
        const int de[4] = {0, 1, 8, 9};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* t = lv + (perdim ? min(dim0 + de[e], sg.ln - 1) << sg.bits : 0);
          x[e] = t[(kw.w[i][0][e] >> v.sh[s]) & mask];
        }
      }
      const float sc = v.sc[s];
      a[h] = pack_bf16(x[0] * sc, x[1] * sc);
      a[2 + h] = pack_bf16(x[2] * sc, x[3] * sc);
    }
  }
}

// The consumer warpgroups' state through a pass
template <int W>
struct Pass {
  float acc[kMT][W / 2];
  uint32_t a0[4], a1[4];  // fragment buffers: one group in flight while the other fills
  int it;      // stages consumed
  int held;    // ring slot still read by the wgmma in flight, -1 none
};

// One k-step: the words once, then per m64 tile a group of its own --
// dequantize into one fragment buffer, issue, keep one group in flight
template <int W, int KIND, int BEFF>
__device__ __forceinline__ void kstep(Pass<W>& ps, const SegView<W, KIND, BEFF>& v,
                                      const Seg& sg, const float* lv, const uint32_t* ws, int c,
                                      int dim0, uint64_t db) {
  static_assert(kMT == 2, "one group a tile, alternating the two buffers");
  const KWords<W, KIND, BEFF> kw(v, ws, c);
  auto group = [&](int mt, uint32_t (&a)[4], uint32_t (&other)[4]) {
    dequant_tile<W, KIND, BEFF>(v, kw, sg, lv, dim0, mt, a);
    fence_regs(a);
    wgmma_fence();
    wgmma_bf16_rs<W>(ps.acc[mt], a, db, 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(other);
  };
  group(0, ps.a0, ps.a1);
  group(1, ps.a1, ps.a0);
}

// Every stage of one segment in this pass: wait for the stage, dequantize
// and multiply its k-steps, release the previous stage's slot once the
// group after its last one is issued
template <int W, int KIND, int BEFF>
__device__ __forceinline__ void seg_stages(const Params& p, const Seg& sg, Pass<W>& ps,
                                           int r0, int cq,
                                           const float* scale, const float* lv,
                                           unsigned char* q_ring, unsigned char* w_ring,
                                           uint64_t* full, uint64_t* empty) {
  const SegView<W, KIND, BEFF> v(sg, r0, cq, scale, lv);
  const int lane = threadIdx.x & 31, c2 = 2 * (lane & 3);
  for (int c0 = 0; c0 < sg.ln; c0 += sg.kdk, ++ps.it) {
    const int slot = ps.it % p.stages;
    mbar_wait(full + slot, (ps.it / p.stages) & 1);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(w_ring + (size_t)slot * p.wslot);
    const uint64_t db =
        sw128_desc(smem_addr(q_ring + (size_t)slot * W * 128)) + 2 * ((c0 % 64) / 16);
    const int nks = (min(sg.kdk, sg.ln - c0) + 15) / 16;
    for (int ks = 0; ks < nks; ++ks) {
      const int c = 16 * ks + c2;
      kstep<W, KIND, BEFF>(ps, v, sg, lv, ws, c, c0 + c, db + 2 * ks);
      if (ks == 0) {
        if (ps.held >= 0 && lane == 0) mbar_arrive(empty + ps.held);
        ps.held = slot;
      }
    }
  }
}

// Consumer warp `warp` (of 8) merges each of its queries' candidates into
// the query's top-k where it holds `at` or more (128 at a time), updates the
// query's k-th entry and cut, and publishes the k-th.
__device__ __forceinline__ void fold_queries(float* fs, int* fi, int kbuf, int k, int at, int nq,
                                          int* n_cand, float* thr_s, int* thr_i, float* cut,
                                          unsigned int* kth_g, int warp, int lane) {
  for (int j = warp; j < nq; j += kCThreads / 32) {
    const int nc = n_cand[j];
    if (nc < max(at, 1)) continue;
    float* s = fs + (size_t)j * kbuf;
    int* id = fi + (size_t)j * kbuf;
    float kth = -INFINITY;
    for (int c = 0; c < nc; c += 128)
      kth = warp_fold_regs(s, id, k, s + k + c, id + k + c, min(nc - c, 128), lane);
    if (lane == 0) {
      thr_s[j] = kth;
      thr_i[j] = id[k - 1];
      n_cand[j] = 0;
      if (kth > -INFINITY) atomicMax(kth_g + j, ordered_bits(kth));
      cut[j] = fmaxf(kth, from_ordered_bits(__ldcg(kth_g + j)));
    }
  }
}

// grid (ceil(Q / W), chunks), kBThreads threads; see the header.  Writes
// each (query, chunk) sorted top-k to cand_s / cand_i, empty slots (-inf,
// INT_MAX).
template <int W>
__global__ void __launch_bounds__(kBThreads, 1)
packed_scan_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  unsigned char* w_ring = q_ring + (size_t)S * W * 128;
  float* f_ring = reinterpret_cast<float*>(w_ring + (size_t)S * p.wslot);
  float* lv_s = f_ring + (p.fac_smem ? 2 * p.nfc * kTile : 0);
  float* qa_s = lv_s + (p.lv_smem ? p.lv_floats : 0);
  float* thr_s = qa_s + W;
  int* thr_i = reinterpret_cast<int*>(thr_s + W);
  float* cut = reinterpret_cast<float*>(thr_i + W);
  int* n_cand = reinterpret_cast<int*>(cut + W);
  int* slot_tile = n_cand + W;
  int* keep_s = slot_tile + kMaxStages;  // the producers' prune decision, two tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(keep_s + 2);
  uint64_t* empty = full + kMaxStages;
  uint64_t* ffull = empty + kMaxStages;
  uint64_t* fempty = ffull + 2;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * W;
  const int nq = min(W, p.Q - q0);
  int i_begin, i_end;
  tile_range(p, i_begin, i_end);

  // the word ring starts zeroed: a partial stage leaves words of an earlier
  // stage or zeros past the segment's end, never a NaN (the queries are 0
  // there)
  for (int i = tid; i < S * p.wslot / 16; i += kBThreads)
    reinterpret_cast<uint4*>(w_ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (p.lv_smem) {
    for (int s = 0; s < p.nseg; ++s) {
      const Seg& sg = p.seg[s];
      if (sg.kind != kPerdim && sg.kind != kShared) continue;
      const int n = (sg.kind == kPerdim ? sg.ln : 1) << sg.bits;
      for (int i = tid; i < n; i += kBThreads) lv_s[sg.lv_off + i] = sg.lv[i];
    }
  }
  if (tid < W) {
    qa_s[tid] = tid < nq ? p.qa[q0 + tid] : 0.f;
    thr_s[tid] = -INFINITY;
    thr_i[tid] = INT_MAX;
    n_cand[tid] = 0;
    cut[tid] = tid < nq ? -INFINITY : INFINITY;  // padding queries admit nothing
  }
  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(full + i, kPThreads);        // every producer thread
      mbar_init(empty + i, kCThreads / 32);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ffull + i, kPThreads);
      mbar_init(fempty + i, kCThreads / 32);
    }
    mbar_init_fence();
  }
  fence_proxy_async();  // the zeros before the copies' writes
  __syncthreads();

  if (tid >= kCThreads) {
    // ---- producers: warpgroup 2, its 128 threads issuing a stage's copies
    // together; thread 0 decides the prune and tells the others
    warpgroup_regs_dec<kProducerRegs>();
    const int pt = tid - kCThreads, lane = tid & 31;
    int it = 0, nt = 0;
    for (int i = i_begin; i < i_end; ++i) {
      const int t = p.tiles != nullptr ? p.tiles[i] : i;  // global tile id
      if (p.prune) {
        if (pt < 32) {
          bool keep = false;
          for (int j = lane; j < nq; j += 32) {
            const float own = *reinterpret_cast<volatile float*>(thr_s + j);
            const float kth = fmaxf(own, from_ordered_bits(__ldcg(p.kth_g + q0 + j)));
            keep |= !(tile_bound(p, t, q0 + j) < kth);
          }
          keep = __any_sync(0xffffffffu, keep);
          if (lane == 0) {
            keep_s[i & 1] = keep;
            if (keep) atomicAdd(p.scanned, 1);
          }
        }
        named_sync(kBarProducer, kPThreads);
        if (!keep_s[i & 1]) continue;
      }
      if (t * kTile >= p.limit) continue;
      if (p.fac_smem) {  // the tile's factor columns
        const int fs = nt & 1;
        mbar_wait(fempty + fs, ((nt >> 1) & 1) ^ 1);
        if (pt == 0) mbar_expect_tx(ffull + fs, p.nfc * kTile * 4);
        for (int c = pt; c < p.nfc; c += kPThreads)
          bulk_copy_g2s(f_ring + (size_t)(fs * p.nfc + c) * kTile,
                        p.fac + (size_t)p.fcol[c] * p.N + (size_t)t * kTile, kTile * 4, ffull + fs);
        mbar_arrive(ffull + fs);
      }
      ++nt;
      for (int pass = 0; pass < kPasses; ++pass) {
        for (int s = 0; s < p.nseg; ++s) {
          const Seg& sg = p.seg[s];
          const int rt = tile_word_rows(sg.kind, sg.beff), nrows = rt / kPasses;
          const int stride = (sg.kdk + kPad) * 4;
          for (int c0 = 0; c0 < sg.ln; c0 += sg.kdk, ++it) {
            const int slot = it % S, nd = min(sg.kdk, sg.ln - c0);
            mbar_wait(empty + slot, ((it / S) & 1) ^ 1);
            unsigned char* ww = w_ring + (size_t)slot * p.wslot;
            const uint32_t* src = static_cast<const uint32_t*>(sg.data) + (size_t)t * rt * sg.ln + c0;
            if (pt == 0) {  // the query tile, by the bulk copy engine
              slot_tile[slot] = t;
              mbar_expect_tx(full + slot, W * 128);
              bulk_copy_g2s(q_ring + (size_t)slot * W * 128,
                            p.q16 + ((size_t)blockIdx.x * (p.Dp / 64) + (sg.poff + c0) / 64) * W * 64,
                            W * 128, full + slot);
            }
            // the words by cp.async, 16 bytes (4 bytes where a segment's
            // rows are not 16-byte aligned) a copy; staged row rr: word row
            // (rr / CW) * 16 + CW * pass + rr % CW
            if (sg.vec) {
              const int cpr = sg.kdk / 4, c = pt % cpr;  // 16-byte chunks a row: 16, 8 or 4
              if (4 * c < nd) {
                for (int rr = pt / cpr; rr < nrows; rr += kPThreads / cpr) {
                  const int r = rr / kCW * 16 + kCW * pass + rr % kCW;
                  cp_async16(ww + (size_t)rr * stride + 16 * c, src + (size_t)r * sg.ln + 4 * c, 16);
                }
              }
            } else {
              for (int e = pt; e < nrows * sg.kdk; e += kPThreads) {
                const int rr = e / sg.kdk, col = e % sg.kdk;
                const int r = rr / kCW * 16 + kCW * pass + rr % kCW;
                cp_async4(ww + (size_t)rr * stride + col * 4, src + (size_t)r * sg.ln + (col < nd ? col : 0),
                          col < nd ? 4 : 0);
              }
            }
            cp_async_mbar_arrive(full + slot);
          }
        }
      }
    }
    // the end: a stage whose tile is -1
    const int slot = it % S;
    mbar_wait(empty + slot, ((it / S) & 1) ^ 1);
    if (pt == 0) slot_tile[slot] = -1;
    mbar_arrive(full + slot);
    return;
  }

  // ---- consumers: warpgroups 0 and 1
  warpgroup_regs_inc<kConsumerRegs>();
  const int warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int pr = 32 * (warp >> 2) + 8 * (warp & 3) + (lane >> 2);  // row owner, 0..63
  const int npb = 64 / kPasses;  // (tile row / 16 % 4, tile row % 16) pairs a pass
  const int z = pr / npb, b = pr % npb / kCW, cq = pr % kCW;
  const int kbuf = p.k + kFoldSlots;
  const size_t fold0 = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * W * kbuf;
  float* fs = p.fold_s + fold0;
  int* fi = p.fold_i + fold0;
  for (int i = tid; i < W * p.k; i += kCThreads) {  // the top-k lists empty
    fs[i / p.k * kbuf + i % p.k] = -INFINITY;
    fi[i / p.k * kbuf + i % p.k] = INT_MAX;
  }
  auto fold = [&](int at) {
    fold_queries(fs, fi, kbuf, p.k, at, nq, n_cand, thr_s, thr_i, cut, p.kth_g + q0, warp, lane);
  };

  Pass<W> ps;
  ps.it = 0, ps.held = -1;
  int nt = 0, pass = 0;
  while (true) {
    const int slot0 = ps.it % S;
    mbar_wait(full + slot0, (ps.it / S) & 1);
    const int t = slot_tile[slot0];
    if (t < 0) break;
    const int fsl = nt & 1;
    if (pass == 0 && p.fac_smem) mbar_wait(ffull + fsl, (nt >> 1) & 1);
    // the published k-th of query tid, once a tile: loaded now, read after
    // the pass
    const bool refresh = pass == 0 && tid < nq;
    const float pub = refresh ? from_ordered_bits(__ldcg(p.kth_g + q0 + tid)) : -INFINITY;
    auto column = [&](int c) -> const float* {  // factor column c of the tile
      return p.fac_smem ? f_ring + (size_t)(fsl * p.nfc + c) * kTile
                        : p.fac + (size_t)p.fcol[c] * p.N + (size_t)t * kTile;
    };
    const int r0 = 64 * kRows * z + 16 * b + kCW * pass + cq;  // tile row of row 0
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int a = 0; a < W / 2; ++a) ps.acc[mt][a] = 0.f;
    for (int s = 0; s < p.nseg; ++s) {
      const Seg& sg = p.seg[s];
      const float* scale = sg.sidx >= 0 ? column(sg.sidx) : nullptr;
      const float* lv = p.lv_smem ? lv_s + sg.lv_off : sg.lv;
#define VQ_SEG(KIND, BEFF) \
  seg_stages<W, KIND, BEFF>(p, sg, ps, r0, cq, scale, lv, q_ring, w_ring, full, empty)
      if (sg.kind == kValues) {
        VQ_SEG(kValues, 32);
      } else if (sg.kind == kUniform) {
        switch (sg.beff) {
          case 1: VQ_SEG(kUniform, 1); break;
          case 2: VQ_SEG(kUniform, 2); break;
          case 4: VQ_SEG(kUniform, 4); break;
          case 8: VQ_SEG(kUniform, 8); break;
          default: VQ_SEG(kUniform, 16); break;
        }
      } else if (register_table(sg.kind, sg.beff, W)) {
        if constexpr (register_table(kShared, 4, W)) {
          switch (sg.beff) {
            case 1: VQ_SEG(kShared, 1); break;
            case 2: VQ_SEG(kShared, 2); break;
            default: VQ_SEG(kShared, 4); break;
          }
        }
      } else {
        switch (sg.beff) {
          case 1: VQ_SEG(kPerdim, 1); break;
          case 2: VQ_SEG(kPerdim, 2); break;
          case 4: VQ_SEG(kPerdim, 4); break;
          case 8: VQ_SEG(kPerdim, 8); break;
          default: VQ_SEG(kPerdim, 16); break;
        }
      }
#undef VQ_SEG
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_regs(ps.acc[mt]);
    if (lane == 0) mbar_arrive(empty + ps.held);
    ps.held = -1;
    // epilogue.  The cuts are read with no barrier after this update: a cut
    // only rises (here and in the folds), so a thread that reads one before
    // it admits a superset, which the fold sorts out.
    if (refresh) cut[tid] = fmaxf(cut[tid], pub);
    // one round over the pass: 2 rows of each m64 tile x W / 4 queries a
    // thread, the rows' score terms
    int row[kRows];
    float term[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int rho = r0 + 64 * s;
      row[s] = t * kTile + rho;
      term[s] = 0.f;
      if (p.metric == kL2) {
        float shift = column(p.tcol)[rho];
        for (int i = 1; i < p.n_r2; ++i) shift = shift + column(p.tcol + i)[rho];
        term[s] = shift;
      } else if (p.metric == kNIP) {
        term[s] = fmaxf(column(p.tcol)[rho], 1e-30f);
      }
    }
    // scores compared with the cut first, the admitted ones (kept in
    // `held`) appended after.  The metric is chosen outside the round: a
    // test of it inside let the compiler compute NIP's division for every
    // score, whatever the metric.
    constexpr int kHeld = kMT * W / 2, kWords = kHeld / 32;
    uint32_t adm[kWords];
    float held[kHeld];
#pragma unroll
    for (int w = 0; w < kWords; ++w) adm[w] = 0u;
    auto score_round = [&](auto metric) {
      constexpr int M = decltype(metric)::value;
#pragma unroll
      for (int jb = 0; jb < W / 8; ++jb) {
        const float2 cj = *reinterpret_cast<const float2*>(cut + 8 * jb + 2 * tq);
        const float2 qj = *reinterpret_cast<const float2*>(qa_s + 8 * jb + 2 * tq);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int a = mt * (W / 2) + 4 * jb + v, s = 2 * mt + (v >> 1);
            const float ip = ps.acc[mt][4 * jb + v], qa = v & 1 ? qj.y : qj.x;
            float sc;
            if constexpr (M == kL2) sc = 2.f * ip + qa - term[s];
            else if constexpr (M == kIP) sc = ip + qa;
            else sc = (ip + qa) / term[s];
            if (row[s] < p.limit && sc >= (v & 1 ? cj.y : cj.x)) {
              held[a] = sc;
              adm[a >> 5] |= 1u << (a & 31);
            }
          }
        }
      }
    };
    if (p.metric == kL2) score_round(std::integral_constant<int, kL2>());
    else if (p.metric == kIP) score_round(std::integral_constant<int, kIP>());
    else score_round(std::integral_constant<int, kNIP>());
    bool any = false;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      for (uint32_t m = adm[w]; m; m &= m - 1) {
        const int a = 32 * w + __ffs(m) - 1, e = a % (W / 2);
        const int qj = 8 * (e >> 2) + 2 * tq + (e & 1), r = row[2 * (a / (W / 2)) + ((e >> 1) & 1)];
        // a score equal to the k-th entry's ranks after it by a larger id
        if (held[a] == thr_s[qj] && r > thr_i[qj]) continue;
        const int slot = p.k + atomicAdd(&n_cand[qj], 1);
        fs[qj * kbuf + slot] = held[a];
        fi[qj * kbuf + slot] = r;
        any = true;
      }
    }
    if (named_sync_or(kBarConsumer, kCThreads, any)) {
      fold(kFoldAt);
      named_sync(kBarConsumer, kCThreads);
    }
    if (++pass == kPasses) {
      if (p.fac_smem && lane == 0) mbar_arrive(fempty + fsl);
      pass = 0;
      ++nt;
    }
  }
  named_sync(kBarConsumer, kCThreads);
  fold(1);  // what is left
  named_sync(kBarConsumer, kCThreads);
  const int chunks = gridDim.y;
  for (int i = tid; i < nq * p.k; i += kCThreads) {
    const int j = i / p.k, r = i % p.k;
    const size_t o = ((size_t)(q0 + j) * chunks + blockIdx.y) * p.k + r;
    p.cand_s[o] = fs[j * kbuf + r];
    p.cand_i[o] = fi[j * kbuf + r];
  }
}

// grid (Qp), Qp = Q rounded up to W; the queries rounded to bf16 into the
// bf16 kernel's stage-major swizzled tiles: query j, padded dim d (segment
// s's dims from poff_s, its ln_s rounded up to 64, zero past ln_s and Q)
// at q16[((j / W * Dp / 64 + d / 64) * W + j % W) * 64 + (d / 8 % 8 ^ j % 8) * 8 + d % 8]
__global__ void round_queries_kernel(const __grid_constant__ Params p, int W) {
  const int j = blockIdx.x, jj = j % W;
  __nv_bfloat16* out = const_cast<__nv_bfloat16*>(p.q16) + (size_t)(j / W) * (p.Dp / 64) * W * 64;
  for (int s = 0; s < p.nseg; ++s) {
    const Seg& sg = p.seg[s];
    const int w = (sg.ln + 63) / 64 * 64;
    for (int d = threadIdx.x; d < w; d += blockDim.x) {
      const int dd = sg.poff + d;
      out[((size_t)(dd / 64) * W + jj) * 64 + (((dd / 8) % 8) ^ (jj % 8)) * 8 + dd % 8] =
          __float2bfloat16(j < p.Q && d < sg.ln ? p.q[(size_t)j * p.D + sg.doff + d] : 0.f);
    }
  }
}

// Dynamic shared memory of a width-W bf16 launch at ring depth `stages`
size_t bf16_smem(const Params& p, int W, int stages) {
  return 1024 + (size_t)stages * ((size_t)W * 128 + p.wslot) +
         (p.fac_smem ? (size_t)2 * p.nfc * kTile * 4 : 0) +
         (p.lv_smem ? (size_t)p.lv_floats * 4 : 0) + (size_t)5 * W * 4 + (kMaxStages + 2) * 4 +
         (2 * kMaxStages + 4) * sizeof(uint64_t);
}

// The bf16 launch's layout: factor columns, word slots, ring depth, what is
// staged; the deepest ring of kMaxStages down to 3 with the factors staged,
// else without them, else of 2, the level tables staged where they still
// fit.  Returns the dynamic shared memory, 0 if nothing fits.
size_t bf16_plan(Params& p, int W) {
  p.nfc = 0;
  for (int s = 0; s < p.nseg; ++s) {
    Seg& sg = p.seg[s];
    sg.kdk = min(64, 512 / sg.beff);
    sg.vec = sg.ln % 4 == 0 && reinterpret_cast<uintptr_t>(sg.data) % 16 == 0;
    sg.sidx = sg.scale_col >= 0 ? p.nfc : -1;
    if (sg.scale_col >= 0) p.fcol[p.nfc++] = sg.scale_col;
  }
  p.tcol = p.nfc;
  if (p.metric == kL2)
    for (int i = 0; i < p.n_r2; ++i) p.fcol[p.nfc++] = p.r2[i];
  if (p.metric == kNIP) p.fcol[p.nfc++] = p.norm_col;
  p.wslot = 0;
  for (int s = 0; s < p.nseg; ++s) {
    const int b = (stage_words_bytes(p.seg[s], kPasses) + 127) / 128 * 128;
    if (b > p.wslot) p.wslot = b;
  }
  for (int lv = p.lv_floats <= kLvSmemFloats; lv >= 0; --lv) {
    p.lv_smem = lv;
    for (int least = 3; least >= 2; --least)
      for (int fac = 1; fac >= 0; --fac)
        for (int st = kMaxStages; st >= least; --st) {
          p.stages = st, p.fac_smem = fac;
          const size_t smem = bf16_smem(p, W, st);
          if (smem <= kSmemCap) return smem;
        }
  }
  return 0;
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

// Resident blocks per SM of a kernel at that shared memory (0: the launch
// cannot run)
template <class K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  cudaError_t err = smem == 0 ? cudaErrorInvalidValue
                              : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the caller sees 0, not a stale error at its next launch
    return 0;
  }
  return n;
}

// The segment descriptors into p (8 int64 a row); false if one is invalid
bool fill_segments(Params& p, const long long* segs, int nseg) {
  int d = 0, dp = 0, lv_floats = 0;
  p.nseg = nseg;
  for (int s = 0; s < nseg; ++s) {
    const long long* r = segs + 8 * s;
    Seg& sg = p.seg[s];
    sg.data = reinterpret_cast<const void*>(r[0]);
    sg.lv = reinterpret_cast<const float*>(r[1]);
    sg.bits = (int)r[2]; sg.beff = (int)r[3]; sg.ln = (int)r[4];
    sg.kind = (int)r[5]; sg.scale_col = (int)r[6]; sg.lv_off = lv_floats;
    sg.doff = d; sg.poff = dp;
    sg.delta = 2.f / (float)(1 << sg.bits);
    if (sg.kind < kUniform || sg.kind > kValues || sg.ln < 1) return false;
    if (sg.kind == kValues) sg.beff = 32;  // one row a "word": the f32 plane
    else if (sg.bits < 1 || sg.bits > sg.beff || sg.beff > 16 || 32 % sg.beff != 0)
      return false;
    if (sg.kind == kPerdim || sg.kind == kShared) {
      if (sg.lv == nullptr) return false;
      lv_floats += (sg.kind == kPerdim ? sg.ln : 1) << sg.bits;
    }
    d += sg.ln;
    dp += (sg.ln + 63) / 64 * 64;
  }
  p.D = d;
  p.Dp = dp;
  p.lv_floats = lv_floats;
  p.lv_smem = lv_floats <= kLvSmemFloats;
  return true;
}

template <int W>
int bf16_blocks(Params& p) {
  return blocks_per_sm(packed_scan_bf16_kernel<W>, kBThreads, bf16_plan(p, W));
}

}  // namespace

extern "C" {

// Layout constants, read by the Python wrapper.
int vq_packed_queries_per_block() { return kQB; }  // f32 mode's query block
int vq_packed_stage_dims() { return 64; }          // the bf16 queries' padding
int vq_packed_max_segments() { return kMaxSegs; }
int vq_packed_fold_slots() { return kFoldSlots; }
int vq_ordered_neg_inf() { return (int)~0xff800000u; }  // ordered bits of -inf

// 1 if a bf16 launch at query-tile width `width` dequantizes a segment of
// this kind and storage width from register tables, else 0
int vq_packed_register_table(int kind, int beff, int width) {
  return register_table(kind, beff, width);
}

// Resident blocks per SM of a launch with these segments at query-tile
// width `width` (bf16: 64 or 128; f32 takes kQB) and metric (the
// factor columns a bf16 tile stages: n_r2 of them for L2); 0 if such a
// launch cannot run
int vq_packed_blocks_per_sm(const long long* segs, int nseg, int bf16, int width, int metric,
                            int n_r2) {
  Params p;
  if (nseg < 1 || nseg > kMaxSegs || n_r2 > kMaxSegs || !fill_segments(p, segs, nseg)) return 0;
  if (!bf16)
    return blocks_per_sm(packed_scan_f32_kernel, kThreads, f32_smem(lv_floats_of(segs, nseg)));
  p.metric = metric;
  p.n_r2 = n_r2;
  for (int i = 0; i < n_r2; ++i) p.r2[i] = 0;
  p.norm_col = 0;
  switch (width) {
    case 64: return bf16_blocks<64>(p);
    case 128: return bf16_blocks<128>(p);
    default: return 0;
  }
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
// count, both on the card, select the gather mode (null: the dense grid).
// bf16 mode: width W = 64 or 128 queries a block; q16 a (Qp, Dp) bf16
// scratch, Qp = Q rounded up to W, Dp = sum of ln rounded up to
// vq_packed_stage_dims(); fold_s / fold_i scratch of ceil(Q / W) * chunks *
// W * (k + vq_packed_fold_slots()) entries (null in f32 mode, whose blocks
// take vq_packed_queries_per_block() queries)
int vq_packed_scan_topk(const float* q, void* q16, const float* qa, const float* fac,
                        const float* stats,
                        const float* qprune, const long long* segs, int nseg, const int* r2,
                        int n_r2, float* cand_s, int* cand_i, float* out_s, int* out_i,
                        int* scanned, unsigned int* kth_g, const int* tiles, const int* cnt,
                        float* fold_s, int* fold_i, int Q, int D, int N, int k,
                        int limit, int metric,
                        int family, int norm_col, int prune, int bf16, int width, int chunks,
                        void* stream) {
  if (k < 1 || k > kMaxK || !merge_shape_ok(chunks, k) ||
      nseg < 1 || nseg > kMaxSegs || n_r2 > kMaxSegs || N % kTile != 0 ||
      (metric == kL2 && n_r2 < 1) || ((tiles == nullptr) != (cnt == nullptr)) ||
      (bf16 && (q16 == nullptr || fold_s == nullptr || fold_i == nullptr ||
                (width != 64 && width != 128))) ||
      (!bf16 && k + kTR > kBuf))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.q16 = static_cast<const __nv_bfloat16*>(q16);
  p.qa = qa; p.fac = fac; p.stats = stats; p.qprune = qprune;
  p.cand_s = cand_s; p.cand_i = cand_i; p.scanned = scanned; p.kth_g = kth_g;
  p.tiles = tiles; p.cnt = cnt; p.fold_s = fold_s; p.fold_i = fold_i;
  p.Q = Q; p.N = N; p.k = k; p.limit = limit; p.metric = metric;
  p.family = family; p.norm_col = norm_col; p.prune = prune;
  p.nb = N / kTile;
  p.n_r2 = n_r2;
  for (int i = 0; i < n_r2; ++i) p.r2[i] = r2[i];
  if (!fill_segments(p, segs, nseg) || p.D != D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16) {
    const size_t smem = f32_smem(p.lv_floats);
    cudaFuncSetAttribute(packed_scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    packed_scan_f32_kernel<<<dim3((Q + kQB - 1) / kQB, chunks), kThreads, smem, st>>>(p);
  } else {
    const size_t smem = bf16_plan(p, width);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((Q + width - 1) / width, chunks);
    round_queries_kernel<<<grid.x * width, 256, 0, st>>>(p, width);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const auto kernel = width == 64 ? packed_scan_bf16_kernel<64> : packed_scan_bf16_kernel<128>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<grid, kBThreads, smem, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)merge_chunks(cand_s, cand_i, out_s, out_i, Q, chunks, k, st);
}

}  // extern "C"
