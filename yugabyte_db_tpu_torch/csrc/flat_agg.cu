// Flat-run MVCC aggregate fold for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_agg.py:_kernel
// (built by pallas_agg.compiled_flat_aggregate). On a flat run (one
// version per key) it resolves, per row: visibility (valid and commit
// hybrid time <= read point), tombstones, TTL expiry (expire time <= read
// point), existence (liveness or any value column set and not NULL), the
// [row_lo, row_hi) row range and the i32/i64 predicates; then it folds
// COUNT(*), COUNT(col), exact SUM (four 16-bit limbs of the 2^31- or
// 2^63-biased value, plus n) and MIN/MAX (lexicographic on the two int32
// order planes, plus n) into one partial row per block and spec. The host
// side (ops/flat_agg.py) folds the [N, G, S] partials over G with torch.
//
// What bounds it. One spec (N = 1) is bound by bytes: each row in range
// needs 16 bytes of hybrid-time/expiry planes, 3 of valid/tomb/live, 2 of
// set/isnull per value column (existence reads them all) and 4 per order
// plane a predicate or aggregate reads (35 B/row for the headline spec on
// a two-column table). A batch of specs is bound by 32-bit integer
// operations: the planes are the same for every spec, and what differs
// per spec is a handful of compares and masked adds or selects per row
// (~32 for the headline spec), against the card's 64 integer lanes per SM
// (132 x 64 x 1.98 GHz = 16.7e12/s on the SXM part), not its fp32 rate.
//
// What the design does about each:
//   - bytes: a block walks tiles of kTileRows rows, kVec consecutive rows
//     a thread, and reads every plane of a tile once for all the specs of
//     its spec chunk: 16-byte vectors for int32 planes, two for an i64
//     column's interleaved [B, R, 2] order planes, 4-byte words for bool
//     planes. The first group of loads (row header, kGroupCols columns'
//     set/isnull, kGroupStaged columns' order planes) is issued with no
//     guard before any of it is used, so a tile costs one load latency;
//     kMinBlocks blocks of kThreads per SM (__launch_bounds__) keep 32
//     warps of loads in flight. Only the tiles that meet the union of the
//     chunk's row ranges are read. Loads go through registers into shared
//     memory rather than through a cp.async/TMA ring: each word is
//     transformed as it lands (biased, an i64 column de-interleaved, bool
//     bytes folded into row masks), which a ring would have to hold twice
//     (raw and decoded), costing the resident blocks that hide latency.
//   - operations: what no spec changes is decoded once per row and staged
//     in shared memory: the order planes, biased (x ^ 2^31) so that every
//     compare, MIN/MAX and limb split is unsigned, and per-lane 32-row
//     masks (candidate rows: valid, not a tombstone, live or some column
//     not NULL; the predicates' columns not NULL; each column not NULL).
//     Visibility (commit time <= read point, expiry > read point) depends
//     only on the read point, and a batch holds few: the chunk's first
//     kReadClasses distinct read points each get a 32-row mask per tile,
//     computed once per row; a spec past them compares the staged
//     hybrid-time and expiry keys row by row. After a barrier each warp
//     takes (spec, run of chunks) items: with 8 or more specs a whole
//     1024-row tile per spec, so a warp reduces once per spec and tile.
//     Per spec and row only the range (at a spec's edges only), one
//     compare per predicate and the aggregates' masked adds and selects
//     are left, without branches: each predicate is one pass specialised
//     (template) on its op and kind, COUNTs come from the masks alone
//     (popc), and the SUM, MIN and MAX of one column share one pass over
//     its words, specialised on which of them it holds. A warp
//     reduces with __reduce_add_sync / __reduce_{min,max}_sync (sm_80+) and
//     lane 0 adds into the spec's int64 accumulators in shared memory;
//     one partial row per block and spec is written at the end. Limb sums
//     are 32-bit per lane and warp: at most 32 rows a lane, 1024 a warp,
//     and 1024 x 0xFFFF < 2^26, exact.
//   - large batches: shared memory holds one chunk of at most
//     kMaxSpecChunk specs (records and accumulators); grid.y runs the
//     chunks, each reading the planes once. The launch geometry (tile
//     rows, grid x, spec chunk, dynamic shared bytes) is computed by
//     ops/flat_agg.py launch_geometry and checked here.
//
// One build serves every signature: a descriptor (kernel parameter, read
// from the constant bank; loops over columns unrolled to the descriptor
// maxima with block-uniform guards, predicates and column groups
// dispatched once per item to their specialised passes) names the shipped
// columns, the predicates (column slot, kind, op, literal offset) and the
// aggregates (fn, column slot, kind); the [N, P] parameter rows carry each
// spec's row range, read point and literals.
//
// Interface: plain C, for ctypes. flat_agg_launch returns 0, a negative
// code for a descriptor or geometry it refuses, or the launch's
// cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxPreds = 8;
constexpr int kMaxAggs = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                      // consecutive rows a thread
constexpr int kTileRows = kThreads * kVec;   // rows a block loads at once
constexpr int kChunkRows = 32 * kVec;        // rows a warp covers at once
constexpr int kChunks = kTileRows / kChunkRows;
constexpr int kMinBlocks = 4;                // resident blocks per SM
constexpr int kMaxSpecChunk = 64;            // specs a block serves
constexpr int kSmemLimit = 232448;           // bytes a block may use
constexpr int kSmemDefault = 48 * 1024;
constexpr int kHead = 5;                     // n_cols, n_preds, n_aggs, n_params, n_out
constexpr int kDescWords = kHead + kMaxCols + 4 * kMaxPreds + 3 * kMaxAggs;
constexpr int kParamHead = 6;                // row_lo, row_hi, read hi/lo, expiry hi/lo
constexpr int kSpecHeadBytes = 32;           // read key, expiry key, lo, hi, class
constexpr int kReadClasses = 4;              // read points a block masks per tile
// Staged words of a row: hybrid time and expiry (hi, lo), then the order
// planes of the columns predicates and aggregates read.
constexpr int kHtHi = 0, kHtLo = 1, kExpHi = 2, kExpLo = 3, kHeadWords = 4;
// Staged row masks, one byte per kVec rows (bits 0..3): kind 0, the row
// is a candidate (valid, not a tombstone, live or some column not NULL);
// kind 1, every column a predicate reads is set and not NULL; kind 2 + k,
// the row is a candidate, visible at read class k and not expired there;
// kind kColMask + c, column slot c is set and not NULL.
constexpr int kMaskBytes = kTileRows / kVec;
constexpr int kCandMask = 0, kPredMask = 1, kVisMask = 2,
              kColMask = kVisMask + kReadClasses;
// Loads issued in one group, before any of them is used: the columns
// whose set/isnull planes, and the staged columns whose order planes, come
// with the row header. The rest (wider tables) follow in later groups.
constexpr int kGroupCols = 4, kGroupStaged = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBias = 0x80000000u;

enum Fn : int32_t { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };
enum Op : int32_t { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
enum Kind : int32_t { kI32 = 0, kI64 = 1 };

enum Err : int {
  kErrDescWords = -1,
  kErrCounts = -2,
  kErrPlanes = -3,
  kErrPred = -4,
  kErrAgg = -5,
  kErrOutWidth = -6,
  kErrGrid = -7,
  kErrAlign = -8,
  kErrShared = -9,
};

struct Desc {
  const int32_t* ht_hi;
  const int32_t* ht_lo;
  const int32_t* exp_hi;
  const int32_t* exp_lo;
  const uint8_t* valid;
  const uint8_t* tomb;
  const uint8_t* live;
  // Slots past n_cols (up to kGroupCols) point at the valid plane, and
  // staged slots past n_vcols (up to kGroupStaged) at ht_hi with stride
  // 1, so that the first group's loads need no guard.
  const uint8_t* set[kMaxCols];
  const uint8_t* isnull[kMaxCols];
  // Staged order planes: the columns predicates and aggregates read.
  const int32_t* vptr[kMaxCols];
  int32_t vstride[kMaxCols];  // order planes per row: 1 or 2
  int32_t vword[kMaxCols];    // first staged word of the column
  int32_t n_cols, n_preds, n_aggs, n_params, n_out, n_vcols;
  uint32_t pred_cols;              // bit c: a predicate reads column slot c
  int32_t pred_kind[kMaxPreds];
  int32_t pred_op[kMaxPreds];
  int32_t pred_lit[kMaxPreds];     // literal offset in the parameter row
  int32_t pred_word[kMaxPreds];
  int32_t agg_fn[kMaxAggs], agg_kind[kMaxAggs], agg_off[kMaxAggs];
  // COUNTs (column slot or -1 for COUNT(*), partial-row offset), and the
  // SUM/MIN/MAX aggregates grouped by column: each group is one pass over
  // the column's staged words, with the partial-row offset of its SUM,
  // MIN and MAX (-1 where absent).
  int32_t n_counts, cnt_col[kMaxAggs], cnt_off[kMaxAggs];
  int32_t n_groups, grp_col[kMaxAggs], grp_kind[kMaxAggs], grp_word[kMaxAggs],
      grp_sum[kMaxAggs], grp_min[kMaxAggs], grp_max[kMaxAggs];
  int32_t n_rows, n_specs, spec_chunk, spec_bytes, cmp_words;
};

__device__ __forceinline__ uint64_t key2(uint32_t hi_b, uint32_t lo_b) {
  return (static_cast<uint64_t>(hi_b) << 32) | lo_b;
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint4 ld128(const int32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A thread's kVec staged words, in shared memory.
__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 biased4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t e) {
  return make_uint4(a ^ kBias, b ^ kBias, c ^ kBias, e ^ kBias);
}

// A bool plane word (kVec rows, one byte each) as 0x01 per true byte.
__device__ __forceinline__ uint32_t bytes01(uint32_t x) {
  return __vcmpne4(x, 0) & 0x01010101u;
}

// 0x01-per-byte flags of kVec rows -> bits 0..3.
__device__ __forceinline__ uint32_t nibble(uint32_t x01) {
  return ((x01 * 0x00204081u) >> 21) & 0xfu;
}

// Bit position of row 0 of chunk j in a lane's 32-row mask.
__device__ __forceinline__ int chunk_shift(int j) { return 4 * j; }

// A lane's eight staged mask bytes (chunk j's rows in bits 0..3 of byte
// j) as one word, chunk j at bit chunk_shift(j).
__device__ __forceinline__ uint32_t pack_nibbles(uint2 m) {
  return __byte_perm(m.x | (m.x >> 4), m.y | (m.y >> 4), 0x6420);
}

// Predicate bits of a lane's rows in an item's chunks [first, first +
// per): bit chunk_shift(j) + r is x op lit. Op and kind are template
// arguments, so that the chunk loop holds no dispatch.
template <int kOp, bool kWide>
__device__ __forceinline__ uint32_t pred_pass(const uint32_t* src, int first,
                                              int per, uint64_t lit64) {
  using T = typename std::conditional<kWide, uint64_t, uint32_t>::type;
  const T lit = static_cast<T>(lit64);
  uint32_t pass = 0;
  for (int j = 0; j < per; ++j) {
    const uint4 vh = ld4(src + j * kChunkRows);
    const uint4 vl = kWide ? ld4(src + j * kChunkRows + kTileRows) : vh;
    uint32_t p = 0;
#pragma unroll
    for (int r = 0; r < kVec; ++r) {
      const T x = kWide ? static_cast<T>(key2(lane_of(vh, r), lane_of(vl, r)))
                        : static_cast<T>(lane_of(vh, r));
      const bool b = kOp == kEq ? x == lit : kOp == kNe ? x != lit
                   : kOp == kLt ? x < lit : kOp == kLe ? x <= lit
                   : kOp == kGt ? x > lit : x >= lit;
      p |= static_cast<uint32_t>(b) << r;
    }
    pass |= p << chunk_shift(first + j);
  }
  return pass;
}

__device__ __forceinline__ uint32_t pred_bits(int32_t op, bool wide,
                                              const uint32_t* src, int first,
                                              int per, uint64_t lit) {
  switch (op * 2 + wide) {
#define FLAT_AGG_PRED(o)                                         \
  case 2 * o: return pred_pass<o, false>(src, first, per, lit); \
  case 2 * o + 1: return pred_pass<o, true>(src, first, per, lit);
    FLAT_AGG_PRED(kEq) FLAT_AGG_PRED(kNe) FLAT_AGG_PRED(kLt)
    FLAT_AGG_PRED(kLe) FLAT_AGG_PRED(kGt) FLAT_AGG_PRED(kGe)
#undef FLAT_AGG_PRED
    default: return 0;
  }
}

// The warp's extreme of the lanes' keys (lanes with no row pass `has`
// false): on the hi word, then on the lo word among the lanes that tie.
__device__ __forceinline__ uint64_t warp_extreme(uint64_t best, bool has,
                                                 bool wide, bool is_max) {
  const uint32_t fill = is_max ? 0u : ~0u;
  const uint32_t b_hi = wide ? static_cast<uint32_t>(best >> 32)
                             : static_cast<uint32_t>(best);
  const uint32_t mine = has ? b_hi : fill;
  const uint32_t w_hi = is_max ? __reduce_max_sync(kFull, mine)
                               : __reduce_min_sync(kFull, mine);
  if (!wide) return w_hi;
  const uint32_t b_lo = has && b_hi == w_hi ? static_cast<uint32_t>(best)
                                            : fill;
  const uint32_t w_lo = is_max ? __reduce_max_sync(kFull, b_lo)
                               : __reduce_min_sync(kFull, b_lo);
  return key2(w_hi, w_lo);
}

// One pass of a column group over an item's chunks: the limb sums and
// the extreme keys of the rows in `rows`, specialised on which of SUM, MIN
// and MAX the group holds and on the column's kind, so that a pass does
// only its own work.
struct Fold {
  const uint32_t* src;  // the column's first staged word, this lane's rows
  uint32_t rows;        // bit chunk_shift(chunk) + r
  int first, per_item;  // the item's chunks
  uint32_t &l0, &l1, &l2, &l3;
  uint64_t &lo_key, &hi_key;

  template <bool kSumOn, bool kMinOn, bool kMaxOn, bool kWide>
  __device__ __forceinline__ void run() {
    for (int j = 0; j < per_item; ++j) {
      const uint32_t bits = (rows >> chunk_shift(first + j)) & 0xfu;
      if (bits == 0) continue;
      const uint4 vh = ld4(src + j * kChunkRows);
      const uint4 vl = kWide ? ld4(src + j * kChunkRows + kTileRows) : vh;
      // Rows off the mask add zero and keep the extremes: selects, not
      // branches.
#pragma unroll
      for (int r = 0; r < kVec; ++r) {
        const bool on = (bits >> r) & 1u;
        const uint32_t x = lane_of(vh, r), y = lane_of(vl, r);
        if (kSumOn) {
          const uint32_t ym = on ? y : 0u;
          l0 += ym & 0xffffu;
          l1 += ym >> 16;
          if (kWide) {
            const uint32_t xm = on ? x : 0u;
            l2 += xm & 0xffffu;
            l3 += xm >> 16;
          }
        }
        if (kWide) {
          const uint64_t k = key2(x, y);
          if (kMinOn) lo_key = on && k < lo_key ? k : lo_key;
          if (kMaxOn) hi_key = on && k > hi_key ? k : hi_key;
        } else {
          if (kMinOn) lo_key = on && x < lo_key ? x : lo_key;
          if (kMaxOn) hi_key = on && x > hi_key ? x : hi_key;
        }
      }
    }
  }
};

struct SpecHead {
  uint64_t read, rexp;  // biased 64-bit keys of the read and expiry points
  int32_t lo, hi;       // row range, clamped to [0, n_rows]
  int32_t cls, pad;     // read class (kVisMask + cls), or -1: per-row compares
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flat_agg_kernel(const __grid_constant__ Desc d,
                    const int32_t* __restrict__ params,
                    long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem);  // [words][kTileRows]
  unsigned char* masks = smem + (kHeadWords + d.cmp_words) * kTileRows * 4;
  unsigned char* recs = masks + (kColMask + d.n_cols) * kMaskBytes;
  __shared__ int union_lo, union_hi, n_cls, unclassed;
  __shared__ uint64_t cls_read[kReadClasses], cls_rexp[kReadClasses];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.y * d.spec_chunk;
  const int ns = min(d.spec_chunk, d.n_specs - s0);
  auto head = [&](int s) {
    return reinterpret_cast<SpecHead*>(recs + s * d.spec_bytes);
  };
  auto lits = [&](int s) {
    return reinterpret_cast<uint64_t*>(recs + s * d.spec_bytes +
                                       kSpecHeadBytes);
  };
  auto accs = [&](int s) {
    return reinterpret_cast<unsigned long long*>(
        recs + s * d.spec_bytes + kSpecHeadBytes + 8 * d.n_preds);
  };
  // A lane's 32-row mask of one kind (bit chunk_shift(j) + r).
  auto lane_mask = [&](int kind) {
    return pack_nibbles(*reinterpret_cast<const uint2*>(
        masks + kind * kMaskBytes + lane * kChunks));
  };

  // The chunk's spec records: biased keys and literals, accumulators.
  if (tid == 0) {
    union_lo = d.n_rows;
    union_hi = 0;
  }
  __syncthreads();
  for (int s = tid; s < ns; s += kThreads) {
    const int32_t* p = params + static_cast<size_t>(s0 + s) * d.n_params;
    SpecHead* h = head(s);
    h->read = key2(p[2] ^ kBias, p[3] ^ kBias);
    h->rexp = key2(p[4] ^ kBias, p[5] ^ kBias);
    h->lo = max(p[0], 0);
    h->hi = min(p[1], d.n_rows);
    if (h->lo < h->hi) {
      atomicMin(&union_lo, h->lo);
      atomicMax(&union_hi, h->hi);
    }
    uint64_t* lit = lits(s);
    for (int q = 0; q < d.n_preds; ++q) {
      const int32_t* l = p + d.pred_lit[q];
      lit[q] = d.pred_kind[q] == kI64 ? key2(l[0] ^ kBias, l[1] ^ kBias)
                                      : static_cast<uint64_t>(l[0] ^ kBias);
    }
    unsigned long long* acc = accs(s);
    for (int k = 0; k < d.n_out; ++k) acc[k] = 0;
    for (int a = 0; a < d.n_aggs; ++a) {
      if (d.agg_fn[a] == kMin) acc[d.agg_off[a]] = ~0ull;
    }
  }
  __syncthreads();
  // Read classes: the chunk's first kReadClasses distinct (read, expiry)
  // points; a tile's visibility is masked once per class, not per spec.
  if (tid == 0) {
    int n = 0, un = 0;
    for (int s = 0; s < ns; ++s) {
      SpecHead* h = head(s);
      int c = 0;
      while (c < n && (cls_read[c] != h->read || cls_rexp[c] != h->rexp)) ++c;
      if (c == n && n < kReadClasses && h->lo < h->hi) {
        cls_read[n] = h->read;
        cls_rexp[n++] = h->rexp;
      }
      h->cls = c < n ? c : -1;
      un |= c == n && h->lo < h->hi;
    }
    n_cls = n;
    unclassed = un;
  }
  __syncthreads();
  const int classes = n_cls;
  const bool stage_keys = unclassed != 0;

  // Work items of a tile: (spec, run of chunks). With few specs a spec's
  // chunks are split over several warps; with 8 or more each warp takes
  // whole-tile items, so that a warp reduces once per spec and tile.
  const int slices = ns == 1 ? kChunks : ns == 2 ? kChunks / 2
                                       : ns <= 4 ? kChunks / 4 : 1;
  const int per_item = kChunks / slices;
  const int n_items = ns * slices;
  const int first_tile = union_lo / kTileRows;
  const int end_tile = (union_hi + kTileRows - 1) / kTileRows;
  for (int tile = first_tile + blockIdx.x; tile < end_tile;
       tile += gridDim.x) {
    const int tile0 = tile * kTileRows;
    const int row0 = tile0 + tid * kVec;
    const bool in = row0 < d.n_rows;  // n_rows is a multiple of kVec
    const int at0 = in ? row0 : 0;    // rows past the end load row 0
    uint32_t* mine = vals + tid * kVec;
    unsigned char* my_mask = masks + lane * kChunks + warp;
    __syncthreads();  // the previous tile's items are done with smem

    // The first group of loads: row header, kGroupCols columns'
    // set/isnull words, kGroupStaged columns' order planes.
    const uint32_t vb = ld32(d.valid + at0);
    const uint32_t tb = ld32(d.tomb + at0);
    const uint32_t lb = ld32(d.live + at0);
    const uint4 hh = ld128(d.ht_hi + at0);
    const uint4 hl = ld128(d.ht_lo + at0);
    const uint4 eh = ld128(d.exp_hi + at0);
    const uint4 el = ld128(d.exp_lo + at0);
    uint32_t sb[kGroupCols], nb[kGroupCols];
#pragma unroll
    for (int c = 0; c < kGroupCols; ++c) {
      sb[c] = ld32(d.set[c] + at0);
      nb[c] = ld32(d.isnull[c] + at0);
    }
    uint4 va[kGroupStaged], vz[kGroupStaged];
#pragma unroll
    for (int v = 0; v < kGroupStaged; ++v) {
      const int32_t* p = d.vptr[v] + d.vstride[v] * at0;
      va[v] = ld128(p);
      vz[v] = ld128(p + 4 * (d.vstride[v] - 1));  // stride 1: p again
    }

    // Decode once per row, staged in shared memory: the order planes
    // biased, the row masks, and the biased keys where a spec of the
    // chunk has no read class.
    const uint4 bhh = biased4(hh.x, hh.y, hh.z, hh.w);
    const uint4 bhl = biased4(hl.x, hl.y, hl.z, hl.w);
    const uint4 beh = biased4(eh.x, eh.y, eh.z, eh.w);
    const uint4 bel = biased4(el.x, el.y, el.z, el.w);
    if (stage_keys) {
      st4(mine + kHtHi * kTileRows, bhh);
      st4(mine + kHtLo * kTileRows, bhl);
      st4(mine + kExpHi * kTileRows, beh);
      st4(mine + kExpLo * kTileRows, bel);
    }
    uint32_t any_nn = 0, pred_nn = 0x01010101u;  // 0x01 per row
    auto column = [&](int c, uint32_t s, uint32_t n) {
      const uint32_t x = bytes01(s) & ~bytes01(n);
      my_mask[(kColMask + c) * kMaskBytes] = nibble(x);
      any_nn |= x;
      if ((d.pred_cols >> c) & 1u) pred_nn &= x;
    };
#pragma unroll
    for (int c = 0; c < kGroupCols; ++c) {
      if (c < d.n_cols) column(c, sb[c], nb[c]);
    }
#pragma unroll
    for (int c = kGroupCols; c < kMaxCols; ++c) {
      if (c < d.n_cols) {
        column(c, ld32(d.set[c] + at0), ld32(d.isnull[c] + at0));
      }
    }
    auto stage = [&](int v, const uint4& a, const uint4& b) {
      uint32_t* dst = mine + d.vword[v] * kTileRows;
      if (d.vstride[v] == 2) {  // [row][hi, lo] -> hi plane, lo plane
        st4(dst, biased4(a.x, a.z, b.x, b.z));
        st4(dst + kTileRows, biased4(a.y, a.w, b.y, b.w));
      } else {
        st4(dst, biased4(a.x, a.y, a.z, a.w));
      }
    };
#pragma unroll
    for (int v = 0; v < kGroupStaged; ++v) {
      if (v < d.n_vcols) stage(v, va[v], vz[v]);
    }
#pragma unroll
    for (int v = kGroupStaged; v < kMaxCols; ++v) {
      if (v < d.n_vcols) {
        const int32_t* p = d.vptr[v] + d.vstride[v] * at0;
        stage(v, ld128(p), ld128(p + 4 * (d.vstride[v] - 1)));
      }
    }
    const uint32_t cand = in ? nibble(bytes01(vb) & ~bytes01(tb) &
                                      (bytes01(lb) | any_nn))
                             : 0u;
    my_mask[kCandMask * kMaskBytes] = cand;
    my_mask[kPredMask * kMaskBytes] = nibble(pred_nn);
#pragma unroll
    for (int k = 0; k < kReadClasses; ++k) {
      if (k >= classes) break;
      uint32_t v = 0;  // visible and not expired at class k
#pragma unroll
      for (int r = 0; r < kVec; ++r) {
        const bool ok =
            key2(lane_of(bhh, r), lane_of(bhl, r)) <= cls_read[k] &&
            key2(lane_of(beh, r), lane_of(bel, r)) > cls_rexp[k];
        v |= static_cast<uint32_t>(ok) << r;
      }
      my_mask[(kVisMask + k) * kMaskBytes] = v & cand;
    }
    if (!__syncthreads_or(cand != 0)) continue;  // no candidate row

    for (int item = warp; item < n_items; item += kWarps) {
      const int s = item / slices;
      const int first = (item - s * slices) * per_item;
      const SpecHead h = *head(s);
      const int lo = tile0 + first * kChunkRows;
      const int hi = lo + per_item * kChunkRows;
      if (lo >= h.hi || hi <= h.lo) continue;
      const bool inside = lo >= h.lo && hi <= h.hi;
      const uint32_t* at = vals + first * kChunkRows + lane * kVec;
      const int at_row = lo + lane * kVec;
      const uint64_t* lit = lits(s);

      // Row masks of the item: bit chunk_shift(chunk) + r. Visible, not
      // expired and in range (rows_e), and passing every predicate too
      // (rows_m).
      uint32_t item_bits = 0;
      for (int j = 0; j < per_item; ++j) {
        item_bits |= 0xfu << chunk_shift(first + j);
      }
      uint32_t rows_e;
      if (h.cls >= 0) {
        rows_e = lane_mask(kVisMask + h.cls) & item_bits;
      } else {
        rows_e = 0;
        for (int j = 0; j < per_item; ++j) {
          const uint32_t* p = at + j * kChunkRows;
          const uint4 th = ld4(p + kHtHi * kTileRows);
          const uint4 tl = ld4(p + kHtLo * kTileRows);
          const uint4 xh = ld4(p + kExpHi * kTileRows);
          const uint4 xl = ld4(p + kExpLo * kTileRows);
          uint32_t e = 0;
#pragma unroll
          for (int r = 0; r < kVec; ++r) {
            const bool ok = key2(lane_of(th, r), lane_of(tl, r)) <= h.read &&
                            key2(lane_of(xh, r), lane_of(xl, r)) > h.rexp;
            e |= static_cast<uint32_t>(ok) << r;
          }
          rows_e |= e << chunk_shift(first + j);
        }
        rows_e &= lane_mask(kCandMask);
      }
      if (!inside) {
        for (int j = 0; j < per_item; ++j) {
          uint32_t in_range = 0;
#pragma unroll
          for (int r = 0; r < kVec; ++r) {
            const int i = at_row + j * kChunkRows + r;
            in_range |= static_cast<uint32_t>(i >= h.lo && i < h.hi) << r;
          }
          rows_e &= ~((~in_range & 0xfu) << chunk_shift(first + j));
        }
      }
      uint32_t rows_m = rows_e & lane_mask(kPredMask);
#pragma unroll 1
      for (int q = 0; q < kMaxPreds; ++q) {
        if (q >= d.n_preds) break;
        rows_m &= pred_bits(d.pred_op[q], d.pred_kind[q] == kI64,
                            at + d.pred_word[q] * kTileRows, first,
                            per_item, lit[q]);
      }

      unsigned long long* acc = accs(s);
      const uint32_t cnt = __reduce_add_sync(kFull, __popc(rows_m));
      const uint32_t scn = __reduce_add_sync(kFull, __popc(rows_e));
      if (lane == 0) {
        if (cnt) atomicAdd(&acc[0], static_cast<unsigned long long>(cnt));
        if (scn) atomicAdd(&acc[1], static_cast<unsigned long long>(scn));
      }
      if (cnt == 0) continue;  // warp-uniform: no row to aggregate

      // COUNTs from the masks alone.
#pragma unroll
      for (int k = 0; k < kMaxAggs; ++k) {
        if (k >= d.n_counts) break;
        const int col = d.cnt_col[k];
        const uint32_t rows = col < 0 ? rows_m
                                      : rows_m & lane_mask(kColMask + col);
        const uint32_t n = __reduce_add_sync(kFull, __popc(rows));
        if (lane == 0 && n) {
          atomicAdd(&acc[d.cnt_off[k]], static_cast<unsigned long long>(n));
        }
      }
      // SUM/MIN/MAX: one pass over the item's chunks per column group.
#pragma unroll 1
      for (int g = 0; g < d.n_groups; ++g) {
        const uint32_t rows = rows_m & lane_mask(kColMask + d.grp_col[g]);
        const uint32_t n = __reduce_add_sync(kFull, __popc(rows));
        if (n == 0) continue;  // warp-uniform
        const bool wide = d.grp_kind[g] == kI64;
        const int sum_off = d.grp_sum[g], min_off = d.grp_min[g],
                  max_off = d.grp_max[g];
        const uint32_t* src = at + d.grp_word[g] * kTileRows;
        // Limbs of the biased value (lo plane for i64, then hi plane) and
        // the extreme keys, lexicographic on (hi, lo) as unsigned words.
        uint32_t l0 = 0, l1 = 0, l2 = 0, l3 = 0;
        uint64_t lo_key = ~0ull, hi_key = 0ull;
        Fold f{src, rows, first, per_item, l0, l1, l2, l3, lo_key, hi_key};
        switch ((sum_off >= 0) | (min_off >= 0) << 1 | (max_off >= 0) << 2 |
                wide << 3) {
#define FLAT_AGG_FOLD(m) \
  case m: f.run<(m & 1) != 0, (m & 2) != 0, (m & 4) != 0, (m & 8) != 0>(); break;
          FLAT_AGG_FOLD(1) FLAT_AGG_FOLD(2) FLAT_AGG_FOLD(3)
          FLAT_AGG_FOLD(4) FLAT_AGG_FOLD(5) FLAT_AGG_FOLD(6)
          FLAT_AGG_FOLD(7) FLAT_AGG_FOLD(9) FLAT_AGG_FOLD(10)
          FLAT_AGG_FOLD(11) FLAT_AGG_FOLD(12) FLAT_AGG_FOLD(13)
          FLAT_AGG_FOLD(14) FLAT_AGG_FOLD(15)
#undef FLAT_AGG_FOLD
          default: break;
        }
        if (sum_off >= 0) {
          l0 = __reduce_add_sync(kFull, l0);
          l1 = __reduce_add_sync(kFull, l1);
          if (wide) {
            l2 = __reduce_add_sync(kFull, l2);
            l3 = __reduce_add_sync(kFull, l3);
          }
          if (lane == 0) {
            atomicAdd(&acc[sum_off], static_cast<unsigned long long>(l0));
            atomicAdd(&acc[sum_off + 1], static_cast<unsigned long long>(l1));
            if (wide) {
              atomicAdd(&acc[sum_off + 2], static_cast<unsigned long long>(l2));
              atomicAdd(&acc[sum_off + 3], static_cast<unsigned long long>(l3));
            }
            atomicAdd(&acc[sum_off + 4], static_cast<unsigned long long>(n));
          }
        }
        const bool has = rows != 0;
        if (min_off >= 0) {
          const uint64_t key = warp_extreme(lo_key, has, wide, false);
          if (lane == 0) {
            atomicMin(&acc[min_off], static_cast<unsigned long long>(key));
            atomicAdd(&acc[min_off + 2], static_cast<unsigned long long>(n));
          }
        }
        if (max_off >= 0) {
          const uint64_t key = warp_extreme(hi_key, has, wide, true);
          if (lane == 0) {
            atomicMax(&acc[max_off], static_cast<unsigned long long>(key));
            atomicAdd(&acc[max_off + 2], static_cast<unsigned long long>(n));
          }
        }
      }
    }
  }
  __syncthreads();

  // The partial rows, in the Pallas kernel's slot order:
  // [count, scanned, per aggregate: count | 4 limbs + n | hi, lo, n].
  for (int k = tid; k < ns * d.n_out; k += kThreads) {
    const int s = k / d.n_out;
    const int slot = k - s * d.n_out;
    const unsigned long long* acc = accs(s);
    long long v = static_cast<long long>(acc[slot]);
    for (int a = 0; a < d.n_aggs; ++a) {
      const int off = d.agg_off[a];
      if (d.agg_fn[a] < kMin || (slot != off && slot != off + 1)) continue;
      const unsigned long long key = acc[off];
      if (d.agg_kind[a] == kI64) {
        const uint32_t w = slot == off ? static_cast<uint32_t>(key >> 32)
                                       : static_cast<uint32_t>(key);
        v = static_cast<int32_t>(w ^ kBias);
      } else {
        v = slot == off ? static_cast<int32_t>(
                              static_cast<uint32_t>(key) ^ kBias)
                        : 0;
      }
    }
    out[(static_cast<size_t>(s0 + s) * gridDim.x + blockIdx.x) * d.n_out +
        slot] = v;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// planes: ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live, then per
// column slot: set, isnull, cmp; each 16-byte aligned. desc: kDescWords
// int32 words (layout in ops/flat_agg.py FlatAggPlan.descriptor). params:
// [n_specs, n_params] int32 on the device. out: [n_specs, grid_x, n_out]
// int64 on the device. spec_chunk and smem_bytes: ops/flat_agg.py
// launch_geometry.
int flat_agg_launch(const void* const* planes, int n_planes,
                    const int32_t* desc, int n_desc, const int32_t* params,
                    int n_specs, long long n_rows, long long* out, int grid_x,
                    int spec_chunk, int smem_bytes, void* stream) {
  if (n_desc != kDescWords) return kErrDescWords;
  Desc d{};
  d.n_cols = desc[0];
  d.n_preds = desc[1];
  d.n_aggs = desc[2];
  d.n_params = desc[3];
  d.n_out = desc[4];
  if (d.n_cols < 0 || d.n_cols > kMaxCols || d.n_preds < 0 ||
      d.n_preds > kMaxPreds || d.n_aggs < 0 || d.n_aggs > kMaxAggs ||
      d.n_params < kParamHead) {
    return kErrCounts;
  }
  if (n_planes != 7 + 3 * d.n_cols) return kErrPlanes;
  for (int k = 0; k < n_planes; ++k) {
    if (!aligned16(planes[k])) return kErrAlign;
  }
  const int32_t* stride = desc + kHead;
  const int32_t* w = stride + kMaxCols;
  // Staged columns, in first-use order; word offsets into shared memory.
  int vslot[kMaxCols];
  auto stage = [&](int c) {
    for (int v = 0; v < d.n_vcols; ++v) {
      if (vslot[v] == c) return d.vword[v];
    }
    const int v = d.n_vcols++;
    vslot[v] = c;
    d.vword[v] = kHeadWords + d.cmp_words;
    d.vstride[v] = stride[c];
    d.vptr[v] = static_cast<const int32_t*>(planes[9 + 3 * c]);
    d.cmp_words += stride[c];
    return d.vword[v];
  };
  for (int q = 0; q < kMaxPreds; ++q, w += 4) {
    if (q >= d.n_preds) continue;
    const int width = w[1] == kI64 ? 2 : 1;
    if (w[0] < 0 || w[0] >= d.n_cols || (w[1] != kI32 && w[1] != kI64) ||
        w[2] < kEq || w[2] > kGe || w[3] < kParamHead ||
        w[3] + width > d.n_params || stride[w[0]] < width ||
        stride[w[0]] > 2) {
      return kErrPred;
    }
    d.pred_cols |= 1u << w[0];
    d.pred_kind[q] = w[1];
    d.pred_op[q] = w[2];
    d.pred_lit[q] = w[3];
    d.pred_word[q] = stage(w[0]);
  }
  int n_out = 2;
  for (int a = 0; a < kMaxAggs; ++a, w += 3) {
    if (a >= d.n_aggs) continue;
    const bool counts = w[0] == kCount;
    if (w[0] < kCount || w[0] > kMax || w[1] < (counts ? -1 : 0) ||
        w[1] >= d.n_cols || (w[2] != kI32 && w[2] != kI64) ||
        (!counts && (stride[w[1]] < (w[2] == kI64 ? 2 : 1) ||
                     stride[w[1]] > 2))) {
      return kErrAgg;
    }
    d.agg_fn[a] = w[0];
    d.agg_kind[a] = w[2];
    d.agg_off[a] = n_out;
    n_out += counts ? 1 : (w[0] == kSum ? 5 : 3);
    if (counts) {
      d.cnt_col[d.n_counts] = w[1];
      d.cnt_off[d.n_counts++] = d.agg_off[a];
      continue;
    }
    // The first group of this column and kind whose slot for fn is free.
    int g = 0;
    for (; g < d.n_groups; ++g) {
      int32_t* slot = w[0] == kSum ? &d.grp_sum[g]
                      : w[0] == kMin ? &d.grp_min[g] : &d.grp_max[g];
      if (d.grp_col[g] == w[1] && d.grp_kind[g] == w[2] && *slot < 0) break;
    }
    if (g == d.n_groups) {
      d.n_groups++;
      d.grp_col[g] = w[1];
      d.grp_kind[g] = w[2];
      d.grp_word[g] = stage(w[1]);
      d.grp_sum[g] = d.grp_min[g] = d.grp_max[g] = -1;
    }
    (w[0] == kSum ? d.grp_sum : w[0] == kMin ? d.grp_min : d.grp_max)[g] =
        d.agg_off[a];
  }
  if (n_out != d.n_out) return kErrOutWidth;
  if (grid_x < 1 || n_specs < 1 || n_specs > 65535 || n_rows < 0 ||
      n_rows > (1ll << 31) - kTileRows || n_rows % kVec != 0 ||
      spec_chunk < 1 || spec_chunk > kMaxSpecChunk) {
    return kErrGrid;
  }
  d.spec_bytes = kSpecHeadBytes + 8 * d.n_preds + 8 * d.n_out;
  const long long need =
      static_cast<long long>(kHeadWords + d.cmp_words) * kTileRows * 4 +
      static_cast<long long>(kColMask + d.n_cols) * kMaskBytes +
      static_cast<long long>(spec_chunk) * d.spec_bytes;
  if (need != smem_bytes || need > kSmemLimit) return kErrShared;
  const int n_chunks = (n_specs + spec_chunk - 1) / spec_chunk;
  if (n_chunks > 65535) return kErrGrid;
  d.ht_hi = static_cast<const int32_t*>(planes[0]);
  d.ht_lo = static_cast<const int32_t*>(planes[1]);
  d.exp_hi = static_cast<const int32_t*>(planes[2]);
  d.exp_lo = static_cast<const int32_t*>(planes[3]);
  d.valid = static_cast<const uint8_t*>(planes[4]);
  d.tomb = static_cast<const uint8_t*>(planes[5]);
  d.live = static_cast<const uint8_t*>(planes[6]);
  for (int c = 0; c < d.n_cols; ++c) {
    d.set[c] = static_cast<const uint8_t*>(planes[7 + 3 * c]);
    d.isnull[c] = static_cast<const uint8_t*>(planes[8 + 3 * c]);
  }
  for (int c = d.n_cols; c < kGroupCols; ++c) d.set[c] = d.isnull[c] = d.valid;
  for (int v = d.n_vcols; v < kGroupStaged; ++v) {
    d.vptr[v] = d.ht_hi;
    d.vstride[v] = 1;
  }
  d.n_rows = static_cast<int32_t>(n_rows);
  d.n_specs = n_specs;
  d.spec_chunk = spec_chunk;
  if (smem_bytes > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flat_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  flat_agg_kernel<<<dim3(grid_x, n_chunks), kThreads, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(d, params, out);
  return static_cast<int>(cudaGetLastError());
}

const char* flat_agg_error_string(int code) {
  switch (code) {
    case kErrDescWords: return "descriptor has the wrong number of words";
    case kErrCounts: return "descriptor counts out of range";
    case kErrPlanes: return "plane table does not match the column count";
    case kErrPred: return "bad predicate descriptor";
    case kErrAgg: return "bad aggregate descriptor";
    case kErrOutWidth: return "output row width disagrees with the aggregates";
    case kErrGrid: return "bad grid, spec count, spec chunk or row count";
    case kErrAlign: return "a plane is not 16-byte aligned";
    case kErrShared: return "shared-memory bytes disagree with the geometry";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
