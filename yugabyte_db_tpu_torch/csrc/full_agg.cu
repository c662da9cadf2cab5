// The windowed full-run aggregate, for Hopper (sm_90a): K5.
//
// Replaces the JAX package's XLA program yugabyte_db_tpu/ops/agg_fold.py
// compiled_full_aggregate (a fori_loop over the run's windows of K blocks;
// per window ops/scan.py scan_window's flat resolve and _eval_agg, folded
// by agg_fold.fold_window / agg_fold). The engine takes it for runs past
// the flat fold's bounds on signatures the flat kernel (flat_agg.cu) does
// not take: float SUM/MIN/MAX, f64 predicates, any number of aggregates,
// predicates and value columns. Its plain version is
// ops/agg_fold.py full_aggregate_plain; ops/full_agg.py is the wrapper and
// computes the launch geometry (launch_geometry) this file checks.
//
// What it computes, per spec (a parameter row) and window w of N = K * R
// rows in [w_first, w_last):
//   - the flat resolve of each row in the spec's row range: valid, visible
//     at the read point (hybrid time <= read), not a tombstone, not
//     expired (expiry > the expiry read point), and existing: the
//     liveness marker or any value column set and not NULL (every value
//     column is read for this);
//   - the predicates (i32, i64, f64 on one or two ordered int32 planes,
//     each of = != < <= > >=) on set, non-NULL values;
//   - per aggregate: COUNT, the exact 16-bit limb sums of the biased
//     order planes (i32 / i64 SUM), the sum of the arith plane (f32 / f64
//     SUM), the extreme of the arith plane (f32 MIN/MAX) or of one or two
//     order planes (lexicographic, i32 / i64 / f64 MIN/MAX), and n;
// then folds the windows in window order as the JAX program does: the
// window's limb sums into 8 base-2^16 digits with ONE carry step a window
// (agg_fold.py carry_step), a Kahan pair for float sums, the extremes
// lexicographically, counts summed. The int32 ivec equals the JAX
// program's digit for digit; the float32 fvec agrees within rounding.
//
// What bounds it. One spec is bound by bytes: each row in range reads its
// hybrid time and expiry (16 B), valid/tomb/live (3 B), set and isnull of
// every value column (2 B a column) and the order and arith planes the
// predicates and aggregates read (ops/full_agg.py bytes_per_row): ~40-70
// B a row of the bench table's shapes. A batch of specs is bound by
// integer operations: the planes are the same for every spec, and what
// differs per spec is its range, read point and literals, a few compares
// and masked adds or selects a row.
//
// The first design (a block a (window, spec); a ballot mask, then one
// walk of the rows per aggregate, re-reading its column's planes; ~10
// block reductions a window) lost to four things; what this one does:
//   - every aggregate walked the rows again: here a spec's rows are
//     resolved once per tile into a 32-bit register mask (bit j = the
//     lane's j-th row of the tile), and the aggregates are computed from
//     the staged tile by one pass per column (the SUM, MIN, MAX and COUNT
//     of one column share it, specialised by template on the column's
//     kind and which of them it holds, as flat_agg.cu does), so the
//     registers hold one column's accumulators at a time and nothing
//     bounds the number of aggregates. Per lane the limb sums stay 32-bit
//     (at most 32 rows a lane and tile: < 2^21), a float sum f32 (then
//     f64 across lanes and tiles); a two-plane value is one 8-byte shared
//     load. A warp reduces each
//     statistic once per (spec, tile) with __reduce_*_sync or shuffles,
//     and lane 0 adds it into the spec's accumulators in shared memory:
//     32-bit limb sums (a window's stays < 2^31 by the limb bound), a
//     double float sum, 64-bit order keys for the extremes.
//   - every spec read the planes again: here a block stages a tile of up
//     to kMaxTileRows rows once for a chunk of up to kMaxSpecChunk specs.
//     What no spec changes is decoded once per row: a candidate bit and a
//     bit per value column (set and not NULL); the order planes are
//     compared biased (x ^ 2^31, so every compare, extreme and limb split
//     is unsigned, a two-plane value one 64-bit key). Visibility depends
//     only on the read point and a batch holds few: the chunk's first
//     kReadClasses distinct read points (ops/full_agg.py read_classes)
//     each get a bit per row at decoding; a spec past them compares the
//     row's hybrid time and expiry itself. A warp that serves several
//     specs a tile makes each lane's row masks (of a read class, of a
//     predicate's or pass's column set and not NULL) once for all of
//     them, so a spec over the whole tile starts from its class's mask
//     with no work a row. A larger batch runs more chunks on grid.y, each
//     reading the planes once.
//   - small windows made tiny blocks: here a block takes a run of
//     windows_per_block consecutive windows (ops/full_agg.py picks it so
//     that the grid still fills the card) and walks each window's rows in
//     tiles, writing one record a (spec, window) at the window's end.
//     Warps take (spec, slice of the tile) items: with 8 or more specs in
//     the chunk a warp takes whole tiles of its specs, with fewer the
//     tile's rows are dealt to warps_per_spec warps a spec, each with
//     accumulators of its own, summed by the record's writer.
//   - the predicates chased pointers: here the descriptor and the plane
//     pointers are copied into shared memory once a block, and each
//     predicate is one pass over the staged tile, specialised on its op
//     and width.
//   Staging, what bounds one spec: the tile's planes (the value planes a
//   predicate or pass reads, hybrid time and expiry, the bool planes) are
//   copied raw into shared memory with cp.async, 16 bytes a copy, one
//   tile ahead: while tile k is decoded and served from one buffer, tile
//   k + 1 lands in the other, so the loads' latency hides behind the
//   work and no register holds a load in flight. The decode then reads 1
//   to 4 consecutive rows a thread with one shared load a plane. Planes
//   off 16 bytes, or windows not a multiple of 16 rows, take plain loads
//   of one row a thread instead (ops/full_agg.py launch_geometry).
//   The fold (fold_kernel) stays a second pass: a block a spec, a warp a
//   statistic. Counts and extremes are associative: lanes take windows in
//   turn and reduce. The exact digits need no walk: one carry step a
//   window has a closed form in the windows' limb totals and the last 7
//   windows' limb sums (fold_digits), equal digit for digit. The Kahan
//   pair follows window order: a warp loads 32 windows' sums, one a lane,
//   and folds them in order by broadcasting each with __shfl_sync while
//   the next 32 load.
//
// One build serves every signature: a descriptor (ops/full_agg.py
// FullAggPlan.descriptor) names the columns, the predicates (slot, kind,
// op, literal word, staged planes), the aggregates (fn, slot, kind,
// output offsets, pass), the passes (slot, kind, which of SUM/MIN/MAX,
// staged planes) and the staged planes (slot, order word or arith).
//
// Interface: plain C, for ctypes. full_agg_launch returns 0, a negative
// code for an argument it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;                // resident blocks per SM
constexpr long long kMaxWindowRows = 32768;  // K * R under the limb bound
constexpr int kMaxTileRows = 1024;           // 32 rows a lane at most
constexpr int kMinTileRows = 32;
constexpr int kMaxSpecChunk = 64;
constexpr int kReadClasses = 8;
constexpr int kClassWords = 1 + 4 * kReadClasses;  // count, then reads
constexpr int kSlots = 5;      // record words an aggregate
constexpr int kParamHead = 8;
constexpr int kSpecHead = 6;   // row_lo, row_hi, w_first, w_last, class, -
constexpr int kSlotHead = 2;   // scanned, -
constexpr int kPassWords = 12; // n, 4 limbs, -, fsum (f64), min, max (u64)
constexpr int kDigits = 8;
constexpr int kFoldWarps = 8;  // warps of a fold block
constexpr int kSmemLimit = 232448;
constexpr int kCandBit = 31;   // a staged row's candidate bit
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBias = 0x80000000u;
constexpr unsigned kInfBits = 0x7f800000u;  // +infinity, float32
constexpr long long kI32Min = -2147483648ll;
constexpr long long kI32Max = 2147483647ll;
constexpr long long kI64Min = static_cast<long long>(0x8000000000000000ull);
constexpr long long kI64Max = 0x7fffffffffffffffll;

enum Err : int {
  kErrShape = -1,
  kErrArgs = -2,
  kErrGeometry = -3,
  kErrShared = -4,
};

enum Fn { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };
enum Kind { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3 };
enum Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
enum PassFlag { fSum = 1, fMin = 2, fMax = 4 };

// Descriptor header (ops/full_agg.py FullAggPlan.descriptor).
enum Head {
  hCols = 0, hPreds, hAggs, hParams, hInts, hFloats, hR, hN, hPasses,
  hStaged, hRaw, hOffPreds, hOffAggs, hOffPasses, hOffStaged, hOffRaw,
  hOffPtrs, kHeadWords
};
constexpr int kPredWords = 6, kAggWords = 6, kPassTab = 6, kStagedWords = 5,
              kRawWords = 4;

// Pointer table order: the run's planes, then 4 a column slot.
enum Plane { pValid = 0, pTomb, pLive, pHtHi, pHtLo, pExpHi, pExpLo, pCols };
enum ColPlane { cSet = 0, cIsNull = 1, cCmp = 2, cArith = 3 };

constexpr int kGeoWords = 18;
int32_t g_last_launch[kGeoWords] = {};

// Shared memory of a window block, in bytes (ops/full_agg.py
// shared_layout computes the same): the descriptor, the accumulators, the
// staged specs, the read classes, each staged plane's (offset, stride) in
// a tile buffer, each lane's row masks of a tile (a class's, the
// candidates', a predicate's or pass's column not NULL), the decoded
// tile (class bits, column bits), and one tile
// buffer (two with the asynchronous copy): the value planes a row, then
// (copied) the hybrid-time and expiry planes and the bool planes.
struct Layout {
  int slots, heads, classes, staged, masks, vis, nn, buf0, buf1, ints,
      bools, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int desc_words, int chunk, int G,
                                         int slot_words, int head_words,
                                         int n_staged, int n_masks, int tile,
                                         int nnw, int val_words, int n_bools,
                                         bool async) {
  Layout l;
  l.slots = align16(desc_words * 8);
  l.heads = l.slots + align16(chunk * G * slot_words * 4);
  l.classes = l.heads + align16(chunk * head_words * 4);
  l.staged = l.classes + align16(kClassWords * 4);
  l.masks = l.staged + align16(n_staged * 8);
  l.vis = l.masks + kWarps * n_masks * 32 * 4;
  l.nn = l.vis + align16(tile * 4);
  l.buf0 = l.nn + align16(nnw * tile * 4);
  l.ints = align16(val_words * tile * 4);  // offsets within a buffer
  l.bools = l.ints + (async ? 16 * tile : 0);
  const int buf = l.bools + (async ? align16(n_bools * tile) : 0);
  l.buf1 = async ? l.buf0 + buf : l.buf0;
  l.total = l.buf1 + buf;
  return l;
}

struct Args {
  const long long* desc;
  const int32_t* params;   // [n_specs, n_params]
  const int32_t* classes;  // [n_specs]: read class in its chunk, or -1
  const int32_t* creads;   // [chunks, kClassWords]
  int32_t* rec;            // [n_specs, n_win, rec_words]
  int32_t* ivec;           // [n_specs, n_ints]
  float* fvec;             // [n_specs, max(n_floats, 1)]
  int desc_words;
  int n_specs;
  int n_params;
  int rec_words;
  int w_base;
  int n_win;
  int f_stride;
  int chunk;
  int tile;
  int wpb;
  int G;
  int slot_words;
  int head_words;
  int nnw;       // 32-bit words of column bits a row
  int n_staged;  // staged planes
  int vec;       // rows a thread decodes at once (1, 2 or 4)
  bool async;    // tiles copied with cp.async, one ahead
  int n_cls;     // read classes a chunk has at most
  Layout lay;
};

__device__ __forceinline__ bool le2(int a_hi, int a_lo, int b_hi, int b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo <= b_lo);
}

template <int kOp, class T>
__device__ __forceinline__ bool compare(T v, T x) {
  if (kOp == kEq) return v == x;
  if (kOp == kNe) return v != x;
  if (kOp == kLt) return v < x;
  if (kOp == kLe) return v <= x;
  if (kOp == kGt) return v > x;
  return v >= x;
}

// float32 bits -> a key whose unsigned order is the float order.
__device__ __forceinline__ uint32_t float_key(uint32_t b) {
  return (b & kBias) ? ~b : (b ^ kBias);
}

__device__ __forceinline__ uint32_t key_float(uint32_t k) {
  return (k & kBias) ? (k ^ kBias) : ~k;
}

__device__ __forceinline__ unsigned long long warp_min64(
    unsigned long long v) {
  const uint32_t hi = __reduce_min_sync(kFull, static_cast<uint32_t>(v >> 32));
  const uint32_t lo = __reduce_min_sync(
      kFull, static_cast<uint32_t>(v >> 32) == hi ? static_cast<uint32_t>(v)
                                                  : 0xffffffffu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned long long warp_max64(
    unsigned long long v) {
  const uint32_t hi = __reduce_max_sync(kFull, static_cast<uint32_t>(v >> 32));
  const uint32_t lo = __reduce_max_sync(
      kFull, static_cast<uint32_t>(v >> 32) == hi ? static_cast<uint32_t>(v)
                                                  : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// What a warp needs to walk its rows of a tile.
struct Walk {
  const uint32_t* vals;  // the tile buffer's value planes
  const int32_t* st;     // per staged plane: offset in vals, row stride
  const uint32_t* nn;    // column bits, [nnw][tile]
  int tile;
  int G;
  int q;     // this warp's slice of the tile
  int lane;
  int J;     // rows a lane: bits of a mask
  __device__ __forceinline__ int row(int j) const {
    return (j * G + q) * 32 + lane;
  }
  __device__ __forceinline__ bool notnull(int slot, int r) const {
    return (nn[(slot >> 5) * tile + r] >> (slot & 31)) & 1u;
  }
  // Staged plane v of row r: an order word biased (unsigned order), or
  // arith bits.
  __device__ __forceinline__ uint32_t cmp(int v, int r) const {
    return vals[st[2 * v] + r * st[2 * v + 1]] ^ kBias;
  }
  __device__ __forceinline__ uint32_t arith(int v, int r) const {
    return vals[st[2 * v] + r * st[2 * v + 1]];
  }
  // A two-plane value of row r as one key: staged plane v is its word 0,
  // word 1 lies beside it (both words of a row, one 8-byte load).
  __device__ __forceinline__ unsigned long long key(int v, int r) const {
    const uint2 x = *reinterpret_cast<const uint2*>(vals + st[2 * v] + 2 * r);
    return (static_cast<unsigned long long>(x.x ^ kBias) << 32) |
           (x.y ^ kBias);
  }
};

// One predicate over the rows of `res` (whose column is set and not
// NULL): the rows whose value compares with the (biased) literal.
template <int kOp, bool kWide>
__device__ __forceinline__ uint32_t pred_pass(const Walk& wk, uint32_t res,
                                              int v0, uint32_t x0,
                                              uint32_t x1) {
  uint32_t out = 0;
  const unsigned long long x =
      kWide ? (static_cast<unsigned long long>(x0) << 32) | x1 : x0;
#pragma unroll 4
  for (int j = 0; j < wk.J; ++j) {
    const int r = wk.row(j);
    if (!((res >> j) & 1u)) continue;
    const unsigned long long v = kWide ? wk.key(v0, r) : wk.cmp(v0, r);
    if (compare<kOp>(v, x)) out |= 1u << j;
  }
  return out;
}

template <int kOp>
__device__ __forceinline__ uint32_t pred_op(const Walk& wk, uint32_t res,
                                            bool wide, int v0, uint32_t x0,
                                            uint32_t x1) {
  return wide ? pred_pass<kOp, true>(wk, res, v0, x0, x1)
              : pred_pass<kOp, false>(wk, res, v0, x0, x1);
}

__device__ __forceinline__ uint32_t run_pred(const Walk& wk, uint32_t res,
                                             int op, bool wide, int v0,
                                             uint32_t x0, uint32_t x1) {
  switch (op) {
    case kEq: return pred_op<kEq>(wk, res, wide, v0, x0, x1);
    case kNe: return pred_op<kNe>(wk, res, wide, v0, x0, x1);
    case kLt: return pred_op<kLt>(wk, res, wide, v0, x0, x1);
    case kLe: return pred_op<kLe>(wk, res, wide, v0, x0, x1);
    case kGt: return pred_op<kGt>(wk, res, wide, v0, x0, x1);
    default: return pred_op<kGe>(wk, res, wide, v0, x0, x1);
  }
}

// One column's aggregates over the rows of `res` (whose column is set
// and not NULL), added into the pass's accumulators `acc` (kPassWords
// words in shared memory, lane 0 writes).
// kKind: the column's kind; kFlags: which of SUM/MIN/MAX the pass holds
// (none: COUNT(col) alone). Float SUMs and f32 extremes read the arith
// plane va; the others the order plane vc0 (a two-plane column's word
// 0, its word 1 beside it).
template <int kKind, int kFlags>
__device__ __forceinline__ void agg_pass(const Walk& wk, uint32_t res,
                                         int vc0, int va, uint32_t* acc) {
  constexpr bool kFloat = kKind == kF32 || kKind == kF64;
  constexpr bool kSumF = (kFlags & fSum) && kFloat;
  constexpr bool kSumI = (kFlags & fSum) && !kFloat;
  constexpr bool kExt = (kFlags & (fMin | fMax)) != 0;
  constexpr bool kExtArith = kExt && kKind == kF32;
  constexpr bool kWide = kKind == kI64 || kKind == kF64;
  uint32_t n = __popc(res), l0 = 0, l1 = 0, l2 = 0, l3 = 0;
  float lane_sum = 0.0f;  // at most 32 rows: f32, then f64 across lanes
  unsigned long long mn = ~0ull, mx = 0ull;
#pragma unroll 4
  for (int j = 0; j < wk.J && kFlags; ++j) {
    const int r = wk.row(j);
    if (!((res >> j) & 1u)) continue;
    if (kSumF) lane_sum += __uint_as_float(wk.arith(va, r));
    if (kSumI || (kExt && !kExtArith)) {
      const unsigned long long both = kWide ? wk.key(vc0, r) : wk.cmp(vc0, r);
      const uint32_t hi = kWide ? static_cast<uint32_t>(both >> 32)
                                : static_cast<uint32_t>(both);
      const uint32_t lo = kWide ? static_cast<uint32_t>(both) : 0u;
      if (kSumI) {
        if (kWide) {  // the lo plane's limbs, then the hi plane's
          l0 += lo & 0xFFFFu;
          l1 += lo >> 16;
          l2 += hi & 0xFFFFu;
          l3 += hi >> 16;
        } else {
          l0 += hi & 0xFFFFu;
          l1 += hi >> 16;
        }
      }
      if (kExt) {
        const unsigned long long key =
            kWide ? (static_cast<unsigned long long>(hi) << 32) | lo : hi;
        mn = key < mn ? key : mn;
        mx = key > mx ? key : mx;
      }
    }
    if (kExtArith) {
      const unsigned long long key = float_key(wk.arith(va, r));
      mn = key < mn ? key : mn;
      mx = key > mx ? key : mx;
    }
  }
  n = __reduce_add_sync(kFull, n);
  if (kSumI) {
    l0 = __reduce_add_sync(kFull, l0);
    l1 = __reduce_add_sync(kFull, l1);
    if (kWide) {
      l2 = __reduce_add_sync(kFull, l2);
      l3 = __reduce_add_sync(kFull, l3);
    }
  }
  double fs = lane_sum;
  if (kSumF) {
    for (int o = 16; o > 0; o >>= 1) fs += __shfl_xor_sync(kFull, fs, o);
  }
  if (kFlags & fMin) {
    mn = kWide ? warp_min64(mn) : __reduce_min_sync(
                                       kFull, static_cast<uint32_t>(mn));
  }
  if (kFlags & fMax) {
    mx = kWide ? warp_max64(mx) : __reduce_max_sync(
                                       kFull, static_cast<uint32_t>(mx));
  }
  if (wk.lane == 0) {
    acc[0] += n;
    if (kSumI) {
      acc[1] += l0;
      acc[2] += l1;
      acc[3] += l2;
      acc[4] += l3;
    }
    if (kSumF) *reinterpret_cast<double*>(acc + 6) += fs;
    if (kFlags & fMin) {
      unsigned long long* p = reinterpret_cast<unsigned long long*>(acc + 8);
      *p = mn < *p ? mn : *p;
    }
    if (kFlags & fMax) {
      unsigned long long* p = reinterpret_cast<unsigned long long*>(acc + 10);
      *p = mx > *p ? mx : *p;
    }
  }
}

template <int kKind>
__device__ __forceinline__ void agg_kind(const Walk& wk, uint32_t res,
                                         int flags, int vc0, int va,
                                         uint32_t* acc) {
  switch (flags) {
    case 0: agg_pass<kKind, 0>(wk, res, vc0, va, acc); break;
    case 1: agg_pass<kKind, 1>(wk, res, vc0, va, acc); break;
    case 2: agg_pass<kKind, 2>(wk, res, vc0, va, acc); break;
    case 3: agg_pass<kKind, 3>(wk, res, vc0, va, acc); break;
    case 4: agg_pass<kKind, 4>(wk, res, vc0, va, acc); break;
    case 5: agg_pass<kKind, 5>(wk, res, vc0, va, acc); break;
    case 6: agg_pass<kKind, 6>(wk, res, vc0, va, acc); break;
    default: agg_pass<kKind, 7>(wk, res, vc0, va, acc); break;
  }
}

__device__ __forceinline__ void run_pass(const Walk& wk, uint32_t res,
                                         int kind, int flags, int vc0,
                                         int va, uint32_t* acc) {
  switch (kind) {
    case kI32: agg_kind<kI32>(wk, res, flags, vc0, va, acc); break;
    case kI64: agg_kind<kI64>(wk, res, flags, vc0, va, acc); break;
    case kF32: agg_kind<kF32>(wk, res, flags, vc0, va, acc); break;
    default: agg_kind<kF64>(wk, res, flags, vc0, va, acc); break;
  }
}

// A pass's accumulators before its first row.
__device__ __forceinline__ void reset_pass(uint32_t* acc) {
  for (int k = 0; k < 6; ++k) acc[k] = 0;
  *reinterpret_cast<double*>(acc + 6) = 0.0;
  *reinterpret_cast<unsigned long long*>(acc + 8) = ~0ull;
  *reinterpret_cast<unsigned long long*>(acc + 10) = 0ull;
}

template <class T>
__device__ __forceinline__ const T* sptr(const long long* d, int k) {
  return reinterpret_cast<const T*>(d[d[hOffPtrs] + k]);
}

// V consecutive bool bytes (V-aligned), byte i of the result row i's.
template <int V>
__device__ __forceinline__ uint32_t ld_bytes(const uint8_t* p, bool global) {
  if (V == 4) {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    return global ? __ldg(q) : *q;
  }
  if (V == 2) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return global ? __ldg(q) : *q;
  }
  return global ? __ldg(p) : *p;
}

// V consecutive int32 words (4V-aligned).
template <int V>
__device__ __forceinline__ void ld_words(const int32_t* p, bool global,
                                         int32_t* out) {
  if (V == 4) {
    const int4* q = reinterpret_cast<const int4*>(p);
    const int4 x = global ? __ldg(q) : *q;
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if (V == 2) {
    const int2* q = reinterpret_cast<const int2*>(p);
    const int2 x = global ? __ldg(q) : *q;
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = global ? __ldg(p) : *p;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying rows [t0, t0 + nt) of the run into tile buffer `buf`
// (t0 a multiple of 16 rows, every plane 16-byte aligned, the window's
// rows a multiple of 16): the value planes, the hybrid-time and expiry
// planes, the bool planes, in 16-byte pieces, as raw as they lie.
__device__ __forceinline__ void issue_tile(const Args& a, const long long* d,
                                           unsigned char* buf, long long t0,
                                           int nt) {
  const int T = a.tile;
  const int rows16 = (nt + 15) & ~15;
  const long long* raw = d + d[hOffRaw];
  const int n_raw = static_cast<int>(d[hRaw]);
  uint32_t* vals = reinterpret_cast<uint32_t*>(buf);
  for (int u = 0; u < n_raw; ++u) {
    const int slot = static_cast<int>(raw[kRawWords * u]);
    const bool arith = raw[kRawWords * u + 1] != 0;
    const int W = static_cast<int>(raw[kRawWords * u + 2]);
    const int off = static_cast<int>(raw[kRawWords * u + 3]);
    const int32_t* src =
        sptr<int32_t>(d, pCols + 4 * slot + (arith ? cArith : cCmp)) +
        t0 * W;
    uint32_t* dst = vals + off * T;
    for (int i = threadIdx.x; i < rows16 * W / 4; i += kThreads) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
  }
  // Hybrid-time / expiry and bool planes: a piece's plane and place by
  // shifts (the tile's pieces a plane are a power of two); pieces past
  // the copied rows skipped.
  const int shift = __ffs(T) - 1;  // T = 2^shift
  int32_t* ints = reinterpret_cast<int32_t*>(buf + a.lay.ints);
  for (int i = threadIdx.x; i < 4 << (shift - 2); i += kThreads) {
    const int p = i >> (shift - 2), k = i & ((T >> 2) - 1);
    if (4 * k < rows16) {
      cp_async16(ints + p * T + 4 * k,
                 sptr<int32_t>(d, pHtHi + p) + t0 + 4 * k);
    }
  }
  uint8_t* bools = buf + a.lay.bools;
  const int n_bools = 3 + 2 * static_cast<int>(d[hCols]);
  for (int i = threadIdx.x; i < n_bools << (shift - 4); i += kThreads) {
    const int p = i >> (shift - 4), k = i & ((T >> 4) - 1);
    if (16 * k < rows16) {
      const int plane = p < 3 ? pValid + p : pCols + 4 * ((p - 3) >> 1) +
                                                 ((p - 3) & 1);
      cp_async16(bools + p * T + 16 * k,
                 sptr<uint8_t>(d, plane) + t0 + 16 * k);
    }
  }
}

// Decode rows [t0, t0 + nt) of a tile into its class bits (bit k:
// candidate and visible at read class k; kCandBit: the candidate bit;
// rows past nt none) and its column bits. kCopied: from the tile buffer
// the asynchronous copy filled; else from the run's planes (one row a
// thread). A thread takes V consecutive rows and loads each plane's V
// values with one load.
template <int V, bool kCopied>
__device__ __forceinline__ void decode_tile(const Args& a, const long long* d,
                                            const int32_t* cls, uint32_t* vis,
                                            uint32_t* nn,
                                            const unsigned char* buf,
                                            long long t0, int nt) {
  const int T = a.tile;
  const int n_cols = static_cast<int>(d[hCols]);
  const int n_classes = cls[0];
  const int32_t* ints = reinterpret_cast<const int32_t*>(buf + a.lay.ints);
  const uint8_t* bools = buf + a.lay.bools;
  // Bool plane p (valid, tomb, live, then set / isnull a column) and int
  // plane p (ht hi, ht lo, exp hi, exp lo) at the tile's row r.
  auto bool_at = [&](int p, int plane, int r) {
    return kCopied ? bools + p * T + r : sptr<uint8_t>(d, plane) + t0 + r;
  };
  auto int_at = [&](int p, int r) {
    return kCopied ? ints + p * T + r : sptr<int32_t>(d, pHtHi + p) + t0 + r;
  };
  for (int r0 = V * threadIdx.x; r0 < T; r0 += V * kThreads) {
    const int nv = min(V, nt - r0);  // rows of the group in the tile
    if (nv <= 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) vis[r0 + i] = 0;
      continue;
    }
    const uint32_t base = ld_bytes<V>(bool_at(0, pValid, r0), !kCopied) &
                          ~ld_bytes<V>(bool_at(1, pTomb, r0), !kCopied);
    uint32_t any = ld_bytes<V>(bool_at(2, pLive, r0), !kCopied);
    int32_t hh[V], hl[V], eh[V], el[V];
    ld_words<V>(int_at(0, r0), !kCopied, hh);
    ld_words<V>(int_at(1, r0), !kCopied, hl);
    ld_words<V>(int_at(2, r0), !kCopied, eh);
    ld_words<V>(int_at(3, r0), !kCopied, el);
    // Column bits, 32 columns a word; per row, byte i of `any` gathers
    // them.
    for (int w0 = 0; w0 < n_cols; w0 += 32) {
      uint32_t bits[V];
#pragma unroll
      for (int i = 0; i < V; ++i) bits[i] = 0;
      const int w1 = min(n_cols, w0 + 32);
#pragma unroll 4
      for (int c = w0; c < w1; ++c) {
        const uint32_t keep =
            ld_bytes<V>(bool_at(3 + 2 * c, pCols + 4 * c + cSet, r0),
                        !kCopied) &
            ~ld_bytes<V>(bool_at(4 + 2 * c, pCols + 4 * c + cIsNull, r0),
                         !kCopied);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          bits[i] |= ((keep >> (8 * i)) & 1u) << (c - w0);
        }
        any |= keep;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i < nv) nn[(w0 >> 5) * T + r0 + i] = bits[i];
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool cand =
          ((base >> (8 * i)) & 0xffu) && ((any >> (8 * i)) & 0xffu);
      uint32_t bits = static_cast<uint32_t>(cand) << kCandBit;
      if (cand) {
        for (int c = 0; c < n_classes; ++c) {
          const int32_t* rd = cls + 1 + 4 * c;
          const bool v = le2(hh[i], hl[i], rd[0], rd[1]) &&
                         !le2(eh[i], el[i], rd[2], rd[3]);
          bits |= static_cast<uint32_t>(v) << c;
        }
      }
      vis[r0 + i] = i < nv ? bits : 0u;
    }
  }
}

// Without the asynchronous copy: the value planes of rows [t0, t0 + nt)
// into the tile buffer, raw, by plain loads.
__device__ __forceinline__ void load_values(const Args& a, const long long* d,
                                            unsigned char* buf, long long t0,
                                            int nt) {
  const int T = a.tile;
  const long long* raw = d + d[hOffRaw];
  const int n_raw = static_cast<int>(d[hRaw]);
  uint32_t* vals = reinterpret_cast<uint32_t*>(buf);
  for (int u = 0; u < n_raw; ++u) {
    const int slot = static_cast<int>(raw[kRawWords * u]);
    const bool arith = raw[kRawWords * u + 1] != 0;
    const int W = static_cast<int>(raw[kRawWords * u + 2]);
    const int off = static_cast<int>(raw[kRawWords * u + 3]);
    const uint32_t* src =
        sptr<uint32_t>(d, pCols + 4 * slot + (arith ? cArith : cCmp)) +
        t0 * W;
    for (int i = threadIdx.x; i < nt * W; i += kThreads) {
      vals[off * T + i] = __ldg(src + i);
    }
  }
}

// Pass 1: a run of windows for a chunk of specs -> one record a (spec,
// window) of the spec's windows.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* d = reinterpret_cast<long long*>(smem);
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem + a.lay.slots);
  int32_t* heads = reinterpret_cast<int32_t*>(smem + a.lay.heads);
  int32_t* cls = reinterpret_cast<int32_t*>(smem + a.lay.classes);
  int32_t* st = reinterpret_cast<int32_t*>(smem + a.lay.staged);
  const int T = a.tile;
  uint32_t* vis = reinterpret_cast<uint32_t*>(smem + a.lay.vis);
  uint32_t* nn = reinterpret_cast<uint32_t*>(smem + a.lay.nn);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * a.chunk;
  const int S = min(a.chunk, a.n_specs - s0);
  const int G = a.G;

  for (int i = threadIdx.x; i < a.desc_words; i += kThreads) d[i] = a.desc[i];
  for (int i = threadIdx.x; i < S * a.head_words; i += kThreads) {
    const int s = i / a.head_words, k = i % a.head_words;
    const int32_t* prm = a.params + static_cast<size_t>(s0 + s) * a.n_params;
    int32_t v = 0;
    if (k < 4) {
      v = prm[k];
    } else if (k == 4) {
      v = a.classes[s0 + s];
    } else if (k >= kSpecHead) {  // the literals, biased
      v = static_cast<int32_t>(
          static_cast<uint32_t>(prm[kParamHead + k - kSpecHead]) ^ kBias);
    }
    heads[i] = v;
  }
  for (int i = threadIdx.x; i < kClassWords; i += kThreads) {
    cls[i] = a.creads[static_cast<size_t>(blockIdx.y) * kClassWords + i];
  }
  for (int v = threadIdx.x; v < a.n_staged; v += kThreads) {
    const long long* e = a.desc + a.desc[hOffStaged] + kStagedWords * v;
    st[2 * v] = static_cast<int>(e[2]) * T + static_cast<int>(e[4]);
    st[2 * v + 1] = static_cast<int>(e[3]);
  }
  for (int i = threadIdx.x; i < S * G; i += kThreads) {
    uint32_t* sl = slots + static_cast<size_t>(i) * a.slot_words;
    sl[0] = sl[1] = 0;
    for (int p = kSlotHead; p < a.slot_words; p += kPassWords) {
      reset_pass(sl + p);
    }
  }
  __syncthreads();

  const long long N = d[hN];
  const int n_preds = static_cast<int>(d[hPreds]);
  const int n_aggs = static_cast<int>(d[hAggs]);
  const int n_passes = static_cast<int>(d[hPasses]);
  const long long* preds = d + d[hOffPreds];
  const long long* aggs = d + d[hOffAggs];
  const long long* passes = d + d[hOffPasses];
  // The chunk's windows and the rows any of its specs reads.
  int uwf = 0x7fffffff, uwl = 0;
  long long ulo = 0x7fffffffffffffffll, uhi = 0;
  for (int s = 0; s < S; ++s) {
    const int32_t* h = heads + s * a.head_words;
    if (h[2] >= h[3]) continue;
    uwf = min(uwf, h[2]);
    uwl = max(uwl, h[3]);
    ulo = min(ulo, static_cast<long long>(h[0]));
    uhi = max(uhi, static_cast<long long>(h[1]));
  }
  const int L = kWarps / G;  // spec lanes
  const int q = warp / L;
  const int J = T / (32 * G);
  Walk wk{nullptr, st, nn, T, G, q, lane, J};
  uint32_t* lm = reinterpret_cast<uint32_t*>(smem + a.lay.masks) +
                warp * 32 * (a.n_cls + 1 + n_preds + n_passes);
  const int32_t* ht_hi = sptr<int32_t>(d, pHtHi);
  const int32_t* ht_lo = sptr<int32_t>(d, pHtLo);
  const int32_t* exp_hi = sptr<int32_t>(d, pExpHi);
  const int32_t* exp_lo = sptr<int32_t>(d, pExpLo);

  // The block's windows, each walked in tiles of T rows from its first
  // staged row (rounded down to a multiple of 16 rows with the copy, as
  // the window's first row is). With the copy, tile k + 1 is copied
  // into the other buffer while tile k is decoded and served.
  const int wb = a.w_base + static_cast<int>(blockIdx.x) * a.wpb;
  const int w_lo = max(wb, uwf);
  const int w_hi = min(min(wb + a.wpb, a.w_base + a.n_win), uwl);
  const long long align = a.async ? 16 : 1;
  auto first_row = [&](int w) {  // the window's first tile start
    const long long lo_s = max(static_cast<long long>(w) * N, ulo);
    return lo_s - lo_s % align;
  };
  auto last_row = [&](int w) {
    return min(static_cast<long long>(w) * N + N, uhi);
  };
  // The first tile of window w or a later one, or w = w_hi for none.
  auto first_tile = [&](int& w, long long& t0) {
    for (; w < w_hi; ++w) {
      t0 = first_row(w);
      if (t0 < last_row(w)) return;
    }
  };
  auto next_tile = [&](int& w, long long& t0) {
    t0 += T;
    if (t0 >= last_row(w)) first_tile(++w, t0);
  };
  int step = 0;
  if (a.async) {
    int w = w_lo;
    long long t0 = 0;
    first_tile(w, t0);
    if (w < w_hi) {
      issue_tile(a, d, smem + a.lay.buf0, t0,
                 static_cast<int>(min(static_cast<long long>(T),
                                      last_row(w) - t0)));
    }
    cp_async_commit();
  }
  for (int w = w_lo; w < w_hi; ++w) {
    const long long hi_s = last_row(w);
    for (long long t0 = first_row(w); t0 < hi_s; t0 += T, ++step) {
      const int nt = static_cast<int>(min(static_cast<long long>(T),
                                          hi_s - t0));
      unsigned char* buf = smem + (step & 1 ? a.lay.buf1 : a.lay.buf0);
      __syncthreads();  // the previous tile's readers are done
      if (a.async) {
        int nw = w;
        long long nt0 = t0;
        next_tile(nw, nt0);
        if (nw < w_hi) {
          unsigned char* next = smem + (step & 1 ? a.lay.buf0 : a.lay.buf1);
          issue_tile(a, d, next, nt0,
                     static_cast<int>(min(static_cast<long long>(T),
                                          last_row(nw) - nt0)));
        }
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies
        __syncthreads();
        if (a.vec == 4) {
          decode_tile<4, true>(a, d, cls, vis, nn, buf, t0, nt);
        } else if (a.vec == 2) {
          decode_tile<2, true>(a, d, cls, vis, nn, buf, t0, nt);
        } else {
          decode_tile<1, true>(a, d, cls, vis, nn, buf, t0, nt);
        }
      } else {
        decode_tile<1, false>(a, d, cls, vis, nn, buf, t0, nt);
        load_values(a, d, buf, t0, nt);
      }
      __syncthreads();
      wk.vals = reinterpret_cast<const uint32_t*>(buf);
      // The lane's row masks (bit j: its j-th row): of a read class, of
      // the candidates, and of each predicate's and pass's column set and
      // not NULL. A warp that serves several specs a tile makes them once
      // (each lane keeps its own in shared memory); else each spec makes
      // the ones it needs.
      const bool shared = S > L;
      auto class_mask = [&](int c) {
        uint32_t m = 0;
#pragma unroll 4
        for (int j = 0; j < J; ++j) {
          m |= ((vis[wk.row(j)] >> (c >= 0 ? c : kCandBit)) & 1u) << j;
        }
        return m;
      };
      auto column_mask = [&](int slot) {
        uint32_t m = 0;
#pragma unroll 4
        for (int j = 0; j < J; ++j) {
          m |= static_cast<uint32_t>(wk.notnull(slot, wk.row(j))) << j;
        }
        return m;
      };
      auto pred_slot = [&](int p) {
        return static_cast<int>(preds[kPredWords * p]);
      };
      auto pass_slot = [&](int p) {
        return static_cast<int>(passes[kPassTab * p]);
      };
      if (shared) {
        uint32_t cm[kReadClasses + 1];
#pragma unroll
        for (int k = 0; k <= kReadClasses; ++k) cm[k] = 0;
#pragma unroll 4
        for (int j = 0; j < J; ++j) {
          const uint32_t v = vis[wk.row(j)];
          cm[kReadClasses] |= ((v >> kCandBit) & 1u) << j;
#pragma unroll
          for (int k = 0; k < kReadClasses; ++k) {
            if (k < a.n_cls) cm[k] |= ((v >> k) & 1u) << j;
          }
        }
#pragma unroll
        for (int k = 0; k < kReadClasses; ++k) {
          if (k < a.n_cls) lm[32 * k + lane] = cm[k];
        }
        lm[32 * a.n_cls + lane] = cm[kReadClasses];
        for (int p = 0; p < n_preds; ++p) {
          lm[32 * (a.n_cls + 1 + p) + lane] = column_mask(pred_slot(p));
        }
        for (int p = 0; p < n_passes; ++p) {
          lm[32 * (a.n_cls + 1 + n_preds + p) + lane] =
              column_mask(pass_slot(p));
        }
      }
      const uint32_t* pm = lm + 32 * (a.n_cls + 1) + lane;  // preds
      const uint32_t* am = pm + 32 * n_preds;                 // passes
      for (int s = warp % L; s < S; s += L) {
        const int32_t* h = heads + s * a.head_words;
        if (w < h[2] || w >= h[3]) continue;
        const int lo = static_cast<int>(
            max(static_cast<long long>(h[0]) - t0, 0ll));
        const int hi = static_cast<int>(
            min(static_cast<long long>(h[1]) - t0, static_cast<long long>(nt)));
        if (lo >= hi) continue;
        const int c = h[4];
        uint32_t res = shared ? lm[32 * (c >= 0 ? c : a.n_cls) + lane]
                              : class_mask(c);
        if (lo > 0 || hi < nt || c < 0) {
          // The row range, or a read point past the chunk's classes.
          const int32_t* rd =
              a.params + static_cast<size_t>(s0 + s) * a.n_params + 4;
          for (int j = 0; j < J; ++j) {
            const int r = wk.row(j);
            bool in = ((res >> j) & 1u) && r >= lo && r < hi;
            if (in && c < 0) {
              const long long g = t0 + r;
              in = le2(__ldg(ht_hi + g), __ldg(ht_lo + g), rd[0], rd[1]) &&
                   !le2(__ldg(exp_hi + g), __ldg(exp_lo + g), rd[2], rd[3]);
            }
            if (!in) res &= ~(1u << j);
          }
        }
        const int32_t* lits = h + kSpecHead;
        for (int p = 0; p < n_preds && __any_sync(kFull, res); ++p) {
          const long long* pr = preds + kPredWords * p;
          const int lit = static_cast<int>(pr[3]);
          const bool wide = pr[5] >= 0;
          const uint32_t nm = shared ? pm[32 * p] : column_mask(pred_slot(p));
          res = run_pred(wk, res & nm, static_cast<int>(pr[2]), wide,
                         static_cast<int>(pr[4]),
                         static_cast<uint32_t>(lits[lit]),
                         wide ? static_cast<uint32_t>(lits[lit + 1]) : 0u);
        }
        uint32_t* sl = slots + static_cast<size_t>(s * G + q) * a.slot_words;
        const uint32_t scanned = __reduce_add_sync(kFull, __popc(res));
        if (lane == 0) sl[0] += scanned;
        if (scanned == 0) continue;
        for (int p = 0; p < n_passes; ++p) {
          const long long* ps = passes + kPassTab * p;
          const uint32_t nm = shared ? am[32 * p] : column_mask(pass_slot(p));
          run_pass(wk, res & nm, static_cast<int>(ps[1]),
                   static_cast<int>(ps[2]), static_cast<int>(ps[3]),
                   static_cast<int>(ps[5]), sl + kSlotHead + kPassWords * p);
        }
      }
    }
    // With one warp a spec, the warp that wrote a spec's accumulators
    // writes its records; else they wait for the spec's other warps.
    if (G > 1) __syncthreads();
    // The window's records: warp w writes those of specs s = w mod 8,
    // lanes over aggregates, then resets the spec's accumulators.
    for (int s = warp; s < S; s += kWarps) {
      const int32_t* h = heads + s * a.head_words;
      if (w < h[2] || w >= h[3]) continue;
      uint32_t* sl0 = slots + static_cast<size_t>(s * G) * a.slot_words;
      int32_t* out = a.rec + (static_cast<size_t>(s0 + s) * a.n_win +
                              (w - a.w_base)) * a.rec_words;
      uint32_t scanned = 0;
      for (int g = 0; g < G; ++g) scanned += sl0[g * a.slot_words];
      if (lane == 0) out[0] = static_cast<int32_t>(scanned);
      for (int ai = lane; ai < n_aggs; ai += 32) {
        const long long* ag = aggs + kAggWords * ai;
        const int fn = static_cast<int>(ag[0]);
        const int kind = static_cast<int>(ag[2]);
        const int p = static_cast<int>(ag[5]);
        uint32_t o[kSlots] = {scanned, 0u, 0u, 0u, 0u};
        if (p >= 0) {
          uint32_t n = 0, l[4] = {0u, 0u, 0u, 0u};
          double fs = 0.0;
          unsigned long long mn = ~0ull, mx = 0ull;
          for (int g = 0; g < G; ++g) {
            const uint32_t* acc =
                sl0 + g * a.slot_words + kSlotHead + kPassWords * p;
            n += acc[0];
            for (int k = 0; k < 4; ++k) l[k] += acc[1 + k];
            fs += *reinterpret_cast<const double*>(acc + 6);
            const unsigned long long m0 =
                *reinterpret_cast<const unsigned long long*>(acc + 8);
            const unsigned long long m1 =
                *reinterpret_cast<const unsigned long long*>(acc + 10);
            mn = m0 < mn ? m0 : mn;
            mx = m1 > mx ? m1 : mx;
          }
          o[0] = n;
          const bool is_max = fn == kMax;
          const unsigned long long e = is_max ? mx : mn;
          if (fn == kSum && (kind == kF32 || kind == kF64)) {
            o[1] = __float_as_uint(static_cast<float>(fs));
          } else if (fn == kSum) {
            for (int k = 0; k < 4; ++k) o[1 + k] = l[k];
          } else if (fn != kCount && kind == kF32) {
            o[1] = n ? key_float(static_cast<uint32_t>(e))
                     : (is_max ? kInfBits | kBias : kInfBits);
          } else if (fn != kCount && kind == kI32) {
            o[1] = static_cast<uint32_t>(e) ^ kBias;
          } else if (fn != kCount) {
            o[1] = static_cast<uint32_t>(e >> 32) ^ kBias;
            o[2] = static_cast<uint32_t>(e) ^ kBias;
          }
        }
        for (int k = 0; k < kSlots; ++k) {
          out[1 + kSlots * ai + k] = static_cast<int32_t>(o[k]);
        }
      }
      __syncwarp();
      for (int i = lane; i < G; i += 32) {
        uint32_t* sl = sl0 + i * a.slot_words;
        sl[0] = 0;
        for (int p = kSlotHead; p < a.slot_words; p += kPassWords) {
          reset_pass(sl + p);
        }
      }
    }
  }
}

// The digits of T = w_last - w_first carry steps (agg_fold.py
// carry_step) over the windows' limb sums x_k(t), t = 1..T, k < 4, in
// closed form. With S_k(t) the sum of x_k over the first t windows and
// C_k(t) the carries digit k has passed on after step t (C_-1 = 0, and
// everything 0 at t <= 0), digit k always keeps what it took less what it
// passed on, so by induction
//   C_k(t) = floor((S_k(t) + C_(k-1)(t-1)) / 2^16),
//   d_k(T) = ((S_k(T) + C_(k-1)(T-1)) mod 2^16) + C_(k-1)(T)
//            - C_(k-1)(T-1),
// the last digit's carries dropped as carry_step drops them. Digit 7
// reaches back to S_0(T-7): the totals and the last 7 windows' limbs give
// the digits of the whole ordered fold, equal to it digit for digit
// (tests/test_torch_full_agg.py holds the Python twin,
// ops/full_agg.py fold_digits, against carry_step).
template <class Limb>
__device__ __forceinline__ void fold_digits(const long long* total, int T,
                                            Limb limb, int32_t* out) {
  long long prev[8];  // C_(k-1)(T - j)
#pragma unroll
  for (int j = 0; j < 8; ++j) prev[j] = 0;
#pragma unroll
  for (int k = 0; k < kDigits; ++k) {
    long long cur[8];
    long long acc = k < 4 ? total[k] : 0;  // S_k(T - j)
    const long long s0 = T > 0 ? acc : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long cin = j + 1 < 8 ? prev[j + 1] : 0;
      cur[j] = T - j > 0 ? (acc + cin) >> 16 : 0;
      if (k < 4 && j < 7 && T - 1 - j >= 0) acc -= limb(T - 1 - j, k);
    }
    out[k] = static_cast<int32_t>(((s0 + prev[1]) & 0xFFFF) + prev[0] -
                                  prev[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) prev[j] = cur[j];
  }
}

// Pass 2: one spec's records, folded in window order. A warp a statistic
// (scanned, then each aggregate), kFoldWarps a block.
__global__ void __launch_bounds__(32 * kFoldWarps)
fold_kernel(Args a) {
  const long long* desc = a.desc;
  const int spec = blockIdx.x;
  const int32_t* prm = a.params + static_cast<size_t>(spec) * a.n_params;
  const int wf = prm[2];
  const int wl = prm[3];
  const int n_aggs = static_cast<int>(desc[hAggs]);
  const int n_ints = static_cast<int>(desc[hInts]);
  const int32_t* recs =
      a.rec + static_cast<size_t>(spec) * a.n_win * a.rec_words;
  int32_t* iv = a.ivec + static_cast<size_t>(spec) * n_ints;
  float* fv = a.fvec + static_cast<size_t>(spec) * a.f_stride;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long* aggs = desc + desc[hOffAggs];
  const float inf = __uint_as_float(kInfBits);
  // Word `col` of window w's record.
  auto word = [&](int w, int col) {
    return recs[static_cast<size_t>(w - a.w_base) * a.rec_words + col];
  };

  for (int item = threadIdx.x >> 5; item <= n_aggs; item += n_warps) {
    // Counts: lanes take windows in turn.
    const int col = item == 0 ? 0 : 1 + kSlots * (item - 1);
    long long n = 0;
#pragma unroll 16
    for (int w = wf + lane; w < wl; w += 32) n += word(w, col);
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (item == 0) {
      if (lane == 0) iv[0] = static_cast<int32_t>(n);
      continue;
    }
    const long long* ag = aggs + kAggWords * (item - 1);
    const int fn = static_cast<int>(ag[0]);
    const int kind = static_cast<int>(ag[2]);
    const int ioff = static_cast<int>(ag[3]);
    const int foff = static_cast<int>(ag[4]);
    const bool is_max = fn == kMax;
    if (fn == kCount) {
      if (lane == 0) iv[ioff] = static_cast<int32_t>(n);
    } else if (fn == kSum && (kind == kF32 || kind == kF64)) {
      // A Kahan add of each window's sum in window order (agg_fold.py
      // agg_fold): a lane holds a window's sum, broadcast in turn; the
      // next 32 windows' sums load while these fold.
      float fsum = 0.0f, fcomp = 0.0f;
      auto sum_at = [&](int w) {
        return w < wl ? __int_as_float(word(w, col + 1)) : 0.0f;
      };
      // Windows w0 + 32 k + lane for k < 4 in flight: the loads' latency
      // is longer than 32 steps of the chain.
      float x = sum_at(wf + lane), x1 = sum_at(wf + 32 + lane),
            x2 = sum_at(wf + 64 + lane), x3 = sum_at(wf + 96 + lane);
      for (int w0 = wf; w0 < wl; w0 += 32) {
        const float next = sum_at(w0 + 128 + lane);
        const int m = min(32, wl - w0);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float xj = __shfl_sync(kFull, x, j);
          if (j < m) {
            const float y = xj - fcomp;
            const float t = fsum + y;
            fcomp = (t - fsum) - y;
            fsum = t;
          }
        }
        x = x1;
        x1 = x2;
        x2 = x3;
        x3 = next;
      }
      if (lane == 0) {
        fv[foff] = fsum;
        fv[foff + 1] = fcomp;
        iv[ioff] = static_cast<int32_t>(n);
      }
    } else if (fn == kSum) {
      long long total[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int w = wf + lane; w < wl; w += 32) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          total[k] += static_cast<uint32_t>(word(w, col + 1 + k));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        for (int o = 16; o > 0; o >>= 1) {
          total[k] += __shfl_xor_sync(kFull, total[k], o);
        }
      }
      if (lane == 0) {
        fold_digits(total, wl - wf,
                    [&](int t, int k) {
                      return static_cast<long long>(static_cast<uint32_t>(
                          word(wf + t, col + 1 + k)));
                    },
                    iv + ioff);
        iv[ioff + kDigits] = static_cast<int32_t>(n);
      }
    } else if (kind == kF32) {
      float e = is_max ? -inf : inf;
#pragma unroll 8
      for (int w = wf + lane; w < wl; w += 32) {
        const float x = __int_as_float(word(w, col + 1));
        e = is_max ? fmaxf(e, x) : fminf(e, x);
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_xor_sync(kFull, e, o);
        e = is_max ? fmaxf(e, y) : fminf(e, y);
      }
      if (lane == 0) {
        fv[foff] = e;
        iv[ioff] = static_cast<int32_t>(n);
      }
    } else {
      // Order-plane extremes as one signed key: (hi, lo) lexicographic;
      // with no window, the fill (agg_fold.py agg_init).
      const bool wide = kind != kI32;
      long long e = wide ? (is_max ? kI64Min : kI64Max)
                         : (is_max ? kI32Min : kI32Max);
#pragma unroll 8
      for (int w = wf + lane; w < wl; w += 32) {
        const long long hi = word(w, col + 1);
        const long long x =
            wide ? hi * 4294967296ll +
                       static_cast<long long>(static_cast<uint32_t>(
                           word(w, col + 2)) ^ kBias)
                 : hi;
        e = is_max ? (x > e ? x : e) : (x < e ? x : e);
      }
      for (int o = 16; o > 0; o >>= 1) {
        const long long y = __shfl_xor_sync(kFull, e, o);
        e = is_max ? (y > e ? y : e) : (y < e ? y : e);
      }
      if (lane == 0) {
        if (wide) {
          iv[ioff] = static_cast<int32_t>(e >> 32);
          iv[ioff + 1] =
              static_cast<int32_t>(static_cast<uint32_t>(e) ^ kBias);
        } else {
          iv[ioff] = static_cast<int32_t>(e);
        }
        iv[ioff + 1 + wide] = static_cast<int32_t>(n);
      }
    }
  }
}

}  // namespace

extern "C" {

// desc: device int64 words (ops/full_agg.py FullAggPlan.descriptor);
// sched: device int32, [n_specs, n_params] parameter rows
// (FullAggPlan.param_row), then [n_specs] read classes and [chunks,
// 1 + 4 * 8] class read points (ops/full_agg.py read_classes); rec:
// device [n_specs, n_win, rec_words] int32 scratch; ivec: device
// [n_specs, n_ints] int32; fvec: device [n_specs, max(n_floats, 1)]
// float32. Pass 1 runs over the windows [w_base, w_base + n_win) in
// blocks of wpb windows, grid.y over the chunks of `chunk` specs; tile,
// warps_per_spec, vec (rows a thread decodes at once) and async_copy
// (tiles copied with cp.async: every plane 16-byte aligned and the
// windows a multiple of 16 rows; else vec 1) as ops/full_agg.py
// launch_geometry gives them; val_words the staged value words a row,
// n_cls the most read classes a chunk has (ops/full_agg.py read_classes).
int full_agg_launch(const void* desc, int desc_words, const void* sched,
                    int n_specs, int n_params, int n_cols, int n_preds,
                    int n_aggs, int n_passes, int n_staged, int val_words,
                    int n_cls,
                    long long window_rows,
                    int rec_words, int w_base, int n_win, int chunk, int tile,
                    int wpb, int warps_per_spec, int vec, int async_copy,
                    void* rec, void* ivec,
                    int n_ints, void* fvec, int n_floats, void* stream) {
  if (n_specs < 1 || n_specs > 65535 || n_aggs < 0 || n_cols < 0 ||
      n_passes < 0 || n_staged < 0 || window_rows < 1 ||
      window_rows > kMaxWindowRows || w_base < 0 || n_win < 0 ||
      rec_words != 1 + kSlots * n_aggs || n_params < kParamHead ||
      n_ints < 1 || n_floats < 0 || desc_words < kHeadWords) {
    return kErrShape;
  }
  if (desc == nullptr || sched == nullptr || ivec == nullptr ||
      fvec == nullptr || (n_win > 0 && rec == nullptr)) {
    return kErrArgs;
  }
  const int chunks = (n_specs + chunk - 1) / (chunk > 0 ? chunk : 1);
  const bool pow2_tile = tile >= kMinTileRows && tile <= kMaxTileRows &&
                         (tile & (tile - 1)) == 0;
  const int G = warps_per_spec;
  if (chunk < 1 || chunk > kMaxSpecChunk || chunks > 65535 || !pow2_tile ||
      wpb < 1 || (G != 1 && G != 2 && G != 4 && G != 8) || 32 * G > tile ||
      (vec != 1 && vec != 2 && vec != 4) || n_preds < 0 || n_cls < 0 ||
      n_cls > kReadClasses || (async_copy != 0 &&
      (window_rows % 16 != 0 || tile % 16 != 0)) || (async_copy == 0 &&
      vec != 1) || val_words < 0 ||
      (G > 1 && chunk * G > kWarps)) {
    return kErrGeometry;
  }
  Args a{};
  a.desc = static_cast<const long long*>(desc);
  a.params = static_cast<const int32_t*>(sched);
  a.classes = a.params + static_cast<size_t>(n_specs) * n_params;
  a.creads = a.classes + n_specs;
  a.rec = static_cast<int32_t*>(rec);
  a.ivec = static_cast<int32_t*>(ivec);
  a.fvec = static_cast<float*>(fvec);
  a.desc_words = desc_words;
  a.n_specs = n_specs;
  a.n_params = n_params;
  a.rec_words = rec_words;
  a.w_base = w_base;
  a.n_win = n_win;
  a.f_stride = n_floats > 0 ? n_floats : 1;
  a.chunk = chunk;
  a.tile = tile;
  a.wpb = wpb;
  a.G = G;
  a.slot_words = kSlotHead + kPassWords * n_passes;
  a.head_words = kSpecHead + (n_params - kParamHead);
  a.nnw = (n_cols + 31) / 32;
  a.n_staged = n_staged;
  a.vec = vec;
  a.async = async_copy != 0;
  a.n_cls = n_cls;
  a.lay = layout(desc_words, chunk, G, a.slot_words, a.head_words, n_staged,
                 n_cls + 1 + n_preds + n_passes, tile, a.nnw, val_words,
                 3 + 2 * n_cols, a.async);
  if (a.lay.total > kSmemLimit) return kErrShared;
  const int blocks = n_win > 0 ? (n_win + wpb - 1) / wpb : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = 1 + n_aggs;
  const int fold_threads = 32 * (items < kFoldWarps ? items : kFoldWarps);
  const int32_t geo[kGeoWords] = {
      w_base, n_win, n_specs, chunk, chunks, tile, wpb, blocks, G, vec,
      async_copy, n_cls, n_passes, n_staged, a.lay.total, kThreads,
      fold_threads, rec_words};
  for (int i = 0; i < kGeoWords; ++i) g_last_launch[i] = geo[i];
  if (blocks > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_kernel<<<dim3(static_cast<unsigned>(blocks),
                         static_cast<unsigned>(chunks)),
                    kThreads, a.lay.total, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fold_kernel<<<static_cast<unsigned>(n_specs), fold_threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[18]: the shape of the last launch (ops/full_agg.py GEOMETRY's keys).
void full_agg_last_launch(int32_t* out) {
  for (int i = 0; i < kGeoWords; ++i) out[i] = g_last_launch[i];
}

const char* full_agg_error_string(int code) {
  switch (code) {
    case kErrShape: return "a shape or count the kernel does not take";
    case kErrArgs: return "a required pointer is missing";
    case kErrGeometry: return "a launch geometry the kernel does not take";
    case kErrShared: return "the launch needs more shared memory than a "
                            "block has";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
