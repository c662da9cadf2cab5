// GROUP BY and expression aggregates for Hopper (sm_90a): the bucket-table
// fold K8.
//
// Replaces the JAX package's ops/group_agg.py grouped_aggregate (an XLA
// program: a fori_loop over block windows that resolves each window, hashes
// every row's group-key planes into NB = 512 buckets and segment-sums
// base-2^16 digit vectors per bucket, carry-normalising after each window).
// Here, over a flat run or a multi-version run's resolved view
// (csrc/mvcc_resolve.cu), for each spec of a launch and each row in its
// range: visibility (valid, commit hybrid time <= read point, no
// tombstone), TTL expiry, existence (liveness or any value column set and
// not NULL), the i32 / two-plane (i64, f64) predicates; then the bucket
// of a matching row, hashed exactly as the JAX program hashes it (uint32
// FNV-style steps over each group column's order planes, zeroed when
// NULL, and its null flag; the murmur3 fmix step; (h & 0x7fffffff) %
// 512), and per bucket: the count, rep (smallest matching row), the min
// and max of every key plane (the host's collision check), per aggregate
// a COUNT, or for a SUM n (inputs all non-NULL) and the exact sum of
// base * f1 [* f2] as a 128-bit integer (the base an i32 or i64 column,
// each factor a small postfix expression over constants and narrow
// columns, |f| < 2^14). Per spec: scanned (rows that exist in range,
// before predicates) and negs (rows where a sum's base or a factor is
// negative: those are left out of the sums and the host re-serves the
// spec, as the JAX engine does). The host side is ops/group_agg.py.
//
// What bounds it. Bytes: each row in range needs its valid flag, hybrid
// time, tombstone, liveness, expiry, every column's set/isnull (existence
// reads them all) and the order planes the predicates, group columns and
// sums read: ~73 B a row for TPC-H Q1 on lineitem, ~0.44 GB at SF1,
// 0.13 ms at 3.35 TB/s. The planes are the same for every spec of a
// launch; what differs per spec is the range, the read point, the
// literals, and the fold of its matching rows, which all lands on the few
// buckets a low-cardinality GROUP BY has (Q1 has 4 live groups), where
// per-row atomics would serialise.
//
// What the design does about it:
//   - bytes, once a batch: a warp walks pieces of kPieceRows consecutive
//     rows, kRows a lane, and reads every plane of a piece once for all
//     the specs of its block's chunk (16-byte vectors for int32 planes, two
//     for a two-plane column's interleaved words, 4-byte words for bool
//     planes), the row header and every column's set/isnull loaded
//     together. What no spec changes is decoded once a row into the warp's
//     own area of shared memory: the hybrid time and expiry; a row word
//     (each column's not-NULL bit, the candidate bit: valid, no tombstone,
//     live or some column not NULL; the bucket; the row's negative sum
//     inputs); the predicate and group columns' order words, zeroed where
//     NULL; and each sum's product as four 24-bit limbs. A warp reads only
//     what it staged (and its piece's first rows of each bucket), so no
//     block barrier separates pieces, and the warps of an SM overlap one
//     another's loads and folds.
//   - the bucket steps, once a piece: the piece's candidate rows grouped
//     by bucket (a ballot loop), each bucket's slot claimed in the block's
//     tag table (atomicCAS, probing linearly; the chunk's specs share the
//     tags), and whether some row's key differs from its bucket's first
//     row's (a collision in the piece), checked a key plane at a time.
//   - per spec, only what the spec changes: the range check, visibility
//     against its read point and expiry, one compare per predicate, and
//     the fold of its matching rows step by step into its slot table: a
//     step's count from popc and __reduce_add_sync, each aggregate's count
//     or n and each limb of each sum from one __reduce_add_sync (128 rows
//     of 24-bit limbs add up in 32 bits), then one word a lane (lane 0 the
//     count, lane 1 + a aggregate a's, lane i the i-th sum's 128 bits, the
//     first lanes rep and the step's first matching row's key planes), so
//     that each kind of addition is one atomic instruction. Only where the
//     piece holds a collision does each differing row add its own key
//     planes. Minima and maxima read the word first and skip the atomic
//     when the value cannot move it. A bucket with no free slot folds into
//     the spec's table in device memory with the same 64- and 128-bit
//     atomics the final merge uses; every fold is an exact addition,
//     minimum or maximum, so the result does not depend on which buckets
//     overflow or on order.
//   - exactness: sums are two 64-bit words with an explicit carry, in
//     shared memory and in the output alike (a carry is detected from the
//     atomic's old value), so they are exact to 2^128: a Q1 sum_charge
//     row is under 2^91, and 2^31 rows of it under 2^122.
//   - batches: grid.y runs chunks of up to kMaxSpecChunk specs (their
//     slot tables and parameter rows beside the warps' areas in shared
//     memory), each chunk reading the planes once; grid.x is one wave of
//     the resident blocks the occupancy calculator allows (a partial
//     second wave doubles its blocks' time). ops/group_agg.py
//     launch_geometry computes the shape and shared bytes, checked here.
//   - registers: nothing a thread holds is indexed at run time (a
//     factor's postfix stack lives in its sum's limb words until the limbs
//     are written), so ptxas reports no stack frame.
//   - encoded planes (the run's resident tree, ops/encodings.py): each
//     plane comes with a leaf descriptor (kind, arrays, rle run slots or
//     dictionary entries, where its piece lies in the warp's copy), and
//     the staging step decodes what it loads, so that no decoded plane is
//     ever written: a bits plane's four rows from one word (shift and
//     mask), const a broadcast, delta16 the block's base plus a u16
//     offset, rle the block's value at the row's run id, and a dictionary
//     column its prefix planes dhi[code], dlo[code] or, for a promoted
//     string predicate (a "code" predicate), the code itself, staged as a
//     word of its own. On a plain tree (a view) a code predicate reads
//     the code plane beside the column's planes. The kernel comes in
//     three builds: a table of plain planes takes the plain one (kEnc
//     false: the vector loads, no leaf dispatch), one with an encoded
//     leaf an encoded one (kEnc true), with or without the copies
//     (kCopy), designed so that decoding costs little beside the plain
//     build's loads:
//       * with the copies, the leaves' per-row arrays (bits words, u16
//         offsets, run ids and codes: 16 bytes of a bits plane a piece,
//         256 of a u16 array a plane word) are copied into the warp's
//         buffer in shared memory with cp.async, 16 bytes a lane at a
//         time, one piece ahead: the next piece's copy is issued before
//         this piece folds (with two buffers, before it stages) and
//         waited for before that piece stages, so it overlaps the fold.
//         Plain planes are loaded as the plain build loads them (copying
//         them too would cost Q1 a block an SM), and so is a leaf whose
//         array is not 16-byte aligned. ops/group_agg.py copies_pay
//         chooses the copies only where they pay: the copy build folds a
//         batch, or groups past a block's slots, more slowly;
//       * without them, each lane loads its rows' offsets, ids or codes
//         from the run, one 8-byte load where the array is aligned;
//       * the leaf kind is dispatched once a (piece, staged entry), and
//         the staged-entry loop is unrolled; each lane reads its four
//         rows' offsets, ids or codes as one 8-byte load (16 for a
//         two-plane delta16), and no index is divided in 64 bits:
//         where R is a multiple of kPieceRows a piece lies in one block
//         of R rows and delta16's base and rle's block offset are read
//         once a piece, elsewhere each row's block comes from one 32-bit
//         division a row a piece, shared by every leaf;
//       * dictionaries the staging reads are copied into shared memory
//         once a block (int2 entries), up to ops/group_agg.py's
//         DICT_SMEM_CAP bytes; a dictionary past the cap is read through
//         the read-only cache: the leaf table says which, and
//         group_agg_last_launch reports it.
//     ops/group_agg.py launch_geometry gives the buffers' and the
//     dictionaries' shared bytes; the launch checks the same sum.

// One build serves every signature: a descriptor (kernel parameter, read
// from the constant bank; loops unrolled to its maxima with block-uniform
// guards) names the columns, predicates (slot, planes, op, literal
// offset), group columns (slot, planes) and aggregates (kind, slot, base
// planes, need mask, factors, output slot, and each factor's postfix
// program); the host resolves each role to its plane and staged words.
// The [N, P] parameter rows carry each spec's row range, read point and
// literals.
//
// Interface: plain C, for ctypes. group_agg_launch returns 0, a negative
// code for a descriptor or geometry it refuses, or the launches'
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNumBuckets = 512;
constexpr int kMaxCols = 16;
constexpr int kMaxPreds = 8;
constexpr int kMaxGroup = 4;
constexpr int kMaxAggs = 8;
constexpr int kMaxFactors = 2;
constexpr int kMaxNodes = 8;
constexpr int kMaxKeyPlanes = 3 * kMaxGroup;  // per group: 2 planes + null
constexpr int kMaxStaged = kMaxCols + kMaxPreds;  // order and code entries
constexpr int kCodePlanes = 3;   // a code predicate's planes in the descriptor
// A leaf's words: kind, rle run slots or dictionary entries, second and
// third array, its offset in a piece's copy (-1: not copied), its
// dictionary's offset in shared memory in entries (-1: read-only cache).
constexpr int kLeafWords = 6;
constexpr int kMaxPlanes = 7 + 3 * kMaxCols;
constexpr int kGeoWords = 13;    // group_agg_last_launch's words
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;      // blocks an SM's registers hold (__launch_bounds__)
constexpr int kRows = 4;           // rows a lane stages and folds at once
constexpr int kPieceRows = 32 * kRows;  // rows a warp stages and folds
constexpr int kSlots = 16;         // a spec's slots in a block (a power of 2)
constexpr int kMaxSpecChunk = 16;  // specs a block serves
constexpr int kSmemLimit = 232448;
constexpr int kSmemDefault = 48 * 1024;
// Static shared memory: the union range, the slots' tags, each warp's
// bucket steps and its scanned and negs a spec, the key planes' map.
constexpr int kStaticBytes = 8 + 4 * kSlots + 8 * kWarps * kPieceRows +
                             16 * kWarps * kMaxSpecChunk + 8 * kMaxKeyPlanes;
constexpr int kHead = 7;
constexpr int kDescWords = kHead + kMaxCols + 4 * kMaxPreds + 2 * kMaxGroup +
                           6 * kMaxAggs + 2 * kMaxNodes * kMaxFactors * kMaxAggs;
constexpr int kParamHead = 6;  // row_lo, row_hi, read hi/lo, expiry hi/lo
// Staged words of a row, each [kPieceRows] in a warp's area: hybrid time
// and expiry, the row word, then the predicate and group columns' order
// words and each sum's four limbs.
constexpr int kHtHi = 0, kHtLo = 1, kExpHi = 2, kExpLo = 3, kRowWord = 4,
              kHeadWords = 5;
// The row word: bits 0..15 column slot c set and not NULL, then the
// candidate bit, the bucket and the count of negative sum inputs.
constexpr int kCandBit = 16, kBucketShift = 17, kNegShift = 26;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHashSeed = 0x01000193u;
constexpr uint32_t kHashMul = 0x811C9DC5u;  // -2128831035 as uint32
constexpr uint32_t kMixMul = 0x85EBCA6Bu;   // -2048144789 as uint32
constexpr uint32_t kLimbMask = (1u << 24) - 1;

enum Op : int32_t { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
enum AggKind : int32_t { kCount = 0, kSum = 1 };
enum Node : int32_t { kEnd = 0, kConst = 1, kColumn = 2, kAdd = 3, kSub = 4,
                      kMul = 5 };
enum LeafKind : int32_t { kPlain = 0, kBits = 1, kConstLeaf = 2, kDelta16 = 3,
                          kRle = 4, kDict = 5 };

enum Err : int {
  kErrDescWords = -1,
  kErrCounts = -2,
  kErrPlanes = -3,
  kErrPred = -4,
  kErrGroup = -5,
  kErrAgg = -6,
  kErrOutWidth = -7,
  kErrGrid = -8,
  kErrShared = -9,
  kErrAlign = -10,
  kErrCopy = -11,
};

// The last launch's shape (group_agg_last_launch; ops/group_agg.py
// GEOMETRY): the build (1 encoded), threads, grid.x, grid.y (chunks),
// specs a chunk, dynamic shared bytes, a piece's copy in bytes, buffers a
// warp, the dictionaries' shared bytes, the copied planes (bit k of the
// two words: plane k), the dictionary columns in shared memory and those
// read through the read-only cache (bit c: slot c).
int32_t g_last_launch[kGeoWords] = {};

// An int plane: plain (a), const (a: the value's words), delta16 (a: the
// blocks' bases [B, P], b: u16 offsets [B, R, P]), rle (a: int16 run ids
// [B, R], b: values [B, Rc, P], rc: Rc) or a dictionary (a: u16 codes
// [B, R], b: dhi, c: dlo, rc: its entries); a plain cmp's c is its code
// plane, if any. raw: where a piece of its per-row array lies in the
// warp's copy (-1: loaded from the run); dsh: a dictionary's first entry
// in shared memory (-1: read through the read-only cache).
struct Leaf {
  const void* a;
  const void* b;
  const void* c;
  int32_t kind, rc, raw, dsh;
};

struct Desc {
  Leaf ht_hi, ht_lo, exp_hi, exp_lo;
  const uint8_t* valid;  // bool planes: one byte a row, or bits words
  const uint8_t* tomb;
  const uint8_t* live;
  const uint8_t* set[kMaxCols];  // slots past n_cols: the valid plane
  const uint8_t* isnull[kMaxCols];
  uint32_t bits_top;   // bit 0 valid, 1 tomb, 2 live: a bits leaf
  uint32_t bits_set, bits_null;  // bit c: slot c's set / isnull is bits
  Leaf col[kMaxCols];   // each slot's order planes
  int32_t width[kMaxCols];  // order planes a row: 1 or 2
  int32_t rows_per_block;
  uint32_t col_mask;        // bits of the slots 0..n_cols-1
  int32_t n_cols, n_preds, n_group, n_aggs, n_params, kp, n_out;
  // Staged entries (the order words of the columns predicates and group
  // columns read, in slot order, then the code word of each column a code
  // predicate reads): slot, words a row (1 for a code), whether it is a
  // code, first staged word.
  int32_t n_staged;
  int32_t stg_col[kMaxStaged], stg_width[kMaxStaged], stg_code[kMaxStaged],
      stg_word[kMaxStaged];
  int32_t pred_col[kMaxPreds], pred_planes[kMaxPreds], pred_op[kMaxPreds],
      pred_lit[kMaxPreds], pred_word[kMaxPreds];
  int32_t grp_col[kMaxGroup], grp_planes[kMaxGroup], grp_word[kMaxGroup];
  int32_t agg_kind[kMaxAggs], agg_col[kMaxAggs], agg_planes[kMaxAggs],
      agg_nf[kMaxAggs], agg_off[kMaxAggs];
  uint32_t agg_need[kMaxAggs];
  int32_t agg_w32[kMaxAggs];   // the aggregate's count or n in a slot's words
  int32_t agg_w64[kMaxAggs];   // its sum's low word in a slot's 64-bit words
  int32_t agg_sum[kMaxAggs];   // a sum's index among the sums
  int32_t limb_word[kMaxAggs];  // a sum's first staged limb
  int32_t agg_width[kMaxAggs];  // a sum's base column's width
  int8_t node_op[kMaxAggs][kMaxFactors][kMaxNodes];
  int32_t node_arg[kMaxAggs][kMaxFactors][kMaxNodes];
  // A factor affine in one column (k, c, k + c, k - c, c - k, k * c...):
  // k0 + k1 * column, evaluated without the postfix program.
  int8_t fac_affine[kMaxAggs][kMaxFactors];
  int32_t fac_k0[kMaxAggs][kMaxFactors], fac_k1[kMaxAggs][kMaxFactors],
      fac_col[kMaxAggs][kMaxFactors];
  int32_t fac_width[kMaxAggs][kMaxFactors];
  // Key plane k: its staged word, or -1 for a null flag of column
  // key_col[k]; n_kpl planes (0 without group columns).
  int32_t key_word[kMaxKeyPlanes], key_col[kMaxKeyPlanes], n_kpl;
  int32_t n32, n64;  // a slot's 32-bit and 64-bit words
  int32_t words;     // staged words a row
  int32_t spec_bytes, chunk, n_specs, n_rows;
  // The encoded build's copies: each bits flag plane's offset in a
  // piece's copy (valid, tomb, live, then set and isnull a slot; -1: not
  // copied), whether a piece lies in one block of R rows, a piece's copy
  // (bytes, 16-byte chunks), the buffers a warp holds (0: no copy), the
  // dictionaries' shared bytes, and the copied planes (plane index and
  // first chunk each, in chunk order; cp_first[n_copies] = raw_chunks).
  int16_t flag_raw[3 + 2 * kMaxCols];
  int32_t one_block;
  int32_t raw_bytes, raw_chunks, buffers, dict_bytes, n_copies;
  int8_t cp_plane[kMaxPlanes];
  int16_t cp_first[kMaxPlanes + 1];
};

// (a_hi, a_lo) <= (b_hi, b_lo) and <, lexicographic on signed planes.
__device__ __forceinline__ bool le2(int32_t a_hi, int32_t a_lo, int32_t b_hi,
                                    int32_t b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo <= b_lo);
}

__device__ __forceinline__ bool lt2(int32_t a_hi, int32_t a_lo, int32_t b_hi,
                                    int32_t b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo < b_lo);
}

__device__ __forceinline__ bool pred_ok(int op, int planes, const int32_t* v,
                                        const int32_t* lit) {
  const int32_t hi = v[0];
  if (planes == 1) {
    const int32_t x = lit[0];
    switch (op) {
      case kEq: return hi == x;
      case kNe: return hi != x;
      case kLt: return hi < x;
      case kLe: return hi <= x;
      case kGt: return hi > x;
      default: return hi >= x;
    }
  }
  const int32_t lo = v[1];
  const bool eq = hi == lit[0] && lo == lit[1];
  const bool lt = lt2(hi, lo, lit[0], lit[1]);
  switch (op) {
    case kEq: return eq;
    case kNe: return !eq;
    case kLt: return lt;
    case kLe: return lt || eq;
    case kGt: return !(lt || eq);
    default: return !lt;
  }
}

// Word p (of P) of row r, in block blk of R rows, of an encoded int leaf
// (not plain): 32-bit block arithmetic, no division.
__device__ __forceinline__ int32_t leaf_word(const Leaf& L, int r, int blk,
                                             int p, int P) {
  if (L.kind == kConstLeaf) return __ldg(static_cast<const int32_t*>(L.a) + p);
  if (L.kind == kDelta16) {
    return static_cast<int32_t>(
        static_cast<uint32_t>(
            __ldg(static_cast<const int32_t*>(L.a) + blk * P + p)) +
        static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(L.b) +
                                    static_cast<size_t>(r) * P + p)));
  }
  if (L.kind == kRle) {
    const int id = __ldg(static_cast<const int16_t*>(L.a) + r);
    return __ldg(static_cast<const int32_t*>(L.b) +
                 (static_cast<size_t>(blk) * L.rc + id) * P + p);
  }
  const int code = __ldg(static_cast<const uint16_t*>(L.a) + r);  // kDict
  return __ldg(static_cast<const int32_t*>(p == 0 ? L.b : L.c) + code);
}

// Word 0 of row r (in block blk) of a slot's order planes (a factor's
// column); the plain build reads plain planes only.
template <bool kEnc>
__device__ __forceinline__ int32_t col_word(const Desc& d, int c, int r,
                                            int blk) {
  const Leaf& L = d.col[c];
  if (!kEnc || L.kind == kPlain) {
    return __ldg(static_cast<const int32_t*>(L.a) +
                 static_cast<size_t>(r) * d.width[c]);
  }
  return leaf_word(L, r, blk, 0, d.width[c]);
}

// A factor's postfix program at row r (in block blk), in wrapping int32
// arithmetic (as the JAX program's int32 ops). Its columns' words are
// loaded as the program reaches them; its stack is kept in shared memory,
// entry k at stk(k).
template <bool kEnc, class Slot>
__device__ int32_t eval_factor(const Desc& d, int a, int f, int r, int blk,
                               Slot stk) {
  int sp = 0;
#pragma unroll 1
  for (int k = 0; k < kMaxNodes; ++k) {
    const int op = d.node_op[a][f][k];
    if (op == kEnd) break;
    const int32_t arg = d.node_arg[a][f][k];
    if (op == kConst) {
      *stk(sp++) = static_cast<uint32_t>(arg);
    } else if (op == kColumn) {
      *stk(sp++) = static_cast<uint32_t>(col_word<kEnc>(d, arg, r, blk));
    } else {
      const uint32_t rt = *stk(--sp);
      const uint32_t l = *stk(--sp);
      *stk(sp++) = op == kAdd ? l + rt : op == kSub ? l - rt : l * rt;
    }
  }
  return static_cast<int32_t>(*stk(0));
}

// A sum's base value from its order words: an i32 plane, or an i64
// column's ordered planes (each the 32-bit word of v ^ 2^63 with its top
// bit flipped).
__device__ __forceinline__ int64_t base_value(const int32_t* w, int planes) {
  if (planes == 1) return w[0];
  const uint64_t hi = static_cast<uint32_t>(w[0]) ^ 0x80000000u;
  const uint64_t lo = static_cast<uint32_t>(w[1]) ^ 0x80000000u;
  return static_cast<int64_t>(((hi << 32) | lo) ^ 0x8000000000000000ull);
}

// (lo, hi) += (a_lo, a_hi), 128-bit, in registers.
__device__ __forceinline__ void add128(uint64_t& lo, uint64_t& hi,
                                       uint64_t a_lo, uint64_t a_hi) {
  const uint64_t s = lo + a_lo;
  hi += a_hi + (s < lo ? 1 : 0);
  lo = s;
}

// *(lo, hi) += (a_lo, a_hi), 128-bit, with atomics (shared or global):
// each add's carry comes from its own atomic's old value, so concurrent
// adds sum exactly mod 2^128.
__device__ __forceinline__ void atomic_add128(unsigned long long* lo,
                                              unsigned long long* hi,
                                              uint64_t a_lo, uint64_t a_hi) {
  const uint64_t old = atomicAdd(lo, static_cast<unsigned long long>(a_lo));
  const uint64_t carry = old + a_lo < old ? 1 : 0;
  if (a_hi + carry) {
    atomicAdd(hi, static_cast<unsigned long long>(a_hi + carry));
  }
}

// The slot of bucket b in a block's slot table (tags[s] < 0: free): the
// slot that holds it, or a free one claimed for it, probing linearly from
// b mod kSlots; -1 when every slot holds another bucket. A tag once set
// never changes, so every warp of the block finds a bucket in one slot.
__device__ __forceinline__ int claim_slot(int* tags, int b) {
  for (int k = 0; k < kSlots; ++k) {
    const int s = (b + k) & (kSlots - 1);
    int t = *reinterpret_cast<volatile int*>(&tags[s]);
    if (t < 0) t = atomicCAS(&tags[s], -1, b);
    if (t < 0 || t == b) return s;
  }
  return -1;
}

// Where a warp folds one bucket's rows: its slot's words in shared memory,
// or, when no slot is free, the bucket's row of the spec's table in device
// memory. Words 0 .. 2 + 2 * kp (count, rep, key minima and maxima) sit at
// the same index in both; an aggregate's count or n at agg_w32 / agg_off,
// its sum at agg_w64 / agg_off + 1. All of it is order-free (additions,
// minima, maxima), so the table is the same whichever rows overflow.
struct Dest {
  uint32_t* w32;  // null: fold into o
  unsigned long long* w64;
  long long* o;

  __device__ __forceinline__ void add(int k32, int ko, uint32_t v) const {
    if (w32) {
      atomicAdd(&w32[k32], v);
    } else {
      atomicAdd(reinterpret_cast<unsigned long long*>(&o[ko]),
                static_cast<unsigned long long>(v));
    }
  }
  // A plain read first: a value that cannot move the word costs no atomic
  // (minima only fall and maxima only rise, so a stale read costs one).
  __device__ __forceinline__ void min(int k, int32_t v) const {
    if (w32) {
      int* p = reinterpret_cast<int*>(&w32[k]);
      if (v < *reinterpret_cast<volatile int*>(p)) atomicMin(p, v);
    } else if (v < *reinterpret_cast<volatile long long*>(&o[k])) {
      atomicMin(&o[k], static_cast<long long>(v));
    }
  }
  __device__ __forceinline__ void max(int k, int32_t v) const {
    if (w32) {
      int* p = reinterpret_cast<int*>(&w32[k]);
      if (v > *reinterpret_cast<volatile int*>(p)) atomicMax(p, v);
    } else if (v > *reinterpret_cast<volatile long long*>(&o[k])) {
      atomicMax(&o[k], static_cast<long long>(v));
    }
  }
  __device__ __forceinline__ void sum(int k64, int ko, uint64_t lo,
                                      uint64_t hi) const {
    if (w32) {
      atomic_add128(&w64[k64], &w64[k64 + 1], lo, hi);
    } else {
      atomic_add128(reinterpret_cast<unsigned long long*>(&o[ko]),
                    reinterpret_cast<unsigned long long*>(&o[ko + 1]), lo, hi);
    }
  }
};

__global__ void group_agg_init(long long* out, long long total, int n_out,
                               int kp) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int w = static_cast<int>(i % n_out);
    const long long b = (i / n_out) % (kNumBuckets + 1);
    long long v = 0;
    if (b < kNumBuckets) {
      if (w == 1 || (w >= 2 && w < 2 + kp)) v = INT32_MAX;
      else if (w >= 2 + kp && w < 2 + 2 * kp) v = INT32_MIN;
    }
    out[i] = v;
  }
}

// A spec's records in shared memory: its slot table (each slot's 64-bit
// words, then its 32-bit words; the slots' tags are the block's, shared by
// the chunk's specs) and its parameter row.
struct Spec {
  unsigned long long* t64;
  uint32_t* t32;
  int32_t* p;
};

__device__ __forceinline__ Spec spec_at(const Desc& d, unsigned char* base,
                                        int s) {
  unsigned char* at = base + static_cast<size_t>(s) * d.spec_bytes;
  Spec r;
  r.t64 = reinterpret_cast<unsigned long long*>(at);
  r.t32 = reinterpret_cast<uint32_t*>(r.t64 + kSlots * d.n64);
  r.p = reinterpret_cast<int32_t*>(r.t32 + kSlots * d.n32);
  return r;
}

// The sum of a 128-bit value given as four 24-bit limb sums (each under
// 2^32), as (lo, hi).
__device__ __forceinline__ void limbs_to_128(const uint32_t (&sum)[4],
                                             uint64_t& lo, uint64_t& hi) {
  lo = sum[0];
  hi = 0;
  add128(lo, hi, static_cast<uint64_t>(sum[1]) << 24, 0);
  add128(lo, hi, static_cast<uint64_t>(sum[2]) << 48,
         static_cast<uint64_t>(sum[2]) >> 16);
  add128(lo, hi, 0, static_cast<uint64_t>(sum[3]) << 8);
}

// A lane's kRows staged words (its rows kRows * lane ...), in shared memory.
__device__ __forceinline__ uint4 sld(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void sst(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t at4(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A bool plane's kRows bytes (one a row) as 0/1 in byte j.
__device__ __forceinline__ uint32_t ldb(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ bool byte_of(uint32_t x, int j) {
  return (x >> (8 * j)) & 0xffu;
}

// A two-plane column's kRows rows: the hi plane and the lo plane.
__device__ __forceinline__ void ld_wide(const int32_t* p, uint4& hi,
                                        uint4& lo) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p + 4));
  hi = make_uint4(a.x, a.z, b.x, b.z);
  lo = make_uint4(a.y, a.w, b.y, b.w);
}

__device__ __forceinline__ uint4 ld_narrow(const int32_t* p) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  return make_uint4(a.x, a.y, a.z, a.w);
}

// Byte k of the result is bit k of the nibble (4 bool bytes).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
         ((nib & 8u) << 21);
}

// The encoded build's view of a warp's piece for one lane: the warp's
// copy of the piece's copied leaves, the lane, its first row (row 0 past
// the run's end) and each of its rows' block of R rows (all equal where
// the piece lies in one block: `one`), the block's shared dictionaries.
struct Piece {
  const unsigned char* raw;
  const int2* dicts;
  int lane, at;
  int blk[kRows];
  bool one;
};

// A bool plane's kRows rows as 0/1 bytes: bytes from the run, or the
// four bits of a bits leaf's word, from the warp's copy (raw >= 0) or the
// run.
__device__ __forceinline__ uint32_t enc_flags(const uint8_t* p, bool bits,
                                              int raw, const Piece& pc) {
  if (!bits) return ldb(p + pc.at);
  const uint32_t w =
      raw >= 0 ? *reinterpret_cast<const uint32_t*>(pc.raw + raw +
                                                    4 * (pc.lane >> 3))
               : __ldg(reinterpret_cast<const uint32_t*>(p) + (pc.at >> 5));
  return spread4((w >> (pc.at & 31)) & 15u);
}

// The kRows u16 words (offsets, run ids or codes) of a one-plane per-row
// array: one 8-byte load from the copy, else from the run (one 8-byte
// load where the array is 8-byte aligned, else four).
__device__ __forceinline__ uint2 u16x4(const void* arr, int raw,
                                       const Piece& pc) {
  if (raw >= 0) {
    return *reinterpret_cast<const uint2*>(pc.raw + raw + 8 * pc.lane);
  }
  const unsigned short* p = static_cast<const unsigned short*>(arr) + pc.at;
  if ((reinterpret_cast<uintptr_t>(p) & 7u) == 0) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  return make_uint2(__ldg(p) | static_cast<uint32_t>(__ldg(p + 1)) << 16,
                    __ldg(p + 2) | static_cast<uint32_t>(__ldg(p + 3)) << 16);
}

__device__ __forceinline__ uint32_t lo16(uint32_t x) { return x & 0xffffu; }
__device__ __forceinline__ uint32_t hi16(uint32_t x) { return x >> 16; }

// Four rows of a one-plane int leaf (plain, const, delta16 or rle).
__device__ __forceinline__ uint4 enc_narrow(const Leaf& L, const Piece& pc) {
  if (L.kind == kPlain) return ld_narrow(static_cast<const int32_t*>(L.a) + pc.at);
  if (L.kind == kConstLeaf) {
    const uint32_t v = __ldg(static_cast<const uint32_t*>(L.a));
    return make_uint4(v, v, v, v);
  }
  const uint2 w = u16x4(L.kind == kDelta16 ? L.b : L.a, L.raw, pc);
  const uint32_t o0 = lo16(w.x), o1 = hi16(w.x), o2 = lo16(w.y),
                 o3 = hi16(w.y);
  if (L.kind == kDelta16) {
    const uint32_t* base = static_cast<const uint32_t*>(L.a);
    if (pc.one) {
      const uint32_t b = __ldg(base + pc.blk[0]);
      return make_uint4(b + o0, b + o1, b + o2, b + o3);
    }
    return make_uint4(__ldg(base + pc.blk[0]) + o0,
                      __ldg(base + pc.blk[1]) + o1,
                      __ldg(base + pc.blk[2]) + o2,
                      __ldg(base + pc.blk[3]) + o3);
  }
  const uint32_t* vals = static_cast<const uint32_t*>(L.b);  // kRle
  if (pc.one) {
    const uint32_t* v = vals + static_cast<size_t>(pc.blk[0]) * L.rc;
    return make_uint4(__ldg(v + o0), __ldg(v + o1), __ldg(v + o2),
                      __ldg(v + o3));
  }
  return make_uint4(__ldg(vals + static_cast<size_t>(pc.blk[0]) * L.rc + o0),
                    __ldg(vals + static_cast<size_t>(pc.blk[1]) * L.rc + o1),
                    __ldg(vals + static_cast<size_t>(pc.blk[2]) * L.rc + o2),
                    __ldg(vals + static_cast<size_t>(pc.blk[3]) * L.rc + o3));
}

// A dictionary entry: (dhi, dlo) of code k, from shared memory or through
// the read-only cache.
__device__ __forceinline__ int2 dict_entry(const Leaf& L, const Piece& pc,
                                           uint32_t k) {
  if (L.dsh >= 0) return pc.dicts[L.dsh + k];
  return make_int2(__ldg(static_cast<const int32_t*>(L.b) + k),
                   __ldg(static_cast<const int32_t*>(L.c) + k));
}

// Four rows of a two-plane leaf: the hi plane and the lo plane.
__device__ __forceinline__ void enc_wide(const Leaf& L, const Piece& pc,
                                         uint4& hi, uint4& lo) {
  if (L.kind == kPlain) {
    ld_wide(static_cast<const int32_t*>(L.a) + 2 * pc.at, hi, lo);
  } else if (L.kind == kConstLeaf) {
    const uint32_t* v = static_cast<const uint32_t*>(L.a);
    const uint32_t h = __ldg(v), l = __ldg(v + 1);
    hi = make_uint4(h, h, h, h);
    lo = make_uint4(l, l, l, l);
  } else if (L.kind == kDelta16) {
    // Each row's two offsets as one word: plane 0 low, plane 1 high.
    uint4 w;
    const unsigned short* p =
        static_cast<const unsigned short*>(L.b) + 2 * pc.at;
    if (L.raw >= 0) {
      w = *reinterpret_cast<const uint4*>(pc.raw + L.raw + 16 * pc.lane);
    } else if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
      w = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      w = make_uint4(__ldg(p) | static_cast<uint32_t>(__ldg(p + 1)) << 16,
                     __ldg(p + 2) | static_cast<uint32_t>(__ldg(p + 3)) << 16,
                     __ldg(p + 4) | static_cast<uint32_t>(__ldg(p + 5)) << 16,
                     __ldg(p + 6) | static_cast<uint32_t>(__ldg(p + 7)) << 16);
    }
    const uint2* base = static_cast<const uint2*>(L.a);
    if (pc.one) {
      const uint2 b = __ldg(base + pc.blk[0]);
      hi = make_uint4(b.x + lo16(w.x), b.x + lo16(w.y), b.x + lo16(w.z),
                      b.x + lo16(w.w));
      lo = make_uint4(b.y + hi16(w.x), b.y + hi16(w.y), b.y + hi16(w.z),
                      b.y + hi16(w.w));
    } else {
      const uint2 b0 = __ldg(base + pc.blk[0]), b1 = __ldg(base + pc.blk[1]),
                  b2 = __ldg(base + pc.blk[2]), b3 = __ldg(base + pc.blk[3]);
      hi = make_uint4(b0.x + lo16(w.x), b1.x + lo16(w.y), b2.x + lo16(w.z),
                      b3.x + lo16(w.w));
      lo = make_uint4(b0.y + hi16(w.x), b1.y + hi16(w.y), b2.y + hi16(w.z),
                      b3.y + hi16(w.w));
    }
  } else if (L.kind == kRle) {
    const uint2 w = u16x4(L.a, L.raw, pc);
    const uint2* vals = static_cast<const uint2*>(L.b);
    const size_t r0 = static_cast<size_t>(pc.blk[0]) * L.rc;
    const size_t r1 = pc.one ? r0 : static_cast<size_t>(pc.blk[1]) * L.rc;
    const size_t r2 = pc.one ? r0 : static_cast<size_t>(pc.blk[2]) * L.rc;
    const size_t r3 = pc.one ? r0 : static_cast<size_t>(pc.blk[3]) * L.rc;
    const uint2 v0 = __ldg(vals + r0 + lo16(w.x)),
                v1 = __ldg(vals + r1 + hi16(w.x)),
                v2 = __ldg(vals + r2 + lo16(w.y)),
                v3 = __ldg(vals + r3 + hi16(w.y));
    hi = make_uint4(v0.x, v1.x, v2.x, v3.x);
    lo = make_uint4(v0.y, v1.y, v2.y, v3.y);
  } else {  // kDict
    const uint2 w = u16x4(L.a, L.raw, pc);
    const int2 e0 = dict_entry(L, pc, lo16(w.x)),
               e1 = dict_entry(L, pc, hi16(w.x)),
               e2 = dict_entry(L, pc, lo16(w.y)),
               e3 = dict_entry(L, pc, hi16(w.y));
    hi = make_uint4(e0.x, e1.x, e2.x, e3.x);
    lo = make_uint4(e0.y, e1.y, e2.y, e3.y);
  }
}

// Four codes of a slot a code predicate reads: the dictionary leaf's
// codes, or the code plane beside a plain column's planes.
__device__ __forceinline__ uint4 enc_code(const Leaf& L, const Piece& pc) {
  if (L.kind == kDict) {
    const uint2 w = u16x4(L.a, L.raw, pc);
    return make_uint4(lo16(w.x), hi16(w.x), lo16(w.y), hi16(w.y));
  }
  return ld_narrow(static_cast<const int32_t*>(L.c) + pc.at);
}

// The loads of the two builds: kEnc decodes leaves (from the warp's copy
// where the piece was copied), the plain build reads plain planes only.
template <bool kEnc>
__device__ __forceinline__ uint32_t load_flags(const uint8_t* p, bool bits,
                                               int raw, const Piece& pc) {
  if constexpr (kEnc) {
    return enc_flags(p, bits, raw, pc);
  } else {
    return ldb(p + pc.at);
  }
}

template <bool kEnc>
__device__ __forceinline__ uint4 load_int(const Leaf& L, const Piece& pc) {
  if constexpr (kEnc) {
    return enc_narrow(L, pc);
  } else {
    return ld_narrow(static_cast<const int32_t*>(L.a) + pc.at);
  }
}

template <bool kEnc>
__device__ __forceinline__ void load_col(const Desc& d, int c,
                                         const Piece& pc, uint4& hi,
                                         uint4& lo) {
  if constexpr (kEnc) {
    if (d.width[c] == 2) {
      enc_wide(d.col[c], pc, hi, lo);
    } else {
      hi = lo = enc_narrow(d.col[c], pc);
    }
  } else {
    const int32_t* p = static_cast<const int32_t*>(d.col[c].a);
    if (d.width[c] == 2) {
      ld_wide(p + 2 * pc.at, hi, lo);
    } else {
      hi = lo = ld_narrow(p + pc.at);
    }
  }
}

template <bool kEnc>
__device__ __forceinline__ uint4 load_code(const Leaf& L, const Piece& pc) {
  if constexpr (kEnc) {
    return enc_code(L, pc);
  } else {
    return ld_narrow(static_cast<const int32_t*>(L.c) + pc.at);
  }
}

// Stages a warp's piece: every plane of the lane's kRows rows (pc.at on)
// loaded once, and what no spec changes decoded into `my` (word k of the
// lane's rows at my + k * kPieceRows). `in`: the rows lie in the run.
// Returns the lane's candidate bits.
template <int kCols, bool kEnc>
__device__ __forceinline__ uint32_t stage_piece(const Desc& d, uint32_t* my,
                                                const Piece& pc, bool in) {
  const uint32_t vb = load_flags<kEnc>(d.valid, d.bits_top & 1u,
                                       d.flag_raw[0], pc),
                 tb = load_flags<kEnc>(d.tomb, d.bits_top & 2u,
                                       d.flag_raw[1], pc),
                 lb = load_flags<kEnc>(d.live, d.bits_top & 4u,
                                       d.flag_raw[2], pc);
  const uint4 hh = load_int<kEnc>(d.ht_hi, pc),
              hl = load_int<kEnc>(d.ht_lo, pc);
  const uint4 eh = load_int<kEnc>(d.exp_hi, pc),
              el = load_int<kEnc>(d.exp_lo, pc);
  uint32_t sb[kCols], nb[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    sb[c] = load_flags<kEnc>(d.set[c], (d.bits_set >> c) & 1u,
                             d.flag_raw[3 + 2 * c], pc);
    nb[c] = load_flags<kEnc>(d.isnull[c], (d.bits_null >> c) & 1u,
                             d.flag_raw[4 + 2 * c], pc);
  }
  uint32_t nn[kRows];  // bit c: slot c set and not NULL
#pragma unroll
  for (int j = 0; j < kRows; ++j) nn[j] = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const uint32_t x = sb[c] & ~nb[c];
#pragma unroll
    for (int j = 0; j < kRows; ++j) nn[j] |= ((x >> (8 * j)) & 1u) << c;
  }
  uint32_t cand = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    nn[j] &= d.col_mask;
    cand |= static_cast<uint32_t>(in && byte_of(vb, j) && !byte_of(tb, j) &&
                                  (byte_of(lb, j) || nn[j]))
            << j;
  }
  sst(my + kHtHi * kPieceRows, hh);
  sst(my + kHtLo * kPieceRows, hl);
  sst(my + kExpHi * kPieceRows, eh);
  sst(my + kExpLo * kPieceRows, el);

  // The predicate and group columns' order words (or a code predicate's
  // code), zeroed where NULL; both builds unroll the loop (the encoded
  // one dispatches on the leaf kind once an entry).
#pragma unroll
  for (int v = 0; v < kMaxStaged; ++v) {
    if (v >= d.n_staged) break;
    const int c = d.stg_col[v];
    uint4 hi, lo;
    if (d.stg_code[v]) {
      hi = lo = load_code<kEnc>(d.col[c], pc);
    } else {
      load_col<kEnc>(d, c, pc, hi, lo);
    }
    const uint32_t z0 = (nn[0] >> c) & 1, z1 = (nn[1] >> c) & 1,
                   z2 = (nn[2] >> c) & 1, z3 = (nn[3] >> c) & 1;
    uint32_t* dst = my + d.stg_word[v] * kPieceRows;
    sst(dst, make_uint4(z0 ? hi.x : 0, z1 ? hi.y : 0, z2 ? hi.z : 0,
                        z3 ? hi.w : 0));
    if (d.stg_width[v] == 2) {
      sst(dst + kPieceRows, make_uint4(z0 ? lo.x : 0, z1 ? lo.y : 0,
                                       z2 ? lo.z : 0, z3 ? lo.w : 0));
    }
  }

  // The bucket of each row from the staged key planes and null flags.
  uint32_t h[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) h[j] = kHashSeed;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= d.n_group) break;
    const uint32_t* w = my + d.grp_word[g] * kPieceRows;
    const uint4 a = sld(w);
    const uint4 b = d.grp_planes[g] == 2 ? sld(w + kPieceRows) : a;
    const int c = d.grp_col[g];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      h[j] = (h[j] ^ at4(a, j)) * kHashMul;
      if (d.grp_planes[g] == 2) h[j] = (h[j] ^ at4(b, j)) * kHashMul;
      h[j] = (h[j] ^ (((nn[j] >> c) & 1) ^ 1u)) * kHashMul;
    }
  }
  uint32_t rw[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    h[j] ^= h[j] >> 16;
    h[j] *= kMixMul;
    h[j] ^= h[j] >> 13;
    rw[j] = nn[j] | ((cand >> j) & 1u) << kCandBit |
            ((h[j] & 0x7fffffffu) % kNumBuckets) << kBucketShift;
  }

  // Each sum's product as four 24-bit limbs (zero where an input is NULL
  // or negative), and the row's negative inputs where its sums' inputs are
  // all non-NULL (negs, counted for the specs the row matches).
#pragma unroll 1
  for (int a = 0; a < d.n_aggs; ++a) {
    if (d.agg_kind[a] != kSum) continue;
    const uint32_t need = d.agg_need[a];
    uint4 bh, bl;
    load_col<kEnc>(d, d.agg_col[a], pc, bh, bl);
    // Each factor's value a row: affine ones from the column's words,
    // the others by their postfix program, one row at a time, with the
    // sum's limb words (not yet written) as the stack and the results.
    static_assert(kMaxNodes + kRows <= 4 * kRows, "scratch in the limbs");
    uint32_t* scratch = my + d.limb_word[a] * kPieceRows;
    auto slot = [scratch](int i) {
      return scratch + (i / kRows) * kPieceRows + i % kRows;
    };
    uint4 fc[kMaxFactors];
#pragma unroll
    for (int k = 0; k < kMaxFactors; ++k) {
      fc[k] = make_uint4(0, 0, 0, 0);
      if (k >= d.agg_nf[a]) continue;
      if (d.fac_affine[a][k]) {
        uint4 col, unused;
        load_col<kEnc>(d, d.fac_col[a][k], pc, col, unused);
        const uint32_t k0 = static_cast<uint32_t>(d.fac_k0[a][k]),
                       k1 = static_cast<uint32_t>(d.fac_k1[a][k]);
        fc[k] = make_uint4(k0 + k1 * col.x, k0 + k1 * col.y, k0 + k1 * col.z,
                           k0 + k1 * col.w);
      } else {
#pragma unroll 1
        for (int j = 0; j < kRows; ++j) {
          // The row's block (not indexed from pc.blk: j is not unrolled).
          const int blk = !kEnc ? 0
                          : pc.one ? pc.blk[0]
                                   : (pc.at + j) / d.rows_per_block;
          *slot(kMaxNodes + j) = static_cast<uint32_t>(
              eval_factor<kEnc>(d, a, k, pc.at + j, blk, slot));
        }
        fc[k] = make_uint4(*slot(kMaxNodes), *slot(kMaxNodes + 1),
                           *slot(kMaxNodes + 2), *slot(kMaxNodes + 3));
      }
    }
    uint32_t limb[4][kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int32_t w2[2] = {static_cast<int32_t>(at4(bh, j)),
                             static_cast<int32_t>(at4(bl, j))};
      const int64_t v = base_value(w2, d.agg_planes[a]);
      uint32_t bad = v < 0;
      uint64_t f[kMaxFactors] = {1, 1};
#pragma unroll
      for (int k = 0; k < kMaxFactors; ++k) {
        if (k >= d.agg_nf[a]) break;
        const int32_t x = static_cast<int32_t>(at4(fc[k], j));
        bad += x < 0;
        f[k] = static_cast<uint32_t>(x);
      }
      const bool ok = (nn[j] & need) == need;
      rw[j] += (ok ? bad : 0u) << kNegShift;
      const bool on = ok && !bad;
      const uint64_t u = static_cast<uint64_t>(v);
      uint64_t lo = u * f[0];  // < 2^77: two words
      uint64_t hi = __umul64hi(u, f[0]);
      hi = hi * f[1] + __umul64hi(lo, f[1]);
      lo *= f[1];
      limb[0][j] = on ? static_cast<uint32_t>(lo) & kLimbMask : 0;
      limb[1][j] = on ? static_cast<uint32_t>(lo >> 24) & kLimbMask : 0;
      limb[2][j] = on ? static_cast<uint32_t>((lo >> 48) | (hi << 16)) &
                            kLimbMask
                      : 0;
      limb[3][j] = on ? static_cast<uint32_t>(hi >> 8) & kLimbMask : 0;
    }
    uint32_t* dst = my + d.limb_word[a] * kPieceRows;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sst(dst + k * kPieceRows,
          make_uint4(limb[k][0], limb[k][1], limb[k][2], limb[k][3]));
    }
  }
  sst(my + kRowWord * kPieceRows, make_uint4(rw[0], rw[1], rw[2], rw[3]));
  return cand;
}

// Key plane k of the piece's row r (a group column's order word, or its
// null flag from the row word); keymap[k]: (word or -1, column).
__device__ __forceinline__ int32_t key_plane(const int2* keymap,
                                             const uint32_t* area, int k,
                                             int r) {
  const int2 km = keymap[k];
  if (km.x >= 0) return static_cast<int32_t>(area[km.x * kPieceRows + r]);
  return static_cast<int32_t>(
      ((area[kRowWord * kPieceRows + r] >> km.y) & 1u) ^ 1u);
}

// Whether row r's key differs from row l's (both in the piece).
__device__ __forceinline__ bool key_differs(const Desc& d, const int2* keymap,
                                            const uint32_t* area, int r,
                                            int l) {
  bool diff = false;
#pragma unroll 1
  for (int k = 0; k < d.n_kpl; ++k) {
    diff |= key_plane(keymap, area, k, r) != key_plane(keymap, area, k, l);
  }
  return diff;
}

// The lane's rows (bits of `rows`) whose bucket is b.
__device__ __forceinline__ uint32_t rows_in(const uint32_t (&bk)[kRows],
                                            uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) r |= static_cast<uint32_t>(bk[j] == b) << j;
  return r;
}

// The piece's bucket steps, once for every spec: its candidate rows
// grouped by bucket in the order of their first rows, each bucket's slot
// claimed in the block's tag table (-1: no slot free), written to `steps`
// (bucket | first row << 9, slot); each lane's rows' step indices in st
// (8 bits a row). Returns the step count, and in `collide` whether some
// row's key differs from its step's first row's (a collision inside the
// piece), checked once for all rows, a key plane at a time.
__device__ __forceinline__ int piece_steps(const Desc& d, const int2* keymap,
                                           const uint32_t* area, int lane,
                                           uint32_t cand, int* tags,
                                           int2* steps, uint32_t& st,
                                           bool& collide) {
  const uint32_t* my = area + kRows * lane;
  const uint4 rw = sld(my + kRowWord * kPieceRows);
  uint32_t bk[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    bk[j] = (at4(rw, j) >> kBucketShift) & (kNumBuckets - 1);
  }
  int n = 0;
  st = 0;
  for (uint32_t pend = cand;;) {
    const unsigned lanes = __ballot_sync(kFull, pend != 0);
    if (!lanes) break;
    const int leader = __ffs(lanes) - 1;
    const int lj = __shfl_sync(kFull, __ffs(pend) - 1, leader);
    uint32_t mb = bk[0];
#pragma unroll
    for (int j = 1; j < kRows; ++j) mb = lj == j ? bk[j] : mb;
    const uint32_t b = __shfl_sync(kFull, mb, leader);
    const uint32_t mine = pend & rows_in(bk, b);
    pend &= ~mine;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      st |= ((mine >> j) & 1u ? static_cast<uint32_t>(n) : 0u) << (8 * j);
    }
    if (lane == leader) {
      steps[n] = make_int2(static_cast<int>(b) | (kRows * leader + lj) << 9,
                           claim_slot(tags, static_cast<int>(b)));
    }
    ++n;
  }
  __syncwarp();
  // Each candidate row's key planes against its step's first row's.
  int lrow[kRows];
  uint32_t lrw[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    lrow[j] = steps[(st >> (8 * j)) & 0xffu].x >> 9;
    lrw[j] = area[kRowWord * kPieceRows + lrow[j]];
  }
  bool diff = false;
#pragma unroll 1
  for (int k = 0; k < d.n_kpl; ++k) {
    const int2 km = keymap[k];
    if (km.x >= 0) {
      const uint32_t* w = area + km.x * kPieceRows;
      const uint4 own = sld(w + kRows * lane);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        diff |= ((cand >> j) & 1u) && at4(own, j) != w[lrow[j]];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        diff |= ((cand >> j) & 1u) &&
                (((at4(rw, j) ^ lrw[j]) >> km.y) & 1u);
      }
    }
  }
  collide = __any_sync(kFull, diff);
  return n;
}

// Folds one spec's matching rows of a piece (m: bit j, the lane's row
// kRows * lane + j) step by step into its slot table, or into its table
// in device memory for a bucket without a slot. Per step: lane 0 adds the
// count, lane 1 + a aggregate a's count or n, lane agg_sum[a] sum a's
// limbs, and lanes 1 .. 2 * n_kpl the leader's key planes' minima and
// maxima, so that each kind goes out as one atomic instruction; lane 0
// also rep, the step's first matching row. Where the piece holds a
// collision, each row whose key differs from the leader's adds its own
// key planes.
__device__ __forceinline__ void fold_spec(const Desc& d, const Spec& sp,
                                          long long* table,
                                          const int2* keymap,
                                          const uint32_t* area,
                                          const int2* steps, int n_steps,
                                          bool collide, int lane, int piece0,
                                          uint32_t m, uint32_t st,
                                          const uint4& rw) {
  const uint32_t* my = area + kRows * lane;
  for (int i = 0; i < n_steps; ++i) {
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      mine |= static_cast<uint32_t>(((st >> (8 * j)) & 0xffu) == i) << j;
    }
    mine &= m;
    const unsigned lanes = __ballot_sync(kFull, mine != 0);
    if (!lanes) continue;
    const int2 step = steps[i];
    const uint32_t bucket = step.x & (kNumBuckets - 1);
    const int leader = __ffs(lanes) - 1;
    const int lrow = kRows * leader + __shfl_sync(kFull, __ffs(mine) - 1,
                                                  leader);
    const Dest t{step.y >= 0 ? sp.t32 + step.y * d.n32 : nullptr,
                 sp.t64 + (step.y >= 0 ? step.y : 0) * d.n64,
                 table + static_cast<long long>(bucket) * d.n_out};
    if (lane <= 2 * d.n_kpl) {
      // Lane 0 rep, lanes 1 .. n_kpl the key planes' minima, the next
      // n_kpl their maxima.
      const bool is_max = lane > d.n_kpl;
      const int k = is_max ? lane - 1 - d.n_kpl : lane - 1;
      const int32_t v =
          lane == 0 ? piece0 + lrow : key_plane(keymap, area, k, lrow);
      const int word = lane == 0 ? 1 : is_max ? 2 + d.kp + k : 2 + k;
      if (is_max) t.max(word, v);
      else t.min(word, v);
    }
    if (collide) {
#pragma unroll 1
      for (int j = 0; j < kRows; ++j) {
        const int r = kRows * lane + j;
        if (!((mine >> j) & 1) || r == lrow ||
            !key_differs(d, keymap, area, r, lrow)) {
          continue;
        }
        for (int k = 0; k < d.n_kpl; ++k) {
          const int32_t v = key_plane(keymap, area, k, r);
          t.min(2 + k, v);
          t.max(2 + d.kp + k, v);
        }
      }
    }
    const uint32_t cnt = __reduce_add_sync(kFull, __popc(mine));
    uint32_t add_v = lane == 0 ? cnt : 0u;
    int add_k32 = 0, add_ko = 0;
    uint32_t sum[4] = {0, 0, 0, 0};
    int sum_k64 = 0, sum_ko = 0;
#pragma unroll
    for (int a = 0; a < kMaxAggs; ++a) {
      if (a >= d.n_aggs) break;
      const uint32_t need = d.agg_need[a];
      uint32_t ok = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        ok |= static_cast<uint32_t>((at4(rw, j) & need) == need) << j;
      }
      ok &= mine;
      const uint32_t n = __reduce_add_sync(kFull, __popc(ok));
      if (lane == 1 + a) {
        add_v = n;
        add_k32 = d.agg_w32[a];
        add_ko = d.agg_off[a];
      }
      if (d.agg_kind[a] == kCount) continue;
      const uint32_t* lw = my + d.limb_word[a] * kPieceRows;
      const bool own = lane == d.agg_sum[a];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 l = sld(lw + k * kPieceRows);
        const uint32_t part = ((ok & 1u) ? l.x : 0u) + ((ok & 2u) ? l.y : 0u) +
                              ((ok & 4u) ? l.z : 0u) + ((ok & 8u) ? l.w : 0u);
        const uint32_t v = __reduce_add_sync(kFull, part);
        sum[k] = own ? v : sum[k];
      }
      if (own) {
        sum_k64 = d.agg_w64[a];
        sum_ko = d.agg_off[a] + 1;
      }
    }
    if (add_v) t.add(add_k32, add_ko, add_v);
    if (sum[0] | sum[1] | sum[2] | sum[3]) {
      uint64_t lo, hi;
      limbs_to_128(sum, lo, hi);
      t.sum(sum_k64, sum_ko, lo, hi);
    }
  }
}

// A 16-byte copy into shared memory that bypasses the registers; bytes
// past `bytes` (of 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The per-row array of copied plane k (ops/group_agg.py plane_table's
// order) and its bytes a piece: a bits plane's words (16), a delta16
// leaf's offsets (256 a plane word), an rle leaf's run ids or a
// dictionary's codes (256).
__device__ __forceinline__ const char* copy_source(const Desc& d, int k,
                                                   int& piece_bytes) {
  const void* src;
  int width = 1;
  const Leaf* L = nullptr;
  if (k < 4) {
    L = &d.ht_hi + k;
  } else if (k < 7) {
    src = (&d.valid)[k - 4];
  } else {
    const int c = (k - 7) / 3, r = k - 7 - 3 * c;
    if (r == 2) {
      L = &d.col[c];
      width = d.width[c];
    } else {
      src = r == 0 ? d.set[c] : d.isnull[c];
    }
  }
  if (L == nullptr) {
    piece_bytes = kPieceRows / 8;
    return static_cast<const char*>(src);
  }
  piece_bytes = 2 * kPieceRows * (L->kind == kDelta16 ? width : 1);
  return static_cast<const char*>(L->kind == kDelta16 ? L->b : L->a);
}

// A copied plane's per-row array and its bytes a piece, resolved once a
// block (copy_source): looked up in the descriptor by plane index inside
// the piece loop, they cost the copy build ~5%.
struct CopySrc {
  const char* src;
  int32_t piece_bytes, unused;
};

// Starts copying piece `piece`'s copied leaves into `buf`, chunk i (16
// bytes) by lane i mod 32: the chunk table `ctab` gives each chunk's
// copied plane (low byte, an index into `rtab`) and its index in the
// plane's piece (high byte). In the run's last piece, bytes past a
// plane's end are zero-filled.
__device__ __forceinline__ void copy_piece(const Desc& d,
                                           const CopySrc* rtab,
                                           const uint16_t* ctab,
                                           unsigned char* buf, int piece,
                                           int lane) {
  const bool tail = (piece + 1) * kPieceRows > d.n_rows;
  for (int i = lane; i < d.raw_chunks; i += 32) {
    const int e = ctab[i];
    const CopySrc cs = rtab[e & 0xff];
    const long long at =
        static_cast<long long>(piece) * cs.piece_bytes + 16 * (e >> 8);
    int bytes = 16;
    if (tail) {
      const long long left =
          ((static_cast<long long>(d.n_rows) * cs.piece_bytes) / kPieceRows) -
          at;
      bytes = left < 0 ? 0 : left < 16 ? static_cast<int>(left) : 16;
    }
    cp_async16(buf + 16 * i, bytes ? cs.src + at : cs.src, bytes);
  }
}

// kCols: the column slots whose set/isnull a row loads (8 or kMaxCols, the
// least that holds n_cols), so that a narrow table issues no padding loads;
// kEnc: some plane is an encoded leaf; kCopy (with kEnc): the pieces'
// per-row arrays are copied into the warps' buffers. The copy is a build
// of its own: a launch that copies nothing takes the build without the
// copy's code.
template <int kCols, bool kEnc, bool kCopy>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    group_agg_kernel(const __grid_constant__ Desc d,
                     const int32_t* __restrict__ params,
                     long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int union_lo, union_hi;
  __shared__ int tags[kSlots];  // each slot's bucket, -1 while free
  // Each warp's bucket steps of its piece, and its scanned and negs a spec
  // (added without atomics).
  __shared__ int2 steps[kWarps][kPieceRows];
  __shared__ unsigned long long counts[kWarps][kMaxSpecChunk][2];
  __shared__ int2 keymap[kMaxKeyPlanes];  // key plane: (word or -1, column)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.y * d.chunk;
  const int ns = min(d.chunk, d.n_specs - s0);
  uint32_t* area = reinterpret_cast<uint32_t*>(smem + d.chunk * d.spec_bytes) +
                   warp * d.words * kPieceRows;
  // The encoded build's regions after the warps' areas: each warp's
  // buffers of a piece's copy, the dictionaries, the copied planes'
  // sources and the chunk table.
  unsigned char* bufs = smem + d.chunk * d.spec_bytes +
                        4 * kWarps * kPieceRows * d.words;
  unsigned char* my_buf = bufs + warp * d.buffers * d.raw_bytes;
  int2* dicts =
      reinterpret_cast<int2*>(bufs + kWarps * d.buffers * d.raw_bytes);
  CopySrc* rtab = reinterpret_cast<CopySrc*>(
      reinterpret_cast<unsigned char*>(dicts) + d.dict_bytes);
  uint16_t* ctab = reinterpret_cast<uint16_t*>(rtab + d.n_copies);

  // The chunk's records: parameter rows, empty slot tables, zero counts.
  for (int s = 0; s < ns; ++s) {
    const Spec sp = spec_at(d, smem, s);
    const int32_t* p = params + static_cast<long long>(s0 + s) * d.n_params;
    for (int i = tid; i < d.n_params; i += kThreads) sp.p[i] = p[i];
    for (int i = tid; i < kSlots * d.n64; i += kThreads) sp.t64[i] = 0;
    for (int i = tid; i < kSlots * d.n32; i += kThreads) {
      const int w = i % d.n32;
      uint32_t v = 0;
      if (w == 1 || (w >= 2 && w < 2 + d.kp)) v = 0x7fffffffu;
      else if (w >= 2 + d.kp && w < 2 + 2 * d.kp) v = 0x80000000u;
      sp.t32[i] = v;
    }
  }
  if (tid < kSlots) tags[tid] = -1;
  if (tid < d.n_kpl) keymap[tid] = make_int2(d.key_word[tid], d.key_col[tid]);
  for (int i = tid; i < kWarps * kMaxSpecChunk * 2; i += kThreads) {
    (&counts[0][0][0])[i] = 0;
  }
  if constexpr (kEnc) {
    // The copied planes' sources, the chunk table, and the dictionaries
    // that live in shared memory.
    if constexpr (kCopy) {
      for (int r = tid; r < d.n_copies; r += kThreads) {
        int pb;
        const char* src = copy_source(d, d.cp_plane[r], pb);
        rtab[r] = CopySrc{src, pb, 0};
      }
      for (int r = 0; r < d.n_copies; ++r) {
        const int c0 = d.cp_first[r], n = d.cp_first[r + 1] - c0;
        for (int i = tid; i < n; i += kThreads) {
          ctab[c0 + i] = static_cast<uint16_t>(r | i << 8);
        }
      }
    }
    for (int c = 0; c < d.n_cols; ++c) {
      const Leaf& L = d.col[c];
      if (L.kind != kDict || L.dsh < 0) continue;
      for (int i = tid; i < L.rc; i += kThreads) {
        dicts[L.dsh + i] =
            make_int2(__ldg(static_cast<const int32_t*>(L.b) + i),
                      __ldg(static_cast<const int32_t*>(L.c) + i));
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int u_lo = d.n_rows, u_hi = 0;
    for (int s = 0; s < ns; ++s) {
      const int32_t* p = spec_at(d, smem, s).p;
      const int lo = min(max(p[0], 0), d.n_rows);
      const int hi = min(max(p[1], 0), d.n_rows);
      if (lo < hi) {
        u_lo = min(u_lo, lo);
        u_hi = max(u_hi, hi);
      }
    }
    union_lo = u_lo;
    union_hi = u_hi;
  }
  __syncthreads();

  // The pieces that meet some spec's range, a warp at a time.
  const int first = union_lo / kPieceRows;
  const int end = union_lo < union_hi
                      ? (union_hi + kPieceRows - 1) / kPieceRows
                      : first;
  long long* tables = out + static_cast<long long>(s0) * (kNumBuckets + 1) *
                                d.n_out;
  const uint32_t* my = area + kRows * lane;
  const int stride = gridDim.x * kWarps;
  int piece = first + blockIdx.x * kWarps + warp;
  constexpr bool copies = kEnc && kCopy;
  if constexpr (copies) {
    if (piece < end) copy_piece(d, rtab, ctab, my_buf, piece, lane);
    cp_async_commit();
  }
  for (int it = 0; piece < end; piece += stride, ++it) {
    const int piece0 = piece * kPieceRows;
    const int row0 = piece0 + kRows * lane;
    const bool in = row0 < d.n_rows;  // n_rows is a multiple of kRows
    Piece pc;
    pc.at = in ? row0 : 0;  // past the end: row 0, no candidate
    pc.lane = lane;
    unsigned char* cur = my_buf;
    if constexpr (kEnc) {
      pc.one = d.one_block;
      if (pc.one) {
        pc.blk[0] = pc.blk[1] = pc.blk[2] = pc.blk[3] =
            static_cast<int>(static_cast<unsigned>(pc.at) /
                             static_cast<unsigned>(d.rows_per_block));
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          pc.blk[j] = static_cast<int>(static_cast<unsigned>(pc.at + j) /
                                       static_cast<unsigned>(d.rows_per_block));
        }
      }
      pc.dicts = dicts;
      if constexpr (copies) {
        // Two buffers: the next piece's copy goes out before this piece
        // stages; one: after, before it folds.
        if (d.buffers == 2) {
          cur = my_buf + (it & 1) * d.raw_bytes;
          if (piece + stride < end) {
            copy_piece(d, rtab, ctab, my_buf + ((it + 1) & 1) * d.raw_bytes,
                       piece + stride, lane);
          }
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      }
    } else {
      pc.one = true;
      pc.blk[0] = pc.blk[1] = pc.blk[2] = pc.blk[3] = 0;
      pc.dicts = nullptr;
    }
    pc.raw = cur;
    __syncwarp();  // the previous piece's folds are done with the area
    const uint32_t cand =
        stage_piece<kCols, kEnc>(d, area + kRows * lane, pc, in);
    __syncwarp();
    if constexpr (copies) {
      if (d.buffers == 1) {
        if (piece + stride < end) {
          copy_piece(d, rtab, ctab, cur, piece + stride, lane);
        }
        cp_async_commit();
      }
    }
    if (!__any_sync(kFull, cand != 0)) continue;
    uint32_t st;
    bool collide;
    const int n_steps = piece_steps(d, keymap, area, lane, cand, tags,
                                    steps[warp], st, collide);
    __syncwarp();
    const uint4 rw = sld(my + kRowWord * kPieceRows);
    const uint4 th = sld(my + kHtHi * kPieceRows);
    const uint4 tl = sld(my + kHtLo * kPieceRows);
    const uint4 xh = sld(my + kExpHi * kPieceRows);
    const uint4 xl = sld(my + kExpLo * kPieceRows);
    for (int s = 0; s < ns; ++s) {
      const Spec sp = spec_at(d, smem, s);
      const int32_t* p = sp.p;
      const int lo = max(p[0], 0), hi = min(p[1], d.n_rows);
      if (piece0 + kPieceRows <= lo || piece0 >= hi) continue;
      // Rows that exist in range at the spec's read point (scanned), then
      // those that pass its predicates too (matches).
      uint32_t e = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool ok =
            row0 + j >= lo && row0 + j < hi &&
            le2(static_cast<int32_t>(at4(th, j)),
                static_cast<int32_t>(at4(tl, j)), p[2], p[3]) &&
            !le2(static_cast<int32_t>(at4(xh, j)),
                 static_cast<int32_t>(at4(xl, j)), p[4], p[5]);
        e |= static_cast<uint32_t>(ok) << j;
      }
      e &= cand;
      uint32_t m = e;
#pragma unroll 1
      for (int q = 0; q < d.n_preds; ++q) {
        const int c = d.pred_col[q], planes = d.pred_planes[q];
        const uint32_t* w = my + d.pred_word[q] * kPieceRows;
        const uint4 a = sld(w);
        const uint4 b = planes == 2 ? sld(w + kPieceRows) : a;
        const int32_t* lit = p + d.pred_lit[q];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int32_t v[2] = {static_cast<int32_t>(at4(a, j)),
                                static_cast<int32_t>(at4(b, j))};
          const bool pass = ((at4(rw, j) >> c) & 1) &&
                            pred_ok(d.pred_op[q], planes, v, lit);
          m &= ~(static_cast<uint32_t>(!pass) << j);
        }
      }
      uint32_t neg = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        neg += (m >> j) & 1u ? at4(rw, j) >> kNegShift : 0u;
      }
      const uint32_t scanned = __reduce_add_sync(kFull, __popc(e));
      const uint32_t negs = __reduce_add_sync(kFull, neg);
      if (lane == 0) {
        counts[warp][s][0] += scanned;
        counts[warp][s][1] += negs;
      }
      fold_spec(d, sp,
                tables + static_cast<long long>(s) * (kNumBuckets + 1) *
                             d.n_out,
                keymap, area, steps[warp], n_steps, collide, lane, piece0, m,
                st, rw);
    }
  }
  __syncthreads();

  // Merge each spec's live slots, scanned and negs into its table.
  for (int i = tid; i < ns * kSlots; i += kThreads) {
    const int s = i / kSlots, slot = i - s * kSlots;
    const Spec sp = spec_at(d, smem, s);
    const int b = tags[slot];
    const uint32_t* w32 = sp.t32 + slot * d.n32;
    if (b < 0 || !w32[0]) continue;  // free, or no row of this spec
    long long* o = tables + (static_cast<long long>(s) * (kNumBuckets + 1) +
                             b) * d.n_out;
    atomicAdd(reinterpret_cast<unsigned long long*>(&o[0]),
              static_cast<unsigned long long>(w32[0]));
    atomicMin(&o[1], static_cast<long long>(static_cast<int32_t>(w32[1])));
    for (int k = 0; k < d.kp; ++k) {
      atomicMin(&o[2 + k],
                static_cast<long long>(static_cast<int32_t>(w32[2 + k])));
      atomicMax(&o[2 + d.kp + k], static_cast<long long>(
                                      static_cast<int32_t>(w32[2 + d.kp + k])));
    }
    for (int a = 0; a < d.n_aggs; ++a) {
      const int off = d.agg_off[a];
      if (w32[d.agg_w32[a]]) {
        atomicAdd(reinterpret_cast<unsigned long long*>(&o[off]),
                  static_cast<unsigned long long>(w32[d.agg_w32[a]]));
      }
      if (d.agg_kind[a] == kSum) {
        const unsigned long long* w = sp.t64 + slot * d.n64 + d.agg_w64[a];
        if (w[0] | w[1]) {
          atomic_add128(reinterpret_cast<unsigned long long*>(&o[off + 1]),
                        reinterpret_cast<unsigned long long*>(&o[off + 2]),
                        w[0], w[1]);
        }
      }
    }
  }
  for (int i = tid; i < 2 * ns; i += kThreads) {
    const int s = i >> 1, k = i & 1;
    unsigned long long v = 0;
    for (int w = 0; w < kWarps; ++w) v += counts[w][s][k];
    long long* o = tables + (static_cast<long long>(s) * (kNumBuckets + 1) +
                             kNumBuckets) * d.n_out;
    if (v) atomicAdd(reinterpret_cast<unsigned long long*>(&o[k]), v);
  }
}

// Marks factor f of aggregate a affine when its postfix program is k, c,
// or one column and one constant under +, - or * (mod 2^32 these equal
// k0 + k1 * c, so the wrapping result is the program's).
void affine(Desc& d, int a, int f) {
  const int8_t* op = d.node_op[a][f];
  const int32_t* arg = d.node_arg[a][f];
  int n = 0;
  while (n < kMaxNodes && op[n] != kEnd) ++n;
  int32_t k0 = 0, k1 = 0, col = 0;
  if (n == 1) {
    if (op[0] == kConst) k0 = arg[0];
    else { k1 = 1; col = arg[0]; }
  } else if (n == 3 && (op[0] == kConst) != (op[1] == kConst) &&
             op[0] <= kColumn && op[1] <= kColumn) {
    const bool k_first = op[0] == kConst;
    const uint32_t k = static_cast<uint32_t>(arg[k_first ? 0 : 1]);
    col = arg[k_first ? 1 : 0];
    if (op[2] == kAdd) { k0 = static_cast<int32_t>(k); k1 = 1; }
    else if (op[2] == kMul) { k1 = static_cast<int32_t>(k); }
    else if (k_first) { k0 = static_cast<int32_t>(k); k1 = -1; }
    else { k0 = static_cast<int32_t>(0u - k); k1 = 1; }
  } else {
    return;
  }
  d.fac_affine[a][f] = 1;
  d.fac_k0[a][f] = k0;
  d.fac_k1[a][f] = k1;
  d.fac_col[a][f] = col;
}

// The kernel of a table of n_cols value columns for a build (0 plain, 1
// encoded, 2 encoded with the copies).
using Kernel = void (*)(const Desc, const int32_t*, long long*);

Kernel pick_kernel(int n_cols, int build) {
  if (n_cols <= 8) {
    return build == 0   ? group_agg_kernel<8, false, false>
           : build == 1 ? group_agg_kernel<8, true, false>
                        : group_agg_kernel<8, true, true>;
  }
  return build == 0   ? group_agg_kernel<kMaxCols, false, false>
         : build == 1 ? group_agg_kernel<kMaxCols, true, false>
                      : group_agg_kernel<kMaxCols, true, true>;
}

}  // namespace

extern "C" {

// planes: ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live, then per column
// slot: set, isnull, cmp; each plane's first array, 16-byte aligned, over
// a number of rows that is a multiple of 4. leaves: kLeafWords int64 words
// a plane: its kind (LeafKind), an rle leaf's run slots or a dictionary's
// entries, its second and third array (a plain cmp's third: its code
// plane, or 0), the offset of its piece in a warp's copy (-1: not copied;
// the copied planes' pieces lie back to back in plane order, each copied
// array 16-byte aligned) and its dictionary's first entry in shared memory
// (-1: the read-only cache; back to back in plane order); flag planes are
// plain or bits, the others any int kind, a cmp also a dictionary.
// rows_per_block: R (a delta16 or rle leaf's block of a row). desc:
// kDescWords int32 words (layout in ops/group_agg.py
// GroupAggPlan.descriptor). params: [n_specs, n_params] int32 on the
// device. out: [n_specs, kNumBuckets + 1, n_out] int64 on the device.
// grid_x (blocks a spec chunk), smem_bytes, raw_bytes (a piece's copy),
// buffers (a warp's copies: 0 without any, else 1 or 2) and dict_bytes:
// ops/group_agg.py launch_geometry.
int group_agg_launch(const void* const* planes, const long long* leaves,
                     int n_planes, const int32_t* desc, int n_desc,
                     const int32_t* params, int n_specs, long long n_rows,
                     int rows_per_block, long long* out, int grid_x,
                     int smem_bytes, int raw_bytes, int buffers,
                     int dict_bytes, void* stream) {
  if (n_desc != kDescWords) return kErrDescWords;
  Desc d{};
  d.n_cols = desc[0];
  d.n_preds = desc[1];
  d.n_group = desc[2];
  d.n_aggs = desc[3];
  d.n_params = desc[4];
  d.kp = desc[5];
  d.n_out = desc[6];
  if (d.n_cols < 0 || d.n_cols > kMaxCols || d.n_preds < 0 ||
      d.n_preds > kMaxPreds || d.n_group < 0 || d.n_group > kMaxGroup ||
      d.n_aggs < 0 || d.n_aggs > kMaxAggs || d.n_params < kParamHead) {
    return kErrCounts;
  }
  if (n_planes != 7 + 3 * d.n_cols || leaves == nullptr) return kErrPlanes;
  if (rows_per_block < 1) return kErrPlanes;
  // Each plane's leaf: kind, run slots, second and third array.
  auto leaf = [&](int k) {
    const long long* lw = leaves + kLeafWords * k;
    Leaf L{planes[k], reinterpret_cast<const void*>(lw[2]),
           reinterpret_cast<const void*>(lw[3]), static_cast<int32_t>(lw[0]),
           static_cast<int32_t>(lw[1]), static_cast<int32_t>(lw[4]),
           static_cast<int32_t>(lw[5])};
    return L;
  };
  for (int k = 0; k < n_planes; ++k) {
    const Leaf L = leaf(k);
    const bool flag = (k >= 4 && k < 7) || (k >= 7 && (k - 7) % 3 != 2);
    if (flag ? (L.kind != kPlain && L.kind != kBits)
             : (L.kind < kPlain || L.kind > kDict || L.kind == kBits ||
                (k < 4 && L.kind == kDict))) {
      return kErrPlanes;
    }
    if ((L.kind == kBits && rows_per_block % 32) ||
        ((L.kind == kRle || L.kind == kDict) && L.rc < 1) ||
        ((L.kind == kDelta16 || L.kind == kRle) && L.b == nullptr) ||
        (L.kind == kDict && (L.b == nullptr || L.c == nullptr))) {
      return kErrPlanes;
    }
  }
  const int32_t* w = desc + kHead;
  for (int c = 0; c < d.n_cols; ++c) {
    if (w[c] != 1 && w[c] != 2) return kErrPlanes;
    d.width[c] = w[c];
    d.set[c] = static_cast<const uint8_t*>(planes[7 + 3 * c]);
    d.isnull[c] = static_cast<const uint8_t*>(planes[8 + 3 * c]);
    d.bits_set |= static_cast<uint32_t>(leaf(7 + 3 * c).kind == kBits) << c;
    d.bits_null |= static_cast<uint32_t>(leaf(8 + 3 * c).kind == kBits) << c;
    d.col[c] = leaf(9 + 3 * c);
    if (d.col[c].kind == kDict && w[c] != 2) return kErrPlanes;
  }
  w += kMaxCols;
  uint32_t staged = 0;  // column slots predicates and group columns read
  uint32_t coded = 0;   // column slots code predicates read
  for (int q = 0; q < kMaxPreds; ++q, w += 4) {
    if (q >= d.n_preds) continue;
    const bool code = w[1] == kCodePlanes;
    const int planes_q = code ? 1 : w[1];
    if (w[0] < 0 || w[0] >= d.n_cols ||
        (!code && w[1] != 1 && w[1] != 2) ||
        (!code && d.width[w[0]] < w[1]) || w[2] < kEq || w[2] > kGe ||
        w[3] < kParamHead || w[3] + planes_q > d.n_params) {
      return kErrPred;
    }
    if (code && d.col[w[0]].kind != kDict &&
        (d.col[w[0]].kind != kPlain || d.col[w[0]].c == nullptr)) {
      return kErrPred;  // no code plane to compare
    }
    d.pred_col[q] = w[0];
    d.pred_planes[q] = planes_q;
    d.pred_op[q] = w[2];
    d.pred_lit[q] = w[3];
    if (code) {
      coded |= 1u << w[0];
    } else {
      staged |= 1u << w[0];
    }
  }
  int kp = 0;
  for (int g = 0; g < kMaxGroup; ++g, w += 2) {
    if (g >= d.n_group) continue;
    if (w[0] < 0 || w[0] >= d.n_cols || (w[1] != 1 && w[1] != 2) ||
        d.width[w[0]] < w[1]) {
      return kErrGroup;
    }
    d.grp_col[g] = w[0];
    d.grp_planes[g] = w[1];
    kp += w[1] + 1;
    staged |= 1u << w[0];
  }
  if (d.kp != (kp > 1 ? kp : 1)) return kErrGroup;
  int n_out = 2 + 2 * d.kp, n64 = 0;
  const int32_t* nodes = w + 6 * kMaxAggs;
  for (int a = 0; a < kMaxAggs; ++a, w += 6) {
    if (a >= d.n_aggs) continue;
    const bool sum = w[0] == kSum;
    if ((w[0] != kCount && !sum) || w[1] < (sum ? 0 : -1) ||
        w[1] >= d.n_cols || (sum && (w[2] < 1 || w[2] > d.width[w[1]])) ||
        w[4] < 0 || w[4] > (sum ? kMaxFactors : 0) ||
        (w[3] >> d.n_cols) != 0 || w[5] != n_out) {
      return kErrAgg;
    }
    d.agg_kind[a] = w[0];
    d.agg_col[a] = w[1];
    d.agg_planes[a] = w[2];
    d.agg_need[a] = static_cast<uint32_t>(w[3]);
    d.agg_nf[a] = w[4];
    d.agg_off[a] = w[5];
    d.agg_w32[a] = 2 + 2 * d.kp + a;
    d.agg_w64[a] = sum ? n64 : -1;
    d.agg_sum[a] = sum ? n64 / 2 : -1;
    n64 += sum ? 2 : 0;
    n_out += sum ? 3 : 1;
    for (int f = 0; f < d.agg_nf[a]; ++f) {
      const int32_t* prog = nodes + 2 * kMaxNodes * (kMaxFactors * a + f);
      int depth = 0;
      for (int k = 0; k < kMaxNodes; ++k) {
        const int32_t op = prog[2 * k], arg = prog[2 * k + 1];
        if (op == kEnd) break;
        if (op == kColumn && (arg < 0 || arg >= d.n_cols)) return kErrAgg;
        if (op < kEnd || op > kMul) return kErrAgg;
        depth += (op == kConst || op == kColumn) ? 1 : -1;
        if (depth < 1) return kErrAgg;
        d.node_op[a][f][k] = static_cast<int8_t>(op);
        d.node_arg[a][f][k] = arg;
      }
      if (depth != 1) return kErrAgg;
      affine(d, a, f);
    }
  }
  if (n_out != d.n_out) return kErrOutWidth;
  d.n64 = n64;
  d.n32 = 2 + 2 * d.kp + d.n_aggs;
  if (grid_x < 1 || n_specs < 1 || n_specs > 65535 || n_rows < 0 ||
      n_rows > (1ll << 31) - 1 - kPieceRows) {
    return kErrGrid;
  }
  // Staged words a row: the header, the staged columns' order words in
  // slot order, each sum's four limbs.
  int words = kHeadWords;
  int col_word[kMaxCols] = {}, code_word[kMaxCols] = {};
  for (int c = 0; c < d.n_cols; ++c) {
    if (!((staged >> c) & 1)) continue;
    d.stg_col[d.n_staged] = c;
    d.stg_width[d.n_staged] = d.width[c];
    d.stg_code[d.n_staged] = 0;
    d.stg_word[d.n_staged++] = col_word[c] = words;
    words += d.width[c];
  }
  // Code words in the order of the predicates that first read them
  // (ops/group_agg.py code_cols).
  const uint32_t code_cols = coded;
  for (int q = 0; q < d.n_preds; ++q) {
    const int c = d.pred_col[q];
    if (!((coded >> c) & 1)) continue;
    coded &= ~(1u << c);
    d.stg_col[d.n_staged] = c;
    d.stg_width[d.n_staged] = 1;
    d.stg_code[d.n_staged] = 1;
    d.stg_word[d.n_staged++] = code_word[c] = words;
    words += 1;
  }
  {
    const int32_t* pw = desc + kHead + kMaxCols;
    for (int q = 0; q < d.n_preds; ++q, pw += 4) {
      d.pred_word[q] = pw[1] == kCodePlanes ? code_word[d.pred_col[q]]
                                            : col_word[d.pred_col[q]];
    }
  }
  for (int g = 0; g < d.n_group; ++g) {
    d.grp_word[g] = col_word[d.grp_col[g]];
    for (int k = 0; k <= d.grp_planes[g]; ++k, ++d.n_kpl) {
      d.key_word[d.n_kpl] = k < d.grp_planes[g] ? d.grp_word[g] + k : -1;
      d.key_col[d.n_kpl] = d.grp_col[g];
    }
  }
  for (int a = 0; a < d.n_aggs; ++a) {
    if (d.agg_kind[a] != kSum) continue;
    d.limb_word[a] = words;
    words += 4;
    d.agg_width[a] = d.width[d.agg_col[a]];
    for (int f = 0; f < d.agg_nf[a]; ++f) {
      d.fac_width[a][f] = d.width[d.fac_col[a][f]];
    }
  }
  d.words = words;
  // Specs in balanced chunks of at most kMaxSpecChunk, one a grid.y.
  const int chunks = (n_specs + kMaxSpecChunk - 1) / kMaxSpecChunk;
  d.chunk = (n_specs + chunks - 1) / chunks;
  d.n_specs = n_specs;
  d.spec_bytes = (kSlots * (8 * d.n64 + 4 * d.n32) +
                  4 * d.n_params + 15) & ~15;
  uint32_t value_cols = staged;  // slots whose order planes staging reads
  for (int a = 0; a < d.n_aggs; ++a) {
    if (d.agg_kind[a] != kSum) continue;
    value_cols |= 1u << d.agg_col[a];
    for (int f = 0; f < d.agg_nf[a]; ++f) {
      for (int k = 0; k < kMaxNodes; ++k) {
        if (d.node_op[a][f][k] == kColumn) value_cols |= 1u << d.node_arg[a][f][k];
      }
    }
  }
  // The encoded build where a plane the staging reads (every flag and
  // time plane, the order planes of value_cols and code_cols) is encoded:
  // a table whose encoded leaves the staging never reads takes the plain
  // build.
  bool enc = false;
  for (int k = 0; k < n_planes; ++k) {
    const bool read = k < 9 || (k - 7) % 3 != 2 ||
                      (((value_cols | code_cols) >> ((k - 7) / 3)) & 1u);
    enc = enc || (read && leaf(k).kind != kPlain);
  }
  // The copied planes and the shared dictionaries, back to back in plane
  // order; every copied array 16-byte aligned.
  int copied = 0, dict_entries = 0;
  uint32_t copied_mask[2] = {0, 0}, dict_shared = 0, dict_cached = 0;
  for (int k = 0; k < n_planes; ++k) {
    const Leaf L = leaf(k);
    const bool cmp = k >= 7 && (k - 7) % 3 == 2;
    if (L.dsh >= 0) {
      if (L.kind != kDict || L.dsh != dict_entries) return kErrCopy;
      dict_entries += L.rc;
      dict_shared |= 1u << ((k - 7) / 3);
    } else if (L.kind == kDict && ((value_cols >> ((k - 7) / 3)) & 1u)) {
      dict_cached |= 1u << ((k - 7) / 3);
    }
    if (L.raw < 0) continue;
    if (!enc || L.kind == kPlain || L.kind == kConstLeaf ||
        L.raw != 16 * copied || d.n_copies >= kMaxPlanes) {
      return kErrCopy;
    }
    const void* src = L.kind == kDelta16 ? L.b : L.a;
    if (reinterpret_cast<uintptr_t>(src) & 15u) return kErrCopy;
    const int width = cmp ? d.width[(k - 7) / 3] : 1;
    const int chunks = L.kind == kBits ? 1
                       : L.kind == kDelta16 ? 16 * width
                                            : 16;
    d.cp_plane[d.n_copies] = static_cast<int8_t>(k);
    d.cp_first[d.n_copies++] = static_cast<int16_t>(copied);
    copied += chunks;
    copied_mask[k >> 5] |= 1u << (k & 31);
  }
  d.cp_first[d.n_copies] = static_cast<int16_t>(copied);
  d.raw_chunks = copied;
  d.raw_bytes = 16 * copied;
  d.buffers = buffers;
  d.dict_bytes = (8 * dict_entries + 15) & ~15;
  if (d.raw_bytes != raw_bytes || d.dict_bytes != dict_bytes ||
      buffers < 0 || buffers > 2 || (buffers == 0) != (copied == 0)) {
    return kErrCopy;
  }
  const long long need = static_cast<long long>(d.chunk) * d.spec_bytes +
                         4ll * kWarps * kPieceRows * words +
                         static_cast<long long>(kWarps) * buffers * raw_bytes +
                         dict_bytes +
                         ((16 * d.n_copies + 2 * copied + 15) & ~15);
  if (need != smem_bytes || need + kStaticBytes > kSmemLimit) return kErrShared;
  for (int k = 0; k < n_planes; ++k) {
    if (reinterpret_cast<uintptr_t>(planes[k]) & 15u) return kErrAlign;
  }
  if (n_rows % kRows) return kErrAlign;
  for (int c = 0; c < d.n_cols; ++c) {
    if (d.col[c].c != nullptr && d.col[c].kind == kPlain &&
        (reinterpret_cast<uintptr_t>(d.col[c].c) & 15u)) {
      return kErrAlign;
    }
  }
  d.ht_hi = leaf(0);
  d.ht_lo = leaf(1);
  d.exp_hi = leaf(2);
  d.exp_lo = leaf(3);
  d.valid = static_cast<const uint8_t*>(planes[4]);
  d.tomb = static_cast<const uint8_t*>(planes[5]);
  d.live = static_cast<const uint8_t*>(planes[6]);
  d.bits_top = static_cast<uint32_t>(leaf(4).kind == kBits) |
               static_cast<uint32_t>(leaf(5).kind == kBits) << 1 |
               static_cast<uint32_t>(leaf(6).kind == kBits) << 2;
  d.rows_per_block = rows_per_block;
  d.n_rows = static_cast<int32_t>(n_rows);
  for (int c = d.n_cols; c < kMaxCols; ++c) d.set[c] = d.isnull[c] = d.valid;
  for (int c = d.n_cols; c < kMaxCols; ++c) {
    d.bits_set |= (d.bits_top & 1u) << c;
    d.bits_null |= (d.bits_top & 1u) << c;
  }
  d.col_mask = (1u << d.n_cols) - 1;
  // Each bits flag plane's offset in a piece's copy (slots past n_cols
  // read the valid plane).
  for (int i = 0; i < 3 + 2 * kMaxCols; ++i) {
    const int k = i < 3 + 2 * d.n_cols ? 4 + i + (i >= 3 ? (i - 3) / 2 : 0)
                                       : 4;
    d.flag_raw[i] = static_cast<int16_t>(leaf(k).raw);
  }
  d.one_block = rows_per_block % kPieceRows == 0;
  const auto kernel = pick_kernel(d.n_cols, enc ? (buffers ? 2 : 1) : 0);
  if (smem_bytes > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total =
      static_cast<long long>(n_specs) * (kNumBuckets + 1) * d.n_out;
  const long long init_need = (total + kThreads - 1) / kThreads;
  const int init_blocks = static_cast<int>(init_need < 4096 ? init_need : 4096);
  group_agg_init<<<init_blocks, kThreads, 0, s>>>(out, total, d.n_out, d.kp);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3(grid_x, chunks), kThreads, smem_bytes, s>>>(d, params, out);
  const int32_t geo[kGeoWords] = {
      enc, kThreads, grid_x, chunks, d.chunk, smem_bytes, raw_bytes, buffers,
      dict_bytes, static_cast<int32_t>(copied_mask[0]),
      static_cast<int32_t>(copied_mask[1]), static_cast<int32_t>(dict_shared),
      static_cast<int32_t>(dict_cached)};
  for (int i = 0; i < kGeoWords; ++i) g_last_launch[i] = geo[i];
  return static_cast<int>(cudaGetLastError());
}

// The shape of this process's last launch (kGeoWords words, as
// g_last_launch says).
void group_agg_last_launch(int32_t* out) {
  for (int i = 0; i < kGeoWords; ++i) out[i] = g_last_launch[i];
}

// Blocks of the kernel's build (0 plain, 1 encoded, 2 encoded with the
// copies) one SM holds at once for a table of n_cols value columns and
// smem_bytes of dynamic shared memory (registers, threads and shared
// memory all counted), or a negative CUDA error code.
int group_agg_occupancy(int n_cols, int smem_bytes, int build) {
  if (build < 0 || build > 2) return -static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pick_kernel(n_cols, build);
  if (smem_bytes > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return -static_cast<int>(rc);
  }
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, smem_bytes);
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

const char* group_agg_error_string(int code) {
  switch (code) {
    case kErrDescWords: return "descriptor has the wrong number of words";
    case kErrCounts: return "descriptor counts out of range";
    case kErrPlanes: return "plane table does not match the columns";
    case kErrPred: return "bad predicate descriptor";
    case kErrGroup: return "bad group-column descriptor";
    case kErrAgg: return "bad aggregate descriptor";
    case kErrOutWidth: return "output row width disagrees with the aggregates";
    case kErrGrid: return "bad grid, spec count or row count";
    case kErrShared: return "shared-memory bytes disagree with the layout";
    case kErrAlign:
      return "a plane is not 16-byte aligned or the rows are not a multiple of 4";
    case kErrCopy:
      return "the copied planes or shared dictionaries disagree with the leaves";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
