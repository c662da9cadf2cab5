// The row path's two kernels for Hopper (sm_90a): K7, the packed row
// gather, and K9, the candidate scan.
//
// K7 (row_gather_launch) replaces the JAX package's
// ops/row_gather.py:143 gather_rows, vmapped over G pages by
// compiled_gather_batch (:208). K9 (scan_window_launch) replaces the
// row-scan form of ops/scan.py:320 scan_window (compiled_scan, :450).
// Both are built on the window resolve of ops/scan.py:143
// resolve_window, and both give its answers int for int, garbage entries
// included (ops/scan.py in the port says which).
//
// A window is K blocks of R rows of a run (N = K * R rows); key groups
// (a key's versions, newest first) never cross a block, and a block's
// first row always starts one (storage/columnar.py). Per key group, at a
// read point:
//   - the first visible tombstone (the newest) shadows every version at
//     or below its hybrid time (the same-batch DELETE + write tie
//     included);
//   - alive = visible, not a tombstone, not shadowed; liveness is an
//     alive, unexpired version with the marker;
//   - per column, the first alive setter is the latest value; its NULL
//     bit or its expiry makes the column NULL. Where a column has no
//     alive setter its planes are read from a stand-in row: the window's
//     last row on a multi-version run, the row itself on a flat one;
//   - the group exists through liveness or any non-NULL column, and
//     matches when it lies in the row bounds and (K7 always, K9 when
//     apply_preds) passes every predicate on its merged values ('str'
//     and 'f32' predicates as supersets the host verifies).
//
// What bounds them: bytes. Per row walked: the flags, the hybrid time and
// the expiry (20 bytes), each value column's set and isnull flags, and
// the order and arithmetic planes of the predicate and output columns at
// each group's setters; then the output once. A few dozen integer
// operations a row are far below the card's integer rate.
//
// The design (the window of a K7 page, or of K9, is one thread block
// cluster):
//
//   1. A cluster of C = min(K, 8) blocks walks one window; block rank r
//      takes run blocks [r * P, min(K, (r + 1) * P)) of it, P = ceil(K / C),
//      so on the main path (K = 8) each block holds one run block.
//   2. Stage. A block copies a piece of its run block (the whole block up
//      to kPieceMax rows) into shared memory: the valid, group-start,
//      tombstone and liveness flags, the hybrid time and expiry, each
//      column's set and isnull flags (21 + 2 * columns bytes a row, with
//      the answer byte), by 16-byte cp.async copies where every plane and
//      the piece are 16-byte aligned, else row by row. Order and
//      arithmetic planes are read only at the setters.
//   3. Resolve by warp steps from shared memory (the method of
//      csrc/mvcc_resolve.cu). Each warp owns the groups that start in its
//      eighth of the piece and moves from group start to group start in
//      32-row windows, a lane a row: ballots of the group starts give each
//      lane its group, and one ballot and __ffs each give the group's first
//      visible tombstone (known before any row is called alive: the tie),
//      its liveness and each column's first alive setter and that
//      setter's NULL bit. A group longer than a window goes in warp steps
//      of kUnroll x 32 rows (resolve_long). A group of L versions costs
//      about L / 32 warp steps. Predicates are read at the setters. Each
//      group's first row records its answer (a group, a match) in a byte.
//   4. Rank. Each block counts its groups, matches and counted groups
//      (at or past scan_from), pushes the counts into every block of the
//      cluster (distributed shared memory) and meets them at
//      cluster.sync(); each block then has its exclusive prefix and the
//      window's totals, so every block takes the same decision on
//      whether a K7 page walks on.
//   5. Write. Each warp walks its groups again in order: K9 writes each
//      group's flag and first row at its window-wide group id from the
//      answer bytes; K7 resolves the groups it writes once more from
//      shared memory (only the warps that hold one of a page's first M
//      matches, in paged mode) and writes their rows: the start row, and
//      each output column's setter planes, NULL flag and setter row.
//
// A block whose run block is longer than kPieceMax rows stages it in
// pieces, and a group that runs past its piece reads the rest from the
// run; such a block resolves each piece a second time to write it.
//
// Interface: plain C, for ctypes. Each launch function returns 0, a
// negative code for an argument it refuses, or the launch's error.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Each block's shared memory: the Head, then the staged piece.
extern __shared__ __align__(16) uint8_t s_dyn[];

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Blocks per SM the register cap is set for.
constexpr int kMinBlocks = 2;
constexpr int kMaxCols = 16;
constexpr int kMaxPreds = 16;
constexpr int kMaxOut = 16;
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable limit)
constexpr int kPieceMax = 2048;  // rows staged at once
constexpr int kUnroll = 2;  // 32-row steps loaded together in a long group
constexpr int kParamFixed = 9;  // w_first, w_last, row_lo, row_hi, read
                                // hi/lo, expiry hi/lo, scan_from
constexpr int kHeadBytes = 512;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kBias = 0x80000000u;

// Predicate kinds and operators (ops/row_gather.py KIND_CODES, OP_CODES).
enum Kind { kI32 = 0, kI64 = 1, kF64 = 2, kStr = 3, kF32 = 4 };
enum Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

constexpr int kErrCols = -1;
constexpr int kErrPreds = -2;
constexpr int kErrOut = -3;
constexpr int kErrShape = -4;
constexpr int kErrPlane = -5;
constexpr int kErrParams = -6;

// The launch's descriptor, a __grid_constant__ kernel parameter: read in
// place (its arrays indexed at run time), never copied to local memory.
struct Sig {
  const uint8_t* valid;
  const uint8_t* group_start;
  const uint8_t* tomb;
  const uint8_t* live;
  const int32_t* ht_hi;
  const int32_t* ht_lo;
  const int32_t* exp_hi;
  const int32_t* exp_lo;
  const uint8_t* set[kMaxCols];
  const uint8_t* isnull[kMaxCols];
  const int32_t* pred_cmp[kMaxPreds];   // the predicate column's planes
  const float* pred_arith[kMaxPreds];
  const int32_t* out_cmp[kMaxOut];      // the output column's planes
  int8_t pred_col[kMaxPreds];   // column slot
  int8_t pred_kind[kMaxPreds];
  int8_t pred_op[kMaxPreds];
  int8_t pred_lit[kMaxPreds];   // offset among the int or float literals
  int8_t pred_width[kMaxPreds];
  int8_t out_col[kMaxOut];      // column slot
  int8_t out_planes[kMaxOut];
  int8_t out_want_idx[kMaxOut];
  int8_t out_width[kMaxOut];
  int n_cols, n_preds, n_out, apply_preds;
  int R, K, N, M, W;
  int flat;
  int P, F;         // params per page: ints, floats
  int cluster;      // blocks a cluster
  int per_block;    // run blocks a block of the cluster
  int piece;        // rows staged at once
  int aligned;      // stage by 16-byte cp.async copies
};

struct Page {
  int32_t w_first, w_last, row_lo, row_hi, scan_from;
  uint64_t read, rexp;  // read and expiry points, as ordered keys
};

// The fixed head of shared memory: the page's literals, each warp's
// counts of the piece, and the counts the cluster's blocks push to each
// other, by window parity.
struct Head {
  int32_t lit_i[2 * kMaxPreds];
  float lit_f[kMaxPreds];
  int32_t cnt[3][kWarps];  // groups, matches, counted groups
  int32_t xchg[2][kMaxCluster][3];
};
static_assert(sizeof(Head) <= kHeadBytes, "the head outgrew its bytes");

struct Counts {
  int lead, match, counted;
};

// The staged piece, after the head: four word planes (hybrid time hi/lo,
// expiry hi/lo), four flag planes, the columns' set flags, their isnull
// flags, and the answer bytes, `piece` entries each.
enum { kPlaneValid, kPlaneStart, kPlaneTomb, kPlaneLive };
enum { kWordHtHi, kWordHtLo, kWordExpHi, kWordExpLo };
enum : uint8_t { kLead = 1, kMatch = 2 };

__device__ __forceinline__ Head& head() {
  return *reinterpret_cast<Head*>(s_dyn);
}
__device__ __forceinline__ int32_t* s_word(const Sig& s, int k) {
  return reinterpret_cast<int32_t*>(s_dyn + kHeadBytes) + k * s.piece;
}
__device__ __forceinline__ uint8_t* s_flag(const Sig& s, int k) {
  return s_dyn + kHeadBytes + (16 + k) * s.piece;
}
__device__ __forceinline__ uint8_t* s_set(const Sig& s, int c) {
  return s_dyn + kHeadBytes + (20 + c) * s.piece;
}
__device__ __forceinline__ uint8_t* s_null(const Sig& s, int c) {
  return s_dyn + kHeadBytes + (20 + s.n_cols + c) * s.piece;
}
__device__ __forceinline__ uint8_t* s_ans(const Sig& s) {
  return s_dyn + kHeadBytes + (20 + 2 * s.n_cols) * s.piece;
}

// (hi, lo) int32 planes, compared lexicographically as signed words ->
// one unsigned 64-bit key of the same order.
__host__ __device__ __forceinline__ uint64_t ordered_key(int32_t hi,
                                                         int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi) ^ kBias) << 32) |
         (static_cast<uint32_t>(lo) ^ kBias);
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(kFull, static_cast<uint32_t>(v), src);
  const uint32_t hi = __shfl_sync(kFull, static_cast<uint32_t>(v >> 32), src);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Lanes [lo, hi) as a mask; 0 <= lo < 32, lo <= hi <= 32.
__device__ __forceinline__ uint32_t lanes(int lo, int hi) {
  const uint32_t below_hi = hi >= 32 ? kFull : (1u << hi) - 1u;
  return below_hi & ~((1u << lo) - 1u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copies `bytes` (a multiple of 16) with the block's threads, 16 bytes
// each, without waiting.
__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           int bytes) {
  for (int k = threadIdx.x; k < bytes / 16; k += kThreads) {
    cp_async16(static_cast<uint8_t*>(smem) + 16 * k,
               static_cast<const uint8_t*>(gmem) + 16 * k);
  }
}

// Stages rows [lo, lo + n) of the run and clears their answer bytes.
__device__ __forceinline__ void stage(const Sig& s, int32_t lo, int32_t n) {
  if (s.aligned) {
    copy_async(s_word(s, kWordHtHi), s.ht_hi + lo, 4 * n);
    copy_async(s_word(s, kWordHtLo), s.ht_lo + lo, 4 * n);
    copy_async(s_word(s, kWordExpHi), s.exp_hi + lo, 4 * n);
    copy_async(s_word(s, kWordExpLo), s.exp_lo + lo, 4 * n);
    copy_async(s_flag(s, kPlaneValid), s.valid + lo, n);
    if (!s.flat) copy_async(s_flag(s, kPlaneStart), s.group_start + lo, n);
    copy_async(s_flag(s, kPlaneTomb), s.tomb + lo, n);
    copy_async(s_flag(s, kPlaneLive), s.live + lo, n);
    for (int c = 0; c < s.n_cols; ++c) {
      copy_async(s_set(s, c), s.set[c] + lo, n);
      copy_async(s_null(s, c), s.isnull[c] + lo, n);
    }
    cp_async_wait_all();
  } else {
    for (int32_t i = threadIdx.x; i < n; i += kThreads) {
      const int32_t row = lo + i;
      s_word(s, kWordHtHi)[i] = __ldg(s.ht_hi + row);
      s_word(s, kWordHtLo)[i] = __ldg(s.ht_lo + row);
      s_word(s, kWordExpHi)[i] = __ldg(s.exp_hi + row);
      s_word(s, kWordExpLo)[i] = __ldg(s.exp_lo + row);
      s_flag(s, kPlaneValid)[i] = __ldg(s.valid + row);
      if (!s.flat) s_flag(s, kPlaneStart)[i] = __ldg(s.group_start + row);
      s_flag(s, kPlaneTomb)[i] = __ldg(s.tomb + row);
      s_flag(s, kPlaneLive)[i] = __ldg(s.live + row);
      for (int c = 0; c < s.n_cols; ++c) {
        s_set(s, c)[i] = __ldg(s.set[c] + row);
        s_null(s, c)[i] = __ldg(s.isnull[c] + row);
      }
    }
  }
  uint8_t* ans = s_ans(s);
  for (int32_t i = threadIdx.x; i < n; i += kThreads) ans[i] = 0;
}

// One lane's row of a step.
enum : uint32_t {
  kValid = 1, kStart = 2, kTomb = 4, kLive = 8, kIn = 16,
  kNextStart = 32,  // lane 31 of a window: the row after it starts a group
};

struct Row {
  uint32_t flags;
  uint32_t sets;   // bit c: column c set
  uint32_t nulls;  // bit c: column c's isnull flag
  uint64_t ht;
  uint64_t exp;
};

// Row `row` below `lim` (its run block's end), from the piece [lo, hi)
// or, past it, from the run; rows at or past `lim` are not in.
__device__ __forceinline__ Row load_row(const Sig& s, int32_t lo, int32_t hi,
                                        int32_t row, int32_t lim) {
  Row x{0, 0, 0, 0, ~0ull};
  if (row >= lim) return x;
  if (row < hi) {
    const int32_t i = row - lo;
    x.flags = kIn | (s_flag(s, kPlaneValid)[i] ? kValid : 0) |
              (s.flat || s_flag(s, kPlaneStart)[i] ? kStart : 0) |
              (s_flag(s, kPlaneTomb)[i] ? kTomb : 0) |
              (s_flag(s, kPlaneLive)[i] ? kLive : 0);
    for (int c = 0; c < s.n_cols; ++c) {
      if (s_set(s, c)[i]) x.sets |= 1u << c;
      if (s_null(s, c)[i]) x.nulls |= 1u << c;
    }
    x.ht = ordered_key(s_word(s, kWordHtHi)[i], s_word(s, kWordHtLo)[i]);
    x.exp = ordered_key(s_word(s, kWordExpHi)[i], s_word(s, kWordExpLo)[i]);
  } else {
    x.flags = kIn | (__ldg(s.valid + row) ? kValid : 0) |
              (s.flat || __ldg(s.group_start + row) ? kStart : 0) |
              (__ldg(s.tomb + row) ? kTomb : 0) |
              (__ldg(s.live + row) ? kLive : 0);
    for (int c = 0; c < s.n_cols; ++c) {
      if (__ldg(s.set[c] + row)) x.sets |= 1u << c;
      if (__ldg(s.isnull[c] + row)) x.nulls |= 1u << c;
    }
    x.ht = ordered_key(__ldg(s.ht_hi + row), __ldg(s.ht_lo + row));
    x.exp = ordered_key(__ldg(s.exp_hi + row), __ldg(s.exp_lo + row));
  }
  return x;
}

__device__ __forceinline__ bool starts_group(const Sig& s, int32_t lo,
                                             int32_t hi, int32_t row) {
  if (s.flat) return true;
  return row < hi ? s_flag(s, kPlaneStart)[row - lo] != 0
                  : __ldg(s.group_start + row) != 0;
}

// A window's row, and for lane 31 whether the row after the window starts
// a group (the run block's end counts).
__device__ __forceinline__ Row load_window(const Sig& s, int32_t lo,
                                           int32_t hi, int32_t cur,
                                           int32_t lim, int lane) {
  const int32_t row = cur + lane;
  Row x = load_row(s, lo, hi, row, lim);
  if (lane == 31 && (row + 1 >= lim || starts_group(s, lo, hi, row + 1))) {
    x.flags |= kNextStart;
  }
  return x;
}

// The first group start at or after `cur` (in the run block ending at
// `lim`), or a row at or past `end`.
__device__ __forceinline__ int32_t first_start(const Sig& s, int32_t lo,
                                               int32_t hi, int32_t cur,
                                               int32_t lim, int32_t end,
                                               int lane) {
  if (s.flat || cur == lim - s.R) return cur;  // a run block's first row
  while (cur < end) {
    const int32_t row = cur + lane;
    const uint32_t b =
        __ballot_sync(kFull, row < lim && starts_group(s, lo, hi, row));
    if (b) return cur + __ffs(b) - 1;
    cur = min(cur + 32, lim);
    if (cur == lim) return cur;
  }
  return end;
}

// A lane's group in a window step.
struct Grp {
  uint32_t group;  // the lanes of the lane's group
  bool lead;       // the lane is the first row of a group resolved here
  bool alive;
  bool expired;
};

// Resolves, from the loaded rows, the groups of the 32-row window at group
// start `cur` that start before `own_end`, in one step. Returns the rows
// resolved, up to the first group it leaves open, or 0 when the group at
// `cur` is longer than the window.
__device__ __forceinline__ int window_step(const Page& p, const Row& x,
                                           int32_t cur, int32_t lim,
                                           int32_t own_end, int lane,
                                           Grp* g) {
  const bool in = x.flags & kIn;
  // Group starts; lanes past the run block close the last group.
  const uint32_t starts =
      __ballot_sync(kFull, !in || lane == 0 || (x.flags & kStart));
  const uint32_t own = lanes(0, min(32, min(own_end, lim) - cur));
  const int h = 31 - __clz(starts & own);  // the last group this warp owns
  const uint32_t above = starts & ~lanes(0, h + 1);
  int e;
  if (above) {
    e = __ffs(above) - 1;
  } else if (__ballot_sync(kFull, x.flags & kNextStart)) {
    e = 32;
  } else if (h > 0) {
    e = h;  // the group at h starts the next window
  } else {
    return 0;
  }
  const uint32_t upto = lanes(0, lane + 1);
  const int first = 31 - __clz(starts & upto);
  const uint32_t after = starts & ~upto;
  g->group = lanes(first, after ? __ffs(after) - 1 : 32);
  g->lead = lane < e && lane == first;
  const bool vis = (x.flags & kValid) && x.ht <= p.read;
  const uint32_t tombs =
      __ballot_sync(kFull, vis && (x.flags & kTomb)) & g->group;
  const uint64_t t_key = shfl64(x.ht, tombs ? __ffs(tombs) - 1 : 0);
  g->alive = vis && !(x.flags & kTomb) && !(tombs && x.ht <= t_key);
  g->expired = x.exp <= p.rexp;
  return e;
}

// Column slot c of the lane's group: the lane of its first alive setter,
// or -1, and whether the merged value is not NULL.
__device__ __forceinline__ int col_setter(const Grp& g, const Row& x, int c,
                                          bool* notnull) {
  const uint32_t found =
      __ballot_sync(kFull, g.alive && (x.sets >> c & 1u)) & g.group;
  const uint32_t nn =
      __ballot_sync(kFull, !(x.nulls >> c & 1u) && !g.expired);
  const int sl = found ? __ffs(found) - 1 : -1;
  *notnull = sl >= 0 && (nn >> sl & 1u);
  return sl;
}

// Predicate i on the planes of global row `row`.
__device__ __forceinline__ bool eval_pred(const Sig& s, int i, int32_t row,
                                          const Head& h) {
  const int op = s.pred_op[i];
  const int kind = s.pred_kind[i];
  const int lit = s.pred_lit[i];
  if (kind == kF32) {
    const float v = __ldg(s.pred_arith[i] + row);
    const float x = h.lit_f[lit];
    switch (op) {
      case kEq: return v == x;
      case kNe: return true;
      case kLt: case kLe: return v <= x;
      default: return v >= x;
    }
  }
  const int32_t* cmp =
      s.pred_cmp[i] + static_cast<int64_t>(row) * s.pred_width[i];
  if (kind == kI32) {
    const int32_t v = __ldg(cmp);
    const int32_t x = h.lit_i[lit];
    switch (op) {
      case kEq: return v == x;
      case kNe: return v != x;
      case kLt: return v < x;
      case kLe: return v <= x;
      case kGt: return v > x;
      default: return v >= x;
    }
  }
  const uint64_t v = ordered_key(__ldg(cmp), __ldg(cmp + 1));
  const uint64_t x = ordered_key(h.lit_i[lit], h.lit_i[lit + 1]);
  if (kind == kStr) {  // prefix planes: equal planes are maybe-matches
    switch (op) {
      case kEq: return v == x;
      case kNe: return true;
      case kLt: case kLe: return v <= x;
      default: return v >= x;
    }
  }
  switch (op) {
    case kEq: return v == x;
    case kNe: return v != x;
    case kLt: return v < x;
    case kLe: return v <= x;
    case kGt: return v > x;
    default: return v >= x;
  }
}

// A group's answer: it exists in range (pre), it matches, it is counted.
struct Flags {
  bool pre, match, counted;
};

enum Mode { kPaged = 0, kChunks = 1, kCandidates = 2 };

template <int kMode>
__device__ __forceinline__ bool applies_preds(const Sig& s) {
  return kMode != kCandidates || s.apply_preds;
}

// The answers of the groups a window step resolved, at their lead lanes.
template <int kMode>
__device__ __forceinline__ Flags window_flags(const Sig& s, const Page& p,
                                              const Head& h, const Row& x,
                                              const Grp& g, int32_t cur,
                                              int lane) {
  bool exists = (__ballot_sync(kFull, g.alive && (x.flags & kLive) &&
                                          !g.expired) & g.group) != 0;
  for (int c = 0; c < s.n_cols; ++c) {
    if (!__ballot_sync(kFull, g.lead && !exists)) break;
    bool nn;
    col_setter(g, x, c, &nn);
    exists = exists || nn;
  }
  const int32_t row = cur + lane;
  const bool pre = g.lead && exists && row >= p.row_lo && row < p.row_hi;
  bool match = pre;
  if (applies_preds<kMode>(s)) {
    for (int i = 0; i < s.n_preds; ++i) {
      if (!__ballot_sync(kFull, match)) break;
      bool nn;
      const int sl = col_setter(g, x, s.pred_col[i], &nn);
      match = match && nn && eval_pred(s, i, cur + sl, h);
    }
  }
  return {pre, match, pre && row >= p.scan_from};
}

// A group longer than a window, resolved in warp steps: its end, its
// liveness, and in lane c < n_cols column c's first alive setter (a
// global row, or -1) and whether its value is not NULL.
struct Long {
  int32_t end;
  bool live;
  int32_t setter;
  bool notnull;
};

// Resolves the group that starts at `start` (run block end `lim`) in warp
// steps of kUnroll x 32 rows.
__device__ __forceinline__ Long resolve_long(const Sig& s, const Page& p,
                                             int32_t lo, int32_t hi,
                                             int32_t start, int32_t lim,
                                             int lane) {
  // Sweep 1: the group's first visible tombstone, whether it has a valid
  // row, and where it ends when it has no tombstone.
  bool has_tomb = false, any_valid = false;
  uint64_t t_key = 0;
  int32_t end = lim;
  for (int32_t base = start; base < end && !has_tomb;
       base += 32 * kUnroll) {
    Row x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = load_row(s, lo, hi, base + 32 * u + lane, end);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t step = base + 32 * u;
      if (step >= end || has_tomb) break;
      const int32_t row = step + lane;
      const uint32_t ends =
          __ballot_sync(kFull, !(x[u].flags & kIn) ||
                                   ((x[u].flags & kStart) && row != start));
      const uint32_t group = ends ? lanes(0, __ffs(ends) - 1) : kFull;
      if (ends) end = step + __ffs(ends) - 1;
      any_valid = any_valid ||
                  (__ballot_sync(kFull, x[u].flags & kValid) & group) != 0;
      const uint32_t tombs =
          __ballot_sync(kFull, (x[u].flags & kValid) &&
                                   (x[u].flags & kTomb) && x[u].ht <= p.read) &
          group;
      if (tombs) {
        has_tomb = true;
        t_key = shfl64(x[u].ht, __ffs(tombs) - 1);
      }
    }
  }
  // Sweep 2: liveness and the first alive setter of each column (found: a
  // warp-uniform mask), until every answer is known; then only the
  // group's end is sought. A group without a valid row has no answer.
  const uint32_t all = (1u << s.n_cols) - 1u;
  bool live = false;
  uint32_t found = 0;
  Long out{lim, false, -1, false};
  int32_t base = start;
  if (any_valid) end = lim;
  for (; any_valid && base < end && !(live && found == all);
       base += 32 * kUnroll) {
    Row x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = load_row(s, lo, hi, base + 32 * u + lane, end);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t step = base + 32 * u;
      if (step >= end) break;
      const int32_t row = step + lane;
      const uint32_t ends =
          __ballot_sync(kFull, !(x[u].flags & kIn) ||
                                   ((x[u].flags & kStart) && row != start));
      const uint32_t group = ends ? lanes(0, __ffs(ends) - 1) : kFull;
      if (ends) end = step + __ffs(ends) - 1;
      const bool alive = (group >> lane & 1u) && (x[u].flags & kValid) &&
                         !(x[u].flags & kTomb) && x[u].ht <= p.read &&
                         !(has_tomb && x[u].ht <= t_key);
      const bool expired = x[u].exp <= p.rexp;
      live = live || __ballot_sync(kFull, alive && (x[u].flags & kLive) &&
                                              !expired) != 0;
      for (int c = 0; c < s.n_cols; ++c) {
        if (found >> c & 1u) continue;
        const uint32_t setters =
            __ballot_sync(kFull, alive && (x[u].sets >> c & 1u));
        if (setters) {
          found |= 1u << c;
          const int sl = __ffs(setters) - 1;
          const uint32_t nn =
              __ballot_sync(kFull, !(x[u].nulls >> c & 1u) && !expired);
          if (lane == c) {
            out.setter = step + sl;
            out.notnull = nn >> sl & 1u;
          }
        }
      }
    }
  }
  // The rest of the group: its end only.
  for (; base < end; base += 32) {
    const int32_t row = base + lane;
    const uint32_t ends = __ballot_sync(
        kFull, row >= end || (row != start && starts_group(s, lo, hi, row)));
    if (ends) end = base + __ffs(ends) - 1;
  }
  out.end = end;
  out.live = live;
  return out;
}

// The answer of a long group (every lane the same).
template <int kMode>
__device__ __forceinline__ Flags long_flags(const Sig& s, const Page& p,
                                            const Head& h, const Long& L,
                                            int32_t start, int lane) {
  const bool exists =
      L.live || __ballot_sync(kFull, lane < s.n_cols && L.notnull) != 0;
  const bool pre = exists && start >= p.row_lo && start < p.row_hi;
  bool match = pre;
  if (applies_preds<kMode>(s)) {
    for (int i = 0; i < s.n_preds; ++i) {
      if (!match) break;
      const int c = s.pred_col[i];
      const int32_t row = __shfl_sync(kFull, L.setter, c);
      const bool nn = __shfl_sync(kFull, L.notnull ? 1 : 0, c) != 0;
      match = nn && eval_pred(s, i, row, h);
    }
  }
  return {pre, match, pre && start >= p.scan_from};
}

// Warp `warp`'s span of the piece [lo, hi): it owns the groups that start
// there.
__device__ __forceinline__ void warp_span(int32_t lo, int32_t hi, int warp,
                                          int32_t* span_lo,
                                          int32_t* span_hi) {
  const int32_t span = (hi - lo + kWarps - 1) / kWarps;
  *span_lo = min(hi, lo + span * warp);
  *span_hi = min(hi, *span_lo + span);
}

// Resolves the staged piece [lo, hi) (run block end `lim`): each group's
// answer byte at its first row, each warp's counts in the head.
template <int kMode>
__device__ __forceinline__ void resolve_piece(const Sig& s, const Page& p,
                                              int32_t lo, int32_t hi,
                                              int32_t lim) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Head& h = head();
  uint8_t* ans = s_ans(s);
  int32_t span_lo, span_hi;
  warp_span(lo, hi, warp, &span_lo, &span_hi);
  int n_lead = 0, n_match = 0, n_counted = 0;
  // A paged walk needs no group out of the row bounds.
  const bool skip = span_lo >= span_hi ||
                    (kMode == kPaged &&
                     (span_hi <= p.row_lo || span_lo >= p.row_hi));
  int32_t cur = skip ? span_hi
                     : first_start(s, lo, hi, span_lo, lim, span_hi, lane);
  while (cur < span_hi) {
    const Row x = load_window(s, lo, hi, cur, lim, lane);
    Grp g;
    const int e = window_step(p, x, cur, lim, span_hi, lane, &g);
    if (e > 0) {
      const Flags f = window_flags<kMode>(s, p, h, x, g, cur, lane);
      if (g.lead) ans[cur + lane - lo] = kLead | (f.match ? kMatch : 0);
      n_lead += __popc(__ballot_sync(kFull, g.lead));
      n_match += __popc(__ballot_sync(kFull, f.match));
      n_counted += __popc(__ballot_sync(kFull, f.counted));
      cur += e;
    } else {
      const Long L = resolve_long(s, p, lo, hi, cur, lim, lane);
      const Flags f = long_flags<kMode>(s, p, h, L, cur, lane);
      if (lane == 0) ans[cur - lo] = kLead | (f.match ? kMatch : 0);
      n_lead += 1;
      n_match += f.match;
      n_counted += f.counted;
      cur = L.end;
    }
  }
  if (lane == 0) {
    h.cnt[0][warp] = n_lead;
    h.cnt[1][warp] = n_match;
    h.cnt[2][warp] = n_counted;
  }
}

// One output row: [start | per output column: planes, null, (setter row)],
// zeros up to W; lanes with `need` write theirs. A column without an alive
// setter reads the stand-in row.
__device__ __forceinline__ void write_window_row(const Sig& s, const Row& x,
                                                 const Grp& g, int32_t cur,
                                                 int lane, bool need,
                                                 int32_t* dst, int32_t start,
                                                 int32_t win_last) {
  if (need) dst[0] = start;
  int off = 1;
  for (int j = 0; j < s.n_out; ++j) {
    bool nn;
    const int sl = col_setter(g, x, s.out_col[j], &nn);
    const int planes = s.out_planes[j];
    const bool want = s.out_want_idx[j] != 0;
    if (need) {
      const int32_t idx =
          sl >= 0 ? cur + sl : (s.flat ? cur + lane : win_last);
      const int32_t* cmp =
          s.out_cmp[j] + static_cast<int64_t>(idx) * s.out_width[j];
      dst[off] = __ldg(cmp);
      if (planes == 2) dst[off + 1] = __ldg(cmp + 1);
      dst[off + planes] = nn ? 0 : 1;
      if (want) dst[off + planes + 1] = nn ? idx : -1;
    }
    off += planes + 1 + (want ? 1 : 0);
  }
  if (need) {
    for (; off < s.W; ++off) dst[off] = 0;
  }
}

// The same for a long group (`need` warp-uniform; lane 0 writes).
__device__ __forceinline__ void write_long_row(const Sig& s, const Long& L,
                                               int lane, bool need,
                                               int32_t* dst, int32_t start,
                                               int32_t win_last) {
  const bool w = need && lane == 0;
  if (w) dst[0] = start;
  int off = 1;
  for (int j = 0; j < s.n_out; ++j) {
    const int c = s.out_col[j];
    const int32_t sr = __shfl_sync(kFull, L.setter, c);
    const bool nn = __shfl_sync(kFull, L.notnull ? 1 : 0, c) != 0;
    const int planes = s.out_planes[j];
    const bool want = s.out_want_idx[j] != 0;
    if (w) {
      const int32_t idx = sr >= 0 ? sr : win_last;
      const int32_t* cmp =
          s.out_cmp[j] + static_cast<int64_t>(idx) * s.out_width[j];
      dst[off] = __ldg(cmp);
      if (planes == 2) dst[off + 1] = __ldg(cmp + 1);
      dst[off + planes] = nn ? 0 : 1;
      if (want) dst[off + planes + 1] = nn ? idx : -1;
    }
    off += planes + 1 + (want ? 1 : 0);
  }
  if (w) {
    for (; off < s.W; ++off) dst[off] = 0;
  }
}

// A group id past the window's groups: the JAX program's garbage row
// (start -1, the window's last row's planes, NULL, no setter).
__device__ __forceinline__ void write_empty_row(const Sig& s, int32_t* dst,
                                int32_t win_last) {
  dst[0] = -1;
  int off = 1;
  for (int j = 0; j < s.n_out; ++j) {
    const int32_t* cmp =
        s.out_cmp[j] + static_cast<int64_t>(win_last) * s.out_width[j];
    const int planes = s.out_planes[j];
    dst[off] = __ldg(cmp);
    if (planes == 2) dst[off + 1] = __ldg(cmp + 1);
    dst[off + planes] = 1;
    if (s.out_want_idx[j]) dst[off + planes + 1] = -1;
    off += planes + 1 + (s.out_want_idx[j] ? 1 : 0);
  }
  for (; off < s.W; ++off) dst[off] = 0;
}

// K7's writes of the resolved piece [lo, hi): each warp walks its groups
// again and writes the rows it owns, from `first` (the piece's first
// match position in paged mode, its first group id in chunks mode).
template <int kMode>
__device__ __forceinline__ void write_piece(const Sig& s, const Page& p,
                                            int32_t lo, int32_t hi, int32_t lim,
                                            int32_t win_last, int first,
                                            int32_t* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Head& h = head();
  const uint8_t* ans = s_ans(s);
  constexpr int kBy = kMode == kPaged ? 1 : 0;  // ranked by match or group
  int mine = first;
  for (int w = 0; w < warp; ++w) mine += h.cnt[kBy][w];
  if (h.cnt[kBy][warp] == 0 || (kMode == kPaged && mine >= s.M)) return;
  int32_t span_lo, span_hi;
  warp_span(lo, hi, warp, &span_lo, &span_hi);
  int32_t cur = first_start(s, lo, hi, span_lo, lim, span_hi, lane);
  int done = 0;
  while (cur < span_hi && (kMode != kPaged || mine + done < s.M)) {
    const Row x = load_window(s, lo, hi, cur, lim, lane);
    Grp g;
    const int e = window_step(p, x, cur, lim, span_hi, lane, &g);
    if (e > 0) {
      const int32_t row = cur + lane;
      const bool m = g.lead && (ans[row - lo] & kMatch);
      const uint32_t ranked =
          __ballot_sync(kFull, kMode == kPaged ? m : g.lead);
      const int pos = mine + done + __popc(ranked & lanes(0, lane));
      const bool need =
          (ranked >> lane & 1u) && (kMode != kPaged || pos < s.M);
      done += __popc(ranked);
      if (__ballot_sync(kFull, need)) {
        write_window_row(s, x, g, cur, lane, need,
                         out + static_cast<int64_t>(pos) * s.W,
                         kMode == kPaged || m ? row : -1, win_last);
      }
      cur += e;
    } else {
      const Long L = resolve_long(s, p, lo, hi, cur, lim, lane);
      const bool m = ans[cur - lo] & kMatch;
      const bool ranked = kMode != kPaged || m;
      const int pos = mine + done;
      done += ranked;
      write_long_row(s, L, lane, ranked && (kMode != kPaged || pos < s.M),
                     out + static_cast<int64_t>(pos) * s.W,
                     kMode == kPaged || m ? cur : -1, win_last);
      cur = L.end;
    }
  }
}

// K9's writes of the resolved piece [lo, hi): each group's match flag and
// first row (window-local) at its group id, from the answer bytes.
__device__ __forceinline__ void write_candidates(const Sig& s, int32_t lo,
                                                 int32_t hi, int32_t wbase,
                                                 int first, uint8_t* cand,
                                                 int32_t* cand_start) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Head& h = head();
  const uint8_t* ans = s_ans(s);
  int mine = first;
  for (int w = 0; w < warp; ++w) mine += h.cnt[0][w];
  int32_t span_lo, span_hi;
  warp_span(lo, hi, warp, &span_lo, &span_hi);
  for (int32_t row0 = span_lo; row0 < span_hi; row0 += 32) {
    const int32_t row = row0 + lane;
    const uint8_t a = row < span_hi ? ans[row - lo] : 0;
    const uint32_t leads = __ballot_sync(kFull, a & kLead);
    if (a & kLead) {
      const int gid = mine + __popc(leads & lanes(0, lane));
      cand[gid] = (a & kMatch) ? 1 : 0;
      cand_start[gid] = row - wbase;
    }
    mine += __popc(leads);
  }
}

// Piece q of the block's run blocks in the window at `wbase`: rows
// [*lo, *hi) of the run block that ends at *lim.
__device__ __forceinline__ void piece_bounds(const Sig& s, int32_t wbase,
                                             int kb0, int per_run_block,
                                             int q, int32_t* lo, int32_t* hi,
                                             int32_t* lim) {
  const int32_t b_lo = wbase + (kb0 + q / per_run_block) * s.R;
  *lim = b_lo + s.R;
  *lo = b_lo + (q % per_run_block) * s.piece;
  *hi = min(*lim, *lo + s.piece);
}

// The block's run blocks of the window at `wbase` (first global row),
// walked with the cluster: resolve, rank across the cluster, write.
// Returns the window's totals (every block the same). `count_base`: the
// page's matches before this window (paged mode).
template <int kMode>
__device__ __forceinline__ Counts cluster_window(const Sig& s, const Page& p,
                                                 int32_t wbase, int count_base,
                                                 int parity, int32_t* out,
                                                 uint8_t* cand,
                                                 int32_t* cand_start) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  Head& h = head();
  const int kb0 = rank * s.per_block;
  const int kb1 = min(s.K, kb0 + s.per_block);
  const int per_run_block = (s.R + s.piece - 1) / s.piece;
  const int n_pieces = kb1 > kb0 ? (kb1 - kb0) * per_run_block : 0;
  const int32_t win_last = wbase + s.N - 1;
  Counts mine{0, 0, 0};
  for (int q = 0; q < n_pieces; ++q) {
    int32_t lo, hi, lim;
    piece_bounds(s, wbase, kb0, per_run_block, q, &lo, &hi, &lim);
    if (kMode == kPaged && (hi <= p.row_lo || lo >= p.row_hi)) continue;
    stage(s, lo, hi - lo);
    __syncthreads();
    resolve_piece<kMode>(s, p, lo, hi, lim);
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      mine.lead += h.cnt[0][w];
      mine.match += h.cnt[1][w];
      mine.counted += h.cnt[2][w];
    }
  }
  // Each block's counts into every block of the cluster.
  if (static_cast<int>(threadIdx.x) < s.cluster) {
    int32_t* dst = cluster.map_shared_rank(&h.xchg[parity][rank][0],
                                           threadIdx.x);
    dst[0] = mine.lead;
    dst[1] = mine.match;
    dst[2] = mine.counted;
  }
  cluster.sync();
  Counts at{0, 0, 0}, total{0, 0, 0};
  for (int r = 0; r < s.cluster; ++r) {
    const int32_t* v = h.xchg[parity][r];
    if (r < rank) {
      at.lead += v[0];
      at.match += v[1];
    }
    total.lead += v[0];
    total.match += v[1];
    total.counted += v[2];
  }
  for (int q = 0; q < n_pieces; ++q) {
    int32_t lo, hi, lim;
    piece_bounds(s, wbase, kb0, per_run_block, q, &lo, &hi, &lim);
    if (kMode == kPaged && (hi <= p.row_lo || lo >= p.row_hi)) continue;
    if (kMode == kPaged && count_base + at.match >= s.M) break;
    if (n_pieces > 1) {  // the piece is no longer staged
      __syncthreads();
      stage(s, lo, hi - lo);
      __syncthreads();
      resolve_piece<kMode>(s, p, lo, hi, lim);
      __syncthreads();
    }
    if (kMode == kCandidates) {
      write_candidates(s, lo, hi, wbase, at.lead, cand, cand_start);
    } else {
      write_piece<kMode>(s, p, lo, hi, lim, win_last,
                         kMode == kPaged ? count_base + at.match : at.lead,
                         out);
    }
    for (int w = 0; w < kWarps; ++w) {
      at.lead += h.cnt[0][w];
      at.match += h.cnt[1][w];
    }
  }
  __syncthreads();  // the next window stages over this one
  return total;
}

// The share [*a, *b) of n items that cluster block `rank` writes.
__device__ __forceinline__ void share(const Sig& s, int64_t n, int rank,
                                      int64_t* a, int64_t* b) {
  const int64_t each = (n + s.cluster - 1) / s.cluster;
  *a = each * rank < n ? each * rank : n;
  *b = *a + each < n ? *a + each : n;
}

__device__ __forceinline__ Page load_page(const int32_t* ip) {
  Page p;
  p.w_first = ip[0];
  p.w_last = ip[1];
  p.row_lo = ip[2];
  p.row_hi = ip[3];
  p.read = ordered_key(ip[4], ip[5]);
  p.rexp = ordered_key(ip[6], ip[7]);
  p.scan_from = ip[8];
  return p;
}

__device__ __forceinline__ void load_lits(const Sig& s, const int32_t* ip,
                                          const float* fp) {
  Head& h = head();
  for (int k = threadIdx.x; k < s.P - kParamFixed && k < 2 * kMaxPreds;
       k += kThreads) {
    h.lit_i[k] = ip[kParamFixed + k];
  }
  for (int k = threadIdx.x; k < s.F && k < kMaxPreds; k += kThreads) {
    h.lit_f[k] = fp[k];
  }
}

// kPacked: paged mode (a page walks windows); else chunks mode.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_kernel(const __grid_constant__ Sig s,
              const int32_t* __restrict__ iparams,
              const float* __restrict__ fparams, int32_t* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t page = blockIdx.x / s.cluster;
  const int32_t* ip = iparams + page * s.P;
  const Page p = load_page(ip);
  load_lits(s, ip, fparams + page * s.F);
  // Every block of the cluster has started (and its head is ready)
  // before any block writes into another's shared memory.
  cluster.sync();
  int32_t* buf = out + page * static_cast<int64_t>(s.M + 1) * s.W;
  int count = 0, scanned = 0;
  int32_t w = p.w_first;
  if (kPacked) {
    int parity = 0;
    while (w <= p.w_last && count < s.M) {
      const Counts t = cluster_window<kPaged>(s, p, w * s.N, count, parity,
                                              buf, nullptr, nullptr);
      count += t.match;
      scanned += t.counted;
      ++w;
      parity ^= 1;
    }
    // Rows past the matches are zeros.
    const int64_t filled = count < s.M ? count : s.M;
    int64_t a, b;
    share(s, (s.M - filled) * static_cast<int64_t>(s.W), rank, &a, &b);
    int32_t* zeros = buf + filled * s.W;
    for (int64_t k = a + threadIdx.x; k < b; k += kThreads) zeros[k] = 0;
  } else {
    const Counts t = cluster_window<kChunks>(s, p, w * s.N, 0, 0, buf,
                                             nullptr, nullptr);
    count = t.match;
    scanned = t.counted;
    // Group ids past the window's groups.
    int64_t a, b;
    share(s, s.N - t.lead, rank, &a, &b);
    for (int64_t k = a + threadIdx.x; k < b; k += kThreads) {
      write_empty_row(s, buf + (t.lead + k) * s.W, w * s.N + s.N - 1);
    }
    ++w;
  }
  if (rank == 0) {
    int32_t* tail = buf + static_cast<int64_t>(s.M) * s.W;
    for (int k = threadIdx.x; k < s.W; k += kThreads) {
      tail[k] = k == 0 ? count : k == 1 ? scanned : k == 2 ? w : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
candidates_kernel(const __grid_constant__ Sig s,
                  const int32_t* __restrict__ iparams,
                  const float* __restrict__ fparams,
                  uint8_t* __restrict__ result, int32_t* __restrict__ start,
                  int32_t* __restrict__ num_groups) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Page p = load_page(iparams);
  load_lits(s, iparams, fparams);
  cluster.sync();  // as in gather_kernel
  const int64_t b = blockIdx.x / s.cluster;
  uint8_t* cand = result + b * s.N;
  int32_t* cand_start = start + b * s.N;
  const Counts t = cluster_window<kCandidates>(
      s, p, static_cast<int32_t>((p.w_first + b) * s.N), 0, 0, nullptr, cand,
      cand_start);
  // Group ids past the window's groups.
  int64_t a, e;
  share(s, s.N - t.lead, rank, &a, &e);
  for (int64_t k = a + threadIdx.x; k < e; k += kThreads) {
    cand[t.lead + k] = 0;
    cand_start[t.lead + k] = kI32Max;
  }
  if (rank == 0 && threadIdx.x == 0) num_groups[b] = t.lead;
}

// Fill the signature from the launch functions' arguments.
int make_sig(Sig* s, const void* const* run, const void* const* cols,
             const int32_t* widths, int n_cols, long long n_rows, int R, int K,
             const int32_t* preds, int n_preds, const int32_t* outs, int n_out,
             int P, int F) {
  if (n_cols < 0 || n_cols > kMaxCols) return kErrCols;
  if (n_preds < 0 || n_preds > kMaxPreds) return kErrPreds;
  if (n_out < 0 || n_out > kMaxOut) return kErrOut;
  if (R < 1 || K < 1 || n_rows < 0 || n_rows >= (1ll << 31) ||
      n_rows % (static_cast<long long>(R) * K) != 0) {
    return kErrShape;
  }
  for (int k = 0; k < 8; ++k) {
    if (run[k] == nullptr) return kErrPlane;
  }
  s->valid = static_cast<const uint8_t*>(run[0]);
  s->group_start = static_cast<const uint8_t*>(run[1]);
  s->tomb = static_cast<const uint8_t*>(run[2]);
  s->live = static_cast<const uint8_t*>(run[3]);
  s->ht_hi = static_cast<const int32_t*>(run[4]);
  s->ht_lo = static_cast<const int32_t*>(run[5]);
  s->exp_hi = static_cast<const int32_t*>(run[6]);
  s->exp_lo = static_cast<const int32_t*>(run[7]);
  s->n_cols = n_cols;
  const int32_t* cmp[kMaxCols] = {};
  const float* arith[kMaxCols] = {};
  for (int c = 0; c < n_cols; ++c) {
    s->set[c] = static_cast<const uint8_t*>(cols[4 * c]);
    s->isnull[c] = static_cast<const uint8_t*>(cols[4 * c + 1]);
    cmp[c] = static_cast<const int32_t*>(cols[4 * c + 2]);
    arith[c] = static_cast<const float*>(cols[4 * c + 3]);
    if (!s->set[c] || !s->isnull[c] || !cmp[c] || widths[c] < 1 ||
        widths[c] > 2) {
      return kErrPlane;
    }
  }
  int n_int = 0, n_float = 0;
  s->n_preds = n_preds;
  for (int i = 0; i < n_preds; ++i) {
    const int c = preds[3 * i], kind = preds[3 * i + 1];
    if (c < 0 || c >= n_cols || kind < kI32 || kind > kF32 ||
        preds[3 * i + 2] < kEq || preds[3 * i + 2] > kGe) {
      return kErrPreds;
    }
    if (kind == kF32 && arith[c] == nullptr) return kErrPreds;
    if (kind != kF32 && kind != kI32 && widths[c] != 2) return kErrPreds;
    s->pred_col[i] = static_cast<int8_t>(c);
    s->pred_kind[i] = static_cast<int8_t>(kind);
    s->pred_op[i] = static_cast<int8_t>(preds[3 * i + 2]);
    s->pred_cmp[i] = cmp[c];
    s->pred_arith[i] = arith[c];
    s->pred_width[i] = static_cast<int8_t>(widths[c]);
    if (kind == kF32) {
      s->pred_lit[i] = static_cast<int8_t>(n_float++);
    } else {
      s->pred_lit[i] = static_cast<int8_t>(n_int);
      n_int += kind == kI32 ? 1 : 2;
    }
  }
  if (P != kParamFixed + n_int || F < n_float || F < 1) return kErrParams;
  s->n_out = n_out;
  for (int j = 0; j < n_out; ++j) {
    const int c = outs[3 * j], planes = outs[3 * j + 1];
    if (c < 0 || c >= n_cols || planes < 1 || planes > widths[c]) {
      return kErrOut;
    }
    s->out_col[j] = static_cast<int8_t>(c);
    s->out_planes[j] = static_cast<int8_t>(planes);
    s->out_want_idx[j] = static_cast<int8_t>(outs[3 * j + 2] != 0);
    s->out_cmp[j] = cmp[c];
    s->out_width[j] = static_cast<int8_t>(widths[c]);
  }
  s->R = R;
  s->K = K;
  s->N = R * K;
  s->P = P;
  s->F = F;
  // The launch geometry (ops/row_gather.py launch_geometry mirrors it).
  s->cluster = K < kMaxCluster ? K : kMaxCluster;
  s->per_block = (K + s->cluster - 1) / s->cluster;
  s->piece = R < kPieceMax ? R : kPieceMax;
  bool aligned = R % 16 == 0;
  for (int k = 0; k < 8; ++k) {
    aligned = aligned && reinterpret_cast<uintptr_t>(run[k]) % 16 == 0;
  }
  for (int c = 0; c < n_cols; ++c) {
    aligned = aligned &&
              reinterpret_cast<uintptr_t>(s->set[c]) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(s->isnull[c]) % 16 == 0;
  }
  s->aligned = aligned;
  return 0;
}

// Dynamic shared memory a block: the head and a staged piece.
int shared_bytes(const Sig& s) {
  return (kHeadBytes + s.piece * (21 + 2 * s.n_cols) + 15) / 16 * 16;
}

// The shape of this library's last launch: cluster, blocks, run blocks
// a block, rows a piece, pieces a run block, shared bytes a block.
int32_t g_last_launch[6];

// Launches `kernel` as `n` clusters of s.cluster blocks.
template <typename... Args>
int launch_clusters(void (*kernel)(const Sig, Args...), const Sig& s, int n,
                    cudaStream_t stream, Args... args) {
  const int bytes = shared_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * s.cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, s, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t shape[6] = {s.cluster, static_cast<int32_t>(cfg.gridDim.x),
                            s.per_block, s.piece,
                            (s.R + s.piece - 1) / s.piece, bytes};
  for (int i = 0; i < 6; ++i) g_last_launch[i] = shape[i];
  return 0;
}

}  // namespace

extern "C" {

// run: valid, group_start, tomb, live, ht_hi, ht_lo, exp_hi, exp_lo.
// cols: per value column set, isnull, cmp ([n_rows, width] int32), arith
// (float32, or null). preds: per predicate (column slot, kind, op).
// outs: per output column (column slot, planes, want_idx).
// iparams [G, P] int32 and fparams [G, F] float32 on the device:
// ops/row_gather.py pack_params' layout. out: [G, M + 1, W] int32.
int row_gather_launch(const void* const* run, const void* const* cols,
                      const int32_t* widths, int n_cols, long long n_rows,
                      int R, int K, int M, int W, int packed, int flat,
                      const int32_t* preds, int n_preds, const int32_t* outs,
                      int n_out, const int32_t* iparams, int P,
                      const float* fparams, int F, int G, int32_t* out,
                      void* stream) {
  Sig s{};
  int rc = make_sig(&s, run, cols, widths, n_cols, n_rows, R, K, preds,
                    n_preds, outs, n_out, P, F);
  if (rc != 0) return rc;
  int w_need = 1;
  for (int j = 0; j < n_out; ++j) {
    w_need += s.out_planes[j] + 1 + s.out_want_idx[j];
  }
  if (M < 1 || W < 3 || W < w_need || G < 0 ||
      static_cast<long long>(G) * s.cluster >= (1ll << 31) ||
      (!packed && M != R * K)) {
    return kErrShape;
  }
  if (!iparams || !fparams || !out) return kErrParams;
  s.M = M;
  s.W = W;
  s.flat = flat != 0;
  s.apply_preds = 1;
  if (G == 0) return 0;
  return launch_clusters(packed ? gather_kernel<true> : gather_kernel<false>,
                         s, G, static_cast<cudaStream_t>(stream), iparams,
                         fparams, out);
}

// One range of windows of a run: iparams [P] / fparams [F] on the device
// (pack_params' layout; w_first is the range's first window), n_windows
// windows from it. result [n_windows, R * K] uint8, start [n_windows,
// R * K] int32, num_groups [n_windows] int32.
int scan_window_launch(const void* const* run, const void* const* cols,
                       const int32_t* widths, int n_cols, long long n_rows,
                       int R, int K, int flat, int apply_preds,
                       const int32_t* preds, int n_preds,
                       const int32_t* iparams, int P, const float* fparams,
                       int F, int n_windows, uint8_t* result, int32_t* start,
                       int32_t* num_groups, void* stream) {
  Sig s{};
  int rc = make_sig(&s, run, cols, widths, n_cols, n_rows, R, K, preds,
                    n_preds, nullptr, 0, P, F);
  if (rc != 0) return rc;
  if (n_windows < 0 ||
      static_cast<long long>(n_windows) * s.cluster >= (1ll << 31)) {
    return kErrShape;
  }
  if (!iparams || !fparams || !result || !start || !num_groups) {
    return kErrParams;
  }
  s.M = 1;
  s.W = 1;
  s.flat = flat != 0;
  s.apply_preds = apply_preds != 0;
  if (n_windows == 0) return 0;
  return launch_clusters(candidates_kernel, s, n_windows,
                         static_cast<cudaStream_t>(stream), iparams, fparams,
                         result, start, num_groups);
}

// out[6]: the shape of the last launch that row_gather_launch or
// scan_window_launch made (g_last_launch).
void row_gather_last_launch(int32_t* out) {
  for (int i = 0; i < 6; ++i) out[i] = g_last_launch[i];
}

const char* row_gather_error_string(int rc) {
  switch (rc) {
    case kErrCols: return "too many value columns";
    case kErrPreds: return "a predicate the kernel does not take";
    case kErrOut: return "an output column the kernel does not take";
    case kErrShape: return "a shape the kernel does not take";
    case kErrPlane: return "a missing plane";
    case kErrParams: return "parameters that do not match the signature";
    default: return cudaGetErrorString(static_cast<cudaError_t>(rc));
  }
}

}  // extern "C"
