// MVCC resolve of a multi-version run into a flat view, for Hopper (sm_90a).
//
// Serves the multi-version aggregate routes that the JAX package runs as
// XLA programs: ops/seg_fold.py compiled_seg_aggregate (K4, segmented
// associative scans) and ops/lookback_fold.py compiled_lookback_aggregate
// (K3, shifted masks), whose resolve both end in flat_fold.finish_groups.
// From a run's planes and one read point, it writes the run's resolved
// flat view (ops/mvcc_resolve.py says what the view holds); the flat fold
// kernel (csrc/flat_agg.cu) then folds the view as it folds a flat run,
// so one resolve serves a whole batch of specs at read points that see
// the same versions.
//
// Per key group (contiguous rows, newest first, never across a block;
// storage/columnar.py), at a read point:
//   - the first visible tombstone (the newest) shadows every version at or
//     below its hybrid time, on either side of it in the layout (the
//     same-batch DELETE + write tie);
//   - alive = visible, not a tombstone, not shadowed; the group is live
//     if an alive, unexpired version carries the liveness marker;
//   - per column, the first alive version that sets it is the latest
//     setter; its NULL bit or its expiry makes the column NULL, with no
//     fallback to an older setter.
//
// What bounds it: bytes. Each row's valid flag is read once, and a valid
// row's group start, tombstone and hybrid time (10 bytes); an alive row's
// liveness marker and set flags, each chosen setter's isnull, order and
// arithmetic planes, and the expiry where liveness or a setter needs it;
// the view's valid, live and column planes are written once (40 bytes a
// row of the bench table). A few dozen integer operations per row against
// the card's integer rate are far below the bytes.
//
// The design it replaces ran one thread per row: the thread at a group's
// first row walked the group twice, row by row, while its warp waited for
// its longest group, so its time followed the hottest key (zipfian updates
// put keys of 256 versions in a run), not the bytes. Here no thread walks
// a group:
//
//   1. Stage. A block takes a tile of the most whole blocks of the run
//      that fit in kTileMax rows (so no group crosses a tile unless a block
//      is longer than that) and copies the planes every row needs (flags,
//      hybrid times, expiries, set flags) into shared memory with 16-byte
//      cp.async copies, all in flight at once (row by row where a plane is
//      not 16-byte aligned or the tile not a multiple of 16 rows).
//   2. Resolve, from shared memory. Each warp owns the groups that start
//      in its eighth of the tile and moves a cursor from group start to
//      group start in windows of 32 rows, a lane a row. __ballot_sync of
//      the group starts gives every group of the window; a lane's group is
//      the run of lanes from the highest start at or below it to the next
//      start (a look-ahead flag says whether the row after the window
//      starts one; a block's end always does). The group's first visible
//      tombstone, its liveness and each column's first alive setter are
//      first-set-bit queries (__ffs) on ballots masked to those lanes, the
//      tombstone's hybrid time one __shfl_sync, so the tombstone is known
//      before any row is called alive (the tie). A group open at a
//      window's end starts the next window. A group longer than a window
//      goes in warp steps of kUnroll x 32 rows: a sweep to its first
//      visible tombstone, a sweep for liveness and setters that stops once
//      every answer is known, and a scan of group starts to its end (only
//      the scan where the group's first row is not valid: such a group has
//      no view row). A group of L versions costs about L / 32 warp steps,
//      never L steps of one thread. Each group's answers (first row, live, each column's
//      setter as a row of the tile) are recorded in shared memory.
//   3. Write. Each warp then writes the view rows of its eighth, a lane a
//      row, stores coalesced: valid and live from the answers, then a pass
//      per column in which the first rows gather their setters' isnull,
//      order and arithmetic planes (a setter is the first row itself or
//      close after it, so a warp's gathers fall on neighbouring rows), with
//      several rows' gathers in flight. Other rows get zeros.
//
// A group that runs past its tile (only in blocks longer than kTileMax) is
// resolved by its warp from the run itself and written by it.
//
// Interface: plain C, for ctypes. mvcc_resolve_launch returns 0, a
// negative code for an argument it refuses, or the launch's
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

// The tile's set flags and setters (dynamic shared memory).
extern __shared__ __align__(16) uint8_t s_dyn[];

namespace {

constexpr int kMaxCols = 16;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
// Rows a block stages: the most whole blocks of the run that fit, or
// kTileMax rows of one block longer than that (ops/mvcc_resolve.py
// launch_geometry mirrors this).
constexpr int kTileMax = 2048;
constexpr int kUnroll = 2;  // 32-row steps loaded together in a long group
// Blocks per SM the register cap is set for: 64 registers a thread.
constexpr int kMinBlocks = 4;
constexpr int kRunPlanes = 8;  // valid, group_start, tomb, live, ht hi/lo, exp hi/lo
constexpr uint32_t kBias = 0x80000000u;
constexpr uint32_t kFull = 0xffffffffu;

enum Err : int {
  kErrCols = -1,
  kErrRows = -2,
  kErrPlane = -3,
  kErrWidth = -4,
};

struct Params {
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
  const int32_t* cmp[kMaxCols];
  const uint32_t* arith[kMaxCols];  // float bits; null: no arithmetic plane
  uint8_t* out_valid;
  uint8_t* out_live;
  uint8_t* out_set[kMaxCols];
  uint8_t* out_isnull[kMaxCols];
  int32_t* out_cmp[kMaxCols];
  uint32_t* out_arith[kMaxCols];
  int32_t width[kMaxCols];  // order planes per row: 1 or 2
  int32_t n_cols;
  int32_t n_rows;
  int32_t rows_per_block;
  int32_t tile_rows;
  int32_t setter_offset;  // bytes of s_dyn before the setters
  bool aligned;  // run planes 16-byte aligned, tile_rows a multiple of 16
  uint64_t read;  // read point, as an ordered key
  uint64_t rexp;  // expiry read point, as an ordered key
};

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

// The end of the block that holds `row` (a group never crosses it).
__device__ __forceinline__ int32_t block_end(const Params& p, int32_t row) {
  // Unsigned 32-bit: row + rows_per_block < 2^32.
  const uint32_t r = p.rows_per_block;
  return static_cast<int32_t>(
      min(static_cast<uint32_t>(p.n_rows),
          (static_cast<uint32_t>(row) / r + 1) * r));
}

// The run's planes are read only, through the read-only path: the
// compiler may then move their loads ahead of the view's stores.
template <typename T>
__device__ __forceinline__ T ld(const T* plane, int64_t i) {
  return __ldg(plane + i);
}

// One row's flags, as staged.
enum : uint32_t {
  kValid = 1, kStart = 2, kTomb = 4, kLive = 8, kIn = 16,
  kNextStart = 32,  // lane 31 of a window: the row after it starts a group
};

// The block's tile of the run's planes, as they lie in the run: the
// valid, group-start, tombstone and liveness flags (a byte a row), the
// hybrid time and expiry (two words a row each); each column's set flags
// lie in dynamic shared memory (s_dyn: tile_rows bytes a column).
enum { kPlaneValid, kPlaneStart, kPlaneTomb, kPlaneLive };
enum { kPlaneHtHi, kPlaneHtLo, kPlaneExpHi, kPlaneExpLo };
__shared__ __align__(16) uint8_t s_flag[4][kTileMax];
__shared__ __align__(16) int32_t s_word[4][kTileMax];
// The tile's answers, for the pass that writes the view: per row kRep
// (a group's first row, valid), kRepLive (and the group is live) or
// kWritten (a group that runs past the tile, written by its warp); per
// column c and row i, setters(p)[c * tile_rows + i] (in s_dyn, after the
// set flags): the group's latest setter as a row of the tile, kNoSetter
// where there is none (only read at a kRep row).
enum : uint8_t { kRep = 1, kRepLive = 2, kWritten = 4 };
constexpr uint16_t kNoSetter = 0xffffu;
__shared__ uint8_t s_out[kTileMax];

__device__ __forceinline__ uint8_t* set_flags(const Params& p, int c) {
  return reinterpret_cast<uint8_t*>(s_dyn) + c * p.tile_rows;
}

__device__ __forceinline__ uint16_t* setters(const Params& p) {
  return reinterpret_cast<uint16_t*>(s_dyn + p.setter_offset);
}

// One lane's row of a step: flags, hybrid time, expiry and set flags.
struct Row {
  uint32_t flags;
  uint32_t sets;  // bit c: column c set
  uint64_t ht;
  uint64_t exp;
};

__device__ __forceinline__ uint32_t flags_at(const Params& p, int32_t row) {
  return (ld(p.valid, row) ? kValid : 0) |
         (ld(p.group_start, row) ? kStart : 0) |
         (ld(p.tomb, row) ? kTomb : 0) | (ld(p.live, row) ? kLive : 0);
}

__device__ __forceinline__ uint32_t sets_at(const Params& p, int32_t row) {
  uint32_t sets = 0;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < p.n_cols && ld(p.set[c], row)) sets |= 1u << c;
  }
  return sets;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Copies `bytes` (a multiple of 16) from the run to shared memory with
// the block's threads, 16 bytes each, without waiting.
__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           int bytes) {
  for (int k = threadIdx.x; k < bytes / 16; k += kThreads) {
    cp_async16(static_cast<uint8_t*>(smem) + 16 * k,
               static_cast<const uint8_t*>(gmem) + 16 * k);
  }
}

// Stages rows [lo, hi) of the run: every plane read once, as contiguous
// runs of the block's threads. Aligned tiles go by asynchronous 16-byte
// copies, all in flight at once; others row by row.
__device__ __forceinline__ void stage_tile(const Params& p, int32_t lo,
                                           int32_t hi) {
  const int32_t n = hi - lo;
  const uint8_t* flag[4] = {p.valid, p.group_start, p.tomb, p.live};
  const int32_t* word[4] = {p.ht_hi, p.ht_lo, p.exp_hi, p.exp_lo};
  if (p.aligned && n % 16 == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      copy_async(s_flag[k], flag[k] + lo, n);
      copy_async(s_word[k], word[k] + lo, 4 * n);
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c >= p.n_cols) break;
      copy_async(set_flags(p, c), p.set[c] + lo, n);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int32_t i = threadIdx.x; i < n; i += kThreads) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_flag[k][i] = ld(flag[k], lo + i);
        s_word[k][i] = ld(word[k], lo + i);
      }
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c >= p.n_cols) break;
        set_flags(p, c)[i] = ld(p.set[c], lo + i);
      }
    }
  }
  for (int32_t i = threadIdx.x; i < n; i += kThreads) s_out[i] = 0;
}

// Row `row` below `lim`, from the tile [lo, hi) or, past it, from the run.
__device__ __forceinline__ Row load_row(const Params& p, int32_t lo,
                                        int32_t hi, int32_t row,
                                        int32_t lim) {
  Row x{0, 0, 0, ~0ull};
  if (row < lim) {
    if (row < hi) {
      const int32_t i = row - lo;
      uint32_t sets = 0;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < p.n_cols && set_flags(p, c)[i]) sets |= 1u << c;
      }
      x = Row{kIn | (s_flag[kPlaneValid][i] ? kValid : 0) |
                  (s_flag[kPlaneStart][i] ? kStart : 0) |
                  (s_flag[kPlaneTomb][i] ? kTomb : 0) |
                  (s_flag[kPlaneLive][i] ? kLive : 0),
              sets,
              ordered_key(s_word[kPlaneHtHi][i], s_word[kPlaneHtLo][i]),
              ordered_key(s_word[kPlaneExpHi][i], s_word[kPlaneExpLo][i])};
    } else {
      x = Row{kIn | flags_at(p, row), sets_at(p, row),
              ordered_key(ld(p.ht_hi, row), ld(p.ht_lo, row)),
              ordered_key(ld(p.exp_hi, row), ld(p.exp_lo, row))};
    }
  }
  return x;
}

__device__ __forceinline__ bool starts_group(const Params& p, int32_t lo,
                                             int32_t hi, int32_t row) {
  return row < hi ? s_flag[kPlaneStart][row - lo] != 0
                  : ld(p.group_start, row) != 0;
}

// A window's row, and for lane 31 whether the row after the window starts
// a group (the block's end counts).
__device__ __forceinline__ Row load_window(const Params& p, int32_t lo,
                                           int32_t hi, int32_t cur,
                                           int32_t lim, int lane) {
  const int32_t row = cur + lane;
  Row x = load_row(p, lo, hi, row, lim);
  if (lane == 31 && (row + 1 >= lim || starts_group(p, lo, hi, row + 1))) {
    x.flags |= kNextStart;
  }
  return x;
}

// Column c of view row `row`: the setter row's planes (s >= 0), or zeros.
__device__ __forceinline__ void write_col(const Params& p, int c, int32_t row,
                                          int32_t s, bool s_expired) {
  uint8_t isnull = 0;
  int32_t v0 = 0, v1 = 0;
  uint32_t arith = 0;
  const bool two = p.width[c] == 2;
  if (s >= 0) {
    isnull = ld(p.isnull[c], s) || s_expired;
    if (two) {
      v0 = ld(p.cmp[c], 2 * static_cast<int64_t>(s));
      v1 = ld(p.cmp[c], 2 * static_cast<int64_t>(s) + 1);
    } else {
      v0 = ld(p.cmp[c], s);
    }
    if (p.arith[c] != nullptr) arith = ld(p.arith[c], s);
  }
  p.out_set[c][row] = s >= 0;
  p.out_isnull[c][row] = isnull;
  if (two) {
    reinterpret_cast<int2*>(p.out_cmp[c])[row] = make_int2(v0, v1);
  } else {
    p.out_cmp[c][row] = v0;
  }
  if (p.out_arith[c] != nullptr) p.out_arith[c][row] = arith;
}

// The first group start at or after `cur` (in the block ending at `lim`),
// or a row at or past `end`.
__device__ int32_t first_start(const Params& p, int32_t lo, int32_t hi,
                               int32_t cur, int32_t lim, int32_t end,
                               int lane) {
  if (cur == lim - p.rows_per_block) return cur;  // a block's first row
  while (cur < end) {
    const int32_t row = cur + lane;
    const uint32_t b =
        __ballot_sync(kFull, row < lim && starts_group(p, lo, hi, row));
    if (b) return cur + __ffs(b) - 1;
    cur = min(cur + 32, lim);
    if (cur == lim) return cur;  // the next block's first row
  }
  return end;
}

// Resolves, from its loaded rows, the groups of the 32-row window at group
// start `cur` that start before `own_end`, in one step, and records each
// group's answer at its first row. Returns the rows resolved: up to the
// first group it leaves open, or 0 when the group at `cur` is long.
__device__ __forceinline__ int resolve_window(const Params& p, const Row& x,
                                              int32_t lo, int32_t hi,
                                              int32_t cur, int32_t lim,
                                              int32_t own_end, int lane) {
  const bool in = x.flags & kIn;
  // Group starts; lanes past the block (or the run) close the last group.
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
  // A group that runs past the tile (in a block longer than a tile) is
  // left to resolve_long, which writes it.
  if (cur + e > hi) {
    if (h == 0) return 0;
    e = h;
  }
  // This lane's group: lanes [first, next).
  const uint32_t upto = lanes(0, lane + 1);
  const int first = 31 - __clz(starts & upto);
  const uint32_t after = starts & ~upto;
  const uint32_t group = lanes(first, after ? __ffs(after) - 1 : 32);

  const bool vis = (x.flags & kValid) && x.ht <= p.read;
  const uint32_t tombs =
      __ballot_sync(kFull, vis && (x.flags & kTomb)) & group;
  const uint64_t t_key = shfl64(x.ht, tombs ? __ffs(tombs) - 1 : 0);
  const bool alive = vis && !(x.flags & kTomb) && !(tombs && x.ht <= t_key);
  const bool live = __ballot_sync(kFull, alive && (x.flags & kLive) &&
                                             x.exp > p.rexp) & group;
  const bool rep = lane < e && lane == first && (x.flags & kStart) &&
                   (x.flags & kValid);
  const int32_t i = cur + lane - lo;
  if (rep) s_out[i] = kRep | (live ? kRepLive : 0);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.n_cols) break;
    const uint32_t found =
        __ballot_sync(kFull, alive && (x.sets >> c & 1u)) & group;
    if (rep) {
      setters(p)[c * p.tile_rows + i] =
          found ? static_cast<uint16_t>(i + __ffs(found) - 1 - lane)
                : kNoSetter;
    }
  }
  return e;
}

// Resolves the group that starts at `start` (block end `lim`) and runs past
// its window or the tile, in warp steps of kUnroll x 32 rows. Returns the
// group's end.
__device__ int32_t resolve_long(const Params& p, int32_t lo, int32_t hi,
                                int32_t start, int32_t lim, int lane) {
  // The group has a view row only when its first row is valid. A group
  // without one (the delta overlay clears whole groups from a run's valid
  // plane) has no answer to find: only its end is sought, since no
  // alive row would ever stop the sweeps early.
  const int32_t i = start - lo;
  const bool rep = s_flag[kPlaneStart][i] && s_flag[kPlaneValid][i];
  // Sweep 1: the group's first visible tombstone, and where the group
  // ends when it has none.
  bool has_tomb = false;
  uint64_t t_key = 0;
  int32_t end = lim;
  for (int32_t base = start; rep && base < end && !has_tomb;
       base += 32 * kUnroll) {
    Row x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = load_row(p, lo, hi, base + 32 * u + lane, end);
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
      const uint32_t tombs =
          __ballot_sync(kFull, (x[u].flags & kValid) && (x[u].flags & kTomb) &&
                                   x[u].ht <= p.read) & group;
      if (tombs) {
        has_tomb = true;
        t_key = shfl64(x[u].ht, __ffs(tombs) - 1);
      }
    }
  }
  // Sweep 2: liveness and the first alive setter of each column (found:
  // a warp-uniform mask; column c's setter row in lane c), until every
  // answer is known; then only the group's end is sought.
  end = lim;
  const uint32_t all = (1u << p.n_cols) - 1u;
  bool live_any = false;
  uint32_t found = 0;
  int32_t my_setter = -1;
  bool my_setter_expired = false;
  int32_t base = start;
  for (; rep && base < end && !(live_any && found == all);
       base += 32 * kUnroll) {
    Row x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = load_row(p, lo, hi, base + 32 * u + lane, end);
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
      live_any |= __ballot_sync(kFull, alive && (x[u].flags & kLive) &&
                                           !expired) != 0;
      const uint32_t exps = __ballot_sync(kFull, expired);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c >= p.n_cols) break;
        if (found >> c & 1u) continue;
        const uint32_t setters =
            __ballot_sync(kFull, alive && (x[u].sets >> c & 1u));
        if (setters) {
          found |= 1u << c;
          const int s = __ffs(setters) - 1;
          if (lane == c) {
            my_setter = step + s;
            my_setter_expired = exps >> s & 1u;
          }
        }
      }
    }
  }
  // The rest of the group: its end only.
  for (; base < end; base += 32) {
    const int32_t row = base + lane;
    const uint32_t ends = __ballot_sync(
        kFull, row >= end || (row != start && starts_group(p, lo, hi, row)));
    if (ends) end = base + __ffs(ends) - 1;
  }
  // The group's first row: its answer for the view pass, or, when the
  // group runs past the tile, written here.
  if (end <= hi) {
    if (lane == 0 && rep) s_out[i] = kRep | (live_any ? kRepLive : 0);
    if (lane < p.n_cols && rep) {
      setters(p)[lane * p.tile_rows + i] =
          my_setter < 0 ? kNoSetter : static_cast<uint16_t>(my_setter - lo);
    }
    return end;
  }
  if (lane == 0) {
    s_out[i] = kWritten;
    p.out_valid[start] = rep;
    p.out_live[start] = rep && live_any;
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.n_cols) break;
    const int32_t s = __shfl_sync(kFull, my_setter, c);
    const bool s_expired = __shfl_sync(kFull, my_setter_expired, c);
    if (lane == 0) write_col(p, c, start, rep ? s : -1, s_expired);
  }
  return end;
}

// Writes the view's rows [from, to) of the tile at `lo`, a row a lane:
// each group's answer at its first row, its setters' planes gathered from
// the run, zeros elsewhere. A pass per column, so that a lane's gathers
// for its rows are in flight together.
__device__ __forceinline__ void write_rows(const Params& p, int32_t lo,
                                           int32_t from, int32_t to,
                                           int lane) {
  for (int32_t row = from + lane; row < to; row += 32) {
    const uint8_t o = s_out[row - lo];
    if (o & kWritten) continue;
    p.out_valid[row] = (o & kRep) != 0;
    p.out_live[row] = (o & kRepLive) != 0;
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.n_cols) break;
    const uint16_t* setter = setters(p) + c * p.tile_rows;
#pragma unroll 4
    for (int32_t row = from + lane; row < to; row += 32) {
      const int32_t i = row - lo;
      const uint8_t o = s_out[i];
      if (o & kWritten) continue;
      const uint16_t s = (o & kRep) ? setter[i] : kNoSetter;
      if (s == kNoSetter) {
        write_col(p, c, row, -1, false);
      } else {
        write_col(p, c, row, lo + s,
                  ordered_key(s_word[kPlaneExpHi][s], s_word[kPlaneExpLo][s]) <=
                      p.rexp);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mvcc_resolve_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  // 64-bit: the tiles cover n_rows < 2^31 rows.
  const int64_t tile_lo = static_cast<int64_t>(blockIdx.x) * p.tile_rows;
  const int32_t lo = static_cast<int32_t>(tile_lo);
  const int32_t hi = static_cast<int32_t>(
      min(static_cast<int64_t>(p.n_rows), tile_lo + p.tile_rows));
  stage_tile(p, lo, hi);
  __syncthreads();
  // Each warp owns the groups that start in its span of the tile.
  const int warp = threadIdx.x / 32;
  const int32_t span = (hi - lo + kWarps - 1) / kWarps;
  const int32_t span_lo = min(hi, lo + span * warp);
  const int32_t span_hi = min(hi, span_lo + span);
  int32_t lim = block_end(p, span_lo);
  int32_t cur = first_start(p, lo, hi, span_lo, lim, span_hi, lane);
  while (cur < span_hi) {
    while (cur >= lim) lim += p.rows_per_block;
    const Row x = load_window(p, lo, hi, cur, lim, lane);
    const int e = resolve_window(p, x, lo, hi, cur, lim, span_hi, lane);
    cur = e > 0 ? cur + e : resolve_long(p, lo, hi, cur, lim, lane);
  }
  // The span's answers are this warp's own: its rows are written now.
  __syncwarp();
  write_rows(p, lo, span_lo, span_hi, lane);
}

}  // namespace

extern "C" {

// in: valid, group_start, tomb, live, ht_hi, ht_lo, exp_hi, exp_lo, then
// per column: set, isnull, cmp ([n_rows, width] int32), arith (float32, or
// null). out: valid, live, then per column: set, isnull, cmp, arith (null
// where the input's is). width: order planes per row of each column.
// read_* / rexp_*: the read point's and the expiry read point's planes.
int mvcc_resolve_launch(const void* const* in, void* const* out,
                        const int32_t* width, int n_cols, long long n_rows,
                        int rows_per_block, int read_hi, int read_lo,
                        int rexp_hi, int rexp_lo, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols) return kErrCols;
  if (n_rows < 0 || n_rows >= (1ll << 31) || rows_per_block < 1 ||
      n_rows % rows_per_block != 0) {
    return kErrRows;
  }
  for (int k = 0; k < kRunPlanes; ++k) {
    if (in[k] == nullptr) return kErrPlane;
  }
  if (out[0] == nullptr || out[1] == nullptr) return kErrPlane;
  Params p{};
  p.valid = static_cast<const uint8_t*>(in[0]);
  p.group_start = static_cast<const uint8_t*>(in[1]);
  p.tomb = static_cast<const uint8_t*>(in[2]);
  p.live = static_cast<const uint8_t*>(in[3]);
  p.ht_hi = static_cast<const int32_t*>(in[4]);
  p.ht_lo = static_cast<const int32_t*>(in[5]);
  p.exp_hi = static_cast<const int32_t*>(in[6]);
  p.exp_lo = static_cast<const int32_t*>(in[7]);
  p.out_valid = static_cast<uint8_t*>(out[0]);
  p.out_live = static_cast<uint8_t*>(out[1]);
  for (int c = 0; c < n_cols; ++c) {
    const void* const* ci = in + kRunPlanes + 4 * c;
    void* const* co = out + 2 + 4 * c;
    if (width[c] != 1 && width[c] != 2) return kErrWidth;
    if (ci[0] == nullptr || ci[1] == nullptr || ci[2] == nullptr ||
        co[0] == nullptr || co[1] == nullptr || co[2] == nullptr ||
        (ci[3] == nullptr) != (co[3] == nullptr)) {
      return kErrPlane;
    }
    // The view's two-plane order values are stored 8 bytes at a time.
    if (width[c] == 2 && reinterpret_cast<uintptr_t>(co[2]) % 8 != 0) {
      return kErrPlane;
    }
    p.set[c] = static_cast<const uint8_t*>(ci[0]);
    p.isnull[c] = static_cast<const uint8_t*>(ci[1]);
    p.cmp[c] = static_cast<const int32_t*>(ci[2]);
    p.arith[c] = static_cast<const uint32_t*>(ci[3]);
    p.out_set[c] = static_cast<uint8_t*>(co[0]);
    p.out_isnull[c] = static_cast<uint8_t*>(co[1]);
    p.out_cmp[c] = static_cast<int32_t*>(co[2]);
    p.out_arith[c] = static_cast<uint32_t*>(co[3]);
    p.width[c] = width[c];
  }
  p.n_cols = n_cols;
  p.n_rows = static_cast<int32_t>(n_rows);
  p.rows_per_block = rows_per_block;
  p.tile_rows = rows_per_block <= kTileMax
                    ? kTileMax / rows_per_block * rows_per_block
                    : kTileMax;
  p.read = ordered_key(read_hi, read_lo);
  p.rexp = ordered_key(rexp_hi, rexp_lo);
  if (n_rows == 0) return 0;
  const long long blocks = (n_rows + p.tile_rows - 1) / p.tile_rows;
  // s_dyn: the set flags (a byte a row and column), then the setters (two
  // bytes a row and column), 16-byte aligned.
  p.setter_offset = (p.tile_rows * n_cols + 15) / 16 * 16;
  const int dyn_bytes = p.setter_offset + 2 * p.tile_rows * n_cols;
  p.aligned = p.tile_rows % 16 == 0;
  for (int k = 0; k < kRunPlanes; ++k) {
    p.aligned = p.aligned && reinterpret_cast<uintptr_t>(in[k]) % 16 == 0;
  }
  for (int c = 0; c < n_cols; ++c) {
    p.aligned = p.aligned && reinterpret_cast<uintptr_t>(p.set[c]) % 16 == 0;
  }
  if (dyn_bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        mvcc_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dyn_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mvcc_resolve_kernel<<<static_cast<unsigned>(blocks), kThreads, dyn_bytes,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mvcc_resolve_error_string(int code) {
  switch (code) {
    case kErrCols: return "column count out of range";
    case kErrRows: return "row count out of range or not whole blocks";
    case kErrPlane: return "a required plane is missing or misaligned";
    case kErrWidth: return "a column has neither 1 nor 2 order planes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
