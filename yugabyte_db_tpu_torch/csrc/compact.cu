// The retention mask of a compaction (history GC over the merge order),
// for Hopper (sm_90a): K11.
//
// Replaces the JAX package's XLA program yugabyte_db_tpu/ops/compact.py
// resident_gc_mask (over gc_mask, compiled_gc_mask). The engine computes
// the merge ORDER of its runs on the host; this kernel decides which rows
// of the sorted union (key asc, hybrid time desc) survive a compaction at
// a history cutoff, exactly as storage/cpu_engine.py gc_versions does key
// by key. Per key group, at the cutoff:
//   - visible = hybrid time <= cutoff; the group's newest visible
//     tombstone t shadows every row at or below it;
//   - alive = visible, not a tombstone, not shadowed;
//   - contributors: each column's first alive setter, and the first alive
//     row with the liveness marker and an expiry after the expiry cutoff;
//   - a row is kept if it is newer than the cutoff, or if it lies in a
//     span of equal hybrid time (contiguous rows of the group) that holds a
//     contributor, unless it is at or below t.
// Each union row's planes are read through idx from the runs' resident
// planes (a pointer table a run and each run's flat offset); idx < 0 is a
// pad row, read as hybrid time 0 and expiry 0 with no flag set.
//
// What bounds it: bytes. Each row's index, hybrid time, expiry, tombstone,
// liveness and set flags are read once and its keep flag written once
// (ops/compact.py mask_bytes): ~28 bytes a row of the bench table. The
// integer work is a few dozen operations a row.
//
// What stood in the way (the first design, a warp a key group): the bench
// union's groups hold 1-3 versions, so 30 of 32 lanes idled at every warp
// step, and each group's planes were read through idx in three passes
// and more.
//
// Design: the resolve's (csrc/mvcc_resolve.cu), over a union read through
// idx. A block owns the key groups whose first row lies in its tile of
// union rows (ops/compact.py tile_rows mirrors the tile and the rows
// staged; a 32-way search of group_start by one warp each finds where the
// owned groups start and end).
//   1. Stage. A thread a row reads idx once (coalesced), finds the row's
//      run by a binary search of the run offsets (in shared memory), and
//      gathers the row's planes once into shared memory as packed words:
//      the ordered 64-bit hybrid-time key, a flag byte (tombstone; alive
//      liveness candidate: the marker with an expiry after the expiry
//      cutoff; group start) and one word of set bits a 32 columns. The
//      group starts come from group_start.
//   2. Resolve. Each warp takes an eighth of the block's groups and moves
//      from group start to group start in 32-row windows, a lane a row,
//      resolving every group that closes in the window at once: a
//      __ballot_sync of the group starts gives each lane its group; the
//      newest visible tombstone is a segmented warp max, known before any
//      row is called alive (the same-hybrid-time tie: a tombstone shadows
//      both sides of its span); the first alive liveness candidate is a
//      first-set-bit query on a ballot masked to the group's lanes, and
//      each column's first alive setter the first bit of a segmented
//      prefix OR of the set words (a few shuffles for 32 columns); spans
//      of equal hybrid time are segmented by a second ballot (a group
//      start, or a key that differs from the row before) and kept if they
//      hold a contributor. A group that does not close in its window (or
//      runs past the rows staged) goes in warp steps: a sweep to its end
//      and its tombstone, a sweep for its contributors that stops once
//      every answer is known (each contributor's span grown in warp
//      steps, so a span may cross windows), and the keep sweep; rows past
//      the staged ones are read from the runs.
//   3. Write. keep is written from shared memory, coalesced (the rows of a
//      group past the staged ones by their warp).
//
// Interface: plain C, for ctypes. gc_mask_launch returns 0, a negative
// code for an argument it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

// The block's staged rows, run offsets, spans and keep flags (dynamic
// shared memory).
extern __shared__ __align__(16) uint8_t s_dyn[];

namespace {

constexpr int kMaxCols = 256;
constexpr int kMaxWords = kMaxCols / 32;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;  // blocks an SM the register cap is set for
constexpr int kRunPlanes = 6;  // ht hi/lo, exp hi/lo, tomb, live
constexpr int kSharedRuns = 64;  // run offsets held in shared memory
constexpr uint32_t kBias = 0x80000000u;
constexpr uint32_t kFull = 0xffffffffu;
// The ordered key of hybrid time 0 (hi 0, lo -2^31): a pad row's.
constexpr uint64_t kPadKey = 0x8000000000000000ull;

// A staged row's flags.
enum : uint32_t { kTomb = 1, kLive = 2, kStart = 4 };

enum Err : int {
  kErrCols = -1,
  kErrRows = -2,
  kErrPlane = -3,
};

struct Params {
  // [n_runs][kRunPlanes + n_cols] plane pointers, then n_runs + 1 flat
  // offsets.
  const long long* table;
  const int32_t* idx;
  const int32_t* group_start;
  uint8_t* keep;
  int n_runs;
  int n_cols;
  int n_words;  // words of set bits a row: ceil(n_cols / 32)
  int tile;     // union rows whose groups a block owns
  int cap;      // union rows a block stages
  long long n_groups;
  long long n_rows;
  uint64_t cut;      // the cutoff, as an ordered key
  uint64_t cut_exp;  // the expiry cutoff, as an ordered key
};

// Union rows a tile (ops/compact.py tile_rows mirrors both).
int tile_rows(int n_cols) { return n_cols <= 32 ? 2048 : 1024; }
int staged_rows(int n_cols) { return tile_rows(n_cols) * 3 / 2; }

// Bytes of dynamic shared memory at each part's start, and in all.
struct Smem {
  int key, set, offs, span, flag, keep, total;
};

__host__ __device__ Smem smem_layout(int cap, int n_words, int n_cols,
                                     int n_runs) {
  Smem s{};
  s.key = 0;
  s.set = s.key + 8 * cap;
  s.offs = s.set + 4 * n_words * cap;
  s.span = s.offs + (n_runs <= kSharedRuns ? 8 * (n_runs + 1) : 0);
  s.flag = s.span + 4 * kWarps * 2 * (n_cols + 1);
  s.keep = s.flag + cap;
  s.total = s.keep + cap;
  return s;
}

// (hi, lo) int32 planes, compared lexicographically as signed words ->
// one unsigned 64-bit key of the same order.
__host__ __device__ __forceinline__ uint64_t ordered_key(int32_t hi,
                                                         int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi) ^ kBias) << 32) |
         (static_cast<uint32_t>(lo) ^ kBias);
}

// Lanes [lo, hi) as a mask; 0 <= lo <= 32, lo <= hi <= 32.
__device__ __forceinline__ uint32_t lanes(int lo, int hi) {
  const uint32_t below_hi = hi >= 32 ? kFull : (1u << hi) - 1u;
  const uint32_t below_lo = lo >= 32 ? kFull : (1u << lo) - 1u;
  return below_hi & ~below_lo;
}

__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max64(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The first index j of the ascending a[0, n) with a[j] >= x (n if none),
// found by the 32 lanes of a warp together: each step probes 32 places
// and keeps the piece between the last below x and the first not.
__device__ __forceinline__ long long warp_lower_bound(const int32_t* a,
                                                      long long n, long long x,
                                                      int lane) {
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long probe = lo + (lane + 1) * step - 1;
    const bool below = probe < hi && __ldg(a + probe) < x;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c < 32) hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  const long long probe = lo + lane;
  const bool below = probe < hi && __ldg(a + probe) < x;
  return lo + __popc(__ballot_sync(kFull, below));
}

// Where a union row lives: its run's plane pointers and its row there
// (no pointers for a pad row).
struct Loc {
  const long long* planes;
  long long row;
};

__device__ __forceinline__ Loc locate(const Params& p, const long long* offs,
                                      int32_t f) {
  if (f < 0) return Loc{nullptr, -1};
  int lo = 0, hi = p.n_runs;  // offs[lo] <= f < offs[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (f >= offs[mid]) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return Loc{p.table + static_cast<long long>(lo) * (kRunPlanes + p.n_cols),
             f - offs[lo]};
}

template <typename T>
__device__ __forceinline__ T plane_at(const Loc& l, int plane) {
  return __ldg(reinterpret_cast<const T*>(l.planes[plane]) + l.row);
}

// A row's key and flags (no group start) read from its run.
struct Row {
  uint64_t key;
  uint32_t flags;
};

__device__ __forceinline__ Row row_at(const Params& p, const Loc& l) {
  if (l.planes == nullptr) return Row{kPadKey, 0};
  Row x{ordered_key(plane_at<int32_t>(l, 0), plane_at<int32_t>(l, 1)), 0};
  if (plane_at<uint8_t>(l, 4)) x.flags |= kTomb;
  if (plane_at<uint8_t>(l, 5) &&
      ordered_key(plane_at<int32_t>(l, 2), plane_at<int32_t>(l, 3)) >
          p.cut_exp) {
    x.flags |= kLive;
  }
  return x;
}

// Set bits of columns [32 w, 32 w + 32) of a row, read from its run.
__device__ __forceinline__ uint32_t set_word_at(const Params& p, const Loc& l,
                                                int w) {
  uint32_t bits = 0;
  if (l.planes == nullptr) return bits;
  const int n = min(32, p.n_cols - 32 * w);
  for (int c = 0; c < n; ++c) {
    if (plane_at<uint8_t>(l, kRunPlanes + 32 * w + c)) bits |= 1u << c;
  }
  return bits;
}

// The block's staged rows [lo, lo + n) of the union, in shared memory:
// each row's key, flags and set words (word w of row k at sets[w * cap +
// k]) and its keep flag; a row past them is read from the runs and its
// keep flag written to device memory.
struct Tile {
  long long lo;
  int n;
  int cap;
  const uint64_t* key;
  const uint32_t* sets;
  const uint8_t* flag;
  uint8_t* keep;
  const long long* offs;  // the run offsets (shared, or in the table)
};

__device__ __forceinline__ Row load_row(const Params& p, const Tile& tl,
                                        long long i) {
  const long long k = i - tl.lo;
  if (k >= 0 && k < tl.n) return Row{tl.key[k], tl.flag[k]};
  return row_at(p, locate(p, tl.offs, __ldg(p.idx + i)));
}

__device__ __forceinline__ uint32_t set_word(const Params& p, const Tile& tl,
                                             long long i, int w) {
  const long long k = i - tl.lo;
  if (k >= 0 && k < tl.n) return tl.sets[w * tl.cap + k];
  return set_word_at(p, locate(p, tl.offs, __ldg(p.idx + i)), w);
}

__device__ __forceinline__ void put_keep(const Params& p, const Tile& tl,
                                         long long i, bool keep) {
  const long long k = i - tl.lo;
  if (k >= 0 && k < tl.n) {
    tl.keep[k] = keep;
  } else {
    p.keep[i] = keep;
  }
}

// Resolves the groups that close in the 32-row window at group start
// `cur` (rows at or past `lim` belong to others) and writes their keep
// flags. Returns the rows resolved, or 0 when the group at `cur` does not
// close in the window.
__device__ __forceinline__ int resolve_window(const Params& p, const Tile& tl,
                                              long long cur, long long lim,
                                              int lane) {
  const long long i = cur + lane;
  Row x{kPadKey, 0};
  if (i < lim) x = load_row(p, tl, i);
  const uint32_t starts =
      __ballot_sync(kFull, i >= lim || lane == 0 || (x.flags & kStart));
  bool next = false;  // lane 31: the row after the window starts a group
  if (lane == 31) {
    next = cur + 32 >= lim || (load_row(p, tl, cur + 32).flags & kStart);
  }
  const uint32_t later = starts & ~1u;
  int e;
  if (__ballot_sync(kFull, next)) {
    e = 32;
  } else if (later) {
    e = 31 - __clz(later);  // the group there stays open
  } else {
    return 0;
  }
  e = static_cast<int>(min(static_cast<long long>(e), lim - cur));
  // This lane's group: lanes [first, next_start).
  const uint32_t upto = lanes(0, lane + 1);
  const int first = 31 - __clz(starts & upto);
  const uint32_t after = starts & ~upto;
  const int last = (after ? __ffs(after) - 1 : 32) - 1;
  const bool in = lane < e;

  // The group's newest visible tombstone: a segmented warp max.
  const bool visible = in && x.key <= p.cut;
  uint64_t t = visible && (x.flags & kTomb) ? x.key : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t u = __shfl_up_sync(kFull, t, o);
    if (lane - o >= first) t = max64(t, u);
  }
  t = __shfl_sync(kFull, t, last);
  const bool shadowed = t != 0 && x.key <= t;
  const bool alive = visible && !(x.flags & kTomb) && !shadowed;

  // Contributors: the first alive liveness candidate, and each column's
  // first alive setter (the set bits no earlier row of the group has).
  const uint32_t lv = __ballot_sync(kFull, alive && (x.flags & kLive));
  bool contrib = (lv >> lane & 1u) && !(lv & lanes(first, lane));
  for (int w = 0; w < p.n_words; ++w) {
    const uint32_t s = alive ? set_word(p, tl, i, w) : 0u;
    uint32_t inc = s;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, inc, o);
      if (lane - o >= first) inc |= u;
    }
    uint32_t exc = __shfl_up_sync(kFull, inc, 1);
    if (lane == first) exc = 0;
    contrib = contrib || (s & ~exc) != 0;
  }

  // Spans of equal hybrid time, kept if they hold a contributor.
  const uint64_t prev = __shfl_up_sync(kFull, x.key, 1);
  const uint32_t spans =
      __ballot_sync(kFull, lane == first || prev != x.key);
  const uint32_t held = __ballot_sync(kFull, contrib);
  const int s0 = 31 - __clz(spans & upto);
  const uint32_t s_after = spans & ~upto;
  const int s1 = s_after ? __ffs(s_after) - 1 : 32;
  const bool kept = (held & lanes(s0, s1)) != 0;
  if (in) put_keep(p, tl, i, x.key > p.cut || (kept && !shadowed));
  return e;
}

// The first and last rows of the span of equal hybrid time `key` around
// row j within the group's rows [g0, g1).
struct Span {
  long long first, last;
};

__device__ __forceinline__ Span span_of(const Params& p, const Tile& tl,
                                        long long j, uint64_t key,
                                        long long g0, long long g1, int lane) {
  long long lo = j;
  while (lo > g0) {  // rows lo - 1, lo - 2, ... a lane each
    const long long i = lo - 1 - lane;
    const bool same = i >= g0 && load_row(p, tl, i).key == key;
    const uint32_t m = __ballot_sync(kFull, same);
    if (m == kFull) {
      lo -= 32;
      continue;
    }
    lo -= __ffs(~m) - 1;
    break;
  }
  long long hi = j;
  while (hi + 1 < g1) {  // rows hi + 1, hi + 2, ...
    const long long i = hi + 1 + lane;
    const bool same = i < g1 && load_row(p, tl, i).key == key;
    const uint32_t m = __ballot_sync(kFull, same);
    if (m == kFull) {
      hi += 32;
      continue;
    }
    hi += __ffs(~m) - 1;
    break;
  }
  return Span{lo, hi};
}

// Resolves the group that starts at `cur` and does not close in its
// window, in warp steps, and writes its keep flags. Returns its end.
// spans: this warp's (first, last) pairs, offsets from `cur`.
__device__ __forceinline__ long long resolve_long(const Params& p,
                                                  const Tile& tl,
                                                  long long cur, long long lim,
                                                  int lane, int32_t* spans) {
  // 1. The group's end and its newest visible tombstone.
  long long end = lim;
  uint64_t t = 0;
  for (long long base = cur; base < end; base += 32) {
    const long long i = base + lane;
    Row x{kPadKey, 0};
    if (i < end) x = load_row(p, tl, i);
    const uint32_t ends =
        __ballot_sync(kFull, i >= end || (i != cur && (x.flags & kStart)));
    if (ends) end = min(end, base + __ffs(ends) - 1);
    const bool tomb = i < end && x.key <= p.cut && (x.flags & kTomb);
    t = max64(t, warp_max(tomb ? x.key : 0));
  }
  // 2. The contributors and their spans, until every answer is known.
  // ``todo`` bit c of word w: column 32 w + c's setter not found yet.
  // (Every loop over the words has constant bounds, so that the words
  // stay in registers.)
  uint32_t todo[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const int n = p.n_cols - 32 * w;
    todo[w] = n >= 32 ? kFull : n > 0 ? (1u << n) - 1 : 0u;
  }
  bool live_todo = true;
  int n_spans = 0;
  for (long long base = cur; base < end; base += 32) {
    const long long i = base + lane;
    Row x{kPadKey, 0};
    if (i < end) x = load_row(p, tl, i);
    const bool alive = i < end && x.key <= p.cut && !(x.flags & kTomb) &&
                       !(t != 0 && x.key <= t);
    uint32_t hits = 0;  // lanes of this step that contribute
    if (live_todo) {
      const uint32_t m = __ballot_sync(kFull, alive && (x.flags & kLive));
      if (m) {
        hits |= m & (~m + 1u);
        live_todo = false;
      }
    }
    bool any_todo = live_todo;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (todo[w]) {
        const uint32_t s = alive ? set_word(p, tl, i, w) : 0u;
        uint32_t cols = todo[w];
        while (cols) {
          const int c = __ffs(cols) - 1;
          cols &= cols - 1;
          const uint32_t m = __ballot_sync(kFull, (s >> c) & 1u);
          if (m) {
            hits |= m & (~m + 1u);
            todo[w] &= ~(1u << c);
          }
        }
      }
      any_todo = any_todo || todo[w] != 0;
    }
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
      const uint64_t key = __shfl_sync(kFull, x.key, src);
      const Span s = span_of(p, tl, base + src, key, cur, end, lane);
      if (lane == 0) {
        spans[2 * n_spans] = static_cast<int32_t>(s.first - cur);
        spans[2 * n_spans + 1] = static_cast<int32_t>(s.last - cur);
      }
      ++n_spans;
    }
    if (!any_todo) break;
  }
  __syncwarp();
  // 3. keep.
  for (long long base = cur; base < end; base += 32) {
    const long long i = base + lane;
    if (i >= end) continue;
    const uint64_t key = load_row(p, tl, i).key;
    const int32_t off = static_cast<int32_t>(i - cur);
    bool in_span = false;
    for (int s = 0; s < n_spans; ++s) {
      in_span = in_span || (spans[2 * s] <= off && off <= spans[2 * s + 1]);
    }
    put_keep(p, tl, i, key > p.cut || (in_span && !(t != 0 && key <= t)));
  }
  __syncwarp();
  return end;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gc_mask_kernel(const __grid_constant__ Params p) {
  const Smem sm = smem_layout(p.cap, p.n_words, p.n_cols, p.n_runs);
  uint64_t* s_key = reinterpret_cast<uint64_t*>(s_dyn + sm.key);
  uint32_t* s_set = reinterpret_cast<uint32_t*>(s_dyn + sm.set);
  long long* s_offs = reinterpret_cast<long long*>(s_dyn + sm.offs);
  int32_t* s_span = reinterpret_cast<int32_t*>(s_dyn + sm.span);
  uint8_t* s_flag = s_dyn + sm.flag;
  uint8_t* s_keep = s_dyn + sm.keep;
  __shared__ long long s_groups[2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // The groups this block owns: those starting in its tile.
  const long long t0 = static_cast<long long>(blockIdx.x) * p.tile;
  const long long t1 = min(t0 + p.tile, p.n_rows);
  if (warp < 2) {
    const long long g =
        warp_lower_bound(p.group_start, p.n_groups, warp ? t1 : t0, lane);
    if (lane == 0) s_groups[warp] = g;
  }
  const long long* g_offs =
      p.table + static_cast<long long>(p.n_runs) * (kRunPlanes + p.n_cols);
  const bool shared_offs = p.n_runs <= kSharedRuns;
  if (shared_offs) {
    for (int k = threadIdx.x; k <= p.n_runs; k += kThreads) {
      s_offs[k] = g_offs[k];
    }
  }
  __syncthreads();
  const long long ga = s_groups[0], gb = s_groups[1];
  if (ga >= gb) return;  // the whole block: no group starts in the tile
  const long long lo = p.group_start[ga];
  const long long hi = gb < p.n_groups ? p.group_start[gb] : p.n_rows;
  const Tile tl{lo,
                static_cast<int>(min(static_cast<long long>(p.cap), hi - lo)),
                p.cap,
                s_key,
                s_set,
                s_flag,
                s_keep,
                shared_offs ? s_offs : g_offs};

  // 1. Stage.
  for (int k = threadIdx.x; k < tl.n; k += kThreads) {
    const Loc l = locate(p, tl.offs, __ldg(p.idx + lo + k));
    const Row x = row_at(p, l);
    s_key[k] = x.key;
    s_flag[k] = static_cast<uint8_t>(x.flags);
    for (int w = 0; w < p.n_words; ++w) s_set[w * p.cap + k] = set_word_at(p, l, w);
  }
  __syncthreads();
  for (long long g = ga + threadIdx.x; g < gb; g += kThreads) {
    s_flag[p.group_start[g] - lo] |= kStart;
  }
  __syncthreads();

  // 2. Resolve: an eighth of the groups a warp.
  const long long per = (gb - ga + kWarps - 1) / kWarps;
  const long long w0 = ga + warp * per;
  const long long w1 = min(gb, w0 + per);
  if (w0 < w1) {
    long long cur = p.group_start[w0];
    const long long lim = w1 < gb ? p.group_start[w1] : hi;
    int32_t* spans = s_span + warp * 2 * (p.n_cols + 1);
    while (cur < lim) {
      const int e = resolve_window(p, tl, cur, lim, lane);
      cur = e > 0 ? cur + e : resolve_long(p, tl, cur, lim, lane, spans);
    }
  }
  __syncthreads();

  // 3. Write.
  for (int k = threadIdx.x; k < tl.n; k += kThreads) p.keep[lo + k] = s_keep[k];
}

}  // namespace

extern "C" {

// desc: device int64 [n_runs * (6 + n_cols) + n_runs + 1]: each run's
// plane pointers (ht_hi, ht_lo, exp_hi, exp_lo, tomb, live, then each
// column's set plane), then each run's flat offset and the total. idx:
// [n_rows] int32; group_start: [n_groups] int32 (the first is 0); keep:
// [n_rows] bool. cut_* / cexp_*: the cutoff's and the expiry cutoff's
// planes.
int gc_mask_launch(const void* desc, int n_runs, int n_cols, const void* idx,
                   const void* group_start, long long n_groups,
                   long long n_rows, int cut_hi, int cut_lo, int cexp_hi,
                   int cexp_lo, void* keep, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols) return kErrCols;
  if (n_rows < 0 || n_rows >= (1ll << 31) || n_groups < 0 ||
      n_groups > n_rows || (n_rows > 0 && n_groups == 0)) {
    return kErrRows;
  }
  if (desc == nullptr || idx == nullptr || group_start == nullptr ||
      keep == nullptr || n_runs < 1) {
    return kErrPlane;
  }
  Params p{};
  p.table = static_cast<const long long*>(desc);
  p.idx = static_cast<const int32_t*>(idx);
  p.group_start = static_cast<const int32_t*>(group_start);
  p.keep = static_cast<uint8_t*>(keep);
  p.n_runs = n_runs;
  p.n_cols = n_cols;
  p.n_words = (n_cols + 31) / 32;
  p.tile = tile_rows(n_cols);
  p.cap = staged_rows(n_cols);
  p.n_groups = n_groups;
  p.n_rows = n_rows;
  p.cut = ordered_key(cut_hi, cut_lo);
  p.cut_exp = ordered_key(cexp_hi, cexp_lo);
  if (n_groups == 0) return 0;
  const int smem = smem_layout(p.cap, p.n_words, n_cols, n_runs).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gc_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_rows + p.tile - 1) / p.tile;
  gc_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* gc_mask_error_string(int code) {
  switch (code) {
    case kErrCols: return "column count out of range";
    case kErrRows: return "row or group count out of range";
    case kErrPlane: return "a required pointer is missing";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
