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
// Design (the first, simple one): a warp a key group, groups in a grid
// stride. The group's rows go in 32-row warp steps, a lane a row, three
// times:
//   1. the tombstone maximum over the visible versions (a warp max of the
//      rows' ordered 64-bit hybrid times);
//   2. alive, then each column's first alive setter and the first alive
//      unexpired liveness, each a __ballot_sync masked to the columns not
//      yet found; a found contributor's span of equal hybrid time is then
//      grown left and right in warp steps (a span may cross a step) and
//      recorded in shared memory; the pass stops once every answer is
//      known;
//   3. keep, written a lane a row.
// A group of L rows costs about L / 32 steps a pass. Groups of one or two
// versions (a flat run's keys) leave most of a warp idle: the bench
// table's 2M-row union has ~1M groups.
//
// Interface: plain C, for ctypes. gc_mask_launch returns 0, a negative
// code for an argument it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

// Each warp's contributor spans (dynamic shared memory).
extern __shared__ __align__(16) int32_t s_spans[];

namespace {

constexpr int kMaxCols = 256;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRunPlanes = 6;  // ht hi/lo, exp hi/lo, tomb, live
constexpr uint32_t kBias = 0x80000000u;
constexpr uint32_t kFull = 0xffffffffu;
// The ordered key of hybrid time 0 (hi 0, lo -2^31): a pad row's.
constexpr uint64_t kPadKey = 0x8000000000000000ull;

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
  long long n_groups;
  long long n_rows;
  uint64_t cut;      // the cutoff, as an ordered key
  uint64_t cut_exp;  // the expiry cutoff, as an ordered key
};

// (hi, lo) int32 planes, compared lexicographically as signed words ->
// one unsigned 64-bit key of the same order.
__host__ __device__ __forceinline__ uint64_t ordered_key(int32_t hi,
                                                         int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi) ^ kBias) << 32) |
         (static_cast<uint32_t>(lo) ^ kBias);
}

// Where a union row lives: its run's plane pointers and its row there
// (no pointers for a pad row).
struct Loc {
  const long long* planes;
  long long row;
};

__device__ __forceinline__ Loc locate(const Params& p, long long i) {
  Loc loc{nullptr, -1};
  const int32_t f = p.idx[i];
  if (f < 0) return loc;
  const long long* offsets = p.table + static_cast<long long>(p.n_runs) *
                                           (kRunPlanes + p.n_cols);
  int r = 0;
  while (r + 1 < p.n_runs && f >= offsets[r + 1]) ++r;
  loc.planes = p.table + static_cast<long long>(r) * (kRunPlanes + p.n_cols);
  loc.row = f - offsets[r];
  return loc;
}

__device__ __forceinline__ uint64_t ht_key(const Loc& l) {
  if (l.planes == nullptr) return kPadKey;
  return ordered_key(reinterpret_cast<const int32_t*>(l.planes[0])[l.row],
                     reinterpret_cast<const int32_t*>(l.planes[1])[l.row]);
}

__device__ __forceinline__ uint64_t exp_key(const Loc& l) {
  if (l.planes == nullptr) return kPadKey;
  return ordered_key(reinterpret_cast<const int32_t*>(l.planes[2])[l.row],
                     reinterpret_cast<const int32_t*>(l.planes[3])[l.row]);
}

__device__ __forceinline__ bool flag(const Loc& l, int plane) {
  if (l.planes == nullptr) return false;
  return reinterpret_cast<const uint8_t*>(l.planes[plane])[l.row] != 0;
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Grows the span of equal hybrid time ``key`` around row j within the
// group's rows [g0, g1): its first and last rows.
__device__ void span_of(const Params& p, long long j, uint64_t key,
                        long long g0, long long g1, int lane,
                        long long* first, long long* last) {
  long long lo = j;
  while (lo > g0) {  // rows lo - 1, lo - 2, ... a lane each
    const long long i = lo - 1 - lane;
    const bool same = i >= g0 && ht_key(locate(p, i)) == key;
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
    const bool same = i < g1 && ht_key(locate(p, i)) == key;
    const uint32_t m = __ballot_sync(kFull, same);
    if (m == kFull) {
      hi += 32;
      continue;
    }
    hi += __ffs(~m) - 1;
    break;
  }
  *first = lo;
  *last = hi;
}

__global__ void __launch_bounds__(kThreads)
    gc_mask_kernel(const __grid_constant__ Params p) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // This warp's spans: (first, last) pairs as int32 offsets from the
  // group's first row, at most one a contributor.
  int32_t* spans = s_spans + warp * 2 * (p.n_cols + 1);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
       g < p.n_groups; g += stride) {
    const long long g0 = p.group_start[g];
    const long long g1 = g + 1 < p.n_groups ? p.group_start[g + 1]
                                            : p.n_rows;
    // 1. The newest visible tombstone (0: none; a real key is >= 2^63).
    uint64_t tomb = 0;
    for (long long base = g0; base < g1; base += 32) {
      const long long i = base + lane;
      uint64_t t = 0;
      if (i < g1) {
        const Loc l = locate(p, i);
        const uint64_t k = ht_key(l);
        if (k <= p.cut && flag(l, 4)) t = k;
      }
      t = warp_max(t);
      tomb = t > tomb ? t : tomb;
    }
    const bool has_tomb = tomb != 0;
    // 2. The contributors and their spans. ``todo`` bit c (word c / 32):
    // column c's setter not found yet; the liveness is ``live_todo``.
    // (Every loop over the words has constant bounds, so that the words
    // stay in registers.)
    uint32_t todo[kMaxCols / 32];
#pragma unroll
    for (int w = 0; w < kMaxCols / 32; ++w) {
      const int n = p.n_cols - 32 * w;
      todo[w] = n >= 32 ? kFull : n > 0 ? (1u << n) - 1 : 0u;
    }
    bool live_todo = true;
    int n_spans = 0;
    for (long long base = g0; base < g1; base += 32) {
      const long long i = base + lane;
      Loc l{nullptr, -1};
      uint64_t k = kPadKey;
      bool alive = false;
      if (i < g1) {
        l = locate(p, i);
        k = ht_key(l);
        alive = k <= p.cut && !flag(l, 4) && !(has_tomb && k <= tomb);
      }
      uint32_t hits = 0;  // lanes of this step that contribute
      if (live_todo) {
        const bool ok = alive && flag(l, 5) && !(exp_key(l) <= p.cut_exp);
        const uint32_t m = __ballot_sync(kFull, ok);
        if (m) {
          hits |= 1u << (__ffs(m) - 1);
          live_todo = false;
        }
      }
      bool any_todo = live_todo;
#pragma unroll
      for (int w = 0; w < kMaxCols / 32; ++w) {
        uint32_t cols = todo[w];
        while (cols) {
          const int c = 32 * w + __ffs(cols) - 1;
          cols &= cols - 1;
          const bool set = alive && flag(l, kRunPlanes + c);
          const uint32_t m = __ballot_sync(kFull, set);
          if (m) {
            hits |= 1u << (__ffs(m) - 1);
            todo[w] &= ~(1u << (c - 32 * w));
          }
        }
        any_todo = any_todo || todo[w] != 0;
      }
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const uint64_t key = __shfl_sync(kFull, k, src);
        long long first, last;
        span_of(p, base + src, key, g0, g1, lane, &first, &last);
        if (lane == 0) {
          spans[2 * n_spans] = static_cast<int32_t>(first - g0);
          spans[2 * n_spans + 1] = static_cast<int32_t>(last - g0);
        }
        ++n_spans;
      }
      if (!any_todo) break;
    }
    __syncwarp();
    // 3. keep.
    for (long long base = g0; base < g1; base += 32) {
      const long long i = base + lane;
      if (i >= g1) continue;
      const uint64_t k = ht_key(locate(p, i));
      bool in_span = false;
      const int32_t off = static_cast<int32_t>(i - g0);
      for (int s = 0; s < n_spans; ++s) {
        in_span = in_span || (spans[2 * s] <= off && off <= spans[2 * s + 1]);
      }
      const bool visible = k <= p.cut;
      p.keep[i] = (!visible || (in_span && !(has_tomb && k <= tomb))) ? 1 : 0;
    }
    __syncwarp();
  }
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
  p.n_groups = n_groups;
  p.n_rows = n_rows;
  p.cut = ordered_key(cut_hi, cut_lo);
  p.cut_exp = ordered_key(cexp_hi, cexp_lo);
  if (n_groups == 0) return 0;
  const int smem = kWarps * 2 * (n_cols + 1) * static_cast<int>(sizeof(int32_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gc_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long want = (n_groups + kWarps - 1) / kWarps;
  const unsigned blocks =
      static_cast<unsigned>(want < (1ll << 30) ? want : (1ll << 30));
  gc_mask_kernel<<<blocks, kThreads, smem,
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
