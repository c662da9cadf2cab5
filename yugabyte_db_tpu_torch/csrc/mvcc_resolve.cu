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
// the view's valid, live and column planes are written once. A handful
// of integer compares per row against the card's integer rate is far
// below the bytes.
//
// Design: one thread per row. A thread whose row starts a group walks the
// group (at most R rows, usually a few) twice: once for the newest visible
// tombstone, once for liveness and the first setter of each column (kept
// in registers, the column loop unrolled to kMaxCols with a uniform
// guard). Every thread then writes its own row of the view, zeros where
// the row is not a representative, so stores coalesce. Reads by a walking
// thread are scattered within its group; groups of one or two versions
// keep them close to coalesced. A simple kernel first: a warp waits for
// its longest group, and the hybrid-time planes are read twice per group
// (the second time from L1).
//
// Interface: plain C, for ctypes. mvcc_resolve_launch returns 0, a
// negative code for an argument it refuses, or the launch's
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
// Resident blocks per SM the kernel is built for: a register cap of 64
// (with kThreads alone, ptxas caps it at 32 and spills).
constexpr int kMinBlocks = 4;
constexpr int kRunPlanes = 8;  // valid, group_start, tomb, live, ht hi/lo, exp hi/lo
constexpr uint32_t kBias = 0x80000000u;

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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mvcc_resolve_kernel(const Params p) {
  // 64-bit: the grid covers n_rows < 2^31 rows, and the last block may
  // run past them.
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= p.n_rows) return;
  const int32_t r = static_cast<int32_t>(row);
  const bool rep = p.group_start[r] && p.valid[r];
  bool live_any = false;
  int32_t first[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) first[c] = -1;
  if (rep) {
    const int32_t block_end =
        min(p.n_rows, (r / p.rows_per_block + 1) * p.rows_per_block);
    int32_t end = r + 1;
    while (end < block_end && !p.group_start[end]) ++end;
    bool has_tomb = false;
    uint64_t tomb_key = 0;
    for (int32_t i = r; i < end; ++i) {
      if (!p.valid[i] || !p.tomb[i]) continue;
      const uint64_t h = ordered_key(p.ht_hi[i], p.ht_lo[i]);
      if (h <= p.read) {
        has_tomb = true;
        tomb_key = h;
        break;
      }
    }
    for (int32_t i = r; i < end; ++i) {
      if (!p.valid[i] || p.tomb[i]) continue;
      const uint64_t h = ordered_key(p.ht_hi[i], p.ht_lo[i]);
      if (h > p.read || (has_tomb && h <= tomb_key)) continue;
      const bool expired = ordered_key(p.exp_hi[i], p.exp_lo[i]) <= p.rexp;
      live_any |= p.live[i] && !expired;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < p.n_cols && first[c] < 0 && p.set[c][i]) first[c] = i;
      }
    }
  }
  p.out_valid[r] = rep;
  p.out_live[r] = rep && live_any;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.n_cols) break;
    const int32_t s = first[c];
    const int64_t w = p.width[c];
    uint8_t isnull = 0;
    int32_t v0 = 0, v1 = 0;
    uint32_t arith = 0;
    if (s >= 0) {
      isnull = p.isnull[c][s] ||
               ordered_key(p.exp_hi[s], p.exp_lo[s]) <= p.rexp;
      v0 = p.cmp[c][s * w];
      if (w == 2) v1 = p.cmp[c][s * w + 1];
      if (p.arith[c] != nullptr) arith = p.arith[c][s];
    }
    p.out_set[c][r] = s >= 0;
    p.out_isnull[c][r] = isnull;
    p.out_cmp[c][r * w] = v0;
    if (w == 2) p.out_cmp[c][r * w + 1] = v1;
    if (p.out_arith[c] != nullptr) p.out_arith[c][r] = arith;
  }
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
  p.read = ordered_key(read_hi, read_lo);
  p.rexp = ordered_key(rexp_hi, rexp_lo);
  if (n_rows == 0) return 0;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  mvcc_resolve_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mvcc_resolve_error_string(int code) {
  switch (code) {
    case kErrCols: return "column count out of range";
    case kErrRows: return "row count out of range or not whole blocks";
    case kErrPlane: return "a required plane is missing";
    case kErrWidth: return "a column has neither 1 nor 2 order planes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
