// The device memtable flush's replay scatter, for Hopper (sm_90a): K12.
//
// Replaces the JAX package's XLA program yugabyte_db_tpu/ops/flush.py
// replay_flush. The host stages the memtable's rows in apply order as
// flat planes and computes the flush order (perm: the staged row of each
// sorted position) and the block packing (dst: each sorted position's
// slot in the run's [Bp, R] planes). This kernel writes every plane of
// the run in one launch:
//   - a slot that some sorted position j lands on takes the planes of
//     staged row perm[j], valid set and group_start = gs[j];
//   - every other slot takes the padding encoding: valid clear,
//     group_start set, every flag and plane zero, except the expiry of an
//     unfilled row of a real block (is_real), which is the default (no
//     expiry), as storage/columnar.py allocates it. Padding blocks keep
//     expiry 0, as ops/device_run.py pads them.
//
// What bounds it: bytes. The gathered staged rows, perm, gs and dst are
// read once, and every output plane written once (ops/flush.py
// replay_bytes): at the engine phase's table (a million rows, three value
// columns) ~65 bytes read and ~58 written a row.
//
// Design: a block a tile of kTile output slots, a thread a slot, so that
// every output plane is stored coalesced. The tile first inverts dst: one
// thread finds the first sorted position at or past the tile's first slot
// (a binary search of dst, which ascends), the block loads the next kTile
// entries of dst (coalesced) and records, for each slot of the tile that
// one of them names, that position in shared memory. Then each thread
// writes its slots, gathering the staged planes through perm (the reads
// the apply order scatters). The fill and the scatter are one pass, so no
// slot is written twice and no ordering between two passes is needed.
// dst must ascend strictly over its in-range entries (the flush's packing
// gives it so): then the positions landing in a tile lie among the kTile
// entries after the searched one.
//
// Interface: plain C, for ctypes. replay_flush_launch returns 0, a
// negative code for an argument it refuses, or the launch's
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kThreads = 256;
constexpr int kTile = 1024;  // output slots a block
constexpr int kTop = 6;      // staged ht hi/lo, exp hi/lo, tomb, live
constexpr int kOutTop = 8;   // valid, group_start, tomb, live, ht, exp

enum Err : int {
  kErrCols = -1,
  kErrRows = -2,
  kErrPlane = -3,
  kErrWidth = -4,
};

struct Params {
  const int32_t* ht_hi;
  const int32_t* ht_lo;
  const int32_t* exp_hi;
  const int32_t* exp_lo;
  const uint8_t* tomb;
  const uint8_t* live;
  const uint8_t* set[kMaxCols];
  const uint8_t* isnull[kMaxCols];
  const int32_t* cmp[kMaxCols];
  const uint32_t* arith[kMaxCols];  // float bits; null: no arithmetic plane
  uint8_t* out_valid;
  uint8_t* out_group_start;
  uint8_t* out_tomb;
  uint8_t* out_live;
  int32_t* out_ht_hi;
  int32_t* out_ht_lo;
  int32_t* out_exp_hi;
  int32_t* out_exp_lo;
  uint8_t* out_set[kMaxCols];
  uint8_t* out_isnull[kMaxCols];
  int32_t* out_cmp[kMaxCols];
  uint32_t* out_arith[kMaxCols];
  int32_t width[kMaxCols];  // order planes per row: 1 or 2
  const int32_t* perm;
  const int32_t* dst;
  const uint8_t* gs;
  const uint8_t* is_real;
  long long m;      // sorted positions
  long long slots;  // Bp * R
  int32_t rows_per_block;
  int32_t n_cols;
  int32_t exp_hi_default;
  int32_t exp_lo_default;
  bool top;  // write the planes every row has (the first column chunk)
};

__global__ void __launch_bounds__(kThreads)
    replay_flush_kernel(const __grid_constant__ Params p) {
  __shared__ int32_t s_src[kTile];  // the sorted position of each slot
  __shared__ long long s_first;
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  if (threadIdx.x == 0) {  // the first position whose slot is >= s0
    long long lo = 0, hi = p.m;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (p.dst[mid] < s0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    s_first = lo;
  }
  for (int t = threadIdx.x; t < kTile; t += kThreads) s_src[t] = -1;
  __syncthreads();
  const long long first = s_first;
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const long long j = first + t;
    if (j < p.m) {
      const long long d = p.dst[j];
      if (d >= s0 && d < s0 + kTile && d < p.slots) {
        s_src[d - s0] = static_cast<int32_t>(j);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const long long s = s0 + t;
    if (s >= p.slots) break;
    const int32_t j = s_src[t];
    if (j >= 0) {
      const long long r = p.perm[j];
      if (p.top) {
        p.out_valid[s] = 1;
        p.out_group_start[s] = p.gs[j];
        p.out_tomb[s] = p.tomb[r];
        p.out_live[s] = p.live[r];
        p.out_ht_hi[s] = p.ht_hi[r];
        p.out_ht_lo[s] = p.ht_lo[r];
        p.out_exp_hi[s] = p.exp_hi[r];
        p.out_exp_lo[s] = p.exp_lo[r];
      }
      for (int c = 0; c < p.n_cols; ++c) {
        p.out_set[c][s] = p.set[c][r];
        p.out_isnull[c][s] = p.isnull[c][r];
        const int w = p.width[c];
        for (int q = 0; q < w; ++q) p.out_cmp[c][s * w + q] = p.cmp[c][r * w + q];
        if (p.arith[c] != nullptr) p.out_arith[c][s] = p.arith[c][r];
      }
    } else {
      if (p.top) {
        const bool real = p.is_real[s / p.rows_per_block] != 0;
        p.out_valid[s] = 0;
        p.out_group_start[s] = 1;
        p.out_tomb[s] = 0;
        p.out_live[s] = 0;
        p.out_ht_hi[s] = 0;
        p.out_ht_lo[s] = 0;
        p.out_exp_hi[s] = real ? p.exp_hi_default : 0;
        p.out_exp_lo[s] = real ? p.exp_lo_default : 0;
      }
      for (int c = 0; c < p.n_cols; ++c) {
        p.out_set[c][s] = 0;
        p.out_isnull[c][s] = 0;
        const int w = p.width[c];
        for (int q = 0; q < w; ++q) p.out_cmp[c][s * w + q] = 0;
        if (p.arith[c] != nullptr) p.out_arith[c][s] = 0u;
      }
    }
  }
}

}  // namespace

extern "C" {

// in: staged ht_hi, ht_lo, exp_hi, exp_lo, tomb, live, then per column:
// set, isnull, cmp ([rows, width] int32), arith (float32, or null). out:
// valid, group_start, tomb, live, ht_hi, ht_lo, exp_hi, exp_lo, then per
// column: set, isnull, cmp, arith (null where the input's is), each of
// Bp * rows_per_block slots. top: write the first eight outputs (a launch
// of a later column chunk writes its columns only). perm, dst: [m] int32;
// gs: [m] bool; is_real: [Bp] bool.
int replay_flush_launch(const void* const* in, void* const* out,
                        const int32_t* width, int n_cols, int top,
                        const void* perm, const void* dst, const void* gs,
                        const void* is_real, long long m, long long n_blocks,
                        int rows_per_block, int exp_hi_default,
                        int exp_lo_default, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols) return kErrCols;
  if (m < 0 || m >= (1ll << 31) || n_blocks < 0 || rows_per_block < 1 ||
      n_blocks * rows_per_block >= (1ll << 31)) {
    return kErrRows;
  }
  if (perm == nullptr || dst == nullptr || gs == nullptr ||
      is_real == nullptr) {
    return kErrPlane;
  }
  Params p{};
  if (top) {
    for (int k = 0; k < kTop; ++k) {
      if (in[k] == nullptr) return kErrPlane;
    }
    for (int k = 0; k < kOutTop; ++k) {
      if (out[k] == nullptr) return kErrPlane;
    }
  }
  p.ht_hi = static_cast<const int32_t*>(in[0]);
  p.ht_lo = static_cast<const int32_t*>(in[1]);
  p.exp_hi = static_cast<const int32_t*>(in[2]);
  p.exp_lo = static_cast<const int32_t*>(in[3]);
  p.tomb = static_cast<const uint8_t*>(in[4]);
  p.live = static_cast<const uint8_t*>(in[5]);
  p.out_valid = static_cast<uint8_t*>(out[0]);
  p.out_group_start = static_cast<uint8_t*>(out[1]);
  p.out_tomb = static_cast<uint8_t*>(out[2]);
  p.out_live = static_cast<uint8_t*>(out[3]);
  p.out_ht_hi = static_cast<int32_t*>(out[4]);
  p.out_ht_lo = static_cast<int32_t*>(out[5]);
  p.out_exp_hi = static_cast<int32_t*>(out[6]);
  p.out_exp_lo = static_cast<int32_t*>(out[7]);
  for (int c = 0; c < n_cols; ++c) {
    const void* const* ci = in + kTop + 4 * c;
    void* const* co = out + kOutTop + 4 * c;
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
  p.perm = static_cast<const int32_t*>(perm);
  p.dst = static_cast<const int32_t*>(dst);
  p.gs = static_cast<const uint8_t*>(gs);
  p.is_real = static_cast<const uint8_t*>(is_real);
  p.m = m;
  p.slots = n_blocks * rows_per_block;
  p.rows_per_block = rows_per_block;
  p.n_cols = n_cols;
  p.exp_hi_default = exp_hi_default;
  p.exp_lo_default = exp_lo_default;
  p.top = top != 0;
  if (p.slots == 0) return 0;
  const long long blocks = (p.slots + kTile - 1) / kTile;
  replay_flush_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* replay_flush_error_string(int code) {
  switch (code) {
    case kErrCols: return "column count out of range";
    case kErrRows: return "row or slot count out of range";
    case kErrPlane: return "a required plane is missing";
    case kErrWidth: return "a column has neither 1 nor 2 order planes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
