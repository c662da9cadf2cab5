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
// Shape of the design. The TPU kernel was tiled (8 blocks x R rows) with
// bool planes cast to int32 and its output row broadcast over 8 sublanes;
// all of that was forced by the TPU's (8, 128) tiles and is gone here:
//   - one kernel serves every signature: a descriptor (kernel parameter,
//     copied to shared memory) names the shipped columns and the
//     predicates (column slot, kind, op, literal offset) and aggregates
//     (fn, column slot, kind); the [N, P] parameter rows carry each
//     spec's row range, read point and literals;
//   - grid (G, N): blockIdx.y is the spec, blocks walk that spec's row
//     range with a grid-stride loop, every thread accumulates in
//     registers (limb sums in int64, so the TPU's R < 4096 bound on int32
//     limb sums does not apply), and a warp-shuffle + shared-memory
//     reduction writes one partial row per block and spec;
//   - bool planes are read as the uint8 bytes they are stored as, and an
//     i64 column's two order planes are read where they lie, interleaved.
//
// What bounds it: device-memory bandwidth. Per row in range it reads 16
// bytes of int32 hybrid-time/expiry planes, 3 bytes of valid/tomb/live,
// 2 bytes (set, isnull) for every value column of the table (existence
// needs them all), and 4 bytes per order plane (1 for i32, 2 for i64) of
// each column a predicate or aggregate reads: 35 bytes a row for the
// headline spec on a table holding just its two columns (37 with the
// bench table's third, DOUBLE, column), against a handful of integer
// operations. The simple design answers that bound with one pass over the
// planes and no intermediate in device memory. What it does not do yet:
// 16-byte vector loads, and one read of the planes for a whole batch of
// specs (each of the N specs reads them again).
//
// Interface: plain C, for ctypes. flat_agg_launch returns 0, a negative
// code for a descriptor it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxPreds = 8;
constexpr int kMaxAggs = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 2 + 5 * kMaxAggs;   // register accumulators per thread
constexpr int kHead = 5;                 // n_cols, n_preds, n_aggs, n_params, n_out
constexpr int kDescWords = kHead + kMaxCols + 4 * kMaxPreds + 3 * kMaxAggs;
constexpr int kParamHead = 6;            // row_lo, row_hi, read hi/lo, expiry hi/lo

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
};

struct Desc {
  const int32_t* ht_hi;
  const int32_t* ht_lo;
  const int32_t* exp_hi;
  const int32_t* exp_lo;
  const uint8_t* valid;
  const uint8_t* tomb;
  const uint8_t* live;
  const uint8_t* set[kMaxCols];
  const uint8_t* isnull[kMaxCols];
  const int32_t* cmp[kMaxCols];
  int32_t cmp_stride[kMaxCols];  // order planes per row: 1 or 2
  int32_t n_cols, n_preds, n_aggs, n_params, n_out;
  int32_t pred_col[kMaxPreds], pred_kind[kMaxPreds], pred_op[kMaxPreds],
      pred_lit[kMaxPreds];
  int32_t agg_fn[kMaxAggs], agg_col[kMaxAggs], agg_kind[kMaxAggs];
  int64_t n_rows;
};

__device__ __forceinline__ bool le2(int32_t a_hi, int32_t a_lo, int32_t b_hi,
                                    int32_t b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo <= b_lo);
}

__device__ __forceinline__ int cmp3(int32_t a, int32_t b) {
  return (a > b) - (a < b);
}

__device__ __forceinline__ bool apply_op(int32_t op, int c3) {
  switch (op) {
    case kEq: return c3 == 0;
    case kNe: return c3 != 0;
    case kLt: return c3 < 0;
    case kLe: return c3 <= 0;
    case kGt: return c3 > 0;
    default: return c3 >= 0;
  }
}

// v ^ 0x80000000 as unsigned: the 2^31-biased value, unsigned order ==
// signed order.
__device__ __forceinline__ uint32_t biased(int32_t v) {
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}

// (hi, lo) order planes -> one int64 whose order is the planes'
// lexicographic order: hi * 2^32 + (lo + 2^31).
__device__ __forceinline__ long long order_key(int32_t hi, int32_t lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<uint32_t>(hi)) << 32) |
      biased(lo));
}

__device__ __forceinline__ long long init_key(int32_t fn, int32_t kind) {
  if (fn == kMax) return kind == kI64 ? INT64_MIN : INT32_MIN;
  return kind == kI64 ? INT64_MAX : INT32_MAX;
}

// How accumulator slot s combines across threads: kSum, kMin or kMax.
__device__ __forceinline__ int32_t slot_reduce(const Desc& d, int s) {
  if (s < 2) return kSum;
  const int a = (s - 2) / 5;
  const int32_t fn = d.agg_fn[a];
  return ((s - 2) % 5 == 0 && fn >= kMin) ? fn : kSum;
}

__device__ __forceinline__ long long combine(int32_t how, long long x,
                                             long long y) {
  if (how == kMax) return x > y ? x : y;
  if (how == kMin) return x < y ? x : y;
  return x + y;
}

__global__ void __launch_bounds__(kThreads)
    flat_agg_kernel(const Desc desc, const int32_t* __restrict__ params,
                    long long* __restrict__ out) {
  __shared__ Desc d;
  __shared__ long long red[kWarps][kAcc];
  if (threadIdx.x == 0) d = desc;
  __syncthreads();

  const int spec = blockIdx.y;
  const int32_t* p = params + static_cast<size_t>(spec) * d.n_params;
  const int32_t read_hi = p[2], read_lo = p[3];
  const int32_t rexp_hi = p[4], rexp_lo = p[5];
  const long long lo = p[0] > 0 ? p[0] : 0;
  const long long hi = p[1] < d.n_rows ? p[1] : d.n_rows;
  const int n_aggs = d.n_aggs;
  const int n_cols = d.n_cols;
  const int n_preds = d.n_preds;

  long long acc[kAcc];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) acc[s] = 0;
#pragma unroll
  for (int a = 0; a < kMaxAggs; ++a) {
    if (a < n_aggs && d.agg_fn[a] >= kMin) {
      acc[2 + 5 * a] = init_key(d.agg_fn[a], d.agg_kind[a]);
    }
  }

  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = lo + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < hi; i += step) {
    const bool valid = __ldg(d.valid + i) != 0;
    const bool visible =
        valid && le2(__ldg(d.ht_hi + i), __ldg(d.ht_lo + i), read_hi, read_lo);
    const bool expired =
        le2(__ldg(d.exp_hi + i), __ldg(d.exp_lo + i), rexp_hi, rexp_lo);
    const bool alive = visible && __ldg(d.tomb + i) == 0;
    uint32_t notnull = 0;  // bit c: column slot c is set, not NULL, alive
    if (alive && !expired) {
      for (int c = 0; c < n_cols; ++c) {
        if (__ldg(d.set[c] + i) != 0 && __ldg(d.isnull[c] + i) == 0) {
          notnull |= 1u << c;
        }
      }
    }
    const bool exists =
        (alive && !expired && __ldg(d.live + i) != 0) || notnull != 0;
    if (!exists) continue;
    acc[1] += 1;  // rows in range that exist, before predicates

    bool mask = true;
    for (int q = 0; q < n_preds && mask; ++q) {
      const int c = d.pred_col[q];
      if (((notnull >> c) & 1u) == 0) {
        mask = false;
        break;
      }
      const int32_t* v = d.cmp[c] + i * d.cmp_stride[c];
      const int32_t* lit = p + d.pred_lit[q];
      int c3 = cmp3(__ldg(v), lit[0]);
      if (c3 == 0 && d.pred_kind[q] == kI64) c3 = cmp3(__ldg(v + 1), lit[1]);
      mask = apply_op(d.pred_op[q], c3);
    }
    if (!mask) continue;
    acc[0] += 1;

#pragma unroll
    for (int a = 0; a < kMaxAggs; ++a) {
      if (a >= n_aggs) break;
      const int c = d.agg_col[a];
      if (c >= 0 && ((notnull >> c) & 1u) == 0) continue;
      const int base = 2 + 5 * a;
      const int32_t fn = d.agg_fn[a];
      if (fn == kCount) {
        acc[base] += 1;
        continue;
      }
      const int32_t* v = d.cmp[c] + i * d.cmp_stride[c];
      const bool wide = d.agg_kind[a] == kI64;
      if (fn == kSum) {
        const uint32_t u_hi = biased(__ldg(v));
        if (wide) {
          const uint32_t u_lo = biased(__ldg(v + 1));
          acc[base] += u_lo & 0xFFFFu;
          acc[base + 1] += u_lo >> 16;
          acc[base + 2] += u_hi & 0xFFFFu;
          acc[base + 3] += u_hi >> 16;
        } else {
          acc[base] += u_hi & 0xFFFFu;
          acc[base + 1] += u_hi >> 16;
        }
        acc[base + 4] += 1;
      } else {
        const long long key = wide ? order_key(__ldg(v), __ldg(v + 1))
                                   : static_cast<long long>(__ldg(v));
        acc[base] = combine(fn, acc[base], key);
        acc[base + 1] += 1;
      }
    }
  }

  // Block reduction: shuffles within each warp, then across the warps'
  // partials in shared memory, one thread per accumulator slot.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_acc = 2 + 5 * n_aggs;
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
    if (s >= n_acc) break;
    const int32_t how = slot_reduce(d, s);
    long long v = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = combine(how, v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) red[warp][s] = v;
  }
  __syncthreads();
  if (threadIdx.x < n_acc) {
    const int s = threadIdx.x;
    const int32_t how = slot_reduce(d, s);
    long long v = red[0][s];
    for (int w = 1; w < kWarps; ++w) v = combine(how, v, red[w][s]);
    red[0][s] = v;
  }
  __syncthreads();

  // The partial row, in the Pallas kernel's slot order:
  // [count, scanned, per aggregate: count | 4 limbs + n | hi, lo, n].
  if (threadIdx.x == 0) {
    long long* o =
        out + (static_cast<size_t>(spec) * gridDim.x + blockIdx.x) * d.n_out;
    o[0] = red[0][0];
    o[1] = red[0][1];
    int k = 2;
    for (int a = 0; a < n_aggs; ++a) {
      const int base = 2 + 5 * a;
      const int32_t fn = d.agg_fn[a];
      if (fn == kCount) {
        o[k++] = red[0][base];
      } else if (fn == kSum) {
        for (int j = 0; j < 5; ++j) o[k++] = red[0][base + j];
      } else {
        const long long key = red[0][base];
        if (d.agg_kind[a] == kI64) {
          o[k++] = static_cast<int32_t>(key >> 32);
          o[k++] = static_cast<int32_t>(static_cast<uint32_t>(key) ^
                                        0x80000000u);
        } else {
          o[k++] = key;
          o[k++] = 0;
        }
        o[k++] = red[0][base + 1];
      }
    }
  }
}

}  // namespace

extern "C" {

// planes: ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live, then per
// column slot: set, isnull, cmp. desc: kDescWords int32 words (layout in
// ops/flat_agg.py FlatAggPlan.descriptor). params: [n_specs, n_params]
// int32 on the device. out: [n_specs, grid_x, n_out] int64 on the device.
int flat_agg_launch(const void* const* planes, int n_planes,
                    const int32_t* desc, int n_desc, const int32_t* params,
                    int n_specs, long long n_rows, long long* out, int grid_x,
                    void* stream) {
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
  const int32_t* w = desc + kHead;
  for (int c = 0; c < kMaxCols; ++c) d.cmp_stride[c] = w[c];
  w += kMaxCols;
  for (int q = 0; q < kMaxPreds; ++q, w += 4) {
    d.pred_col[q] = w[0];
    d.pred_kind[q] = w[1];
    d.pred_op[q] = w[2];
    d.pred_lit[q] = w[3];
    if (q >= d.n_preds) continue;
    const int width = w[1] == kI64 ? 2 : 1;
    if (w[0] < 0 || w[0] >= d.n_cols || (w[1] != kI32 && w[1] != kI64) ||
        w[2] < kEq || w[2] > kGe || w[3] < kParamHead ||
        w[3] + width > d.n_params || d.cmp_stride[w[0]] < width) {
      return kErrPred;
    }
  }
  int n_out = 2;
  for (int a = 0; a < kMaxAggs; ++a, w += 3) {
    d.agg_fn[a] = w[0];
    d.agg_col[a] = w[1];
    d.agg_kind[a] = w[2];
    if (a >= d.n_aggs) continue;
    const bool counts = w[0] == kCount;
    if (w[0] < kCount || w[0] > kMax || w[1] < (counts ? -1 : 0) ||
        w[1] >= d.n_cols || (w[2] != kI32 && w[2] != kI64) ||
        (!counts && d.cmp_stride[w[1]] < (w[2] == kI64 ? 2 : 1))) {
      return kErrAgg;
    }
    n_out += counts ? 1 : (w[0] == kSum ? 5 : 3);
  }
  if (n_out != d.n_out) return kErrOutWidth;
  if (grid_x < 1 || n_specs < 1 || n_specs > 65535 || n_rows < 0) {
    return kErrGrid;
  }
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
    d.cmp[c] = static_cast<const int32_t*>(planes[9 + 3 * c]);
  }
  d.n_rows = n_rows;
  flat_agg_kernel<<<dim3(grid_x, n_specs), kThreads, 0,
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
    case kErrGrid: return "bad grid or spec count";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
