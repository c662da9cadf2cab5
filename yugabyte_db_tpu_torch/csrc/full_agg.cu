// The windowed full-run aggregate, for Hopper (sm_90a): K5.
//
// Replaces the JAX package's XLA program yugabyte_db_tpu/ops/agg_fold.py
// compiled_full_aggregate (a fori_loop over the run's windows of K blocks;
// per window ops/scan.py scan_window's flat resolve and _eval_agg, folded
// by agg_fold.fold_window / agg_fold). The engine takes it for runs past
// the flat fold's bounds on signatures the flat kernel (flat_agg.cu) does
// not take: float SUM/MIN/MAX, f64 predicates, any number of aggregates,
// predicates and value columns. Its plain version is
// ops/agg_fold.py full_aggregate_plain; ops/full_agg.py is the wrapper.
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
// What bounds it: bytes. Each row in range reads its hybrid time and
// expiry (16 B), valid/tomb/live (3 B), set and isnull of the value
// columns (2 B a column) and the order and arith planes the predicates
// and aggregates read (ops/full_agg.py bytes_per_row): ~50-70 B a row of
// the bench table's shapes, against a few dozen integer operations.
//
// Design (a first one: right and simple, not yet fast).
//   Pass 1 (window_kernel): a block of 256 threads a (window, spec). A
//     warp takes 32 consecutive rows at a time (byte and word loads of
//     neighbouring rows coalesce), resolves them and keeps each row's
//     result as one bit of a __ballot_sync word in shared memory (N <=
//     32,768 rows: 4 KB). Then, per aggregate, the threads walk the rows
//     whose bit is set, accumulate in 64-bit registers (limb sums are
//     exact integers; float sums in double) and reduce across the block;
//     thread 0 writes the window's record: scanned, then 5 int64 words an
//     aggregate. The descriptor (column, predicate and aggregate tables,
//     plane pointers) lives in global memory, so nothing bounds the
//     number of columns, predicates or aggregates. Each spec reads the
//     planes once: a batch of specs reads them once a spec.
//   Pass 2 (fold_kernel): a block a spec, a warp a statistic (scanned,
//     then each aggregate). The warp loads 32 windows' records at once,
//     one a lane, and folds them in window order by broadcasting each
//     lane's record with __shfl_sync: every lane holds the same state, and
//     lane 0 writes the packed ivec / fvec entries (agg_fold.pack).
//
// Interface: plain C, for ctypes. full_agg_launch returns 0, a negative
// code for an argument it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxWindowRows = 32768;  // K * R under the limb bound
constexpr int kMaxWords = static_cast<int>(kMaxWindowRows / 32);
constexpr int kSlots = 5;   // record words an aggregate
constexpr int kParamHead = 8;
constexpr int kDigits = 8;
constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned kInfBits = 0x7f800000u;  // +infinity, float32

constexpr int kErrShape = -1;
constexpr int kErrArgs = -2;

enum Fn { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };
enum Kind { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kStr = 4 };
enum Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

// Descriptor header (ops/full_agg.py FullAggPlan.descriptor).
enum Head {
  hCols = 0, hPreds = 1, hAggs = 2, hParams = 3, hInts = 4, hFloats = 5,
  hR = 6, hN = 7, hOffCols = 8, hOffPreds = 9, hOffAggs = 10, hOffPtrs = 11
};

// Pointer table order: the run's planes, then 4 a column slot.
enum Plane { pValid = 0, pTomb, pLive, pHtHi, pHtLo, pExpHi, pExpLo, pCols };
enum ColPlane { cSet = 0, cIsNull = 1, cCmp = 2, cArith = 3 };

constexpr long long kI32Min = -2147483648ll;
constexpr long long kI32Max = 2147483647ll;
constexpr long long kI64Min = static_cast<long long>(0x8000000000000000ull);
constexpr long long kI64Max = 0x7fffffffffffffffll;

int32_t g_last_launch[6] = {0, 0, 0, 0, 0, 0};

struct Args {
  const long long* desc;
  const int32_t* params;  // [n_specs, n_params]
  long long* rec;         // [n_specs, n_win, rec_words]
  int32_t* ivec;          // [n_specs, n_ints]
  float* fvec;            // [n_specs, max(n_floats, 1)]
  int n_params;
  int rec_words;
  int w_base;
  int n_win;
  int f_stride;
};

__device__ __forceinline__ bool le2(int a_hi, int a_lo, int b_hi, int b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo <= b_lo);
}

__device__ __forceinline__ bool lt2(int a_hi, int a_lo, int b_hi, int b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo < b_lo);
}

// The int64 whose order is the (hi, lo) planes' lexicographic order.
__device__ __forceinline__ long long order_key(int hi, int lo) {
  return static_cast<long long>(hi) * 4294967296ll +
         static_cast<long long>(static_cast<uint32_t>(lo) ^ 0x80000000u);
}

template <class T>
__device__ __forceinline__ const T* ptr(const long long* desc, int k) {
  return reinterpret_cast<const T*>(desc[desc[hOffPtrs] + k]);
}

template <class T>
__device__ __forceinline__ const T* col_ptr(const long long* desc, int slot,
                                            int plane) {
  return ptr<T>(desc, pCols + 4 * slot + plane);
}

__device__ __forceinline__ bool compare(int op, bool eq, bool lt) {
  switch (op) {
    case kEq: return eq;
    case kNe: return !eq;
    case kLt: return lt;
    case kLe: return lt || eq;
    case kGt: return !(lt || eq);
    default: return !lt;  // kGe
  }
}

// A predicate on row g, whose column is set and not NULL.
__device__ __forceinline__ bool pred_holds(const long long* desc,
                                           const int32_t* prm, int q,
                                           long long g) {
  const long long* p = desc + desc[hOffPreds] + 4 * q;
  const int slot = static_cast<int>(p[0]);
  const int kind = static_cast<int>(p[1]);
  const int op = static_cast<int>(p[2]);
  const int lit = static_cast<int>(p[3]);
  const uint8_t* set = col_ptr<uint8_t>(desc, slot, cSet);
  const uint8_t* isnull = col_ptr<uint8_t>(desc, slot, cIsNull);
  if (!set[g] || isnull[g]) return false;
  const int width = static_cast<int>(desc[desc[hOffCols] + 2 * slot]);
  const int32_t* cmp = col_ptr<int32_t>(desc, slot, cCmp) + g * width;
  if (kind == kI32) {
    const int v = cmp[0], x = prm[lit];
    return compare(op, v == x, v < x);
  }
  const int hi = cmp[0], lo = cmp[1], xh = prm[lit], xl = prm[lit + 1];
  return compare(op, hi == xh && lo == xl, lt2(hi, lo, xh, xl));
}

// Block-wide reduction; every thread gets the result. `sh` holds kWarps
// values of 8 bytes.
template <class T, class F>
__device__ __forceinline__ T block_reduce(T v, F op, long long* sh) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  T* s = reinterpret_cast<T*>(sh);
  __syncthreads();  // the previous reduction's readers are done
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = s[0];
  for (int i = 1; i < kWarps; ++i) r = op(r, s[i]);
  return r;
}

struct AddL {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct AddD {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct MaxL {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};
struct MinL {
  __device__ long long operator()(long long a, long long b) const {
    return a < b ? a : b;
  }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Pass 1: one window of one spec -> its record.
__global__ void __launch_bounds__(kThreads)
window_kernel(Args a) {
  __shared__ uint32_t s_res[kMaxWords];
  __shared__ long long s_red[kWarps];
  const long long* desc = a.desc;
  const int spec = blockIdx.y;
  const int w = a.w_base + static_cast<int>(blockIdx.x);
  const int32_t* prm = a.params + static_cast<size_t>(spec) * a.n_params;
  if (w < prm[2] || w >= prm[3]) return;  // outside this spec's windows
  const int n_cols = static_cast<int>(desc[hCols]);
  const int n_preds = static_cast<int>(desc[hPreds]);
  const int n_aggs = static_cast<int>(desc[hAggs]);
  const long long N = desc[hN];
  const long long row0 = static_cast<long long>(w) * N;
  const long long lo = max(static_cast<long long>(prm[0]) - row0, 0ll);
  const long long hi = min(static_cast<long long>(prm[1]) - row0, N);
  const int read_hi = prm[4], read_lo = prm[5];
  const int rexp_hi = prm[6], rexp_lo = prm[7];
  const uint8_t* valid = ptr<uint8_t>(desc, pValid);
  const uint8_t* tomb = ptr<uint8_t>(desc, pTomb);
  const uint8_t* live = ptr<uint8_t>(desc, pLive);
  const int32_t* ht_hi = ptr<int32_t>(desc, pHtHi);
  const int32_t* ht_lo = ptr<int32_t>(desc, pHtLo);
  const int32_t* exp_hi = ptr<int32_t>(desc, pExpHi);
  const int32_t* exp_lo = ptr<int32_t>(desc, pExpLo);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. The rows that count: exist in range and pass every predicate.
  for (long long base = 32ll * warp; base < N; base += kThreads) {
    const long long r = base + lane;
    bool res = false;
    if (r >= lo && r < hi) {
      const long long g = row0 + r;
      if (valid[g] && !tomb[g] &&
          le2(ht_hi[g], ht_lo[g], read_hi, read_lo) &&
          !le2(exp_hi[g], exp_lo[g], rexp_hi, rexp_lo)) {
        bool exists = live[g] != 0;
        for (int c = 0; c < n_cols && !exists; ++c) {
          exists = col_ptr<uint8_t>(desc, c, cSet)[g] &&
                   !col_ptr<uint8_t>(desc, c, cIsNull)[g];
        }
        res = exists;
        for (int q = 0; q < n_preds && res; ++q) {
          res = pred_holds(desc, prm, q, g);
        }
      }
    }
    const unsigned bits = __ballot_sync(kFull, res);
    if (lane == 0) s_res[base >> 5] = bits;
  }
  __syncthreads();

  long long* out = a.rec + (static_cast<size_t>(spec) * a.n_win +
                            blockIdx.x) * a.rec_words;
  const int n_words = static_cast<int>((N + 31) / 32);
  long long scanned = 0;
  for (int i = threadIdx.x; i < n_words; i += kThreads) {
    scanned += __popc(s_res[i]);
  }
  scanned = block_reduce(scanned, AddL(), s_red);
  if (threadIdx.x == 0) out[0] = scanned;

  // 2. Each aggregate over those rows.
  const long long* aggs = desc + desc[hOffAggs];
  for (int ai = 0; ai < n_aggs; ++ai) {
    const int fn = static_cast<int>(aggs[5 * ai]);
    const int slot = static_cast<int>(aggs[5 * ai + 1]);
    const int kind = static_cast<int>(aggs[5 * ai + 2]);
    const uint8_t* set = nullptr;
    const uint8_t* isnull = nullptr;
    const int32_t* cmp = nullptr;
    const float* arith = nullptr;
    int width = 1;
    if (slot >= 0) {
      set = col_ptr<uint8_t>(desc, slot, cSet);
      isnull = col_ptr<uint8_t>(desc, slot, cIsNull);
      cmp = col_ptr<int32_t>(desc, slot, cCmp);
      arith = col_ptr<float>(desc, slot, cArith);
      width = static_cast<int>(desc[desc[hOffCols] + 2 * slot]);
    }
    const bool is_max = fn == kMax;
    const bool float_sum = fn == kSum && (kind == kF32 || kind == kF64);
    const bool float_ext = (fn == kMin || fn == kMax) && kind == kF32;
    long long n = 0, l0 = 0, l1 = 0, l2 = 0, l3 = 0;
    double fsum = 0.0;
    const float inf = __int_as_float(static_cast<int>(kInfBits));
    float fext = is_max ? -inf : inf;
    long long ext = kind == kI32 ? (is_max ? kI32Min : kI32Max)
                                 : (is_max ? kI64Min : kI64Max);
    for (long long base = 32ll * warp; base < N; base += kThreads) {
      const unsigned word = s_res[base >> 5];
      if (!((word >> lane) & 1u)) continue;
      const long long g = row0 + base + lane;
      if (slot >= 0 && (!set[g] || isnull[g])) continue;
      ++n;
      if (fn == kCount) continue;
      if (float_sum) {
        fsum += static_cast<double>(arith[g]);
      } else if (float_ext) {
        fext = is_max ? fmaxf(fext, arith[g]) : fminf(fext, arith[g]);
      } else if (fn == kSum) {
        const int32_t* v = cmp + g * width;
        if (kind == kI32) {
          const uint32_t u = static_cast<uint32_t>(v[0]) ^ 0x80000000u;
          l0 += u & 0xFFFFu;
          l1 += u >> 16;
        } else {  // the lo plane's limbs, then the hi plane's
          const uint32_t ul = static_cast<uint32_t>(v[1]) ^ 0x80000000u;
          const uint32_t uh = static_cast<uint32_t>(v[0]) ^ 0x80000000u;
          l0 += ul & 0xFFFFu;
          l1 += ul >> 16;
          l2 += uh & 0xFFFFu;
          l3 += uh >> 16;
        }
      } else {
        const int32_t* v = cmp + g * width;
        const long long key =
            kind == kI32 ? static_cast<long long>(v[0]) : order_key(v[0], v[1]);
        ext = is_max ? (key > ext ? key : ext) : (key < ext ? key : ext);
      }
    }
    n = block_reduce(n, AddL(), s_red);
    long long r0 = n, r1 = 0, r2 = 0, r3 = 0;
    if (fn == kCount) {
      // r0 is the count
    } else if (float_sum) {
      r0 = __double_as_longlong(block_reduce(fsum, AddD(), s_red));
    } else if (float_ext) {
      const float e = is_max ? block_reduce(fext, MaxF(), s_red)
                             : block_reduce(fext, MinF(), s_red);
      r0 = static_cast<long long>(static_cast<uint32_t>(__float_as_int(e)));
    } else if (fn == kSum) {
      r0 = block_reduce(l0, AddL(), s_red);
      r1 = block_reduce(l1, AddL(), s_red);
      r2 = block_reduce(l2, AddL(), s_red);
      r3 = block_reduce(l3, AddL(), s_red);
    } else {
      r0 = is_max ? block_reduce(ext, MaxL(), s_red)
                  : block_reduce(ext, MinL(), s_red);
    }
    if (threadIdx.x == 0) {
      long long* o = out + 1 + kSlots * ai;
      o[0] = r0;
      o[1] = r1;
      o[2] = r2;
      o[3] = r3;
      o[4] = n;
    }
  }
}

// Pass 2: one spec's records, folded in window order.
__global__ void __launch_bounds__(1024)
fold_kernel(Args a) {
  const long long* desc = a.desc;
  const int spec = blockIdx.x;
  const int32_t* prm = a.params + static_cast<size_t>(spec) * a.n_params;
  const int wf = prm[2];
  const int wl = prm[3];
  const int n_aggs = static_cast<int>(desc[hAggs]);
  const int n_ints = static_cast<int>(desc[hInts]);
  const long long* recs =
      a.rec + static_cast<size_t>(spec) * a.n_win * a.rec_words;
  int32_t* iv = a.ivec + static_cast<size_t>(spec) * n_ints;
  float* fv = a.fvec + static_cast<size_t>(spec) * a.f_stride;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long* aggs = desc + desc[hOffAggs];

  for (int item = threadIdx.x >> 5; item <= n_aggs; item += n_warps) {
    if (item == 0) {  // scanned
      long long sum = 0;
      for (int w = wf + lane; w < wl; w += 32) {
        sum += recs[static_cast<size_t>(w - a.w_base) * a.rec_words];
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      if (lane == 0) iv[0] = static_cast<int32_t>(sum);
      continue;
    }
    const int ai = item - 1;
    const int fn = static_cast<int>(aggs[5 * ai]);
    const int kind = static_cast<int>(aggs[5 * ai + 2]);
    const int ioff = static_cast<int>(aggs[5 * ai + 3]);
    const int foff = static_cast<int>(aggs[5 * ai + 4]);
    const bool is_max = fn == kMax;
    const bool float_sum = fn == kSum && (kind == kF32 || kind == kF64);
    const bool float_ext = (fn == kMin || fn == kMax) && kind == kF32;
    long long d0 = 0, d1 = 0, d2 = 0, d3 = 0, d4 = 0, d5 = 0, d6 = 0, d7 = 0;
    long long n = 0, ext = kind == kI32 ? (is_max ? kI32Min : kI32Max)
                                        : (is_max ? kI64Min : kI64Max);
    float fsum = 0.0f, fcomp = 0.0f;
    const float inf = __int_as_float(static_cast<int>(kInfBits));
    float fext = is_max ? -inf : inf;
    const int col = 1 + kSlots * ai;
    for (int w0 = wf; w0 < wl; w0 += 32) {
      const int w = w0 + lane;
      long long x0 = 0, x1 = 0, x2 = 0, x3 = 0, x4 = 0;
      if (w < wl) {
        const long long* r =
            recs + static_cast<size_t>(w - a.w_base) * a.rec_words + col;
        x0 = r[0];
        x1 = r[1];
        x2 = r[2];
        x3 = r[3];
        x4 = r[4];
      }
      const int m = min(32, wl - w0);
      for (int j = 0; j < m; ++j) {
        const long long y0 = __shfl_sync(kFull, x0, j);
        const long long y4 = __shfl_sync(kFull, x4, j);
        n += y4;
        if (fn == kCount) {
          continue;
        } else if (float_sum) {
          // A Kahan add of the window's sum (agg_fold.py agg_fold).
          const float wsum = static_cast<float>(__longlong_as_double(y0));
          const float y = wsum - fcomp;
          const float t = fsum + y;
          fcomp = (t - fsum) - y;
          fsum = t;
        } else if (float_ext) {
          const float e = __int_as_float(static_cast<int>(y0));
          fext = is_max ? fmaxf(fext, e) : fminf(fext, e);
        } else if (fn == kSum) {
          const long long y1 = __shfl_sync(kFull, x1, j);
          const long long y2 = __shfl_sync(kFull, x2, j);
          const long long y3 = __shfl_sync(kFull, x3, j);
          d0 += y0;
          d1 += y1;
          d2 += y2;
          d3 += y3;
          // One carry step (agg_fold.py carry_step): each digit keeps its
          // low 16 bits and takes the previous digit's high bits; the last
          // digit's carry drops.
          const long long c0 = d0 >> 16, c1 = d1 >> 16, c2 = d2 >> 16,
                          c3 = d3 >> 16, c4 = d4 >> 16, c5 = d5 >> 16,
                          c6 = d6 >> 16;
          d7 = (d7 & 0xFFFF) + c6;
          d6 = (d6 & 0xFFFF) + c5;
          d5 = (d5 & 0xFFFF) + c4;
          d4 = (d4 & 0xFFFF) + c3;
          d3 = (d3 & 0xFFFF) + c2;
          d2 = (d2 & 0xFFFF) + c1;
          d1 = (d1 & 0xFFFF) + c0;
          d0 = d0 & 0xFFFF;
        } else {
          ext = is_max ? (y0 > ext ? y0 : ext) : (y0 < ext ? y0 : ext);
        }
      }
    }
    if (lane != 0) {
      // lane 0 writes the warp's statistic
    } else if (fn == kCount) {
      iv[ioff] = static_cast<int32_t>(n);
    } else if (float_sum) {
      fv[foff] = fsum;
      fv[foff + 1] = fcomp;
      iv[ioff] = static_cast<int32_t>(n);
    } else if (float_ext) {
      fv[foff] = fext;
      iv[ioff] = static_cast<int32_t>(n);
    } else if (fn == kSum) {
      int32_t* o = iv + ioff;
      o[0] = static_cast<int32_t>(d0);
      o[1] = static_cast<int32_t>(d1);
      o[2] = static_cast<int32_t>(d2);
      o[3] = static_cast<int32_t>(d3);
      o[4] = static_cast<int32_t>(d4);
      o[5] = static_cast<int32_t>(d5);
      o[6] = static_cast<int32_t>(d6);
      o[7] = static_cast<int32_t>(d7);
      o[kDigits] = static_cast<int32_t>(n);
    } else if (kind == kI32) {
      iv[ioff] = static_cast<int32_t>(ext);
      iv[ioff + 1] = static_cast<int32_t>(n);
    } else {
      iv[ioff] = static_cast<int32_t>(ext >> 32);
      iv[ioff + 1] = static_cast<int32_t>((ext & 0xFFFFFFFFll) - 2147483648ll);
      iv[ioff + 2] = static_cast<int32_t>(n);
    }
  }
}

}  // namespace

extern "C" {

// desc: device int64 words (ops/full_agg.py FullAggPlan.descriptor);
// params: device [n_specs, n_params] int32 (FullAggPlan.param_row); rec:
// device [n_specs, n_win, rec_words] int64 scratch; ivec: device
// [n_specs, n_ints] int32; fvec: device [n_specs, max(n_floats, 1)]
// float32. Pass 1 runs over the windows [w_base, w_base + n_win).
int full_agg_launch(const void* desc, const void* params, int n_specs,
                    int n_params, int n_aggs, long long window_rows,
                    int rec_words, int w_base, int n_win, void* rec,
                    void* ivec, int n_ints, void* fvec, int n_floats,
                    void* stream) {
  if (n_specs < 1 || n_specs > 65535 || n_aggs < 0 ||
      window_rows < 1 || window_rows > kMaxWindowRows || w_base < 0 ||
      n_win < 0 || rec_words != 1 + kSlots * n_aggs ||
      n_params < kParamHead || n_ints < 1 || n_floats < 0) {
    return kErrShape;
  }
  if (desc == nullptr || params == nullptr || ivec == nullptr ||
      fvec == nullptr || (n_win > 0 && rec == nullptr)) {
    return kErrArgs;
  }
  Args a{};
  a.desc = static_cast<const long long*>(desc);
  a.params = static_cast<const int32_t*>(params);
  a.rec = static_cast<long long*>(rec);
  a.ivec = static_cast<int32_t*>(ivec);
  a.fvec = static_cast<float*>(fvec);
  a.n_params = n_params;
  a.rec_words = rec_words;
  a.w_base = w_base;
  a.n_win = n_win;
  a.f_stride = n_floats > 0 ? n_floats : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = 1 + n_aggs;
  const int fold_threads = 32 * (items < 32 ? items : 32);
  g_last_launch[0] = w_base;
  g_last_launch[1] = n_win;
  g_last_launch[2] = n_specs;
  g_last_launch[3] = kThreads;
  g_last_launch[4] = fold_threads;
  g_last_launch[5] = rec_words;
  if (n_win > 0) {
    window_kernel<<<dim3(static_cast<unsigned>(n_win),
                         static_cast<unsigned>(n_specs)),
                    kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fold_kernel<<<static_cast<unsigned>(n_specs), fold_threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[6]: the shape of the last launch (w_base, windows, specs, threads,
// fold threads, record words).
void full_agg_last_launch(int32_t* out) {
  for (int i = 0; i < 6; ++i) out[i] = g_last_launch[i];
}

const char* full_agg_error_string(int code) {
  switch (code) {
    case kErrShape: return "a shape or count the kernel does not take";
    case kErrArgs: return "a required pointer is missing";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
