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
// 0.13 ms at 3.35 TB/s. The work per matching row is a hash, a few
// compares and 128-bit multiply-adds: small beside the bytes, but it all
// lands on the few buckets a low-cardinality GROUP BY has (Q1 has 4 live
// groups), where per-row atomics would serialise.
//
// What the design does about it (a first design: simple and exact):
//   - contention: each block folds a slice of one spec's rows into a
//     bucket table of its own in shared memory, then merges its live
//     buckets into the spec's table in device memory once, with 64-bit
//     atomics. Inside a block a warp takes 32 consecutive rows at a time.
//     Each lane first works out its row's inputs once: which aggregates
//     it feeds, and each sum's product as four 26-bit limbs. Then the
//     warp folds its rows one bucket at a time: the lanes whose rows share
//     the first pending bucket are found with a ballot, their counts come
//     from popc, their sums from one __reduce_add_sync a limb (32 lanes'
//     26-bit limbs add up in 32 bits), and one lane adds them into the
//     shared table. A warp's rows hold few buckets on a low-cardinality
//     GROUP BY, so a row costs a few warp instructions rather than an
//     atomic per aggregate. Rep is the lowest peer lane's row (rows rise
//     with the lane); the key planes are checked against that lane's, and
//     only a lane whose key differs (a collision) adds its own minima and
//     maxima.
//   - latency: a row's loads (the header, every slot's set/isnull, the
//     order words of the columns the spec reads) are all issued before
//     any is used, none guarded by another's value; the slot loops are
//     specialised on the table's width (8 or 16 slots).
//   - exactness: sums are two 64-bit words with an explicit carry, in
//     shared memory and in the output alike (a carry is detected from the
//     atomic's old value), so they are exact to 2^128: a Q1 sum_charge
//     row is under 2^91, and 2^31 rows of it under 2^122.
//   - batches: grid.y runs over the specs of a launch (a shared table
//     holds one spec's buckets: 70 KB for Q1), grid.x over slices of each
//     spec's rows; the engine sends every spec of a batch that shares a
//     source and a signature in one launch. Each spec reads its rows'
//     planes itself: sharing one read between specs is later work.
//
// One build serves every signature: a descriptor (kernel parameter; loops
// unrolled to its maxima with block-uniform guards) names the columns,
// predicates (slot, planes, op, literal offset), group columns (slot,
// planes) and aggregates (kind, slot, base planes, need mask, factors,
// output slot, and each factor's postfix program); the [N, P] parameter
// rows carry each spec's row range, read point and literals.
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
constexpr int kKeySlots = 3 * kMaxGroup;  // per group: 2 planes + null
constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kHead = 7;
constexpr int kDescWords = kHead + kMaxCols + 4 * kMaxPreds + 2 * kMaxGroup +
                           6 * kMaxAggs + 2 * kMaxNodes * kMaxFactors * kMaxAggs;
constexpr int kParamHead = 6;  // row_lo, row_hi, read hi/lo, expiry hi/lo
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHashSeed = 0x01000193u;
constexpr uint32_t kHashMul = 0x811C9DC5u;  // -2128831035 as uint32
constexpr uint32_t kMixMul = 0x85EBCA6Bu;   // -2048144789 as uint32
constexpr uint32_t kLimbMask = (1u << 26) - 1;

enum Op : int32_t { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
enum AggKind : int32_t { kCount = 0, kSum = 1 };
enum Node : int32_t { kEnd = 0, kConst = 1, kColumn = 2, kAdd = 3, kSub = 4,
                      kMul = 5 };

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
  int32_t width[kMaxCols];   // order planes a row: 1 or 2
  int32_t stride[kMaxCols];  // words loaded a row: width, or 0 if unread
  uint32_t col_mask;         // bits of the slots 0..n_cols-1
  int32_t n_cols, n_preds, n_group, n_aggs, n_params, kp, n_out;
  int32_t pred_col[kMaxPreds], pred_planes[kMaxPreds], pred_op[kMaxPreds],
      pred_lit[kMaxPreds];
  int32_t grp_col[kMaxGroup], grp_planes[kMaxGroup], grp_key[kMaxGroup];
  int32_t agg_kind[kMaxAggs], agg_col[kMaxAggs], agg_planes[kMaxAggs],
      agg_nf[kMaxAggs], agg_off[kMaxAggs];
  uint32_t agg_need[kMaxAggs];
  int32_t agg_w32[kMaxAggs];  // the aggregate's count or n in a bucket's words
  int32_t agg_w64[kMaxAggs];  // its sum's low word in a bucket's 64-bit words
  int8_t node_op[kMaxAggs][kMaxFactors][kMaxNodes];
  int32_t node_arg[kMaxAggs][kMaxFactors][kMaxNodes];
  // A factor affine in one column (k, c, k + c, k - c, c - k, k * c...):
  // k0 + k1 * column, evaluated without the postfix program.
  int8_t fac_affine[kMaxAggs][kMaxFactors];
  int32_t fac_k0[kMaxAggs][kMaxFactors], fac_k1[kMaxAggs][kMaxFactors],
      fac_col[kMaxAggs][kMaxFactors];
  int32_t n32, n64;  // a bucket's 32-bit and 64-bit words in shared memory
  int32_t n_rows;
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

// A factor's postfix program at one row (``cw``: its order words), in
// wrapping int32 arithmetic (as the JAX program's int32 ops).
__device__ int32_t eval_factor(const Desc& d, int a, int f,
                               const int32_t (*cw)[2]) {
  uint32_t st[kMaxNodes];
  int sp = 0;
  for (int k = 0; k < kMaxNodes; ++k) {
    const int op = d.node_op[a][f][k];
    if (op == kEnd) break;
    const int32_t arg = d.node_arg[a][f][k];
    if (op == kConst) {
      st[sp++] = static_cast<uint32_t>(arg);
    } else if (op == kColumn) {
      st[sp++] = static_cast<uint32_t>(cw[arg][0]);
    } else {
      const uint32_t r = st[--sp];
      const uint32_t l = st[--sp];
      st[sp++] = op == kAdd ? l + r : op == kSub ? l - r : l * r;
    }
  }
  return static_cast<int32_t>(st[0]);
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

// kCols: the column slots a row loads (8 or kMaxCols, the least that
// holds n_cols), so that a narrow table issues no padding loads.
template <int kCols>
__global__ void __launch_bounds__(kThreads, 2)
    group_agg_kernel(const Desc d, const int32_t* __restrict__ params,
                     long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* t64 = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* t32 = reinterpret_cast<uint32_t*>(t64 + kNumBuckets * d.n64);
  __shared__ unsigned long long s_scanned, s_negs;

  const int spec = blockIdx.x;
  const int32_t* p = params + static_cast<long long>(spec) * d.n_params;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kNumBuckets * d.n64; i += kThreads) t64[i] = 0;
  for (int i = threadIdx.x; i < kNumBuckets * d.n32; i += kThreads) {
    const int w = i % d.n32;
    uint32_t v = 0;
    if (w == 1 || (w >= 2 && w < 2 + d.kp)) v = 0x7fffffffu;
    else if (w >= 2 + d.kp && w < 2 + 2 * d.kp) v = 0x80000000u;
    t32[i] = v;
  }
  if (threadIdx.x == 0) s_scanned = s_negs = 0;
  __syncthreads();

  // This block's slice of the spec's rows: whole warps' worth, in order.
  const long long lo = min(max(p[0], 0), d.n_rows);
  const long long hi = min(max(p[1], 0), d.n_rows);
  const long long span = hi > lo ? hi - lo : 0;
  const long long per = ((span + gridDim.y - 1) / gridDim.y + 31) & ~31ll;
  const long long s_lo = lo + blockIdx.y * per;
  const long long s_hi = min(hi, s_lo + per);
  const int32_t read_hi = p[2], read_lo = p[3], exp_hi = p[4], exp_lo = p[5];

  unsigned long long my_scanned = 0, my_negs = 0;
  for (long long base = s_lo; base < s_hi; base += kThreads) {
    const long long row = base + threadIdx.x;
    const long long r = row < s_hi ? row : s_lo;  // past the slice: no row
    // Every load of the row first, none guarded by another's value, so
    // that a row costs one memory latency: the header, each slot's
    // set/isnull (slots past n_cols read the valid plane) and the order
    // words of each column the spec reads (stride 0 for the others: one
    // cached word for the whole warp).
    const bool valid = d.valid[r] && row < s_hi;
    const bool tomb = d.tomb[r], live = d.live[r];
    const int32_t h_hi = __ldg(d.ht_hi + r), h_lo = __ldg(d.ht_lo + r);
    const int32_t e_hi = __ldg(d.exp_hi + r), e_lo = __ldg(d.exp_lo + r);
    uint32_t notnull = 0;  // bit c: slot c is set and not NULL
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const uint32_t set = d.set[c][r], isnull = d.isnull[c][r];
      notnull |= (set & (isnull ^ 1u)) << c;
    }
    int32_t cw[kCols][2];  // order words of the columns read
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int32_t* q = d.cmp[c] + r * d.stride[c];
      cw[c][0] = __ldg(q);
      cw[c][1] = __ldg(q + (d.stride[c] > 1 ? 1 : 0));
    }
    const bool alive = valid && le2(h_hi, h_lo, read_hi, read_lo) && !tomb &&
                       !le2(e_hi, e_lo, exp_hi, exp_lo);
    const uint32_t nn = alive ? notnull & d.col_mask : 0;
    const bool pre = alive && (live || nn != 0);
    my_scanned += pre;
    bool m = pre;
#pragma unroll
    for (int q = 0; q < kMaxPreds; ++q) {
      if (q < d.n_preds) {
        const int c = d.pred_col[q];
        m = m && ((nn >> c) & 1) &&
            pred_ok(d.pred_op[q], d.pred_planes[q], cw[c], p + d.pred_lit[q]);
      }
    }
    // Key planes at fixed slots (3 a group column) and the bucket.
    int32_t key[kKeySlots];
    uint32_t h = kHashSeed;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      key[3 * g] = key[3 * g + 1] = key[3 * g + 2] = 0;
      if (g < d.n_group) {
        const int c = d.grp_col[g];
        const bool on = m && ((nn >> c) & 1);
        key[3 * g] = on ? cw[c][0] : 0;
        h = (h ^ static_cast<uint32_t>(key[3 * g])) * kHashMul;
        if (d.grp_planes[g] == 2) {
          key[3 * g + 1] = on ? cw[c][1] : 0;
          h = (h ^ static_cast<uint32_t>(key[3 * g + 1])) * kHashMul;
        }
        key[3 * g + 2] = ((nn >> c) & 1) ? 0 : 1;
        h = (h ^ static_cast<uint32_t>(key[3 * g + 2])) * kHashMul;
      }
    }
    h ^= h >> 16;
    h *= kMixMul;
    h ^= h >> 13;
    const int bucket = static_cast<int>((h & 0x7fffffffu) % kNumBuckets);

    // The row's aggregate inputs, once: the aggregates it feeds (bit a:
    // it matches and aggregate a's inputs are all non-NULL), and each
    // sum's product as four 26-bit limbs (a product is under 2^91, and 32
    // lanes' limbs add up in 32 bits). A product with a negative input
    // is left out and counted in negs.
    uint32_t ok_bits = 0;
    uint32_t limb[kMaxAggs][4];
#pragma unroll
    for (int a = 0; a < kMaxAggs; ++a) {
      limb[a][0] = limb[a][1] = limb[a][2] = limb[a][3] = 0;
      if (a < d.n_aggs && m && (nn & d.agg_need[a]) == d.agg_need[a]) {
        ok_bits |= 1u << a;
        if (d.agg_kind[a] == kSum) {
          const int64_t v = base_value(cw[d.agg_col[a]], d.agg_planes[a]);
          int bad = v < 0;
          uint64_t f[kMaxFactors] = {1, 1};
#pragma unroll
          for (int k = 0; k < kMaxFactors; ++k) {
            if (k < d.agg_nf[a]) {
              const int32_t x =
                  d.fac_affine[a][k]
                      ? static_cast<int32_t>(
                            static_cast<uint32_t>(d.fac_k0[a][k]) +
                            static_cast<uint32_t>(d.fac_k1[a][k]) *
                                static_cast<uint32_t>(cw[d.fac_col[a][k]][0]))
                      : eval_factor(d, a, k, cw);
              bad += x < 0;
              f[k] = static_cast<uint32_t>(x);
            }
          }
          my_negs += bad;
          if (!bad) {
            const uint64_t u = static_cast<uint64_t>(v);
            uint64_t lo = u * f[0];  // < 2^77: two words
            uint64_t hi = __umul64hi(u, f[0]);
            hi = hi * f[1] + __umul64hi(lo, f[1]);
            lo *= f[1];
            limb[a][0] = static_cast<uint32_t>(lo) & kLimbMask;
            limb[a][1] = static_cast<uint32_t>(lo >> 26) & kLimbMask;
            limb[a][2] = static_cast<uint32_t>((lo >> 52) | (hi << 12)) &
                         kLimbMask;
            limb[a][3] = static_cast<uint32_t>(hi >> 14) & kLimbMask;
          }
        }
      }
    }

    // Fold the warp's matching rows one bucket at a time.
    unsigned todo = __ballot_sync(kFull, m);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const int b = __shfl_sync(kFull, bucket, leader);
      const bool mine = m && bucket == b && ((todo >> lane) & 1);
      const unsigned peers = __ballot_sync(kFull, mine);
      todo &= ~peers;
      bool same = true;
#pragma unroll
      for (int k = 0; k < kKeySlots; ++k) {
        if (k < 3 * d.n_group) {
          same &= key[k] == __shfl_sync(kFull, key[k], leader);
        }
      }
      uint32_t* w32 = t32 + b * d.n32;
      if (lane == leader) {
        atomicAdd(&w32[0], __popc(peers));
        atomicMin(reinterpret_cast<int*>(&w32[1]), static_cast<int>(row));
      }
      if (mine && (lane == leader || !same)) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < d.n_group) {
            // Planes at key positions at, at + 1 (two-plane columns),
            // then the null flag.
            const int at = d.grp_key[g];
            const int planes = d.grp_planes[g];
            int* kmin = reinterpret_cast<int*>(&w32[2 + at]);
            int* kmax = reinterpret_cast<int*>(&w32[2 + d.kp + at]);
            atomicMin(kmin, key[3 * g]);
            atomicMax(kmax, key[3 * g]);
            if (planes == 2) {
              atomicMin(kmin + 1, key[3 * g + 1]);
              atomicMax(kmax + 1, key[3 * g + 1]);
            }
            atomicMin(kmin + planes, key[3 * g + 2]);
            atomicMax(kmax + planes, key[3 * g + 2]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kMaxAggs; ++a) {
        if (a >= d.n_aggs) continue;
        const bool ok = mine && ((ok_bits >> a) & 1);
        const unsigned oks = __ballot_sync(kFull, ok);
        if (!oks) continue;
        if (lane == leader) atomicAdd(&w32[d.agg_w32[a]], __popc(oks));
        if (d.agg_kind[a] == kCount) continue;
        uint32_t sum[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sum[k] = __reduce_add_sync(kFull, ok ? limb[a][k] : 0u);
        }
        if (lane == leader && (sum[0] | sum[1] | sum[2] | sum[3])) {
          uint64_t lo = sum[0], hi = 0;
          add128(lo, hi, static_cast<uint64_t>(sum[1]) << 26, 0);
          add128(lo, hi, static_cast<uint64_t>(sum[2]) << 52,
                 static_cast<uint64_t>(sum[2]) >> 12);
          add128(lo, hi, 0, static_cast<uint64_t>(sum[3]) << 14);
          unsigned long long* w = t64 + b * d.n64 + d.agg_w64[a];
          atomic_add128(w, w + 1, lo, hi);
        }
      }
    }
  }
  atomicAdd(&s_scanned, my_scanned);
  if (my_negs) atomicAdd(&s_negs, my_negs);
  __syncthreads();

  // Merge the live buckets into the spec's table in device memory.
  long long* table = out + static_cast<long long>(spec) * (kNumBuckets + 1) *
                               d.n_out;
  for (int b = threadIdx.x; b < kNumBuckets; b += kThreads) {
    const uint32_t* w32 = t32 + b * d.n32;
    if (!w32[0]) continue;
    long long* o = table + static_cast<long long>(b) * d.n_out;
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
        const unsigned long long* w = t64 + b * d.n64 + d.agg_w64[a];
        if (w[0] | w[1]) {
          atomic_add128(reinterpret_cast<unsigned long long*>(&o[off + 1]),
                        reinterpret_cast<unsigned long long*>(&o[off + 2]),
                        w[0], w[1]);
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    long long* o = table + static_cast<long long>(kNumBuckets) * d.n_out;
    if (s_scanned) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&o[0]), s_scanned);
    }
    if (s_negs) atomicAdd(reinterpret_cast<unsigned long long*>(&o[1]), s_negs);
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

}  // namespace

extern "C" {

// planes: ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live, then per column
// slot: set, isnull, cmp. desc: kDescWords int32 words (layout in
// ops/group_agg.py GroupAggPlan.descriptor). params: [n_specs, n_params]
// int32 on the device. out: [n_specs, kNumBuckets + 1, n_out] int64 on the
// device. slices (blocks a spec) and smem_bytes: ops/group_agg.py
// launch_geometry.
int group_agg_launch(const void* const* planes, int n_planes,
                     const int32_t* desc, int n_desc, const int32_t* params,
                     int n_specs, long long n_rows, long long* out, int slices,
                     int smem_bytes, void* stream) {
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
  if (n_planes != 7 + 3 * d.n_cols) return kErrPlanes;
  const int32_t* w = desc + kHead;
  for (int c = 0; c < d.n_cols; ++c) {
    if (w[c] != 1 && w[c] != 2) return kErrPlanes;
    d.width[c] = w[c];
    d.set[c] = static_cast<const uint8_t*>(planes[7 + 3 * c]);
    d.isnull[c] = static_cast<const uint8_t*>(planes[8 + 3 * c]);
    d.cmp[c] = static_cast<const int32_t*>(planes[9 + 3 * c]);
  }
  w += kMaxCols;
  for (int q = 0; q < kMaxPreds; ++q, w += 4) {
    if (q >= d.n_preds) continue;
    if (w[0] < 0 || w[0] >= d.n_cols || (w[1] != 1 && w[1] != 2) ||
        d.width[w[0]] < w[1] || w[2] < kEq || w[2] > kGe ||
        w[3] < kParamHead || w[3] + w[1] > d.n_params) {
      return kErrPred;
    }
    d.pred_col[q] = w[0];
    d.pred_planes[q] = w[1];
    d.pred_op[q] = w[2];
    d.pred_lit[q] = w[3];
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
    d.grp_key[g] = kp;
    kp += w[1] + 1;
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
  if (slices < 1 || slices > 65535 || n_specs < 1 || n_specs > 65535 ||
      n_rows < 0 ||
      n_rows > (1ll << 31) - 1 - kThreads) {
    return kErrGrid;
  }
  const long long need =
      static_cast<long long>(kNumBuckets) * (8 * d.n64 + 4 * d.n32);
  if (need != smem_bytes || need > kSmemLimit) return kErrShared;
  d.ht_hi = static_cast<const int32_t*>(planes[0]);
  d.ht_lo = static_cast<const int32_t*>(planes[1]);
  d.exp_hi = static_cast<const int32_t*>(planes[2]);
  d.exp_lo = static_cast<const int32_t*>(planes[3]);
  d.valid = static_cast<const uint8_t*>(planes[4]);
  d.tomb = static_cast<const uint8_t*>(planes[5]);
  d.live = static_cast<const uint8_t*>(planes[6]);
  d.n_rows = static_cast<int32_t>(n_rows);
  // The order words a row reads: the predicates', group columns', sum
  // bases' and factor columns'. Unread slots and slots past n_cols load one
  // fixed word (stride 0); their set/isnull load the valid plane.
  uint32_t read = 0;
  for (int q = 0; q < d.n_preds; ++q) read |= 1u << d.pred_col[q];
  for (int g = 0; g < d.n_group; ++g) read |= 1u << d.grp_col[g];
  for (int a = 0; a < d.n_aggs; ++a) {
    if (d.agg_kind[a] == kSum) read |= 1u << d.agg_col[a];
    for (int f = 0; f < d.agg_nf[a]; ++f) {
      for (int k = 0; k < kMaxNodes; ++k) {
        if (d.node_op[a][f][k] == kColumn) read |= 1u << d.node_arg[a][f][k];
      }
    }
  }
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= d.n_cols) {
      d.set[c] = d.isnull[c] = d.valid;
      d.cmp[c] = d.ht_hi;
    }
    d.stride[c] = c < d.n_cols && ((read >> c) & 1) ? d.width[c] : 0;
  }
  d.col_mask = d.n_cols == 32 ? ~0u : (1u << d.n_cols) - 1;
  const auto kernel =
      d.n_cols <= 8 ? group_agg_kernel<8> : group_agg_kernel<kMaxCols>;
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
  // Specs on x: the blocks of one row slice for every spec are scheduled
  // together, so that the specs after the first read it from L2.
  kernel<<<dim3(n_specs, slices), kThreads, smem_bytes, s>>>(
      d, params, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel one SM holds at once for a table of n_cols value
// columns and a bucket table of smem_bytes (registers, threads and shared
// memory all counted), or a negative CUDA error code.
int group_agg_occupancy(int n_cols, int smem_bytes) {
  const auto kernel =
      n_cols <= 8 ? group_agg_kernel<8> : group_agg_kernel<kMaxCols>;
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
    case kErrShared: return "shared-memory bytes disagree with the table";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
