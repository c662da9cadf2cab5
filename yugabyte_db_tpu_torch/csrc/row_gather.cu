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
// (a key's versions, newest first) never cross a block, so a window is
// segment-complete. Per key group, at a read point:
//   - the newest visible tombstone shadows every version at or below its
//     hybrid time (the same-batch DELETE + write tie included);
//   - alive = visible, not a tombstone, not shadowed; liveness is an
//     alive, unexpired version with the marker;
//   - per column, the first alive setter is the latest value; its NULL
//     bit or its expiry makes the column NULL;
//   - the group exists through liveness or any non-NULL column, and
//     matches when it lies in the row bounds and (K7 always, K9 when
//     apply_preds) passes every predicate on its merged values ('str'
//     and 'f32' predicates as supersets the host verifies).
//
// K7: one block a page. The block walks the page's windows in key order,
// 256 rows a step, one thread a row; the thread at a group's first row
// resolves the group (a flat run: one row a group, no walk). Ballots and
// a prefix over the block's 8 warps number the step's groups and its
// matches in key order (the compaction JAX does with top_k), and each
// matching thread writes its output row at count + its rank while that is
// below M. `count` sums every match of every window walked and is not
// capped at M (the host reads count > M as overflow); `scanned` counts
// the groups that exist in range, before predicates, at or past
// scan_from; the page stops after the window in which count reached M,
// and w_end is the first window not walked. In chunks mode (packed = 0)
// the block writes its one window in place, each group at its group id,
// start = -1 for a group that does not match.
//
// K9: one block a window of a range, the same walk; each group writes its
// match flag and first row at its group id, past the window's groups
// false and I32_MAX, and the block writes the window's group count.
//
// What bounds them: bytes. Per row walked: the flags, the hybrid time and
// the expiry (20 bytes), each value column's set and isnull flags, and
// the order and arithmetic planes of the predicate and output columns at
// each group's setters; then the output once. A few dozen integer
// operations a row are far below the card's integer rate. A LIMIT page
// walks one window or a few, so the work of a page stays proportional to
// the windows it walks; there is no resolve of the whole run.
//
// The design is the simple one: a thread walks its group row by row, so
// a warp waits for the longest group it holds (the warp-step resolve of
// csrc/mvcc_resolve.cu is the way to take that away), and a page is one
// block, so a batch of fewer than ~264 pages leaves SMs idle.
//
// Interface: plain C, for ctypes. Each launch function returns 0, a
// negative code for an argument it refuses, or the launch's
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;
constexpr int kMaxPreds = 16;
constexpr int kMaxOut = 16;
constexpr int kParamFixed = 9;  // w_first, w_last, row_lo, row_hi, read
                                // hi/lo, expiry hi/lo, scan_from
constexpr int32_t kI32Max = 0x7fffffff;

// Predicate kinds and operators (ops/row_gather.py KIND_CODES, OP_CODES).
enum Kind { kI32 = 0, kI64 = 1, kF64 = 2, kStr = 3, kF32 = 4 };
enum Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

constexpr int kErrCols = -1;
constexpr int kErrPreds = -2;
constexpr int kErrOut = -3;
constexpr int kErrShape = -4;
constexpr int kErrPlane = -5;
constexpr int kErrParams = -6;

struct Col {
  const uint8_t* set;
  const uint8_t* isnull;
  const int32_t* cmp;   // [n_rows, width]
  const float* arith;   // null where the column has none
  int width;
};

struct Sig {
  const uint8_t* valid;
  const uint8_t* group_start;
  const uint8_t* tomb;
  const uint8_t* live;
  const int32_t* ht_hi;
  const int32_t* ht_lo;
  const int32_t* exp_hi;
  const int32_t* exp_lo;
  Col cols[kMaxCols];
  int n_cols;
  int8_t pred_col[kMaxPreds];   // column slot
  int8_t pred_kind[kMaxPreds];
  int8_t pred_op[kMaxPreds];
  int8_t pred_lit[kMaxPreds];   // offset among the int or float literals
  int n_preds;
  int apply_preds;
  int8_t out_col[kMaxOut];      // column slot
  int8_t out_planes[kMaxOut];
  int8_t out_want_idx[kMaxOut];
  int n_out;
  int R, K, N, M, W;
  int flat, packed;
  int P, F;                     // params per page: ints, floats
};

struct Page {
  int32_t w_first, w_last;
  long long row_lo, row_hi, scan_from;
  int32_t r_hi, r_lo, e_hi, e_lo;
};

__device__ __forceinline__ bool le2(int32_t ah, int32_t al, int32_t bh,
                                    int32_t bl) {
  return ah < bh || (ah == bh && al <= bl);
}

__device__ __forceinline__ bool lt2(int32_t ah, int32_t al, int32_t bh,
                                    int32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

__device__ __forceinline__ bool expired_at(const Sig& s, long long g,
                                           const Page& p) {
  return le2(s.exp_hi[g], s.exp_lo[g], p.e_hi, p.e_lo);
}

// A group: rows [g0, g0 + len) of the run, its newest visible tombstone.
struct Group {
  long long g0;
  int len;
  bool has_t;
  int32_t t_hi, t_lo;
};

__device__ __forceinline__ bool alive_at(const Sig& s, long long g,
                                         const Page& p, const Group& grp) {
  if (!s.valid[g]) return false;
  const int32_t hh = s.ht_hi[g], hl = s.ht_lo[g];
  if (!le2(hh, hl, p.r_hi, p.r_lo) || s.tomb[g]) return false;
  return !(grp.has_t && le2(hh, hl, grp.t_hi, grp.t_lo));
}

// The group's first alive setter of column slot c, as an offset in the
// group, or -1.
__device__ int first_setter(const Sig& s, int c, const Page& p,
                            const Group& grp) {
  const uint8_t* set = s.cols[c].set;
  for (int r = 0; r < grp.len; ++r) {
    const long long g = grp.g0 + r;
    if (set[g] && alive_at(s, g, p, grp)) return r;
  }
  return -1;
}

struct ColState {
  long long idx;  // global row whose planes stand for the column
  bool notnull;
};

// Column slot c of the group: its setter's global row (where there is
// none, the JAX program's stand-in: the row itself on a flat run, the
// window's last row otherwise) and whether the merged value is non-NULL.
__device__ ColState col_state(const Sig& s, int c, const Page& p,
                              const Group& grp, long long win_last) {
  const int f = first_setter(s, c, p, grp);
  if (f < 0) return {s.flat ? grp.g0 : win_last, false};
  const long long g = grp.g0 + f;
  return {g, !s.cols[c].isnull[g] && !expired_at(s, g, p)};
}

__device__ bool eval_pred(const Sig& s, int i, long long g,
                          const int32_t* ilit, const float* flit) {
  const Col& col = s.cols[s.pred_col[i]];
  const int op = s.pred_op[i];
  const int kind = s.pred_kind[i];
  if (kind == kF32) {
    const float v = col.arith[g];
    const float x = flit[s.pred_lit[i]];
    switch (op) {
      case kEq: return v == x;
      case kNe: return true;
      case kLt: case kLe: return v <= x;
      default: return v >= x;
    }
  }
  if (kind == kI32) {
    const int32_t v = col.cmp[g * col.width];
    const int32_t x = ilit[s.pred_lit[i]];
    switch (op) {
      case kEq: return v == x;
      case kNe: return v != x;
      case kLt: return v < x;
      case kLe: return v <= x;
      case kGt: return v > x;
      default: return v >= x;
    }
  }
  const int32_t hi = col.cmp[g * col.width];
  const int32_t lo = col.cmp[g * col.width + 1];
  const int32_t xh = ilit[s.pred_lit[i]], xl = ilit[s.pred_lit[i] + 1];
  const bool eq = hi == xh && lo == xl;
  const bool lt = lt2(hi, lo, xh, xl);
  if (kind == kStr) {  // prefix planes: equal planes are maybe-matches
    switch (op) {
      case kEq: return eq;
      case kNe: return true;
      case kLt: case kLe: return lt || eq;
      default: return !lt;
    }
  }
  switch (op) {
    case kEq: return eq;
    case kNe: return !eq;
    case kLt: return lt;
    case kLe: return lt || eq;
    case kGt: return !(lt || eq);
    default: return !lt;
  }
}

// One output row: [start | per output column: planes, null, (setter row)],
// zeros up to W.
__device__ void write_row(const Sig& s, int32_t* dst, int32_t start,
                          const Page& p, const Group& grp,
                          long long win_last) {
  dst[0] = start;
  int off = 1;
  for (int j = 0; j < s.n_out; ++j) {
    const int c = s.out_col[j];
    const ColState cs = col_state(s, c, p, grp, win_last);
    const Col& col = s.cols[c];
    for (int k = 0; k < s.out_planes[j]; ++k) {
      dst[off++] = col.cmp[cs.idx * col.width + k];
    }
    dst[off++] = cs.notnull ? 0 : 1;
    if (s.out_want_idx[j]) {
      dst[off++] = cs.notnull ? static_cast<int32_t>(cs.idx) : -1;
    }
  }
  for (; off < s.W; ++off) dst[off] = 0;
}

// A group id past the window's groups: the JAX program's garbage row
// (start -1, the window's last row's planes, NULL, no setter).
__device__ void write_empty_row(const Sig& s, int32_t* dst,
                                long long win_last) {
  dst[0] = -1;
  int off = 1;
  for (int j = 0; j < s.n_out; ++j) {
    const Col& col = s.cols[s.out_col[j]];
    for (int k = 0; k < s.out_planes[j]; ++k) {
      dst[off++] = col.cmp[win_last * col.width + k];
    }
    dst[off++] = 1;
    if (s.out_want_idx[j]) dst[off++] = -1;
  }
  for (; off < s.W; ++off) dst[off] = 0;
}

__device__ Page load_page(const Sig& s, const int32_t* ip) {
  Page p;
  p.w_first = ip[0];
  p.w_last = ip[1];
  p.row_lo = ip[2];
  p.row_hi = ip[3];
  p.r_hi = ip[4];
  p.r_lo = ip[5];
  p.e_hi = ip[6];
  p.e_lo = ip[7];
  p.scan_from = ip[8];
  return p;
}

// The block's literals in shared memory.
struct Lits {
  int32_t i[2 * kMaxPreds];
  float f[kMaxPreds];
};

__device__ void load_lits(const Sig& s, const int32_t* ip, const float* fp,
                          Lits* lits) {
  for (int k = threadIdx.x; k < s.P - kParamFixed && k < 2 * kMaxPreds;
       k += kThreads) {
    lits->i[k] = ip[kParamFixed + k];
  }
  for (int k = threadIdx.x; k < s.F && k < kMaxPreds; k += kThreads) {
    lits->f[k] = fp[k];
  }
}

enum Mode { kPaged = 0, kChunks = 1, kCandidates = 2 };

// Step sums of the block: the thread's rank among the earlier threads and
// the totals, for each of three flags.
struct Ranks {
  int lead, match;
  int tot_lead, tot_match, tot_count;
};

__device__ Ranks block_ranks(bool lead, bool match, bool counted,
                             int (*warp_tot)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned bl = __ballot_sync(0xffffffffu, lead);
  const unsigned bm = __ballot_sync(0xffffffffu, match);
  const unsigned bc = __ballot_sync(0xffffffffu, counted);
  if (lane == 0) {
    warp_tot[0][warp] = __popc(bl);
    warp_tot[1][warp] = __popc(bm);
    warp_tot[2][warp] = __popc(bc);
  }
  __syncthreads();
  Ranks r{__popc(bl & lt), __popc(bm & lt), 0, 0, 0};
  for (int w = 0; w < kWarps; ++w) {
    const int l = warp_tot[0][w], m = warp_tot[1][w];
    if (w < warp) {
      r.lead += l;
      r.match += m;
    }
    r.tot_lead += l;
    r.tot_match += m;
    r.tot_count += warp_tot[2][w];
  }
  __syncthreads();  // the totals are read before the next step writes
  return r;
}

// Walk one window (its first global row `base`). Returns the window's
// group count; adds its matches to *count and its counted groups to
// *scanned. kPaged writes matches at *count + rank below M into `out`;
// kChunks writes every group at its id into `out`; kCandidates writes
// match flags and first rows into `cand` / `cand_start`.
template <int kMode>
__device__ int walk_window(const Sig& s, const Page& p, const Lits& lits,
                           long long base, int32_t* out, uint8_t* cand,
                           int32_t* cand_start, int* count, int* scanned,
                           int (*warp_tot)[kWarps]) {
  const int N = s.N;
  const long long win_last = base + N - 1;
  int gid_base = 0;
  for (int c0 = 0; c0 < N; c0 += kThreads) {
    const int row = c0 + threadIdx.x;
    const long long g0 = base + row;
    const bool lead = row < N && (s.flat || s.group_start[g0]);
    bool pre = false, match = false;
    Group grp{g0, 1, false, 0, 0};
    if (lead) {
      bool valid_any = s.valid[g0];
      if (!s.flat) {
        while (row + grp.len < N && !s.group_start[g0 + grp.len]) ++grp.len;
        for (int r = 0; r < grp.len; ++r) {
          const long long g = g0 + r;
          if (!s.valid[g]) continue;
          valid_any = true;
          const int32_t hh = s.ht_hi[g], hl = s.ht_lo[g];
          if (s.tomb[g] && le2(hh, hl, p.r_hi, p.r_lo) &&
              (!grp.has_t || lt2(grp.t_hi, grp.t_lo, hh, hl))) {
            grp.has_t = true;
            grp.t_hi = hh;
            grp.t_lo = hl;
          }
        }
      }
      bool exists = false;
      for (int r = 0; r < grp.len && !exists; ++r) {
        const long long g = g0 + r;
        exists = s.live[g] && alive_at(s, g, p, grp) && !expired_at(s, g, p);
      }
      for (int c = 0; c < s.n_cols && !exists; ++c) {
        exists = col_state(s, c, p, grp, win_last).notnull;
      }
      pre = exists && valid_any && g0 >= p.row_lo && g0 < p.row_hi;
      match = pre;
      if (match && (kMode != kCandidates || s.apply_preds)) {
        for (int i = 0; i < s.n_preds && match; ++i) {
          const ColState cs = col_state(s, s.pred_col[i], p, grp, win_last);
          match = cs.notnull && eval_pred(s, i, cs.idx, lits.i, lits.f);
        }
      }
    }
    const bool counted = pre && g0 >= p.scan_from;
    const Ranks rk = block_ranks(lead, match, counted, warp_tot);
    const int gid = gid_base + rk.lead;
    if (kMode == kPaged) {
      const int pos = *count + rk.match;
      if (match && pos < s.M) {
        write_row(s, out + static_cast<long long>(pos) * s.W,
                  static_cast<int32_t>(g0), p, grp, win_last);
      }
    } else if (kMode == kChunks) {
      if (lead) {
        write_row(s, out + static_cast<long long>(gid) * s.W,
                  match ? static_cast<int32_t>(g0) : -1, p, grp, win_last);
      }
    } else if (lead) {
      cand[gid] = match ? 1 : 0;
      cand_start[gid] = row;
    }
    gid_base += rk.tot_lead;
    *count += rk.tot_match;
    *scanned += rk.tot_count;
  }
  // Group ids past the window's groups.
  for (int gid = gid_base + threadIdx.x; gid < N; gid += kThreads) {
    if (kMode == kChunks) {
      write_empty_row(s, out + static_cast<long long>(gid) * s.W, win_last);
    } else if (kMode == kCandidates) {
      cand[gid] = 0;
      cand_start[gid] = kI32Max;
    }
  }
  return gid_base;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const Sig s, const int32_t* __restrict__ iparams,
              const float* __restrict__ fparams, int32_t* __restrict__ out) {
  __shared__ Lits lits;
  __shared__ int warp_tot[3][kWarps];
  const long long page = blockIdx.x;
  const int32_t* ip = iparams + page * s.P;
  const Page p = load_page(s, ip);
  load_lits(s, ip, fparams + page * s.F, &lits);
  __syncthreads();
  int32_t* buf = out + page * static_cast<long long>(s.M + 1) * s.W;
  const long long window_rows = static_cast<long long>(s.K) * s.R;
  int count = 0, scanned = 0;
  int w = p.w_first;
  if (s.packed) {
    while (w <= p.w_last && count < s.M) {
      walk_window<kPaged>(s, p, lits, w * window_rows, buf, nullptr, nullptr,
                          &count, &scanned, warp_tot);
      ++w;
    }
    // Rows past the matches are zeros.
    const long long filled = count < s.M ? count : s.M;
    for (long long k = filled * s.W + threadIdx.x;
         k < static_cast<long long>(s.M) * s.W; k += kThreads) {
      buf[k] = 0;
    }
  } else {
    walk_window<kChunks>(s, p, lits, w * window_rows, buf, nullptr, nullptr,
                         &count, &scanned, warp_tot);
    ++w;
  }
  int32_t* tail = buf + static_cast<long long>(s.M) * s.W;
  for (int k = threadIdx.x; k < s.W; k += kThreads) {
    tail[k] = k == 0 ? count : k == 1 ? scanned : k == 2 ? w : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
candidates_kernel(const Sig s, const int32_t* __restrict__ iparams,
                  const float* __restrict__ fparams,
                  uint8_t* __restrict__ result, int32_t* __restrict__ start,
                  int32_t* __restrict__ num_groups) {
  __shared__ Lits lits;
  __shared__ int warp_tot[3][kWarps];
  const Page p = load_page(s, iparams);
  load_lits(s, iparams, fparams, &lits);
  __syncthreads();
  const long long b = blockIdx.x;
  const long long window_rows = static_cast<long long>(s.K) * s.R;
  int count = 0, scanned = 0;
  const int ng = walk_window<kCandidates>(
      s, p, lits, (p.w_first + b) * window_rows, nullptr, result + b * s.N,
      start + b * s.N, &count, &scanned, warp_tot);
  if (threadIdx.x == 0) num_groups[b] = ng;
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
  for (int c = 0; c < n_cols; ++c) {
    Col& col = s->cols[c];
    col.set = static_cast<const uint8_t*>(cols[4 * c]);
    col.isnull = static_cast<const uint8_t*>(cols[4 * c + 1]);
    col.cmp = static_cast<const int32_t*>(cols[4 * c + 2]);
    col.arith = static_cast<const float*>(cols[4 * c + 3]);
    col.width = widths[c];
    if (!col.set || !col.isnull || !col.cmp || col.width < 1 ||
        col.width > 2) {
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
    if (kind == kF32 && s->cols[c].arith == nullptr) return kErrPreds;
    if (kind != kF32 && kind != kI32 && s->cols[c].width != 2) {
      return kErrPreds;
    }
    s->pred_col[i] = static_cast<int8_t>(c);
    s->pred_kind[i] = static_cast<int8_t>(kind);
    s->pred_op[i] = static_cast<int8_t>(preds[3 * i + 2]);
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
    if (c < 0 || c >= n_cols || planes < 1 || planes > s->cols[c].width) {
      return kErrOut;
    }
    s->out_col[j] = static_cast<int8_t>(c);
    s->out_planes[j] = static_cast<int8_t>(planes);
    s->out_want_idx[j] = static_cast<int8_t>(outs[3 * j + 2] != 0);
  }
  s->R = R;
  s->K = K;
  s->N = R * K;
  s->P = P;
  s->F = F;
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
      (!packed && M != R * K)) {
    return kErrShape;
  }
  if (!iparams || !fparams || !out) return kErrParams;
  s.M = M;
  s.W = W;
  s.flat = flat != 0;
  s.packed = packed != 0;
  s.apply_preds = 1;
  if (G == 0) return 0;
  gather_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, iparams, fparams, out);
  return static_cast<int>(cudaGetLastError());
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
  if (n_windows < 0) return kErrShape;
  if (!iparams || !fparams || !result || !start || !num_groups) {
    return kErrParams;
  }
  s.M = 1;
  s.W = 1;
  s.flat = flat != 0;
  s.packed = 1;
  s.apply_preds = apply_preds != 0;
  if (n_windows == 0) return 0;
  candidates_kernel<<<n_windows, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      s, iparams, fparams, result, start, num_groups);
  return static_cast<int>(cudaGetLastError());
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
