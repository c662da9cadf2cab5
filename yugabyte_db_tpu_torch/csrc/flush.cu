// The device memtable flush's replay scatter, for Hopper (sm_90a): K12.
//
// Replaces the JAX package's XLA program yugabyte_db_tpu/ops/flush.py
// replay_flush. The host stages the memtable's rows in apply order as
// flat planes and computes the flush order (perm: the staged row of each
// sorted position) and the block packing (dst: each sorted position's
// slot in the run's [Bp, R] planes). One call writes every plane of the
// run:
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
// What stands in the way: perm maps sorted order back to apply order, so
// the staged rows a tile of output slots needs lie anywhere. Gathering
// them plane by plane (the first design: a thread a slot) pulls a whole
// 32-byte sector for every 1-4 byte plane of every row, ~18 sectors a
// row of the bench table against ~65 useful bytes.
//
// Design: two passes, both launched here on the caller's stream, with a
// scratch of records that the wrapper allocates.
//   1. Pack. A thread a staged row, in apply order, so that every plane is
//      read coalesced, composes the row's record in shared memory: hybrid
//      time and expiry (the first column chunk only), a flag byte each for
//      tombstone, liveness and each column's set and isnull, then each
//      column's one or two order words and its arithmetic word, padded to
//      a multiple of 16 bytes (ops/flush.py record_layout mirrors the
//      layout). The block then writes its records out 16 bytes a thread.
//   2. Tile. A block takes a tile of T = 256 output slots (fewer where
//      the records are wide), so that eight blocks share an SM and hide
//      the gathers' latency (larger and smaller tiles were slower on an
//      H100; PERF.md has the times). One warp finds the first sorted
//      position at or past the tile's first slot (a 32-way search of dst,
//      which ascends), the block loads the next T entries of dst, perm
//      and gs (coalesced) and inverts them in shared memory. Then the
//      block gathers each filled slot's record
//      with 16-byte loads, a record's pieces on neighbouring threads,
//      into shared memory transposed (a row of T words for each word of
//      the record), padding slots filled with their encoding. Last, each
//      thread writes four slots of one plane of one column with a single
//      store: 16 bytes for a word plane, 4 for a flag plane, 32 for a
//      two-word order plane. The fill and the scatter are one pass, so no
//      slot is written twice.
// A dictionary-encoded string column (the JAX function's codes route) is
// staged as one u16 code a row: its record holds the code in one word, and
// the tile pass writes the run's u16 code plane (8 bytes for four slots),
// unfilled and padding slots taking the column's absent code, the
// dictionary's last slot.
// A random access now moves one whole record of a row, not a sector per
// plane. dst must ascend strictly over its in-range entries (the flush's
// packing gives it so; entries past the last slot may repeat): then the
// positions landing in a tile lie among the T entries after the searched
// one.
//
// Interface: plain C, for ctypes. replay_flush_launch returns 0, a
// negative code for an argument it refuses, or the launches'
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

// A pack block's records, or a tile block's transposed records and its
// slot map (dynamic shared memory).
extern __shared__ __align__(16) int32_t s_dyn[];

namespace {

constexpr int kMaxCols = 32;
constexpr int kThreads = 256;
constexpr int kTop = 6;       // staged ht hi/lo, exp hi/lo, tomb, live
constexpr int kOutTop = 8;    // valid, group_start, tomb, live, ht, exp
constexpr int kTopWords = 4;  // a record's ht hi/lo, exp hi/lo
constexpr int kPackBytes = 48 * 1024;  // a pack block's records at most
constexpr int kTileBytes = 96 * 1024;  // a tile block's record rows at most
constexpr int kTileMax = 256;          // output slots a tile block
constexpr int kTileMin = 128;
constexpr uint32_t kFull = 0xffffffffu;

enum Err : int {
  kErrCols = -1,
  kErrRows = -2,
  kErrPlane = -3,
  kErrWidth = -4,
  kErrScratch = -5,
  kErrAlign = -6,
};

// Where each plane of a staged row lies in its record, in 32-bit words.
struct Layout {
  int32_t stride;          // words a record, a multiple of 4
  int32_t flags;           // the first flag word: byte 0 tombstone, 1
                           // liveness, 2 + 2c column c's set, 3 + 2c isnull
  int32_t cmp[kMaxCols];   // column c's first order word
  int32_t arith[kMaxCols]; // column c's arithmetic word, -1: none
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
  int32_t width[kMaxCols];  // order planes per row: 1 or 2; 0: u16 codes
  int32_t absent[kMaxCols];  // a codes column's absent code
  Layout lay;
  int32_t* records;  // [n_staged, lay.stride] words of scratch
  const int32_t* perm;
  const int32_t* dst;
  const uint8_t* gs;
  const uint8_t* is_real;
  long long m;         // sorted positions
  long long n_staged;  // staged rows
  long long slots;     // Bp * R
  int32_t rows_per_block;
  int32_t n_cols;
  int32_t exp_hi_default;
  int32_t exp_lo_default;
  int32_t pack_rows;  // staged rows a pack block
  int32_t tile;       // output slots a tile block, a power of two
  int32_t log_groups; // log2(tile / 4)
  bool top;  // write the planes every row has (the first column chunk)
};

Layout record_layout(const int32_t* width, const void* const* in, int n_cols,
                     bool top) {
  Layout lay{};
  int words = top ? kTopWords : 0;
  lay.flags = words;
  words += (2 + 2 * n_cols + 3) / 4;
  for (int c = 0; c < n_cols; ++c) {
    lay.cmp[c] = words;
    words += width[c] == 0 ? 1 : width[c];
    lay.arith[c] = -1;
    if (in[kTop + 4 * c + 3] != nullptr) lay.arith[c] = words++;
  }
  lay.stride = (words + 3) / 4 * 4;
  return lay;
}

// The first index j of the ascending a[0, n) with a[j] >= x (n if none),
// found by the 32 lanes of a warp together: each step probes 32 places
// and keeps the piece between the last below x and the first not.
__device__ long long warp_lower_bound(const int32_t* a, long long n,
                                      long long x, int lane) {
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

// 1. Pack: staged rows [r0, r0 + pack_rows) into their records.
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const __grid_constant__ Params p) {
  const int S = p.lay.stride;
  const int pitch = S + 1;  // odd: a warp's rows fall on distinct banks
  const long long r0 = static_cast<long long>(blockIdx.x) * p.pack_rows;
  const int t = threadIdx.x;
  const long long r = r0 + t;
  if (t < p.pack_rows && r < p.n_staged) {
    int32_t* w = s_dyn + t * pitch;
    for (int k = 0; k < S; ++k) w[k] = 0;
    uint8_t* flag = reinterpret_cast<uint8_t*>(w + p.lay.flags);
    if (p.top) {
      w[0] = p.ht_hi[r];
      w[1] = p.ht_lo[r];
      w[2] = p.exp_hi[r];
      w[3] = p.exp_lo[r];
      flag[0] = p.tomb[r];
      flag[1] = p.live[r];
    }
    for (int c = 0; c < p.n_cols; ++c) {
      flag[2 + 2 * c] = p.set[c][r];
      flag[3 + 2 * c] = p.isnull[c][r];
      const int wd = p.width[c];
      if (wd == 0) {
        w[p.lay.cmp[c]] = reinterpret_cast<const uint16_t*>(p.cmp[c])[r];
      }
      for (int q = 0; q < wd; ++q) w[p.lay.cmp[c] + q] = p.cmp[c][r * wd + q];
      if (p.lay.arith[c] >= 0) {
        w[p.lay.arith[c]] = static_cast<int32_t>(p.arith[c][r]);
      }
    }
  }
  __syncthreads();
  const long long rows = min(static_cast<long long>(p.pack_rows),
                             p.n_staged - r0);
  const int nq = S / 4;
  uint4* out = reinterpret_cast<uint4*>(p.records) + r0 * nq;
  for (int i = t; i < rows * nq; i += kThreads) {
    const int row = i / nq;
    const int32_t* w = s_dyn + row * pitch + 4 * (i - row * nq);
    out[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Four slots' words of record word k, from the tile's transposed rows.
__device__ __forceinline__ uint4 row4(const int32_t* rows, int pitch, int k,
                                      int t) {
  return *reinterpret_cast<const uint4*>(rows + k * pitch + t);
}

// Byte `shift / 8` of each of four words, packed into one word.
__device__ __forceinline__ uint32_t bytes4(uint4 w, int shift) {
  return ((w.x >> shift) & 0xffu) | (((w.y >> shift) & 0xffu) << 8) |
         (((w.z >> shift) & 0xffu) << 16) | (((w.w >> shift) & 0xffu) << 24);
}

// Slots [s, s + n) of a flag plane (s a multiple of 4): one 4-byte store
// for four slots.
__device__ __forceinline__ void put_bytes(uint8_t* plane, long long s, int n,
                                          uint32_t v) {
  if (n == 4) {
    *reinterpret_cast<uint32_t*>(plane + s) = v;
  } else {
    for (int k = 0; k < n; ++k) plane[s + k] = (v >> (8 * k)) & 0xffu;
  }
}

// Slots [s, s + n) of a u16 plane: one 8-byte store for four slots.
__device__ __forceinline__ void put_u16(void* plane, long long s, int n,
                                        uint4 v) {
  uint16_t* out = static_cast<uint16_t*>(plane);
  if (n == 4) {
    *reinterpret_cast<uint2*>(out + s) =
        make_uint2((v.x & 0xffffu) | (v.y << 16), (v.z & 0xffffu) | (v.w << 16));
  } else {
    for (int k = 0; k < n; ++k) {
      out[s + k] = static_cast<uint16_t>(k == 0 ? v.x : k == 1 ? v.y
                                         : k == 2 ? v.z : v.w);
    }
  }
}

// Slots [s, s + n) of a word plane: one 16-byte store for four slots.
__device__ __forceinline__ void put_words(void* plane, long long s, int n,
                                          uint4 v) {
  uint32_t* out = static_cast<uint32_t*>(plane);
  if (n == 4) {
    *reinterpret_cast<uint4*>(out + s) = v;
  } else {  // no array indexed at run time: it would take a stack frame
    for (int k = 0; k < n; ++k) {
      out[s + k] = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    }
  }
}

// 2. Tile: output slots [s0, s0 + tile).
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const __grid_constant__ Params p) {
  const int S = p.lay.stride;
  const int T = p.tile;
  const int pitch = T + 4;  // a multiple of 4: rows stay 16-byte aligned
  int32_t* rows = s_dyn;                // [S][pitch]: record word k of slot t
  int32_t* src = rows + S * pitch;      // [T]: the slot's staged row, or -1
  uint8_t* gsb = reinterpret_cast<uint8_t*>(src + T);  // [T]: group_start
  __shared__ long long s_first;
  const long long s0 = static_cast<long long>(blockIdx.x) * T;
  const int tid = threadIdx.x;
  if (tid < 32) {  // the first position whose slot is >= s0
    const long long f = warp_lower_bound(p.dst, p.m, s0, tid);
    if (tid == 0) s_first = f;
  }
  for (int t = tid; t < T; t += kThreads) {
    src[t] = -1;
    gsb[t] = 1;
  }
  __syncthreads();
  const long long first = s_first;
  for (int t = tid; t < T; t += kThreads) {
    const long long j = first + t;
    if (j < p.m) {
      const long long d = p.dst[j];
      if (d >= s0 && d < s0 + T && d < p.slots) {
        src[d - s0] = p.perm[j];
        gsb[d - s0] = p.gs[j];
      }
    }
  }
  __syncthreads();
  // Each slot's record, a 16-byte piece a thread, transposed into rows;
  // a padding slot's words are zero but a real block's expiry.
  const int nq = S / 4;
  const uint4* rec = reinterpret_cast<const uint4*>(p.records);
#pragma unroll 4
  for (int i = tid; i < T * nq; i += kThreads) {
    const int t = i / nq;
    const int q = i - t * nq;
    const int32_t r = src[t];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r >= 0) {
      v = __ldg(rec + static_cast<long long>(r) * nq + q);
    } else if (q == 0 && p.top && s0 + t < p.slots &&
               p.is_real[(s0 + t) / p.rows_per_block]) {
      v.z = static_cast<uint32_t>(p.exp_hi_default);
      v.w = static_cast<uint32_t>(p.exp_lo_default);
    }
    int32_t* col = rows + 4 * q * pitch + t;
    col[0] = static_cast<int32_t>(v.x);
    col[pitch] = static_cast<int32_t>(v.y);
    col[2 * pitch] = static_cast<int32_t>(v.z);
    col[3 * pitch] = static_cast<int32_t>(v.w);
  }
  __syncthreads();
  // Each thread writes four slots of one column's planes (column -1: the
  // planes every row has) at a time.
  const int top = p.top ? 1 : 0;
  const int groups = T / 4;
  const int items = (p.n_cols + top) * groups;
  for (int i = tid; i < items; i += kThreads) {
    const int c = (i >> p.log_groups) - top;
    const int t = 4 * (i & (groups - 1));
    const long long s = s0 + t;
    if (s >= p.slots) continue;
    const int n = static_cast<int>(min(4ll, p.slots - s));
    if (c < 0) {
      uint32_t valid = 0, start = 0;
      for (int k = 0; k < 4; ++k) {
        valid |= static_cast<uint32_t>(src[t + k] >= 0) << (8 * k);
        start |= static_cast<uint32_t>(gsb[t + k]) << (8 * k);
      }
      put_bytes(p.out_valid, s, n, valid);
      put_bytes(p.out_group_start, s, n, start);
      const uint4 f = row4(rows, pitch, p.lay.flags, t);
      put_bytes(p.out_tomb, s, n, bytes4(f, 0));
      put_bytes(p.out_live, s, n, bytes4(f, 8));
      put_words(p.out_ht_hi, s, n, row4(rows, pitch, 0, t));
      put_words(p.out_ht_lo, s, n, row4(rows, pitch, 1, t));
      put_words(p.out_exp_hi, s, n, row4(rows, pitch, 2, t));
      put_words(p.out_exp_lo, s, n, row4(rows, pitch, 3, t));
      continue;
    }
    const int b = 2 + 2 * c;  // the set flag's byte; isnull's follows
    const uint4 f = row4(rows, pitch, p.lay.flags + b / 4, t);
    put_bytes(p.out_set[c], s, n, bytes4(f, 8 * (b % 4)));
    put_bytes(p.out_isnull[c], s, n, bytes4(f, 8 * (b % 4) + 8));
    const uint4 a = row4(rows, pitch, p.lay.cmp[c], t);
    if (p.width[c] == 0) {  // codes: a slot no row lands on is absent
      const uint32_t ab = static_cast<uint32_t>(p.absent[c]);
      put_u16(p.out_cmp[c], s, n,
              make_uint4(src[t] >= 0 ? a.x : ab, src[t + 1] >= 0 ? a.y : ab,
                         src[t + 2] >= 0 ? a.z : ab,
                         src[t + 3] >= 0 ? a.w : ab));
    } else if (p.width[c] == 1) {
      put_words(p.out_cmp[c], s, n, a);
    } else {
      const uint4 b2 = row4(rows, pitch, p.lay.cmp[c] + 1, t);
      put_words(p.out_cmp[c], 2 * s, min(4, 2 * n),
                make_uint4(a.x, b2.x, a.y, b2.y));
      if (n > 2) {
        put_words(p.out_cmp[c], 2 * s + 4, 2 * n - 4,
                  make_uint4(a.z, b2.z, a.w, b2.w));
      }
    }
    if (p.lay.arith[c] >= 0) {
      put_words(p.out_arith[c], s, n, row4(rows, pitch, p.lay.arith[c], t));
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// in: staged ht_hi, ht_lo, exp_hi, exp_lo, tomb, live, then per column:
// set, isnull, cmp ([rows, width] int32, or [rows] u16 codes where width
// is 0), arith (float32, or null), each of n_staged rows. absent: each
// codes column's absent code. out: valid, group_start, tomb, live, ht_hi, ht_lo,
// exp_hi, exp_lo, then per column: set, isnull, cmp, arith (null where the
// input's is), each of n_blocks * rows_per_block slots, 16-byte aligned.
// top: write the first eight outputs (a launch of a later column chunk
// writes its columns only). perm, dst: [m] int32; gs: [m] bool; is_real:
// [n_blocks] bool. scratch: 16-byte aligned, at least n_staged records of
// the chunk's layout (ops/flush.py record_layout), scratch_bytes long.
int replay_flush_launch(const void* const* in, void* const* out,
                        const int32_t* width, const int32_t* absent,
                        int n_cols, int top,
                        const void* perm, const void* dst, const void* gs,
                        const void* is_real, long long m, long long n_staged,
                        long long n_blocks, int rows_per_block,
                        int exp_hi_default, int exp_lo_default, void* scratch,
                        long long scratch_bytes, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols) return kErrCols;
  if (m < 0 || m >= (1ll << 31) || n_staged < 0 || n_staged >= (1ll << 31) ||
      n_blocks < 0 || rows_per_block < 1 ||
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
      if (!aligned16(out[k])) return kErrAlign;
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
    if (width[c] < 0 || width[c] > 2) return kErrWidth;
    if (width[c] == 0 && (absent[c] < 0 || absent[c] > 0xffff)) {
      return kErrWidth;
    }
    if (ci[0] == nullptr || ci[1] == nullptr || ci[2] == nullptr ||
        co[0] == nullptr || co[1] == nullptr || co[2] == nullptr ||
        (ci[3] == nullptr) != (co[3] == nullptr)) {
      return kErrPlane;
    }
    for (int k = 0; k < 4; ++k) {
      if (co[k] != nullptr && !aligned16(co[k])) return kErrAlign;
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
    p.absent[c] = width[c] == 0 ? absent[c] : 0;
  }
  p.lay = record_layout(width, in, n_cols, top != 0);
  const int S = p.lay.stride;
  if (n_staged > 0 && (scratch == nullptr || !aligned16(scratch) ||
                       scratch_bytes < n_staged * S * 4)) {
    return kErrScratch;
  }
  p.records = static_cast<int32_t*>(scratch);
  p.perm = static_cast<const int32_t*>(perm);
  p.dst = static_cast<const int32_t*>(dst);
  p.gs = static_cast<const uint8_t*>(gs);
  p.is_real = static_cast<const uint8_t*>(is_real);
  p.m = m;
  p.n_staged = n_staged;
  p.slots = n_blocks * rows_per_block;
  p.rows_per_block = rows_per_block;
  p.n_cols = n_cols;
  p.exp_hi_default = exp_hi_default;
  p.exp_lo_default = exp_lo_default;
  p.top = top != 0;
  p.pack_rows = kThreads;
  while ((S + 1) * 4 * p.pack_rows > kPackBytes) p.pack_rows /= 2;
  p.tile = kTileMax;
  while (S * (p.tile + 4) * 4 > kTileBytes && p.tile > kTileMin) p.tile /= 2;
  p.log_groups = 0;
  while ((4 << p.log_groups) < p.tile) ++p.log_groups;
  if (p.slots == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_staged > 0) {
    const long long blocks = (n_staged + p.pack_rows - 1) / p.pack_rows;
    pack_kernel<<<static_cast<unsigned>(blocks), kThreads,
                  (S + 1) * 4 * p.pack_rows, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = (S * (p.tile + 4) + p.tile) * 4 + p.tile;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (p.slots + p.tile - 1) / p.tile;
  tile_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* replay_flush_error_string(int code) {
  switch (code) {
    case kErrCols: return "column count out of range";
    case kErrRows: return "row or slot count out of range";
    case kErrPlane: return "a required plane is missing";
    case kErrWidth:
      return "a column has neither 1 nor 2 order planes nor u16 codes";
    case kErrScratch: return "the record scratch is missing or too small";
    case kErrAlign: return "an output plane is not 16-byte aligned";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
