// The mesh scans' two kernels for Hopper (sm_90a): K14's cross-piece
// combine and the stack's slot update.
//
// mesh_combine replaces the collectives of the JAX package's
// parallel/sharded.py _compiled_dist_agg (K14: _combine_across_mesh :399
// and _lex_collective_ext :389, a psum and a two-step lexicographic pmax
// over the ("t", "b") mesh). The port folds each piece (one tablet's
// b-shard) with K5 into one packed accumulator row (ops/agg_fold.py
// pack's layout: [S, I] int32 and [S, F] float32), and this kernel
// reduces the S rows to one, as described by a table of items (one a
// packed field or digit vector, ops/mesh.py combine_items):
//   - kSum: an int32 word summed in int64 (count, n, rows scanned);
//   - kDigits: a base-2^16 digit vector of kDigits words, each summed in
//     int64, then carry-normalised (digits 0..6 keep their low 16 bits,
//     the last digit takes what is left), because S rows of digits up to
//     2^17 overflow int32 past 2^14 rows;
//   - kMax / kMin: an int32 extreme;
//   - kLexMax / kLexMin: an i64 or f64 extreme on two ordered int32 planes,
//     the extreme of the high plane, then of the low plane masked to the
//     high plane's ties (INT_MIN / INT_MAX fill), as _lex_collective_ext;
//   - kFSum: a float32 word summed in row order, one rounding an add;
//   - kFMax / kFMin: a float32 extreme (a NaN wins, as torch.amax).
// The output is one row: int64 [I] (the same layout, wider words) and
// float32 [F]. One thread serves an item and walks the S rows in order,
// so the result does not depend on the launch and equals the plain
// version (ops/mesh.py combine_plain) bit for bit.
//
// stack_update replaces parallel/sharded.py _compiled_stack_update :479
// (a dynamic_update_slice of tablet t's slot in every leaf of the stacked
// planes, the source cast as s.astype(d.dtype)). One launch writes every
// entry of a table (ops/mesh.py update_entries): a destination range of a
// leaf, and a source range or a fill value (the slot's padding blocks),
// with their element types (bool, int32, float32, int16). A block of
// threads walks a range of one entry (grid.y an entry): equal types copy
// bytes (16 bytes a thread where both ranges are 16-byte aligned), others
// convert element by element as a C++ cast does.
//
// What bounds them: bytes, both. The combine reads S packed rows (a few
// hundred bytes a piece) and writes one; it is a launch's latency at the
// mesh's sizes. The update reads each source range once and writes each
// destination range once (ops/mesh.py update_bytes).
//
// Interface: plain C, for ctypes. Each launch function returns 0, a
// negative code for an argument it refuses, or the launch's
// cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCombineThreads = 128;
constexpr int kUpdateThreads = 256;
constexpr int kDigits = 8;        // ops/agg_fold.py DIGITS
constexpr int kItemWords = 2;     // op, offset
constexpr int kEntryWords = 6;    // dst, src, count, dst type, src type, fill
constexpr int kMaxGridY = 65535;

enum Op : int {
  kSum = 0, kDigitsOp = 1, kMax = 2, kMin = 3, kLexMax = 4, kLexMin = 5,
  kFSum = 6, kFMax = 7, kFMin = 8,
};

enum Type : long long { kBool = 0, kInt32 = 1, kFloat32 = 2, kInt16 = 3 };

enum Err : int {
  kErrShape = -1,
  kErrPointer = -2,
  kErrGrid = -3,
};

// The last launch's shape: kernel (0 combine, 1 update), blocks x, blocks
// y, threads.
int g_last_launch[4] = {-1, 0, 0, 0};

__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int* __restrict__ items, int n_items,
               const int32_t* __restrict__ iv, int I,
               const float* __restrict__ fv, int F, int S,
               long long* __restrict__ out_i, float* __restrict__ out_f) {
  const int q = blockIdx.x * kCombineThreads + threadIdx.x;
  if (q >= n_items) return;
  const int op = items[q * kItemWords];
  const int off = items[q * kItemWords + 1];
  switch (op) {
    case kSum: {
      long long acc = 0;
      for (int s = 0; s < S; ++s) acc += iv[static_cast<long long>(s) * I + off];
      out_i[off] = acc;
      break;
    }
    case kDigitsOp: {
      long long d[kDigits];
#pragma unroll
      for (int k = 0; k < kDigits; ++k) d[k] = 0;
      for (int s = 0; s < S; ++s) {
        const int32_t* row = iv + static_cast<long long>(s) * I + off;
#pragma unroll
        for (int k = 0; k < kDigits; ++k) d[k] += row[k];
      }
      long long carry = 0;
#pragma unroll
      for (int k = 0; k < kDigits - 1; ++k) {
        const long long v = d[k] + carry;
        out_i[off + k] = v & 0xFFFF;
        carry = v >> 16;
      }
      out_i[off + kDigits - 1] = d[kDigits - 1] + carry;
      break;
    }
    case kMax:
    case kMin: {
      int32_t best = iv[off];
      for (int s = 1; s < S; ++s) {
        const int32_t v = iv[static_cast<long long>(s) * I + off];
        best = op == kMax ? max(best, v) : min(best, v);
      }
      out_i[off] = best;
      break;
    }
    case kLexMax:
    case kLexMin: {
      const bool is_max = op == kLexMax;
      int32_t hi = iv[off];
      for (int s = 1; s < S; ++s) {
        const int32_t v = iv[static_cast<long long>(s) * I + off];
        hi = is_max ? max(hi, v) : min(hi, v);
      }
      int32_t lo = is_max ? INT_MIN : INT_MAX;
      for (int s = 0; s < S; ++s) {
        const int32_t* row = iv + static_cast<long long>(s) * I + off;
        if (row[0] != hi) continue;
        lo = is_max ? max(lo, row[1]) : min(lo, row[1]);
      }
      out_i[off] = hi;
      out_i[off + 1] = lo;
      break;
    }
    case kFSum: {
      float acc = 0.0f;
      for (int s = 0; s < S; ++s) {
        acc = __fadd_rn(acc, fv[static_cast<long long>(s) * F + off]);
      }
      out_f[off] = acc;
      break;
    }
    case kFMax:
    case kFMin: {
      float best = fv[off];
      for (int s = 1; s < S; ++s) {
        const float v = fv[static_cast<long long>(s) * F + off];
        if (best != best) break;  // a NaN wins
        if (v != v || (op == kFMax ? v > best : v < best)) best = v;
      }
      out_f[off] = best;
      break;
    }
    default:
      break;
  }
}

__device__ __forceinline__ int type_bytes(long long t) {
  return t == kBool ? 1 : t == kInt16 ? 2 : 4;
}

// Element e of a source range as (integer, float, is float).
__device__ __forceinline__ void load_elem(const unsigned char* src,
                                          long long type, long long e,
                                          long long& iv, float& fv,
                                          bool& is_float) {
  is_float = false;
  switch (type) {
    case kBool: iv = src[e] != 0; break;
    case kInt32: iv = reinterpret_cast<const int32_t*>(src)[e]; break;
    case kInt16: iv = reinterpret_cast<const int16_t*>(src)[e]; break;
    default:
      fv = reinterpret_cast<const float*>(src)[e];
      is_float = true;
      break;
  }
}

__device__ __forceinline__ void store_elem(unsigned char* dst, long long type,
                                           long long e, long long iv, float fv,
                                           bool is_float) {
  switch (type) {
    case kBool: dst[e] = is_float ? (fv != 0.0f) : (iv != 0); break;
    case kInt32:
      reinterpret_cast<int32_t*>(dst)[e] =
          is_float ? static_cast<int32_t>(fv) : static_cast<int32_t>(iv);
      break;
    case kInt16:
      reinterpret_cast<int16_t*>(dst)[e] =
          is_float ? static_cast<int16_t>(fv) : static_cast<int16_t>(iv);
      break;
    default:
      reinterpret_cast<float*>(dst)[e] =
          is_float ? fv : static_cast<float>(iv);
      break;
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
update_kernel(const long long* __restrict__ entries) {
  const long long* e = entries + static_cast<long long>(blockIdx.y) * kEntryWords;
  unsigned char* dst = reinterpret_cast<unsigned char*>(e[0]);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(e[1]);
  const long long count = e[2];
  const long long dtype = e[3], stype = e[4], fill = e[5];
  const long long tid = static_cast<long long>(blockIdx.x) * kUpdateThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kUpdateThreads;
  if (src != nullptr && stype == dtype) {
    // Equal types: bytes, 16 at a time where both ranges are aligned.
    const long long nbytes = count * type_bytes(dtype);
    long long done = 0;
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
      const long long n16 = nbytes / 16;
      const uint4* s16 = reinterpret_cast<const uint4*>(src);
      uint4* d16 = reinterpret_cast<uint4*>(dst);
      for (long long i = tid; i < n16; i += stride) d16[i] = s16[i];
      done = n16 * 16;
    }
    for (long long i = done + tid; i < nbytes; i += stride) dst[i] = src[i];
    return;
  }
  for (long long i = tid; i < count; i += stride) {
    long long iv = fill;
    float fv = 0.0f;
    bool is_float = false;
    if (src != nullptr) load_elem(src, stype, i, iv, fv, is_float);
    store_elem(dst, dtype, i, iv, fv, is_float);
  }
}

}  // namespace

extern "C" {

// items: n_items rows of (op, offset) int32 in device memory (ops/mesh.py
// combine_items); iv [S, I] int32 and fv [S, F] float32 the pieces'
// packed rows (fv may be null when F is 0); out_i int64 [I], out_f
// float32 [F].
int mesh_combine_launch(const void* items, int n_items, const void* iv, int I,
                        const void* fv, int F, int S, void* out_i, void* out_f,
                        void* stream) {
  if (n_items < 1 || I < 1 || F < 0 || S < 1) return kErrShape;
  if (items == nullptr || iv == nullptr || out_i == nullptr ||
      (F > 0 && (fv == nullptr || out_f == nullptr))) {
    return kErrPointer;
  }
  const int blocks = (n_items + kCombineThreads - 1) / kCombineThreads;
  combine_kernel<<<blocks, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(items), n_items, static_cast<const int32_t*>(iv), I,
      static_cast<const float*>(fv), F, S, static_cast<long long*>(out_i),
      static_cast<float*>(out_f));
  g_last_launch[0] = 0;
  g_last_launch[1] = blocks;
  g_last_launch[2] = 1;
  g_last_launch[3] = kCombineThreads;
  return static_cast<int>(cudaGetLastError());
}

// entries: n_entries rows of kEntryWords long long words in device memory
// (ops/mesh.py update_entries: destination address, source address or 0
// for a fill, elements, destination type, source type, fill value);
// grid_x: blocks an entry (ops/mesh.py launch_geometry).
int stack_update_launch(const void* entries, int n_entries, int grid_x,
                        void* stream) {
  if (n_entries < 1 || n_entries > kMaxGridY) return kErrShape;
  if (grid_x < 1) return kErrGrid;
  if (entries == nullptr) return kErrPointer;
  const dim3 grid(grid_x, n_entries);
  update_kernel<<<grid, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(entries));
  g_last_launch[0] = 1;
  g_last_launch[1] = grid_x;
  g_last_launch[2] = n_entries;
  g_last_launch[3] = kUpdateThreads;
  return static_cast<int>(cudaGetLastError());
}

int mesh_item_words() { return kItemWords; }

int mesh_entry_words() { return kEntryWords; }

void mesh_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = g_last_launch[i];
}

const char* mesh_error_string(int code) {
  switch (code) {
    case kErrShape: return "item, entry, row or column count out of range";
    case kErrPointer: return "a table, input or output is missing";
    case kErrGrid: return "grid out of range";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
