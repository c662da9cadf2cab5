// The whole-run decode of encoded planes for Hopper (sm_90a): K10.
//
// Replaces the JAX package's ops/encodings.py decode_run (an XLA program
// over wplane / decode_leaf), which turns a run's encoded plane tree back
// into plain planes for the kernels that read whole plain planes (the
// JAX package materialises it as K1's side-car in ops/pallas_agg.py
// gather_tensors). Here one launch decodes every encoded leaf of a run,
// each described by rows of a part table in device memory:
//   - bits:    bw int32 [B, R/32]               -> bool [B, R] (a byte a row)
//   - const:   cval 4-byte words [P]            -> [B, R, P]
//   - delta16: dbase int32 [B, P], doff u16 [B, R, P] -> int32 [B, R, P]
//   - rle:     rid int16 [B, R], rvals 4-byte [B, Rc, P] -> [B, R, P]
//   - dict:    codes u16 [B, R], dhi, dlo int32 [D]
//              -> the prefix planes int32 [B, R, 2] (one part) and the
//                 code plane int32 [B, R] (a second part; the JAX
//                 decode's plane 2, kept beside the two prefix planes so
//                 that no reader's strides change)
// Floats (const and rle of an arithmetic plane) are copied as their bit
// patterns, so the decode is byte for byte the plain planes.
//
// What bounds it: bytes. Each encoded leaf is read once and each plain
// plane written once (ops/decode.py decode_bytes); the output is the
// larger part (a bits word becomes 32 bytes, a u16 offset 4).
//
// Design (ops/decode.py plan_leaves builds the part table once a run and
// keeps it on the device; a launch copies nothing from the host):
//   - every output plane is cut into 16-byte units, and a thread writes
//     one unit with one 16-byte store: 16 rows of a bits plane (half a
//     word), four words of an int plane (four u16 offsets or run ids from
//     one 8-byte load), two rows of a dictionary's prefix planes, four
//     codes. A part's last unit may be short: its words are stored one by
//     one;
//   - one flat grid over work items of equal output bytes (kThreads units
//     each, a part's items numbered after the previous parts' in the
//     table's prefix), walked by a persistent grid of the resident
//     blocks: no block is empty, a bits leaf takes as many items as its
//     bytes and no more;
//   - index math is 32-bit inside a part; a unit's four words lie in one
//     block of R rows where R * P is a multiple of 4 (the base and the
//     block's run values then come from one division a unit), else each
//     word finds its own block;
//   - dictionaries up to ops/decode.py's DICT_SMEM_CAP bytes are copied
//     into shared memory once a block (int2 entries); a larger one is read
//     through the read-only cache.
//
// Interface: plain C, for ctypes. decode_launch returns 0, a negative code
// for an argument it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // units an item: one a thread
constexpr int kPartWords = 12;     // long long words of a part table row
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemLimit = 232448;

enum Kind : long long { kBits = 0, kConst = 1, kDelta16 = 2, kRle = 3,
                        kDictPair = 4, kDictCode = 5 };

// A part table row's words.
enum Word : int { kKind = 0, kUnits = 1, kP = 2, kR = 3, kRc = 4, kItem0 = 5,
                  kDsh = 6, kOut = 7, kA = 8, kB = 9, kC = 10, kWords = 11 };

enum Err : int {
  kErrParts = -1,
  kErrTable = -2,
  kErrShared = -3,
};

// Byte k of the result is bit k of the nibble (4 bool bytes).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
         ((nib & 8u) << 21);
}

__device__ __forceinline__ uint32_t at4(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Stores unit u's words: one 16-byte store, or word by word where the
// part ends inside the unit (n words of it left).
__device__ __forceinline__ void put(uint32_t* out, uint32_t u, uint4 v,
                                    uint32_t n) {
  if (n >= 4) {
    reinterpret_cast<uint4*>(out)[u] = v;
    return;
  }
  for (uint32_t j = 0; j < n; ++j) out[4 * u + j] = at4(v, static_cast<int>(j));
}

// Four u16 words from word w0 of a u16 array (one 8-byte load), or the n
// that are left.
__device__ __forceinline__ uint4 u16x4(const void* arr, uint32_t w0,
                                       uint32_t n) {
  const unsigned short* p = static_cast<const unsigned short*>(arr) + w0;
  if (n >= 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(v.x & 0xffffu, v.x >> 16, v.y & 0xffffu, v.y >> 16);
  }
  return make_uint4(n > 0 ? __ldg(p) : 0u, n > 1 ? __ldg(p + 1) : 0u,
                    n > 2 ? __ldg(p + 2) : 0u, 0u);
}

// The block of R rows of each of unit w0's four words (P words a row).
__device__ __forceinline__ void word_blocks(uint32_t w0, uint32_t P,
                                            uint32_t R, uint32_t (&blk)[4],
                                            uint32_t (&p)[4]) {
  const uint32_t rpw = R * P;
  if (rpw % 4 == 0) {
    const uint32_t b = w0 / rpw, p0 = (w0 - b * rpw) % P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      blk[j] = b;
      p[j] = P == 1 ? 0 : P == 2 ? (p0 + j) & 1 : (p0 + j) % P;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = w0 + j, row = w / P;
      blk[j] = row / R;
      p[j] = w - row * P;
    }
  }
}

// Unit u of one part (row `t` of the part table).
__device__ __forceinline__ void decode_unit(const long long* t, uint32_t u,
                                            unsigned char* out_base,
                                            const int2* dicts) {
  const long long kind = __ldg(t + kKind);
  unsigned char* out = out_base + __ldg(t + kOut);
  const void* a = reinterpret_cast<const void*>(__ldg(t + kA));
  const void* b = reinterpret_cast<const void*>(__ldg(t + kB));
  if (kind == kBits) {
    const uint32_t w =
        static_cast<uint32_t>(__ldg(static_cast<const int32_t*>(a) + (u >> 1))) >>
        ((u & 1) * 16);
    reinterpret_cast<uint4*>(out)[u] =
        make_uint4(spread4(w & 15u), spread4((w >> 4) & 15u),
                   spread4((w >> 8) & 15u), spread4((w >> 12) & 15u));
    return;
  }
  const uint32_t words = static_cast<uint32_t>(__ldg(t + kWords));
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  if (kind == kDictPair || kind == kDictCode) {
    const int dsh = static_cast<int>(__ldg(t + kDsh));
    const int32_t* dhi = static_cast<const int32_t*>(b);
    const int32_t* dlo =
        reinterpret_cast<const int32_t*>(__ldg(t + kC));
    if (kind == kDictCode) {
      const uint32_t w0 = 4 * u;
      put(o, u, u16x4(a, w0, words - w0), words - w0);
      return;
    }
    // Two rows' prefix pairs (rows 2u, 2u + 1; words = 2 a row).
    const uint32_t w0 = 4 * u, rows = (words - w0) / 2;
    const unsigned short* c = static_cast<const unsigned short*>(a) + 2 * u;
    const uint32_t c0 = __ldg(c), c1 = rows > 1 ? __ldg(c + 1) : 0u;
    int2 e0, e1;
    if (dsh >= 0) {
      e0 = dicts[dsh + c0];
      e1 = dicts[dsh + c1];
    } else {
      e0 = make_int2(__ldg(dhi + c0), __ldg(dlo + c0));
      e1 = make_int2(__ldg(dhi + c1), __ldg(dlo + c1));
    }
    put(o, u, make_uint4(e0.x, e0.y, e1.x, e1.y), words - w0);
    return;
  }
  const uint32_t P = static_cast<uint32_t>(__ldg(t + kP));
  const uint32_t w0 = 4 * u, n = words - w0;
  uint4 v;
  if (kind == kConst) {
    const uint32_t* cval = static_cast<const uint32_t*>(a);
    if (P == 1) {
      const uint32_t x = __ldg(cval);
      v = make_uint4(x, x, x, x);
    } else {
      v = make_uint4(__ldg(cval + w0 % P), __ldg(cval + (w0 + 1) % P),
                     __ldg(cval + (w0 + 2) % P), __ldg(cval + (w0 + 3) % P));
    }
  } else {
    const uint32_t R = static_cast<uint32_t>(__ldg(t + kR));
    uint32_t blk[4], p[4];
    word_blocks(w0, P, R, blk, p);
    if (kind == kDelta16) {
      const uint4 off = u16x4(b, w0, n);
      const uint32_t* base = static_cast<const uint32_t*>(a);
      v = make_uint4(__ldg(base + blk[0] * P + p[0]) + off.x,
                     __ldg(base + blk[1] * P + p[1]) + off.y,
                     __ldg(base + blk[2] * P + p[2]) + off.z,
                     __ldg(base + blk[3] * P + p[3]) + off.w);
    } else {  // kRle: each word's row's run id, then its block's value
      const uint32_t Rc = static_cast<uint32_t>(__ldg(t + kRc));
      const uint32_t* vals = static_cast<const uint32_t*>(b);
      uint4 id;
      if (P == 1) {
        id = u16x4(a, w0, n);
      } else {
        const unsigned short* r = static_cast<const unsigned short*>(a);
        uint32_t k[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          k[j] = j < static_cast<int>(n) ? __ldg(r + (w0 + j) / P) : 0u;
        }
        id = make_uint4(k[0], k[1], k[2], k[3]);
      }
      v = make_uint4(__ldg(vals + (blk[0] * Rc + id.x) * P + p[0]),
                     __ldg(vals + (blk[1] * Rc + id.y) * P + p[1]),
                     __ldg(vals + (blk[2] * Rc + id.z) * P + p[2]),
                     __ldg(vals + (blk[3] * Rc + id.w) * P + p[3]));
    }
  }
  put(o, u, v, n);
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const long long* __restrict__ table, int n_parts,
                  int n_items, unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Each part's first item (n_parts + 1 entries), then the dictionaries.
  int* first = reinterpret_cast<int*>(smem);
  int2* dicts = reinterpret_cast<int2*>(smem + ((4 * (n_parts + 1) + 15) & ~15));
  for (int i = threadIdx.x; i <= n_parts; i += kThreads) {
    first[i] = i < n_parts ? static_cast<int>(__ldg(table + i * kPartWords + kItem0))
                           : n_items;
  }
  for (int q = 0; q < n_parts; ++q) {
    const long long* t = table + q * kPartWords;
    const int dsh = static_cast<int>(__ldg(t + kDsh));
    if (__ldg(t + kKind) != kDictPair || dsh < 0) continue;
    const int d = static_cast<int>(__ldg(t + kRc));
    const int32_t* dhi = reinterpret_cast<const int32_t*>(__ldg(t + kB));
    const int32_t* dlo = reinterpret_cast<const int32_t*>(__ldg(t + kC));
    for (int i = threadIdx.x; i < d; i += kThreads) {
      dicts[dsh + i] = make_int2(__ldg(dhi + i), __ldg(dlo + i));
    }
  }
  __syncthreads();
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // The item's part: the last whose first item is at or before it.
    int lo = 0, hi = n_parts - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= item) lo = mid;
      else hi = mid - 1;
    }
    const long long* t = table + lo * kPartWords;
    const uint32_t u =
        static_cast<uint32_t>(item - first[lo]) * kThreads + threadIdx.x;
    if (u < static_cast<uint32_t>(__ldg(t + kUnits))) {
      decode_unit(t, u, out, dicts);
    }
  }
}

}  // namespace

extern "C" {

// table: n_parts rows of kPartWords long long words in device memory
// (ops/decode.py part_rows: kind, 16-byte units, P, R, Rc or dictionary
// entries, first item, dictionary's first entry in shared memory or -1,
// output offset in bytes (16-byte aligned), the leaf's arrays a, b, c,
// output words); n_items: the items of every part; out: the output
// allocation. grid and smem_bytes: ops/decode.py launch_geometry (the
// parts' first items, 16-byte aligned, then the shared dictionaries).
int decode_launch(const void* table, int n_parts, int n_items, void* out,
                  int grid, int smem_bytes, void* stream) {
  if (n_parts < 0 || n_items < 0 || grid < 0) return kErrParts;
  if (n_parts == 0 || n_items == 0) return 0;
  if (table == nullptr || out == nullptr || grid < 1) return kErrTable;
  if (smem_bytes < ((4 * (n_parts + 1) + 15) & ~15) || smem_bytes > kSmemLimit) {
    return kErrShared;
  }
  if (smem_bytes > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  decode_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_parts, n_items,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel one SM holds at once with smem_bytes of dynamic
// shared memory, or a negative CUDA error code.
int decode_occupancy(int smem_bytes) {
  if (smem_bytes > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return -static_cast<int>(rc);
  }
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, decode_kernel, kThreads, smem_bytes);
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

int decode_part_words() { return kPartWords; }

const char* decode_error_string(int code) {
  switch (code) {
    case kErrParts: return "part or item count out of range";
    case kErrTable: return "the part table or the output is missing";
    case kErrShared: return "shared bytes out of range for the part table";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
