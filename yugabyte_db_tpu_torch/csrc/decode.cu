// The whole-run decode of encoded planes for Hopper (sm_90a): K10.
//
// Replaces the JAX package's ops/encodings.py decode_run (an XLA program
// over wplane / decode_leaf), which turns a run's encoded plane tree back
// into plain planes for the kernels that read whole plain planes (the
// JAX package materialises it as K1's side-car in ops/pallas_agg.py
// gather_tensors). Here one launch decodes every encoded leaf of a run,
// each described by a row of a leaf table in device memory:
//   - bits:    bw int32 [B, R/32]               -> bool [B, R] (a byte a row)
//   - const:   cval 4-byte words [P]            -> [B, R, P]
//   - delta16: dbase int32 [B, P], doff u16 [B, R, P] -> int32 [B, R, P]
//   - rle:     rid int16 [B, R], rvals 4-byte [B, Rc, P] -> [B, R, P]
//   - dict:    codes u16 [B, R], dhi, dlo int32 [D]
//              -> the prefix planes int32 [B, R, 2] and the code plane
//                 int32 [B, R] (the JAX decode's plane 2, kept beside the
//                 two prefix planes so that no reader's strides change)
// Floats (const and rle of an arithmetic plane) are copied as their bit
// patterns, so the decode is byte for byte the plain planes.
//
// What bounds it: bytes. Each encoded leaf is read once and each plain
// plane written once (ops/decode.py decode_bytes); the output is the
// larger part (a bits word becomes 32 bytes, a u16 offset 4).
//
// Design: grid.y runs the leaves, grid.x a grid-stride loop over a leaf's
// units; a thread writes contiguous output: a bits word's 32 bool bytes as
// two 16-byte stores, one row's P words of an int plane, a dictionary
// row's two prefix words and its code. Small leaves (a dictionary's
// table, an rle block's values) are read through the read-only cache.
//
// Interface: plain C, for ctypes. decode_launch returns 0, a negative code
// for an argument it refuses, or the launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeafWords = 10;  // long long words of a leaf table row
constexpr long long kMaxBlocksX = 4096;

enum Kind : long long { kBits = 0, kConst = 1, kDelta16 = 2, kRle = 3,
                        kDict = 4 };

enum Err : int {
  kErrLeaves = -1,
  kErrTable = -2,
};

// A row of the leaf table: kind, units (bits: words, else rows), P (words a
// row of the output), R (rows a block), Rc (rle: run slots a block), then
// the pointers a, b, c (the leaf's arrays in the order above), out and out2
// (a dictionary's code plane).
struct Leaf {
  long long kind, units, P, R, Rc;
  const void* a;
  const void* b;
  const void* c;
  void* out;
  void* out2;
};

// Byte k of the result is bit k of the nibble (4 bool bytes).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
         ((nib & 8u) << 21);
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Leaf* __restrict__ leaves) {
  const Leaf L = leaves[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (L.kind == kBits) {
    const int32_t* bw = static_cast<const int32_t*>(L.a);
    uint4* out = static_cast<uint4*>(L.out);
    for (long long u = first; u < L.units; u += stride) {
      const uint32_t w = static_cast<uint32_t>(__ldg(bw + u));
      out[2 * u] = make_uint4(spread4(w & 15u), spread4((w >> 4) & 15u),
                              spread4((w >> 8) & 15u),
                              spread4((w >> 12) & 15u));
      out[2 * u + 1] = make_uint4(spread4((w >> 16) & 15u),
                                  spread4((w >> 20) & 15u),
                                  spread4((w >> 24) & 15u), spread4(w >> 28));
    }
    return;
  }
  const int P = static_cast<int>(L.P);
  uint32_t* out = static_cast<uint32_t*>(L.out);
  if (L.kind == kConst) {
    const uint32_t* cval = static_cast<const uint32_t*>(L.a);
    for (long long u = first; u < L.units; u += stride) {
      for (int p = 0; p < P; ++p) out[u * P + p] = __ldg(cval + p);
    }
  } else if (L.kind == kDelta16) {
    const int32_t* base = static_cast<const int32_t*>(L.a);
    const uint16_t* off = static_cast<const uint16_t*>(L.b);
    for (long long u = first; u < L.units; u += stride) {
      const long long blk = u / L.R;
      for (int p = 0; p < P; ++p) {
        out[u * P + p] =
            static_cast<uint32_t>(__ldg(base + blk * P + p)) +
            static_cast<uint32_t>(__ldg(off + u * P + p));
      }
    }
  } else if (L.kind == kRle) {
    const int16_t* rid = static_cast<const int16_t*>(L.a);
    const uint32_t* vals = static_cast<const uint32_t*>(L.b);
    for (long long u = first; u < L.units; u += stride) {
      const long long blk = u / L.R;
      const long long at = (blk * L.Rc + __ldg(rid + u)) * P;
      for (int p = 0; p < P; ++p) out[u * P + p] = __ldg(vals + at + p);
    }
  } else if (L.kind == kDict) {
    const uint16_t* codes = static_cast<const uint16_t*>(L.a);
    const int32_t* dhi = static_cast<const int32_t*>(L.b);
    const int32_t* dlo = static_cast<const int32_t*>(L.c);
    int32_t* code_out = static_cast<int32_t*>(L.out2);
    uint2* pair = static_cast<uint2*>(L.out);
    for (long long u = first; u < L.units; u += stride) {
      const int code = __ldg(codes + u);
      pair[u] = make_uint2(static_cast<uint32_t>(__ldg(dhi + code)),
                           static_cast<uint32_t>(__ldg(dlo + code)));
      code_out[u] = code;
    }
  }
}

}  // namespace

extern "C" {

// table: n_leaves rows of kLeafWords long long words in device memory (the
// Leaf layout above); max_units: the most units of any leaf (it sizes
// grid.x). Every output plane is 16-byte aligned (bits leaves write 16
// bytes at a time; the others need 4- or 8-byte alignment).
int decode_launch(const void* table, int n_leaves, long long max_units,
                  void* stream) {
  if (n_leaves < 0 || n_leaves > 65535) return kErrLeaves;
  if (n_leaves == 0 || max_units <= 0) return 0;
  if (table == nullptr) return kErrTable;
  long long blocks = (max_units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_leaves));
  decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table));
  return static_cast<int>(cudaGetLastError());
}

int decode_leaf_words() { return kLeafWords; }

const char* decode_error_string(int code) {
  switch (code) {
    case kErrLeaves: return "leaf count out of range";
    case kErrTable: return "the leaf table is missing";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
