"""int32 "plane" representation of unsigned 64/32-bit scalars for TPU kernels.

TPUs have no native int64 and JAX defaults to 32-bit. Every ordered quantity
the device kernels compare — hybrid times, key-prefix words — is therefore
carried as one or more **int32 planes** chosen so that *signed* int32
comparisons reproduce the unsigned/lexicographic order:

- a u64 ``v < 2**63`` (hybrid times) splits into ``hi = v >> 32`` (fits a
  non-negative int32 because v < 2^63) and ``lo = (v & 0xFFFFFFFF) ^ 0x80000000``
  reinterpreted as int32. Bias-flipping the low word maps unsigned order onto
  signed order: (a ^ 2^31 as i32) < (b ^ 2^31 as i32)  ⇔  a <u b.
- a u32 key word bias-flips the same way into a single plane.

Host-side helpers here are numpy; device kernels in yugabyte_db_tpu_torch.ops
operate on the resulting arrays directly.
"""

from __future__ import annotations

import numpy as np

_BIAS = np.uint32(0x80000000)


def u32_to_plane(words: np.ndarray) -> np.ndarray:
    """uint32 array -> int32 plane preserving unsigned order under signed compare."""
    return (words.astype(np.uint32) ^ _BIAS).view(np.int32)


def plane_to_u32(plane: np.ndarray) -> np.ndarray:
    return plane.view(np.uint32) ^ _BIAS


def u64_to_planes(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 array (< 2^63) -> (hi int32, lo int32 bias-flipped) planes.

    (hi_a, lo_a) <lex (hi_b, lo_b) under signed int32 comparison iff a < b.
    """
    v = values.astype(np.uint64)
    hi = (v >> np.uint64(32)).astype(np.int64)
    if (hi >= (1 << 31)).any():
        raise ValueError("u64 plane split requires values < 2**63")
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi.astype(np.int32), u32_to_plane(lo)


def planes_to_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | plane_to_u32(lo).astype(np.uint64)


def ht_to_planes(ht_values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Hybrid-time int64 array -> (hi, lo) int32 planes. HT is always < 2^63."""
    return u64_to_planes(ht_values.astype(np.int64).view(np.uint64))


import functools


@functools.lru_cache(maxsize=4096)
def scalar_ht_planes(ht_value: int) -> tuple[int, int]:
    """A single hybrid time -> (hi, lo) python ints suitable as jnp.int32.
    Cached: servers resolve the same read points (and MAX_HT) constantly."""
    hi, lo = ht_to_planes(np.array([ht_value], dtype=np.int64))
    return int(hi[0]), int(lo[0])


def i64_to_ordered_planes(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Signed int64 -> (hi, lo) int32 planes; signed-lex plane order == value order.

    Sign-flips to u64 (v ^ 2^63) then bias-flips both 32-bit words.
    """
    u = values.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return u32_to_plane(hi), u32_to_plane(lo)


def ordered_planes_to_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    u = (plane_to_u32(hi).astype(np.uint64) << np.uint64(32)) | \
        plane_to_u32(lo).astype(np.uint64)
    return (u ^ np.uint64(1 << 63)).view(np.int64)


def f64_to_ordered_planes(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 -> (hi, lo) int32 planes; plane order == IEEE total order
    (with -0.0 == 0.0 canonicalized). Same transform as the key encoding:
    negative: flip all bits, else set sign bit."""
    v = values.astype(np.float64).copy()
    v[v == 0.0] = 0.0  # canonicalize -0.0
    bits = v.view(np.uint64)
    neg = (bits >> np.uint64(63)).astype(bool)
    flipped = np.where(neg, ~bits, bits | np.uint64(1 << 63))
    hi = (flipped >> np.uint64(32)).astype(np.uint32)
    lo = (flipped & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return u32_to_plane(hi), u32_to_plane(lo)


def ordered_planes_to_f64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    flipped = (plane_to_u32(hi).astype(np.uint64) << np.uint64(32)) | \
        plane_to_u32(lo).astype(np.uint64)
    neg = ~(flipped >> np.uint64(63)).astype(bool)
    bits = np.where(neg, ~flipped, flipped & ~np.uint64(1 << 63))
    return bits.view(np.float64)


def varlen_prefix_planes(raws: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """First 8 bytes of each byte string -> (hi, lo) int32 planes whose
    signed-lex order equals byte order on the 8-byte prefix. Equal planes are
    a TIE (strings may differ past 8 bytes) — callers must host-verify."""
    planes = key_prefix_planes(list(raws), num_words=2)
    return planes[:, 0], planes[:, 1]


def key_prefix_planes(keys: list[bytes], num_words: int) -> np.ndarray:
    """Encoded keys -> [N, num_words] int32 planes; signed-lex order == byte order
    on the first 4*num_words bytes: each key's fixed-width big-endian
    uint32 words, zero-padded.

    Zero padding is order-correct for the DocKey encoding because encoded keys
    are prefix-free at every component boundary (terminators/type tags are
    nonzero), so no valid encoded key is a strict prefix of another within the
    compared width except when they share components — ties are resolved by
    the full key bytes on host (see storage.block boundary handling).
    """
    width = num_words * 4
    padded = b"".join(k[:width].ljust(width, b"\x00") for k in keys)
    out = np.frombuffer(padded, dtype=">u4").reshape(len(keys), num_words)
    return u32_to_plane(out)
