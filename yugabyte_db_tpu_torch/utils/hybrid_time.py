"""Hybrid time constants: a 64-bit value packing a physical microsecond
timestamp in the high 52 bits and a 12-bit logical counter in the low
bits (reference: src/yb/common/hybrid_time.h:69). Only what
``storage.row_version`` needs to resolve relative TTLs lives here."""

BITS_FOR_LOGICAL = 12
