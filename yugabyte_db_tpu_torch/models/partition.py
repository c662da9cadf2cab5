"""Hash partitioning of tables into tablets.

Reference analog: src/yb/common/partition.h — multi-column hash of the hash
key columns onto a uint16 space (kMaxPartitionKey = 65535, partition.h:156;
EncodeMultiColumnHashValue partition.h:204; HashColumnCompoundValue
partition.h:274), split evenly into N tablets at table-creation time
(CatalogManager::CreateTabletsFromTable, src/yb/master/catalog_manager.cc:2274).
The initial split is even; master-driven tablet splitting
(master/split_manager.py) can later divide a hot tablet at the median
resident key hash, so ranges need not stay uniform over time.

The hash function differs from the reference's Jenkins hash by design (we are
not wire-compatible with YB's on-disk layout); it only needs to be stable and
well-spread. We hash the *encoded* hash-column bytes with CRC32 folded to 16
bits.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from yugabyte_db_tpu_torch.models.encoding import encode_key_component
from yugabyte_db_tpu_torch.models.schema import Schema

MAX_PARTITION_KEY = 0xFFFF  # 65535, uint16 hash space


def hash_column_compound_value(encoded_components: bytes) -> int:
    """Stable uint16 hash of the concatenated encoded hash-column values."""
    crc = zlib.crc32(encoded_components) & 0xFFFFFFFF
    return ((crc >> 16) ^ (crc & 0xFFFF)) & 0xFFFF


def compute_hash_code(schema: Schema, key_values: dict) -> int | None:
    """Partition hash code for a row (None for range-partitioned tables)."""
    if schema.num_hash == 0:
        return None
    buf = bytearray()
    for c in schema.hash_columns:
        buf += encode_key_component(key_values[c.name], c.dtype)
    return hash_column_compound_value(bytes(buf))


@dataclass(frozen=True)
class Partition:
    """One tablet's slice of the hash space: [start, end) over uint16+1.

    end == MAX_PARTITION_KEY + 1 means "to the top". Range-partitioned
    tables use a single full-range partition in v1.
    """

    start: int
    end: int

    def contains(self, hash_code: int) -> bool:
        return self.start <= hash_code < self.end

    @property
    def key_start(self) -> bytes:
        return struct.pack(">H", self.start)

    def __repr__(self) -> str:
        return f"Partition[{self.start:#06x},{self.end:#06x})"


class PartitionSchema:
    """Splits the uint16 hash space evenly into num_tablets partitions.

    Reference analog: PartitionSchema::CreatePartitions (partition.cc) — the
    same even split of [0, 65536).
    """

    def __init__(self, num_tablets: int, hash_partitioned: bool = True):
        if num_tablets < 1:
            raise ValueError("need at least one tablet")
        self.hash_partitioned = hash_partitioned
        if not hash_partitioned:
            num_tablets = 1
        self.num_tablets = num_tablets
        if not hash_partitioned:
            self._partitions = [Partition(0, MAX_PARTITION_KEY + 1)]
        else:
            space = MAX_PARTITION_KEY + 1
            bounds = [round(i * space / num_tablets) for i in range(num_tablets + 1)]
            self._partitions = [Partition(bounds[i], bounds[i + 1])
                                for i in range(num_tablets)]

    def create_partitions(self) -> list[Partition]:
        return list(self._partitions)

    def partition_index_for_hash(self, hash_code: int) -> int:
        space = MAX_PARTITION_KEY + 1
        # Even split: invert the rounding used by the constructor.
        idx = min(self.num_tablets - 1, hash_code * self.num_tablets // space)
        # Guard against rounding edges.
        parts = self._partitions
        while idx > 0 and hash_code < parts[idx].start:
            idx -= 1
        while idx < self.num_tablets - 1 and hash_code >= parts[idx].end:
            idx += 1
        return idx

    def to_dict(self) -> dict:
        return {"num_tablets": self.num_tablets,
                "hash_partitioned": self.hash_partitioned}

    @staticmethod
    def from_dict(d: dict) -> "PartitionSchema":
        return PartitionSchema(d["num_tablets"], d.get("hash_partitioned", True))
