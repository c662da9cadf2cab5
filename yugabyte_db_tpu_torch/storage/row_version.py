"""RowVersion: one MVCC version of one row — the storage write record.

Reference analog: in DocDB a logical row version is *shredded* into one
RocksDB KV per column (SubDocKey = DocKey + column_id + DocHybridTime,
src/yb/docdb/doc_key.h) plus a liveness system column written by INSERT.
The columnar TPU layout wants whole-row versions instead: one record per
(DocKey, commit hybrid time) carrying the set of columns that write touched.
The semantics are identical:

- INSERT  -> liveness=True, all provided columns set
- UPDATE  -> liveness=False, only the SET columns present
- DELETE  -> tombstone=True (row tombstone)
- SET col=NULL -> column present with value None (column tombstone)
- TTL     -> expire_ht precomputed at write time; an expired value reads as
  a tombstone at its own hybrid time (shadowing older versions), matching
  DocDBCompactionFilter/GetSubDocument expiry semantics
  (src/yb/docdb/docdb_compaction_filter.cc).
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_HT = (1 << 63) - 1


@dataclass
class RowVersion:
    key: bytes                 # encoded DocKey
    ht: int                    # commit hybrid time (HybridTime.value)
    tombstone: bool = False    # row delete marker
    liveness: bool = False     # INSERT liveness marker
    columns: dict = field(default_factory=dict)  # col_id -> value (None = null)
    expire_ht: int = MAX_HT    # TTL expiry as a hybrid time; MAX_HT = no TTL
    # RELATIVE TTL in microseconds: resolved into expire_ht against the
    # write's own stamped hybrid time by the leader (tablet clocks can
    # legitimately run ahead of wall time, so clients must not compute
    # absolute expiry from their wall clock — the reference stores TTLs
    # relative to the value's write time for the same reason).
    ttl_us: int | None = None
    # Sub-hybrid-time ordering of writes within ONE batch (reference:
    # DocHybridTime's write_id component, src/yb/common/doc_hybrid_time.h):
    # every row in a batch shares the batch's hybrid time; write_id is the
    # row's position, so two writes to the SAME key in one batch order by
    # (ht, write_id). A row tombstone at ht T still shadows ALL versions
    # with ht <= T (the same-batch DELETE rule the device kernel applies).
    write_id: int = 0
    # Pending counter deltas (col_id -> signed int). NEVER stored: the
    # tablet LEADER resolves them into absolute column values under its
    # write lock before stamping/appending, so concurrent increments
    # serialize (reference: counter column read-modify-write inside the
    # tablet, cql_operation.cc). Only the client->leader RPC carries them.
    increments: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.tombstone and (self.liveness or self.columns
                               or self.increments):
            raise ValueError("tombstone carries no columns or liveness")

    @classmethod
    def stored(cls, key: bytes, ht: int, tombstone: bool, liveness: bool,
               columns: dict, expire_ht: int, write_id: int) -> "RowVersion":
        """A version as a run file stores it (no relative TTL, no pending
        increments), built without ``__init__``: a run load makes a
        million of them, and the dataclass's ``__init__`` costs more than
        the parse. It sets every field and keeps ``__post_init__``'s rule."""
        if tombstone and (liveness or columns):
            raise ValueError("tombstone carries no columns or liveness")
        rv = object.__new__(cls)
        rv.__dict__ = {"key": key, "ht": ht, "tombstone": tombstone,
                       "liveness": liveness, "columns": columns,
                       "expire_ht": expire_ht, "ttl_us": None,
                       "write_id": write_id, "increments": {}}
        return rv

    def resolve_ttl(self, ht: int) -> int:
        """Absolute expire_ht for a write stamped at ``ht``."""
        if self.ttl_us is not None:
            from yugabyte_db_tpu_torch.utils.hybrid_time import BITS_FOR_LOGICAL

            return ht + (self.ttl_us << BITS_FOR_LOGICAL)
        return self.expire_ht

    @property
    def has_ttl(self) -> bool:
        return self.expire_ht != MAX_HT
