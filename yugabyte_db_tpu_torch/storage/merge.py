"""MVCC merge-on-read semantics, shared by every engine.

This module is the single source of truth for how a set of RowVersions of
one key collapses to the visible row at a read hybrid time. The CPU engine
executes it directly per key; the TPU kernels implement the same function
vectorized over plane arrays (ops/scan.py), and the randomized engine-diff
tests hold the two to identical results.

Reference analog: docdb::GetSubDocument's version/tombstone/TTL resolution
(src/yb/docdb/docdb.cc:849) and the IntentAwareIterator read-point filtering
(src/yb/docdb/intent_aware_iterator.h:81).

Rules (versions sorted ht desc; "visible" = ht <= read_ht):
1. tomb_ht = max ht of visible row tombstones (0 if none). Versions with
   ht <= tomb_ht are shadowed.
2. Per column: the value is the newest visible unshadowed version that sets
   the column; if that value is TTL-expired at read_ht it reads as NULL but
   still shadows older versions (expiry == tombstone at the value's ht).
3. Row liveness: the newest visible unshadowed non-expired liveness marker.
4. The row exists iff it has liveness or any non-null column value.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.storage.row_version import RowVersion


@dataclass
class MergedRow:
    """Per-source merge result for one key; combinable across sources."""

    key: bytes
    tomb_ht: int = 0                      # max visible row-tombstone ht
    live_ht: int = 0                      # max visible liveness ht (0 = none)
    values: dict = field(default_factory=dict)   # col_id -> value (None = null)
    value_hts: dict = field(default_factory=dict)  # col_id -> ht of that value

    @property
    def exists(self) -> bool:
        if self.live_ht > self.tomb_ht:
            return True
        return any(
            v is not None and self.value_hts[c] > self.tomb_ht
            for c, v in self.values.items()
        )

    def get(self, col_id: int):
        if col_id in self.values and self.value_hts[col_id] > self.tomb_ht:
            return self.values[col_id]
        return None


def merge_versions(key: bytes, versions: list[RowVersion], read_ht: int) -> MergedRow:
    """Collapse one key's versions (any order) to its MergedRow at read_ht."""
    out = MergedRow(key)
    for v in versions:
        if v.ht > read_ht:
            continue
        if v.tombstone and v.ht > out.tomb_ht:
            out.tomb_ht = v.ht
    for v in sorted(versions, key=lambda r: (-r.ht, -r.write_id)):
        if v.ht > read_ht or v.ht <= out.tomb_ht or v.tombstone:
            continue
        expired = v.has_ttl and read_ht >= v.expire_ht
        if v.liveness and not expired and v.ht > out.live_ht:
            out.live_ht = v.ht
        for cid, val in v.columns.items():
            if cid not in out.values:
                out.values[cid] = None if expired else val
                out.value_hts[cid] = v.ht
    return out


def combine_merged(a: MergedRow, b: MergedRow) -> MergedRow:
    """Combine two per-source MergedRows of the SAME key (e.g. memtable
    overlay + device-scanned runs, or overlapping sorted runs).

    Associative and commutative: the newest tombstone wins globally, then
    per column the newest value wins, then shadowing is re-applied via
    tomb_ht at read time (MergedRow.get / .exists).
    """
    if a.key != b.key:
        raise ValueError("combine_merged requires identical keys")
    out = MergedRow(a.key)
    out.tomb_ht = max(a.tomb_ht, b.tomb_ht)
    out.live_ht = max(a.live_ht, b.live_ht)
    for src in (a, b):
        for cid, val in src.values.items():
            ht = src.value_hts[cid]
            if cid not in out.values or ht > out.value_hts[cid]:
                out.values[cid] = val
                out.value_hts[cid] = ht
    return out


def merge_entry_streams(streams):
    """K-way merge of (key, versions ht-desc) streams into grouped
    (key, versions ht-desc) pairs in key order — the shared inner loop of
    compaction and remote-bootstrap dumps (reference: the MergingIterator
    under CompactionJob::Run, src/yb/rocksdb/db/compaction_job.cc:622)."""
    import heapq

    current, bucket = None, []
    for key, versions in heapq.merge(*streams, key=lambda p: p[0]):
        if key != current:
            if current is not None:
                yield current, sorted(bucket, key=lambda r: (-r.ht, -r.write_id))
            current, bucket = key, []
        bucket.extend(versions)
    if current is not None:
        yield current, sorted(bucket, key=lambda r: (-r.ht, -r.write_id))
