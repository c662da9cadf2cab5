"""In-memory write buffer: the memtable.

Reference analog: src/yb/rocksdb/memtable (skiplist memtable). The
pure-Python ``MemTable`` of the JAX package: a dict keyed by encoded key
with per-key version lists, plus a lazily-sorted key index for ordered
scans and the flush drain, and an apply-order log that the delta overlay
reads (``versions_since``).
"""

from __future__ import annotations

import bisect

from yugabyte_db_tpu_torch.storage.merge import MergedRow, merge_versions
from yugabyte_db_tpu_torch.storage.row_version import RowVersion


class MemTable:
    def __init__(self):
        self._data: dict[bytes, list[RowVersion]] = {}
        self._sorted_keys: list[bytes] | None = []
        # Apply-order log backing versions_since(); entries are the same
        # RowVersion objects _data holds, so the overhead is one pointer
        # per version.
        self._log: list[RowVersion] | None = []
        self.num_versions = 0
        self.approx_bytes = 0
        self.min_ht = None
        self.max_ht = None

    def __len__(self) -> int:
        return self.num_versions

    @property
    def is_empty(self) -> bool:
        return self.num_versions == 0

    def apply(self, rows: list[RowVersion]) -> None:
        for r in rows:
            versions = self._data.get(r.key)
            if versions is None:
                self._data[r.key] = [r]
                self._sorted_keys = None  # new key invalidates the index
            else:
                versions.append(r)
            if self._log is not None:
                self._log.append(r)
            self.num_versions += 1
            self.approx_bytes += len(r.key) + 64 + 16 * len(r.columns)
            if self.min_ht is None or r.ht < self.min_ht:
                self.min_ht = r.ht
            if self.max_ht is None or r.ht > self.max_ht:
                self.max_ht = r.ht

    def _index(self) -> list[bytes]:
        if self._sorted_keys is None:
            self._sorted_keys = sorted(self._data.keys())
        return self._sorted_keys

    def scan_keys(self, lower: bytes, upper: bytes):
        """Yield keys in [lower, upper) in order (upper=b'' means unbounded)."""
        keys = self._index()
        i = bisect.bisect_left(keys, lower)
        while i < len(keys):
            k = keys[i]
            if upper and k >= upper:
                return
            yield k
            i += 1

    def has_keys(self, lower: bytes, upper: bytes) -> bool:
        """Any key in [lower, upper)? (the scan-planning emptiness probe)."""
        return next(self.scan_keys(lower, upper), None) is not None

    def versions(self, key: bytes) -> list[RowVersion]:
        return self._data.get(key, [])

    def versions_since(self, n: int) -> list[RowVersion] | None:
        """Row versions applied after global version index ``n`` (i.e.
        once ``num_versions`` was ``n``), in apply order: the delta
        source for the incremental scan overlay. None when the log is
        unavailable, which tells the caller to rebuild from scratch."""
        if self._log is None:
            return None
        return self._log[n:]

    def merged(self, key: bytes, read_ht: int) -> MergedRow | None:
        versions = self._data.get(key)
        if not versions:
            return None
        return merge_versions(key, versions, read_ht)

    def drain_sorted(self) -> list[tuple[bytes, list[RowVersion]]]:
        """All (key, versions ht-desc) in key order — the flush input."""
        data = self._data

        def order(r):
            return (r.ht, r.write_id)

        return [(k, vs if len(vs := data[k]) == 1
                 else sorted(vs, key=order, reverse=True))
                for k in self._index()]
