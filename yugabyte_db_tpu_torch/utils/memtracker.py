"""Hierarchical memory trackers.

Reference analog: src/yb/util/mem_tracker.h — a tree of named trackers;
consumption propagates to ancestors; /memz dumps the tree; the global
memstore budget (docdb_rocksdb_util.cc:437 memory_monitor) triggers
flushes when the memtable subtree exceeds its limit.
"""

from __future__ import annotations

import threading


class MemTracker:
    def __init__(self, name: str, parent: "MemTracker | None" = None,
                 limit: int | None = None):
        self.name = name
        self.parent = parent
        self.limit = limit
        self._lock = threading.Lock()
        self._consumption = 0
        self._peak = 0
        self._children: dict[str, MemTracker] = {}
        if parent is not None:
            with parent._lock:
                parent._children[name] = self

    def child(self, name: str, limit: int | None = None) -> "MemTracker":
        # lookup-and-create under ONE lock hold: two concurrent callers
        # must get the same node, or accounting splits across duplicates
        with self._lock:
            existing = self._children.get(name)
            if existing is not None:
                return existing
            c = MemTracker(name, None, limit)
            c.parent = self
            self._children[name] = c
            return c

    def consume(self, bytes_: int) -> None:
        node = self
        while node is not None:
            with node._lock:
                node._consumption += bytes_
                if node._consumption > node._peak:
                    node._peak = node._consumption
            node = node.parent

    def release(self, bytes_: int) -> None:
        self.consume(-bytes_)

    @property
    def consumption(self) -> int:
        with self._lock:
            return self._consumption

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    def over_limit(self) -> bool:
        return self.limit is not None and self.consumption > self.limit

    def set_limit(self, limit: int | None) -> None:
        """Update the limit shown next to consumption in /memz dumps —
        for runtime-settable budgets (e.g. the HBM residency budget
        mirrored onto the root->device subtree)."""
        with self._lock:
            self.limit = limit

    def detach(self) -> None:
        """Remove this tracker from its parent (releasing any residual
        consumption up the tree)."""
        residual = self.consumption
        if residual:
            self.release(residual)
        if self.parent is not None:
            with self.parent._lock:
                self.parent._children.pop(self.name, None)

    def dump(self) -> dict:
        with self._lock:
            children = list(self._children.values())
            out = {"consumption": self._consumption, "peak": self._peak}
            if self.limit is not None:
                out["limit"] = self.limit
        if children:
            out["children"] = {c.name: c.dump() for c in children}
        return out


_root = MemTracker("root")


def root_tracker() -> MemTracker:
    return _root
