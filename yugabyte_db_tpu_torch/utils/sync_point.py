"""SyncPoint: deterministic cross-thread interleaving control for tests.

Reference analog: src/yb/util/sync_point.h:61 (itself from rocksdb) —
named points in production code that tests order relative to each other
(LoadDependency: point A must be REACHED before point B may proceed) or
hook with callbacks. Disabled by default: a process() call without an
enabled singleton is one predicate check.

    SYNC_POINT.load_dependency([("flush:done", "scan:start")])
    SYNC_POINT.enable()
    ... threads call sync_point("flush:done") / sync_point("scan:start")
    SYNC_POINT.disable_and_clear()
"""

from __future__ import annotations

import threading
import time


class SyncPoint:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._enabled = False
        self._cleared: set[str] = set()
        # point -> set of predecessor points that must clear first
        self._predecessors: dict[str, set[str]] = {}
        self._callbacks: dict[str, object] = {}

    def load_dependency(self, deps: list[tuple[str, str]]) -> None:
        """deps: (before, after) pairs — ``after`` blocks until
        ``before`` has been processed (sync_point.h:58 LoadDependency)."""
        with self._lock:
            for before, after in deps:
                self._predecessors.setdefault(after, set()).add(before)

    def set_callback(self, point: str, fn) -> None:
        with self._lock:
            self._callbacks[point] = fn

    def enable(self) -> None:
        with self._lock:
            self._enabled = True

    def disable_and_clear(self) -> None:
        with self._cv:
            self._enabled = False
            self._cleared.clear()
            self._predecessors.clear()
            self._callbacks.clear()
            self._cv.notify_all()

    def process(self, point: str, arg=None,
                timeout_s: float = 10.0) -> None:
        if not self._enabled:  # racy-read fast path: off = no cost
            return
        with self._cv:
            if not self._enabled:
                return
            cb = self._callbacks.get(point)
            need = self._predecessors.get(point)
            if need:
                deadline = time.monotonic() + timeout_s
                while not need <= self._cleared:
                    if not self._enabled:
                        return
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"sync point {point!r} waited for "
                            f"{sorted(need - self._cleared)}")
                    self._cv.wait(timeout=remaining)
            self._cleared.add(point)
            self._cv.notify_all()
        if cb is not None:
            cb(arg)


SYNC_POINT = SyncPoint()


def sync_point(point: str, arg=None) -> None:
    """The production-side hook (TEST_SYNC_POINT macro analog)."""
    SYNC_POINT.process(point, arg)
