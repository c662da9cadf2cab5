"""MvccManager: tracks in-flight operations and the safe read time.

Reference analog: src/yb/tablet/mvcc.h:46 — operations register their hybrid
time before applying; the safe time is the largest HT such that no operation
with a smaller-or-equal HT can still arrive. Reads pick read_ht <= safe time
so results are stable (no write can later commit "in the past" of a read).

The port's copy of the JAX package's ``tablet/mvcc.py``, whole.
"""

from __future__ import annotations

import threading

from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock, HybridTime


class MvccManager:
    def __init__(self, clock: HybridClock):
        self.clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[int] = []      # in-flight operation HTs (sorted-ish)
        self._last_replicated = 0

    def add_pending(self, ht: HybridTime) -> None:
        with self._lock:
            self._pending.append(ht.value)

    def replicated(self, ht: HybridTime) -> None:
        with self._cond:
            try:
                self._pending.remove(ht.value)
            except ValueError:
                raise ValueError(f"replicated unknown ht {ht}")
            if ht.value > self._last_replicated:
                self._last_replicated = ht.value
            self._cond.notify_all()

    def aborted(self, ht: HybridTime) -> None:
        with self._cond:
            self._pending.remove(ht.value)
            self._cond.notify_all()

    def safe_time(self) -> HybridTime:
        """Largest HT at which a read sees a stable snapshot.

        With pending ops: just below the smallest pending HT. Without: the
        clock's current bound, observed WITHOUT issuing a timestamp (any
        future write still gets a strictly larger HT from the same clock).
        """
        with self._lock:
            if self._pending:
                return HybridTime(min(self._pending) - 1)
        return self.clock.max_global_now()

    def wait_for_safe_time(self, ht: HybridTime, timeout: float = 10.0) -> bool:
        """Block until safe_time() >= ht (for follower/snapshot reads)."""
        deadline_ok = True
        with self._cond:
            def safe_enough():
                if self._pending and min(self._pending) <= ht.value:
                    return False
                return True
            deadline_ok = self._cond.wait_for(safe_enough, timeout=timeout)
        return deadline_ok

    @property
    def last_replicated_ht(self) -> HybridTime:
        with self._lock:
            return HybridTime(self._last_replicated)
