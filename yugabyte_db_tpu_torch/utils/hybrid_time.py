"""Hybrid time: the MVCC timestamp of the whole framework.

Reference analog: src/yb/common/hybrid_time.h:69 — a 64-bit value packing a
physical microsecond timestamp in the high 52 bits and a 12-bit logical
counter in the low bits, and src/yb/server/hybrid_clock.h:55 — the clock that
issues them (physical wall clock, logical increments within one microsecond,
``Update()`` on message receipt for causality).

The port's copy of the JAX package's ``utils/hybrid_time.py``: the
constants ``storage.row_version`` resolves relative TTLs with,
``HybridTime`` (with ``from_micros`` and ``max``, which the CQL layer
reads) and ``HybridClock`` (the tablet stamps its writes with the
clock; ``HybridClock(now_micros=...)`` takes a deterministic time source,
as the tests do). Left out: ``LogicalClock`` and the clock-skew bound,
which only the cluster layers read (ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

# 12 bits of logical counter below the microsecond physical component,
# matching the reference (hybrid_time.h kBitsForLogicalComponent = 12).
BITS_FOR_LOGICAL = 12
LOGICAL_MASK = (1 << BITS_FOR_LOGICAL) - 1

_MAX_HT = (1 << 63) - 1


@dataclass(frozen=True, order=True)
class HybridTime:
    """An immutable hybrid timestamp. Total order == integer order on .value."""

    value: int

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_micros(micros: int, logical: int = 0) -> "HybridTime":
        # '+' (not '|') so a logical overflow carries into the physical
        # component instead of silently wrapping backwards in time.
        return HybridTime((micros << BITS_FOR_LOGICAL) + logical)

    @staticmethod
    def max() -> "HybridTime":
        return _MAX

    # -- accessors ---------------------------------------------------------
    @property
    def physical_micros(self) -> int:
        return self.value >> BITS_FOR_LOGICAL

    @property
    def logical(self) -> int:
        return self.value & LOGICAL_MASK

    @property
    def is_valid(self) -> bool:
        return self.value >= 0

    def __repr__(self) -> str:
        if self.value == _MAX_HT:
            return "HT<max>"
        if self.value == 0:
            return "HT<min>"
        if self.value < 0:
            return "HT<invalid>"
        return f"HT{{p:{self.physical_micros} l:{self.logical}}}"


_MAX = HybridTime(_MAX_HT)


class HybridClock:
    """Issues monotonically increasing hybrid times from the wall clock.

    Reference analog: src/yb/server/hybrid_clock.h:55 (Now/Update). The clock
    never goes backwards: if the wall clock regresses or stalls within one
    microsecond, the logical component increments; ``update`` ratchets the
    clock forward on receipt of a remote hybrid time (causality across nodes).
    """

    def __init__(self, now_micros=None):
        self._lock = threading.Lock()
        self._last = 0  # last issued HT value
        self._now_micros = now_micros or (lambda: time.time_ns() // 1000)

    def now(self) -> HybridTime:
        physical = self._now_micros() << BITS_FOR_LOGICAL
        with self._lock:
            if physical > self._last:
                self._last = physical
            else:
                self._last += 1
            return HybridTime(self._last)

    def update(self, observed: HybridTime) -> None:
        """Ratchet the clock to be >= an observed remote hybrid time."""
        if not observed.is_valid:
            return
        with self._lock:
            if observed.value > self._last:
                self._last = observed.value

    def max_global_now(self) -> HybridTime:
        """Upper bound on any hybrid time issued anywhere (clock-skew bound).

        Read-only: observing the bound must not issue a timestamp.
        Single-process deployments have no skew; multi-node config adds it.
        """
        physical = self._now_micros() << BITS_FOR_LOGICAL
        with self._lock:
            return HybridTime(max(self._last, physical))
