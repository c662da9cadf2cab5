"""Circuit breaker for the device (GPU) dispatch path.

A device-side failure (device memory exhausted, an injected dispatch
fault) must degrade the engine to host-path serving,
never take it down. This module is the containment state machine, the
port's copy of the JAX package's ``storage/breaker.py``:

    CLOSED ──(failure_threshold consecutive faults)──> OPEN
    OPEN ──(cooldown elapsed)──> HALF_OPEN (exactly one probe admitted)
    HALF_OPEN ──probe succeeds──> CLOSED
    HALF_OPEN ──probe fails────> OPEN (fresh cooldown)

Reference analog: the reference quarantines a misbehaving path by flag
(e.g. rocksdb's background-error mode setting the DB read-only) and
recovers by operator action; the breaker automates the quarantine and
the recovery probe.

``degraded()`` and ``health_report()`` give the breakers currently not
CLOSED; the JAX module's ``yb_engine_degraded`` gauge waits for the
port's metrics registry (ROADMAP.md §1 item 16).

What counts as a device fault is the caller's decision
(``is_device_fault``): the JAX engine's tuple is ``(FaultInjected,
RuntimeError)``, and in PyTorch a shape or dtype bug is a RuntimeError
too, as is a faulty kernel's illegal address, so the port narrows it to
an injected fault and exhausted device memory (see there). This
module imports no device framework at import time — it only decides
whether the protected path may run; the engine supplies the host
fallback.
"""

from __future__ import annotations

import threading
import time
import weakref

from yugabyte_db_tpu_torch.utils.fault_injection import FaultInjected

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_REGISTRY_LOCK = threading.Lock()
_BREAKERS: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a fault of the device rather than of the
    program: an injected dispatch fault or ``torch.cuda.OutOfMemoryError``
    (the card's memory exhausted), the two faults the engine can recover
    from by serving the batch from the host. Everything else propagates:
    a plain RuntimeError (a shape or dtype mismatch), a TypeError, a
    kernel's build or load error (``nvcc``, the ``ctypes`` load of
    ``ops/native.py``), and the CUDA runtime's own errors
    (``torch.AcceleratorError``, "CUDA error: ..."). The last are how an
    illegal address or a bad launch of one of the port's own kernels
    shows up at the next sync or copy, so a host re-serve of them would
    hide a faulty kernel; they also leave the context unusable, so no
    probe could close the breaker again."""
    if isinstance(exc, FaultInjected):
        return True
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError)


def register(breaker: "CircuitBreaker") -> None:
    with _REGISTRY_LOCK:
        _BREAKERS.add(breaker)


def degraded() -> list["CircuitBreaker"]:
    """Breakers currently quarantining their protected path (state is
    sampled without forcing OPEN->HALF_OPEN transitions)."""
    with _REGISTRY_LOCK:
        breakers = list(_BREAKERS)
    return [b for b in breakers if b.state != CLOSED]


def health_report() -> dict:
    """The /healthz fragment: overall status plus one entry per
    degraded breaker."""
    bad = degraded()
    if not bad:
        return {"status": "ok"}
    return {"status": "degraded",
            "degraded": [{"breaker": b.name, "state": b.state,
                          "failures": b.consecutive_failures,
                          "last_error": repr(b.last_error)}
                         for b in bad]}


class CircuitBreaker:
    """closed -> open -> half-open (single probe) state machine.

    ``allow()`` gates the protected path; ``record_success()`` /
    ``record_failure()`` report the outcome of an admitted call. All
    transitions happen under one lock; ``clock`` is injectable so tests
    don't sleep through cooldowns."""

    def __init__(self, name: str, failure_threshold: int = 3,
                 cooldown_s: float = 1.0, clock=time.monotonic):
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self.consecutive_failures = 0
        self.trips = 0          # CLOSED/HALF_OPEN -> OPEN transitions
        self.last_error: BaseException | None = None
        register(self)

    # -- gating ---------------------------------------------------------------
    def allow(self) -> bool:
        """May the protected path run now? CLOSED: yes. OPEN: no, until
        the cooldown elapses — then the breaker moves to HALF_OPEN and
        admits exactly one probe; further calls stay on the fallback
        until the probe reports."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = HALF_OPEN
                self._probe_inflight = True
                return True
            # HALF_OPEN: one probe at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    # -- outcome reporting ----------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._state = CLOSED
                self.last_error = None

    def record_failure(self, exc: BaseException | None = None) -> None:
        with self._lock:
            self.last_error = exc
            self.consecutive_failures += 1
            if self._state == HALF_OPEN:
                # Failed probe: quarantine again for a fresh cooldown.
                self._probe_inflight = False
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
            elif (self._state == CLOSED
                    and self.consecutive_failures >= self.failure_threshold):
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1

    def release_probe(self) -> None:
        """An admitted call ended without a verdict on the protected path
        (its caller's deadline ran out): free the half-open probe slot so
        the next call probes, and leave CLOSED's failure count alone."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    def trip(self, exc: BaseException | None = None) -> None:
        """Open immediately regardless of the threshold (a fault the
        caller knows is structural)."""
        with self._lock:
            self.last_error = exc
            self.consecutive_failures = max(self.consecutive_failures,
                                            self.failure_threshold)
            if self._state != OPEN:
                self._state = OPEN
                self.trips += 1
            self._probe_inflight = False
            self._opened_at = self._clock()

    def reset(self) -> None:
        """Back to pristine CLOSED (tests / operator action)."""
        with self._lock:
            self._state = CLOSED
            self.consecutive_failures = 0
            self._probe_inflight = False
            self.last_error = None

    # -- introspection --------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def is_degraded(self) -> bool:
        return self.state != CLOSED

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "state": self._state,
                    "consecutive_failures": self.consecutive_failures,
                    "trips": self.trips,
                    "last_error": repr(self.last_error)
                    if self.last_error else None}

    def __repr__(self) -> str:
        return f"CircuitBreaker({self.name!r}, state={self.state})"
