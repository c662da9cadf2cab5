"""The runtime resource witness: pin attribution + lock-hold durations.

- **Pin attribution**: every residency pin reported through
  :meth:`ResourceWitness.pin_acquired` is attributed to its acquire site
  and thread; every :meth:`~ResourceWitness.pin_released` retires one.
  Whatever is still outstanding at dump time — excluding external
  entries, which are permanently pinned by design — is a leak, and the
  dump names the exact frame that took it.

- **Hold durations**: locks wrapped by the witness (the ``@guarded_by``
  guard locks, see utils/locking.py) record every acquire→release
  interval into ``yb_lock_hold_seconds{cls}``, and the blocking seams
  (``transport.send``, the WAL fsync) call :func:`note_blocking` so any
  lock the calling thread still holds at that point is flagged as a
  (class, blocking-kind) hold observation.

Enable with :func:`enable_resource_witness` BEFORE constructing the
system under test (locks are only wrapped on instances built while a
witness is enabled); :func:`dump_resource_witness` writes the leaks and
holds as JSON.

Everything here is best-effort and exception-free: the witness observes
the system, it must never perturb it.

The port's copy of the JAX package's ``utils/resources.py``, whole. Its
callers in the port are the consensus transport and the WAL
(``note_blocking``); the residency cache's pin hooks are wired in a later
slice, and the JAX package's static checker (``analysis``) is not ported
(ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import json
import logging
import threading
import time

_LOG = logging.getLogger("yugabyte_db_tpu_torch.swallowed")

_SITE_CAP = 8  # acquire sites kept per hold key (enough to debug)

# Frames belonging to the instrumentation itself, skipped when
# attributing an event to its caller.
_OWN_FILES = ("resources.py", "locking.py", "residency.py")


def _caller_site() -> str:
    """file:line of the nearest frame outside the instrumentation."""
    import sys

    try:
        f = sys._getframe(2)
        while f is not None and \
                f.f_code.co_filename.endswith(_OWN_FILES):
            f = f.f_back
        if f is None:
            return "?"
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except Exception:  # noqa: BLE001 — witness must never throw
        return "?"


class ResourceWitness:
    """Process-wide accumulator of pin lifetimes and lock-hold facts."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        # pin key -> list of {"key","site","thread","external"}, one
        # per outstanding pin (a pin count attributed per-acquire).
        self._pins: dict[object, list] = {}
        # (cls, blocking kind) -> [count, first site]
        self._holds: dict[tuple, list] = {}
        # Per-thread stack of (lock identity, cls, acquire monotonic).
        self._tls = threading.local()
        self.pin_acquires = 0
        self.pin_releases = 0

    # -- pin lifecycle (hooked from storage/residency.py) --------------------

    def pin_acquired(self, key, label: str = "",
                     external: bool = False) -> None:
        try:
            rec = {"key": f"{label or 'pin'}#{key}",
                   "site": _caller_site(),
                   "thread": threading.current_thread().name,
                   "external": external}
            with self._lock:
                self._pins.setdefault(key, []).append(rec)
                self.pin_acquires += 1
            from yugabyte_db_tpu_torch.utils.metrics import (
                resource_witness_entity)
            resource_witness_entity().counter(
                "yb_resource_pin_acquires").increment()
        except Exception:  # noqa: BLE001 — witness must never throw
            _LOG.debug("pin_acquired failed for %r", key)

    def pin_released(self, key) -> None:
        try:
            with self._lock:
                recs = self._pins.get(key)
                if recs:
                    recs.pop()
                    if not recs:
                        del self._pins[key]
                self.pin_releases += 1
            from yugabyte_db_tpu_torch.utils.metrics import (
                resource_witness_entity)
            resource_witness_entity().counter(
                "yb_resource_pin_releases").increment()
        except Exception:  # noqa: BLE001 — witness must never throw
            _LOG.debug("pin_released failed for %r", key)

    def pins_cleared(self, key) -> None:
        """Entry teardown (invalidate / owner collected): every pin on
        the key is retired at once — balanced, not a leak."""
        try:
            with self._lock:
                recs = self._pins.pop(key, None)
                if recs:
                    self.pin_releases += len(recs)
        except Exception:  # noqa: BLE001 — witness must never throw
            _LOG.debug("pins_cleared failed for %r", key)

    def outstanding(self) -> list[dict]:
        """Every non-external pin still held, oldest first — after a
        quiesce (overlays dropped, unpinned evicted) these are leaks."""
        with self._lock:
            return [dict(r) for recs in self._pins.values()
                    for r in recs if not r["external"]]

    # -- lock holds (hooked from utils/locking.py _WitnessLock) ---------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def lock_acquired(self, lock) -> None:
        try:
            self._held().append(
                (id(lock), getattr(lock, "_cls", "") or "?",
                 time.monotonic()))
        except Exception:  # noqa: BLE001 — witness must never throw
            _LOG.debug("lock_acquired recording failed")

    def lock_released(self, lock) -> None:
        try:
            held = self._held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] == id(lock):
                    _, cls, t0 = held.pop(i)
                    from yugabyte_db_tpu_torch.utils.metrics import \
                        observe_lock_hold_s
                    observe_lock_hold_s(cls, time.monotonic() - t0)
                    return
        except Exception:  # noqa: BLE001 — witness must never throw
            _LOG.debug("lock_released recording failed")

    def note_blocking(self, kind: str) -> None:
        """A blocking seam (``rpc``, ``fsync``, ...) is about to run on
        the calling thread: flag every witness-wrapped lock it still
        holds as a (class, kind) hold-across-blocking observation."""
        if not self.enabled:
            return
        try:
            held = getattr(self._tls, "held", None)
            if not held:
                return
            site = _caller_site()
            with self._lock:
                for _, cls, _t0 in held:
                    row = self._holds.get((cls, kind))
                    if row is None:
                        row = self._holds[(cls, kind)] = [0, site]
                    row[0] += 1
            from yugabyte_db_tpu_torch.utils.metrics import (
                resource_witness_entity)
            resource_witness_entity().counter(
                "yb_resource_holds_across_blocking").increment()
        except Exception:  # noqa: BLE001 — witness must never throw
            _LOG.debug("note_blocking recording failed for %s", kind)

    # -- reporting ------------------------------------------------------------

    def holds(self) -> list[dict]:
        with self._lock:
            return [{"cls": k[0], "blocking": k[1], "count": row[0],
                     "site": row[1]}
                    for k, row in sorted(self._holds.items())]

    def clear(self) -> None:
        with self._lock:
            self._pins.clear()
            self._holds.clear()
            self.pin_acquires = 0
            self.pin_releases = 0

    def dump(self, path: str) -> str:
        payload = {"version": 1, "kind": "yb-resource-witness",
                   "leaks": self.outstanding(),
                   "holds": self.holds(),
                   "counters": {"pin_acquires": self.pin_acquires,
                                "pin_releases": self.pin_releases}}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        return path


_WITNESS = ResourceWitness()


def witness() -> ResourceWitness:
    return _WITNESS


def enable_resource_witness() -> None:
    from yugabyte_db_tpu_torch.utils import locking

    _WITNESS.enabled = True
    # Locks wrap (and report acquire/release) only while some witness
    # is live — flip the locking-side fast-path flag on.
    locking.set_hold_tracking(True)


def disable_resource_witness() -> None:
    from yugabyte_db_tpu_torch.utils import locking

    _WITNESS.enabled = False
    locking.set_hold_tracking(False)


def resource_witness_enabled() -> bool:
    return _WITNESS.enabled


def note_blocking(kind: str) -> None:
    """Module-level seam marker (cheap no-op while disabled)."""
    w = _WITNESS
    if w.enabled:
        w.note_blocking(kind)


def dump_resource_witness(path: str) -> str:
    return _WITNESS.dump(path)


def load_resource_witness_dump(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("kind") != "yb-resource-witness":
        raise ValueError(f"{path}: not a resource-witness dump")
    return data
