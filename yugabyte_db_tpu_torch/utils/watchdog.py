"""Standing stall detector: flags operations that exceed their
latency budget while they are still running.

Reference analog: the kernel-stack watchdog
(src/yb/util/kernel_stack_watchdog.h) — threads register each
latency-sensitive section (WAL fsync, Raft apply, engine flush); a
sampler thread flags sections still running past their threshold, so a
wedged apply/fsync surfaces as a logged stall event and a metric
instead of silent throughput loss. Sections that finish late between
samples are flagged post-hoc, so nothing escapes by racing the sampler.

Stress rigs treat the collected stall records as a standing check; the
sampler is process-wide and always on once the first section registers.

The port's copy of the JAX package's ``utils/watchdog.py``, whole. The
WAL's sync (``wal.sync``) and Raft's apply-hole wait (``raft.apply_hole``)
register sections.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from contextlib import contextmanager

LOG = logging.getLogger("yb.watchdog")

_SAMPLE_INTERVAL_S = 0.25
_MAX_RECORDS = 256


class StallWatchdog:
    def __init__(self, interval_s: float = _SAMPLE_INTERVAL_S):
        self._interval = interval_s
        self._lock = threading.Lock()
        self._active: dict[int, tuple] = {}  # token -> record
        self._flagged: set[int] = set()
        self._records: list[dict] = []
        self._ids = itertools.count()
        self._thread: threading.Thread | None = None
        self.stall_count = 0  # lifetime total (server /metrics exports)

    # -- registration -------------------------------------------------------
    @contextmanager
    def watch(self, label: str, threshold_s: float = 1.0):
        """Wrap one latency-sensitive section. The sampler flags it if
        it is still running past threshold_s; a completion past the
        threshold that the sampler missed is flagged on exit."""
        self._ensure_thread()
        token = next(self._ids)
        start = time.monotonic()
        rec = (label, start, threshold_s, threading.current_thread().name)
        with self._lock:
            self._active[token] = rec
        try:
            yield
        finally:
            dur = time.monotonic() - start
            with self._lock:
                self._active.pop(token, None)
                flagged = token in self._flagged
                self._flagged.discard(token)
                if dur > threshold_s:
                    # Record the FINAL duration even when the sampler
                    # already flagged the in-flight section — the
                    # completed record is what duration-based standing
                    # checks assert on. One stall = one stall_count,
                    # even when both sampler and exit record it.
                    self._record_locked(label, dur, rec[3], done=True,
                                        count=not flagged)

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="stall-watchdog", daemon=True)
            self._thread.start()

    # -- sampling -----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            time.sleep(self._interval)
            try:
                now = time.monotonic()
                with self._lock:
                    for token, (label, start, thr, tname) in \
                            list(self._active.items()):
                        if token in self._flagged or now - start <= thr:
                            continue
                        self._flagged.add(token)
                        self._record_locked(label, now - start, tname,
                                            done=False)
            except Exception:  # the watchdog itself must never die
                LOG.exception("stall-watchdog sampler failed")

    def _record_locked(self, label: str, dur: float, tname: str,
                       done: bool, count: bool = True) -> None:
        if count:
            self.stall_count += 1
        if len(self._records) >= _MAX_RECORDS:
            del self._records[: _MAX_RECORDS // 2]
        self._records.append({"label": label, "seconds": round(dur, 3),
                              "thread": tname, "completed": done,
                              "at": time.time()})
        LOG.warning("stall: %s running %.2fs on %s%s", label, dur, tname,
                    "" if done else " (still running)")

    # -- inspection (the stress rigs' standing check) -----------------------
    def stalls(self, label_prefix: str = "") -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records
                    if r["label"].startswith(label_prefix)]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


_WATCHDOG: StallWatchdog | None = None
_WD_LOCK = threading.Lock()


def watchdog() -> StallWatchdog:
    global _WATCHDOG
    if _WATCHDOG is None:
        with _WD_LOCK:
            if _WATCHDOG is None:
                _WATCHDOG = StallWatchdog()
    return _WATCHDOG
