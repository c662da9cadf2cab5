"""Per-request tracing + the /rpcz sample store.

Reference analog: src/yb/util/trace.{h,cc} — a Trace is a ring of
timestamped messages attached to the current request (TRACE("...") from
anywhere below the dispatch), dumped for slow RPCs — plus the rpcz
sampling of src/yb/server/rpcz-path-handler.cc and
src/yb/rpc/rpcz_store.cc: recent and slowest samples per method,
browsable over HTTP while the server runs.

Usage::

    with trace_request("ts.write") as t:
        ...
        TRACE("submitted to raft")      # from any frame below
        ...
    store.record(t)                      # duration + messages sampled

TRACE() is a no-op (one contextvar read) when no trace is active, so
library code can trace unconditionally.

The port's copy of the JAX package's ``utils/trace.py``, whole. The
port's ``TabletPeer`` traces its writes and scans, the tablet server its
RPCs; its webserver serves ``/rpcz`` and ``/tracing.json``.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque

_current: contextvars.ContextVar["Trace | None"] = \
    contextvars.ContextVar("active_trace", default=None)

MAX_MESSAGES = 64


class Trace:
    __slots__ = ("method", "start_wall", "start", "entries", "duration_us",
                 "dropped", "_done")

    def __init__(self, method: str):
        self.method = method
        self.start_wall = time.time()
        self.start = time.monotonic()
        self.entries: list[tuple[float, str]] = []
        self.duration_us: int = 0
        self.dropped = 0
        self._done = False

    def trace(self, msg: str) -> None:
        if len(self.entries) >= MAX_MESSAGES:
            self.dropped += 1
            return
        self.entries.append((time.monotonic() - self.start, msg))

    def finish(self) -> None:
        """Idempotent: the first call fixes the duration (the sample may
        already be recorded when a later finish runs)."""
        if not self._done:
            self._done = True
            self.duration_us = int((time.monotonic() - self.start) * 1e6)

    def dump(self) -> dict:
        out = {
            "method": self.method,
            "start": self.start_wall,
            "duration_us": self.duration_us,
            "messages": [f"{dt * 1e6:8.0f}us {m}"
                         for dt, m in self.entries],
        }
        if self.dropped:
            out["dropped_messages"] = self.dropped
        return out


def TRACE(msg: str, *args) -> None:  # noqa: N802 — reference macro name
    """Append to the active request trace, if any (trace.h TRACE())."""
    t = _current.get()
    if t is not None:
        t.trace(msg % args if args else msg)


class trace_request:
    """Context manager: install a Trace as the active one for this
    (thread/context) for the duration of a request."""

    __slots__ = ("trace", "_token")

    def __init__(self, method: str):
        self.trace = Trace(method)
        self._token = None

    def __enter__(self) -> Trace:
        self._token = _current.set(self.trace)
        return self.trace

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)
        self.trace.finish()
        return None


class RpczStore:
    """Recent + slowest samples per method (rpc/rpcz_store.cc)."""

    def __init__(self, recent_per_method: int = 8, slow_keep: int = 32,
                 slow_threshold_us: int = 500_000):
        self.recent_per_method = recent_per_method
        self.slow_threshold_us = slow_threshold_us
        self._recent: dict[str, deque] = {}
        self._slow: deque = deque(maxlen=slow_keep)
        self._lock = threading.Lock()

    def record(self, trace: Trace) -> None:
        with self._lock:
            dq = self._recent.get(trace.method)
            if dq is None:
                dq = self._recent[trace.method] = deque(
                    maxlen=self.recent_per_method)
            dq.append(trace)
            if trace.duration_us >= self.slow_threshold_us:
                self._slow.append(trace)
        # every sampled request is also one /tracing.json slice
        TRACE_EVENTS.record(trace.method, trace.start_wall,
                            trace.duration_us)

    def dump(self) -> dict:
        with self._lock:
            return {
                "methods": {
                    m: [t.dump() for t in dq]
                    for m, dq in sorted(self._recent.items())
                },
                "slow": [t.dump() for t in self._slow],
                "slow_threshold_us": self.slow_threshold_us,
            }


# -- chromium trace events (/tracing.json) -----------------------------------

class TraceEventLog:
    """Process-wide ring of Chromium trace-event records, browsable in
    Perfetto / chrome://tracing (reference: src/yb/util/debug/
    trace_event.h + the /tracing.json handler,
    tracing-path-handlers.cc). Complete events ("ph":"X") only — each
    traced request or explicitly marked span is one slice."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)

    def record(self, name: str, start_wall_s: float, duration_us: int,
               tid: int | None = None, args: dict | None = None) -> None:
        ev = {"name": name, "ph": "X", "pid": 1,
              "tid": tid if tid is not None else threading.get_ident(),
              "ts": int(start_wall_s * 1e6), "dur": int(duration_us)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def dump(self) -> dict:
        with self._lock:
            return {"traceEvents": list(self._events),
                    "displayTimeUnit": "ms"}


TRACE_EVENTS = TraceEventLog()


class trace_event:
    """Span context manager feeding /tracing.json:

        with trace_event("compaction", tablet=tid):
            ...
    """

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args or None

    def __enter__(self):
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TRACE_EVENTS.record(self.name, self._wall,
                            (time.perf_counter() - self._t0) * 1e6,
                            args=self.args)
        return False


def dump_stacks() -> str:
    """All live threads' Python stacks (the pprof/stacks analog of
    src/yb/server/pprof-path-handlers.cc, for a Python runtime)."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"
