"""@guarded_by declarations + the runtime lock-witness recorder.

Reference analog: the Clang thread-safety annotations the reference tree
puts on every shared field (``GUARDED_BY(lock_)``, src/yb/gutil/
thread_annotations.h) and the TSan runs that cross-check them.  Python
has neither, so this module supplies both halves:

- :func:`guarded_by` is a class decorator declaring "these fields are
  protected by this lock attribute".  The declaration is a plain literal
  (``@guarded_by("_lock", "_state", "_entries")``), recorded on the class
  (``__guarded_by__``, ``__guard_locks__``).

- The **lock witness** is the dynamic half: when enabled
  (:func:`enable_lock_witness`), every rebind of a declared field records
  whether the declared lock was actually held by the writing thread;
  :func:`dump_lock_witness` writes those observations as JSON.

Scope: the witness sees attribute *rebinds* (``self._state = x``,
``self._n += 1``).  In-place container mutation (``self._d[k] = v``)
never calls ``__setattr__``.  When disabled (the default) the per-write
cost is one attribute load and a falsy check; locks are only wrapped for
ownership tracking on instances constructed while the witness is enabled.

The port's copy of the JAX package's ``utils/locking.py``, whole. The
JAX package's static checker, which reads the declarations and the dumps
(its ``analysis`` package, ``--witness-check``), is not ported
(ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import json
import threading

_UNTRACKED = -1  # lock ownership not decidable (lock created pre-enable)

# Flipped by utils.resources.enable_resource_witness(): when True,
# _WitnessLock reports outermost acquire/release transitions to the
# resource witness (hold durations + holds-across-blocking). A plain
# module global so the disabled-path cost is one falsy check.
_HOLD_TRACKING = False


def set_hold_tracking(on: bool) -> None:
    global _HOLD_TRACKING
    _HOLD_TRACKING = on


def _resource_witness():
    from yugabyte_db_tpu_torch.utils import resources

    return resources.witness()


class _WitnessLock:
    """Wraps a Lock/RLock to track per-thread ownership (re-entrant
    count) so the witness can ask "does the *writing* thread hold it?"
    — ``Lock.locked()`` only answers "does anyone?"."""

    __slots__ = ("_inner", "_tls", "_cls")

    def __init__(self, inner, cls_name: str = ""):
        self._inner = inner
        self._tls = threading.local()
        self._cls = cls_name

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            depth = getattr(self._tls, "depth", 0) + 1
            self._tls.depth = depth
            if depth == 1 and _HOLD_TRACKING:
                _resource_witness().lock_acquired(self)
        return got

    def release(self):
        self._inner.release()
        depth = getattr(self._tls, "depth", 1) - 1
        self._tls.depth = depth
        if depth == 0 and _HOLD_TRACKING:
            _resource_witness().lock_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_current_thread(self) -> bool:
        return getattr(self._tls, "depth", 0) > 0

    def locked(self):
        return self._inner.locked()

    # Condition-variable protocol: threading.Condition copies these three
    # from its lock at construction. Without them it falls back to
    # non-reentrant-Lock defaults, which misdetect ownership of a wrapped
    # RLock (acquire(0) re-enters and "succeeds") and release only one
    # level across a wait.
    def _is_owned(self):
        probe = getattr(self._inner, "_is_owned", None)
        if probe is not None:
            return probe()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        depth = getattr(self._tls, "depth", 0)
        saver = getattr(self._inner, "_release_save", None)
        if saver is not None:
            inner_state = saver()
        else:
            self._inner.release()
            inner_state = None
        self._tls.depth = 0
        # A condition wait genuinely drops the lock: close this hold
        # interval (the re-acquire after the wait opens a new one).
        if depth > 0 and _HOLD_TRACKING:
            _resource_witness().lock_released(self)
        return inner_state, depth

    def _acquire_restore(self, state):
        inner_state, depth = state
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(inner_state)
        else:
            self._inner.acquire()
        self._tls.depth = depth
        if depth > 0 and _HOLD_TRACKING:
            _resource_witness().lock_acquired(self)


def _ownership(lock) -> int:
    """1/0 when decidable for the current thread, _UNTRACKED otherwise."""
    if isinstance(lock, _WitnessLock):
        return 1 if lock.held_by_current_thread() else 0
    # RLock (and Condition) expose _is_owned(); stable CPython internals,
    # good enough for a debug-only witness.
    probe = getattr(lock, "_is_owned", None)
    if probe is not None:
        try:
            return 1 if probe() else 0
        except Exception:  # noqa: BLE001 — witness must never throw
            return _UNTRACKED
    return _UNTRACKED


class LockWitness:
    """Process-wide accumulator of (class, field, lock) -> held/unheld
    write observations.  Everything is best-effort and exception-free:
    the witness observes the system, it must never perturb it."""

    _SITE_CAP = 8  # unheld call sites kept per key (enough to debug)

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        # (cls_name, field, lock_attr) -> [held, unheld, [sites...]]
        self._obs: dict[tuple, list] = {}

    def record(self, cls_name: str, field: str, lock_attr: str,
               owned: int) -> None:
        if owned == _UNTRACKED:
            return
        try:
            key = (cls_name, field, lock_attr)
            with self._lock:
                row = self._obs.get(key)
                if row is None:
                    row = self._obs[key] = [0, 0, []]
                if owned:
                    row[0] += 1
                else:
                    row[1] += 1
                    if len(row[2]) < self._SITE_CAP:
                        row[2].append(_caller_site())
        # The witness observes every instrumented write; throwing (or
        # even logging) from here would perturb the system under test.
        except Exception:  # noqa: BLE001 — witness must never throw
            pass

    def observations(self) -> list[dict]:
        with self._lock:
            return [{"class": k[0], "field": k[1], "lock": k[2],
                     "held": row[0], "unheld": row[1],
                     "unheld_sites": list(row[2])}
                    for k, row in sorted(self._obs.items())]

    def clear(self) -> None:
        with self._lock:
            self._obs.clear()

    def dump(self, path: str) -> str:
        payload = {"version": 1, "kind": "yb-lock-witness",
                   "observations": self.observations()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        return path


def _caller_site() -> str:
    """file:line of the write that produced an unheld observation (the
    frame below the instrumented __setattr__); "?" when unavailable."""
    import sys

    try:
        f = sys._getframe(3)
        while f is not None and f.f_code.co_filename.endswith("locking.py"):
            f = f.f_back
        if f is None:
            return "?"
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except Exception:  # noqa: BLE001 — witness must never throw
        return "?"


_WITNESS = LockWitness()


def witness() -> LockWitness:
    return _WITNESS


def enable_lock_witness() -> None:
    _WITNESS.enabled = True


def disable_lock_witness() -> None:
    _WITNESS.enabled = False


def lock_witness_enabled() -> bool:
    return _WITNESS.enabled


def dump_lock_witness(path: str) -> str:
    return _WITNESS.dump(path)


def load_witness_dump(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("kind") != "yb-lock-witness":
        raise ValueError(f"{path}: not a lock-witness dump")
    return data


# -- the declaration decorator ------------------------------------------------

def guarded_by(lock_attr: str, *fields: str):
    """Class decorator: declare ``fields`` protected by ``self.<lock_attr>``.

    Pure-literal usage only (string constants), so the static pass can
    read the declaration off the AST::

        @guarded_by("_lock", "_state", "_opened_at")
        class CircuitBreaker: ...

    Stackable for classes with more than one lock.  At runtime the
    decorator records the mapping on the class and — only while the
    witness is enabled — instruments ``__setattr__`` to log whether the
    declared lock is held at each field rebind.  Writes inside
    ``__init__`` are construction, not sharing, and are not recorded.
    """
    if not isinstance(lock_attr, str) or not fields \
            or not all(isinstance(f, str) for f in fields):
        raise TypeError("guarded_by(lock_attr, *fields) takes string "
                        "literals")

    def deco(cls):
        decl = dict(getattr(cls, "__guarded_by__", {}))
        for f in fields:
            decl[f] = lock_attr
        cls.__guarded_by__ = decl
        locks = set(getattr(cls, "__guard_locks__", ()))
        locks.add(lock_attr)
        cls.__guard_locks__ = frozenset(locks)
        if cls.__dict__.get("__gb_instrumented__") is not True:
            _instrument(cls)
        return cls

    return deco


def _instrument(cls) -> None:
    import functools

    cls.__gb_instrumented__ = True
    orig_setattr = cls.__setattr__
    orig_init = cls.__init__

    def __setattr__(self, name, value):
        w = _WITNESS
        if w.enabled or _HOLD_TRACKING:
            klass = type(self)
            if name in klass.__guard_locks__ \
                    and not isinstance(value, _WitnessLock) \
                    and hasattr(value, "acquire"):
                value = _WitnessLock(value, klass.__name__)
            elif w.enabled:
                lock_attr = klass.__guarded_by__.get(name)
                if lock_attr is not None \
                        and getattr(self, "_gb_constructed", False):
                    w.record(klass.__name__, name, lock_attr,
                             _ownership(getattr(self, lock_attr, None)))
        orig_setattr(self, name, value)

    @functools.wraps(orig_init)
    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        try:
            object.__setattr__(self, "_gb_constructed", True)
        except AttributeError:
            pass  # __slots__ class: witness degrades to declarations-only

    cls.__setattr__ = __setattr__
    cls.__init__ = __init__
