"""``@guarded_by`` declarations.

Reference analog: the Clang thread-safety annotations the reference tree
puts on every shared field (``GUARDED_BY(lock_)``,
src/yb/gutil/thread_annotations.h). The port's copy of the declaration
half of the JAX package's ``utils/locking.py``: :func:`guarded_by` records
"these fields are protected by this lock attribute" on the class
(``__guarded_by__``, ``__guard_locks__``), as the JAX decorator does. Left
out: the runtime lock witness and the resource-witness hooks (the JAX
module's ``_WitnessLock``, ``LockWitness`` and ``utils/resources.py``),
which wait for ROADMAP.md §1 item 16; the declarations cost nothing at
run time.
"""

from __future__ import annotations


def guarded_by(lock_attr: str, *fields: str):
    """Class decorator: declare ``fields`` protected by ``self.<lock_attr>``.

    Pure-literal usage only (string constants)::

        @guarded_by("_lock", "_state", "_opened_at")
        class CircuitBreaker: ...

    Stackable for classes with more than one lock."""
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
        return cls

    return deco
