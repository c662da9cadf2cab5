"""Fault injection: flag-driven probabilistic/deterministic failures.

Reference analog: src/yb/util/fault_injection.h:49 (MAYBE_FAULT) and
the per-service probability flags
(FLAGS_respond_write_failed_probability, tablet_service.cc:784) —
production code marks fault points; tests arm them via flags.

    FLAGS.set("fault.gpu_dispatch", 1.0)   # always
    FLAGS.set("fault.gpu_dispatch", 0.0)   # never (default)
    arm_fault_once("fault.gpu_dispatch")   # exactly one hit

``fault.seed`` (non-zero) seeds the probability draw so that a randomized
run replays byte for byte. The JAX module's ``yb_faults_fired`` series
waits for the port's metrics registry (ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import random
import threading

_lock = threading.Lock()
_once: dict[str, int] = {}   # fault name -> remaining forced hits
_rng = random.Random()
_applied_seed = 0            # last fault.seed value folded into _rng


def arm_fault_once(name: str, times: int = 1) -> None:
    """Force the next ``times`` evaluations of ``name`` to fire
    (deterministic tests; beats probability flags for exactness)."""
    with _lock:
        _once[name] = _once.get(name, 0) + times


def clear_faults() -> None:
    with _lock:
        _once.clear()


def _maybe_reseed_locked() -> None:
    """Fold a changed ``fault.seed`` flag into the RNG (0 = unseeded).
    Lazy so ``FLAGS.set("fault.seed", s)`` takes effect at the next
    fault evaluation."""
    global _applied_seed
    from yugabyte_db_tpu_torch.utils.flags import FLAGS

    try:
        seed = int(FLAGS.get("fault.seed"))
    except (KeyError, TypeError, ValueError):
        return
    if seed != _applied_seed:
        _applied_seed = seed
        if seed != 0:
            _rng.seed(seed)


def maybe_fault(name: str) -> bool:
    """True when the named fault should fire. Checks armed one-shot
    hits first, then the flag ``name`` as a probability in [0, 1]
    (unknown flag = 0: disabled)."""
    with _lock:
        n = _once.get(name, 0)
        if n > 0:
            _once[name] = n - 1
            return True
    from yugabyte_db_tpu_torch.utils.flags import FLAGS

    try:
        p = float(FLAGS.get(name))
    except (KeyError, TypeError, ValueError):
        return False
    if p <= 0:
        return False
    with _lock:
        _maybe_reseed_locked()
        return _rng.random() < p


class FaultInjected(Exception):
    """Raised by fault points that abort the operation."""
