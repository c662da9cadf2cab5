"""The port's process-wide flags: a small runtime-settable registry.

Reference analog: the gflags registry (src/yb/util/flag_tags.h) and the
JAX package's ``utils/flags.py``. The port keeps only the flags its own
modules read. Each is a JAX flag with the device's name changed
(``tpu_*`` -> ``gpu_*``), with the same default and meaning:

- ``gpu_hbm_budget_bytes`` (JAX ``tpu_hbm_budget_bytes``): the budget of
  device-resident run planes a device, in bytes; 0 means unbounded
  (``storage.residency``);
- ``gpu_breaker_failure_threshold`` / ``gpu_breaker_cooldown_s`` (JAX
  ``tpu_breaker_*``): the default options of the ``gpu`` engine's circuit
  breaker (``storage.breaker``);
- ``fault.gpu_dispatch`` (JAX ``fault.tpu_dispatch``) and ``fault.seed``:
  the probability that a device dispatch raises an injected fault, and
  the seed of that draw (``utils.fault_injection``).

And one the JAX package names the same way: ``txn_expiry_s``, the
default expiry of a silent transaction (``txn.coordinator``).
"""

from __future__ import annotations

import threading


class FlagRegistry:
    """Named values with defaults; ``set`` coerces to the default's type."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[str, object] = {}
        self._defaults: dict[str, object] = {}
        self._help: dict[str, str] = {}

    def define(self, name: str, default, help_: str = "") -> None:
        with self._lock:
            if name in self._defaults:
                return  # idempotent re-import
            self._defaults[name] = default
            self._values[name] = default
            self._help[name] = help_

    def get(self, name: str):
        with self._lock:
            return self._values[name]

    def set(self, name: str, value) -> None:
        with self._lock:
            default = self._defaults[name]
            if default is not None and not isinstance(value, type(default)):
                value = type(default)(value)
            self._values[name] = value


FLAGS = FlagRegistry()

FLAGS.define("gpu_hbm_budget_bytes", 0,
             "budget of device-resident columnar run planes a device; 0 = "
             "unbounded. When set, runs upload on demand through the "
             "storage.residency cache and are evicted LRU with a "
             "scan-resistant two-pool policy (reference: "
             "rocksdb/util/cache.cc high-pri/low-pri split)")
FLAGS.define("gpu_breaker_failure_threshold", 3,
             "consecutive device faults before the gpu engine's circuit "
             "breaker opens and its scans are re-served from the host")
FLAGS.define("gpu_breaker_cooldown_s", 1.0,
             "seconds an open breaker waits before it admits one half-open "
             "probe")
FLAGS.define("fault.gpu_dispatch", 0.0,
             "probability that a device dispatch raises an injected fault "
             "(exercises the circuit breaker and the host re-serve)")
FLAGS.define("fault.seed", 0,
             "seed of the fault probabilities' draw; 0 = unseeded")
FLAGS.define("txn_expiry_s", 10.0,
             "seconds without a client heartbeat after which a transaction "
             "coordinator aborts a pending transaction")
