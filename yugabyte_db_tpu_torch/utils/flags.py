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

And those the JAX package names the same way: ``txn_expiry_s``, the
default expiry of a silent transaction (``txn.coordinator``), and, with
the JAX defaults, help texts and tags:

- ``raft_group_commit_window_us``, ``raft_max_inflight_ops`` and
  ``fault.raft_apply_stall`` (``consensus.raft``), and
  ``fault.wal_sync_failed`` (``tablet.wal``);
- ``max_clock_skew_us`` (``tserver.tablet_server``);
- ``follower_unavailable_considered_failed_sec`` (``master.ts_manager``,
  ``server.options``), ``tablet_split_size_bytes`` /
  ``tablet_split_ops_per_sec`` (``master.split_manager``) and
  ``enable_leader_balancing`` (``master.load_balancer``).

The registry is the JAX one: tags, and ``force=True`` to set a flag
tagged ``unsafe`` (the JAX ``fault.*`` flags are; the port's own
``gpu_*`` and ``fault.gpu_dispatch`` / ``fault.seed`` carry no tags).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

VALID_TAGS = {"stable", "evolving", "advanced", "runtime", "unsafe",
              "hidden"}


@dataclass
class FlagInfo:
    name: str
    default: object
    help: str
    tags: frozenset = frozenset()
    value: object = None


class FlagRegistry:
    """Named values with defaults and tags; ``set`` coerces to the
    default's type. Flags tagged ``unsafe`` need ``force=True`` to
    change, mirroring --unlock_unsafe_flags."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flags: dict[str, FlagInfo] = {}

    def define(self, name: str, default, help_: str = "",
               tags=()) -> None:
        tags = frozenset(tags)
        bad = tags - VALID_TAGS
        if bad:
            raise ValueError(f"unknown flag tags {sorted(bad)}")
        with self._lock:
            if name in self._flags:
                return  # idempotent re-import
            self._flags[name] = FlagInfo(name, default, help_, tags,
                                         default)

    def get(self, name: str):
        with self._lock:
            return self._flags[name].value

    def set(self, name: str, value, force: bool = False) -> None:
        with self._lock:
            f = self._flags[name]
            if "unsafe" in f.tags and not force:
                raise PermissionError(
                    f"flag {name} is tagged unsafe; unlock unsafe flags "
                    "first")
            if not isinstance(value, type(f.default)) and \
                    f.default is not None:
                value = type(f.default)(value)
            f.value = value

    def all(self) -> list[FlagInfo]:
        with self._lock:
            return [FlagInfo(f.name, f.default, f.help, f.tags, f.value)
                    for f in self._flags.values()]


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
FLAGS.define("fault.wal_sync_failed", 0.0,
             "probability a WAL group-commit sync raises IOError",
             ("unsafe", "runtime", "hidden"))
FLAGS.define("raft_group_commit_window_us", 200,
             "microseconds the leader-side commit pipeline waits after "
             "the first append before issuing one WAL sync + one "
             "AppendEntries round per peer for every entry admitted in "
             "the window; 0 disables coalescing (every append signals "
             "peers immediately, the pre-group-commit behaviour)",
             ("evolving", "runtime"))
FLAGS.define("raft_max_inflight_ops", 4096,
             "backpressure bound on the leader's append->apply window: "
             "append_leader blocks while last_index - applied_index "
             "reaches this many entries (bounded apply-queue depth for "
             "the ack-at-commit pipeline)",
             ("evolving", "runtime"))
FLAGS.define("fault.raft_apply_stall", 0.0,
             "non-zero: the Raft apply stage stalls (committed entries "
             "stay unapplied) — used by the commit_ack_crash fault-sweep "
             "round to widen the commit-ack/apply window deterministically",
             ("unsafe", "runtime", "hidden"))
FLAGS.define("max_clock_skew_us", 500_000,
             "bound on tolerated inter-node clock skew",
             ("stable",))
FLAGS.define("follower_unavailable_considered_failed_sec", 5.0,
             "tserver liveness timeout", ("stable",))
FLAGS.define("tablet_split_size_bytes", 0,
             "size threshold for master-driven tablet splitting: a "
             "tablet whose reported on-disk size (WAL + flushed runs) "
             "crosses this many bytes is split at its median resident "
             "key; 0 disables size-based splitting (reference: "
             "FLAGS_tablet_split_size_threshold_bytes of "
             "catalog_manager's tablet-split heuristics)",
             ("evolving", "runtime"))
FLAGS.define("tablet_split_ops_per_sec", 0.0,
             "op-rate threshold for master-driven tablet splitting: a "
             "tablet whose heartbeat-reported op rate sustains above "
             "this many ops/s is split at its median resident key; 0 "
             "disables load-based splitting (reference: the automatic "
             "tablet-splitting thresholds of the reference's "
             "TabletSplitManager)",
             ("evolving", "runtime"))
FLAGS.define("enable_leader_balancing", False,
             "run the master's leader load-balancer pass: when the "
             "spread between the most- and least-leader-loaded live "
             "tservers reaches 2, step one leader down toward the "
             "least-loaded tserver (one move per pass; reference: "
             "the leader-balancing half of cluster_balance.cc)",
             ("evolving", "runtime"))
FLAGS.define("use_cassandra_authentication", False,
             "require CQL authentication + per-statement role "
             "permission checks (reference: the flag of the same name "
             "gating auth in the CQL proxy)", ("stable", "runtime"))
FLAGS.define("ysql_require_auth", False,
             "require cleartext-password authentication on the PG wire "
             "(reference: pg_hba password auth via initdb defaults)",
             ("stable", "runtime"))
