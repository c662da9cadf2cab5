"""Metrics: counters, gauges, histograms + Prometheus text exposition.

Reference analog: src/yb/util/metrics.h — MetricRegistry/MetricEntity
with METRIC_DEFINE_* metrics attached to entities (server, tablet), HDR
histograms for latencies, and the PrometheusWriter (metrics.h:584) that
renders the registry for scraping.

Shapes:
- Counter: monotonically increasing int.
- Gauge: set() directly, or constructed with a callback sampled at
  scrape time (how per-tablet row counts surface without bookkeeping).
- Histogram: exponential buckets (powers of 2 in microseconds by
  default) with count/sum — the Prometheus histogram contract; covers
  the reference's HDR-histogram latency use.

Entities carry label sets (e.g. tablet_id); the registry renders
everything in one pass, grouping series by metric name.

The port's copy of the JAX package's ``utils/metrics.py``: the registry
whole, and the series the port feeds, with the same names, so a scrape
of either package reads alike. The feeders are consensus
(``count_swallowed``, ``count_fault_fired``,
``observe_group_commit_batch``), the WAL (``observe_wal_sync_ms``) and
the resource witness (``observe_lock_hold_s``,
``resource_witness_entity``). The JAX module's other series (serving
batches, residency, flush paths, plane encodings, splits, leader moves,
request latency) come with the slice that first feeds each
(ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import logging
import threading
import time


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def increment(self, by: int = 1) -> None:
        with self._lock:
            self.value += by

    def get(self) -> int:
        return self.value


class Gauge:
    __slots__ = ("_value", "_fn")

    def __init__(self, fn=None):
        self._value = 0
        self._fn = fn

    def set(self, v) -> None:
        self._value = v

    def get(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:  # noqa: BLE001 — scrape must not die
                return 0
        return self._value


# Exponential bucket bounds (microseconds): 64us .. ~67s
DEFAULT_BUCKETS = tuple(64 * (2 ** i) for i in range(21))


class Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "_lock")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.count = 0
        self.sum = 0
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v

    def observe_duration_us(self, start_monotonic: float) -> None:
        self.observe(int((time.monotonic() - start_monotonic) * 1e6))

    def percentile(self, p: float):
        """Approximate percentile from bucket upper bounds."""
        with self._lock:
            if self.count == 0:
                return 0
            target = self.count * p
            acc = 0
            for i, n in enumerate(self.counts):
                acc += n
                if acc >= target:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self.buckets[-1])
            return self.buckets[-1]


class MetricEntity:
    """One labeled owner of metrics (server / tablet / table)."""

    def __init__(self, registry: "MetricRegistry", labels: dict):
        self.registry = registry
        self.labels = dict(labels)
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, fn=None) -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(fn)
            elif fn is not None:
                m._fn = fn
            return m

    def histogram(self, name: str, buckets=None) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = (
                    Histogram(buckets) if buckets is not None
                    else Histogram())
            return m

    def _get(self, name, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            return m


class MetricRegistry:
    """All of one process's metrics; renders Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entities: list[MetricEntity] = []
        self._collectors: list = []  # callables refreshing gauges pre-scrape

    def entity(self, **labels) -> MetricEntity:
        e = MetricEntity(self, labels)
        with self._lock:
            self._entities.append(e)
        return e

    def remove_entity(self, entity: MetricEntity) -> None:
        with self._lock:
            try:
                self._entities.remove(entity)
            except ValueError:
                pass

    def add_collector(self, fn) -> None:
        """fn() runs before each scrape (register/refresh dynamic
        entities, e.g. per-tablet gauges after tablets move)."""
        with self._lock:
            self._collectors.append(fn)

    def prometheus_text(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — scrape must not die
                count_swallowed("metrics.collector", e)
        with self._lock:
            entities = list(self._entities)
        by_name: dict[str, list] = {}
        for e in entities:
            with e._lock:
                metrics = dict(e._metrics)
            for name, m in metrics.items():
                by_name.setdefault(name, []).append((e.labels, m))
        out = []
        for name in sorted(by_name):
            series = by_name[name]
            kind = ("counter" if isinstance(series[0][1], Counter)
                    else "histogram" if isinstance(series[0][1], Histogram)
                    else "gauge")
            out.append(f"# TYPE {name} {kind}")
            for labels, m in series:
                ls = _labels(labels)
                if isinstance(m, Histogram):
                    with m._lock:
                        counts = list(m.counts)
                        total, s = m.count, m.sum
                    acc = 0
                    for i, b in enumerate(m.buckets):
                        acc += counts[i]
                        out.append(
                            f"{name}_bucket{_labels(labels, le=b)} {acc}")
                    out.append(
                        f'{name}_bucket{_labels(labels, le="+Inf")} {total}')
                    out.append(f"{name}_sum{ls} {s}")
                    out.append(f"{name}_count{ls} {total}")
                else:
                    out.append(f"{name}{ls} {m.get()}")
        return "\n".join(out) + "\n"


def _labels(labels: dict, **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


# -- process-wide registry + swallowed-error accounting ----------------------
# Daemons construct their own registries for per-server metrics; this one
# exists so cross-cutting health counters (swallowed errors, scrape
# failures) have a home regardless of which daemon — or no daemon — is
# running in the process.
_PROCESS_REGISTRY = MetricRegistry()
_SWALLOW_LOG = logging.getLogger("yugabyte_db_tpu_torch.swallowed")
_SWALLOW_ENTITIES: dict[str, MetricEntity] = {}
_SWALLOW_LOCK = threading.Lock()


def process_registry() -> MetricRegistry:
    return _PROCESS_REGISTRY


def count_swallowed(site: str, exc: object = None) -> None:
    """Record a deliberately-swallowed exception: bump
    ``yb_swallowed_errors{site=...}`` on the process registry and leave a
    debug-level trace. For best-effort paths (retry loops, shutdown,
    scrapes) where the except block would otherwise discard the error
    invisibly — the counter makes a noisy failure site show up on a
    dashboard even when nobody has debug logging on. Never raises."""
    try:
        with _SWALLOW_LOCK:
            ent = _SWALLOW_ENTITIES.get(site)
            if ent is None:
                ent = _PROCESS_REGISTRY.entity(site=site)
                _SWALLOW_ENTITIES[site] = ent
        ent.counter("yb_swallowed_errors").increment()
        _SWALLOW_LOG.debug("swallowed at %s: %r", site, exc)
    except Exception:  # noqa: BLE001 — error accounting must not throw
        _SWALLOW_LOG.debug("count_swallowed failed at site %s", site)


# -- fault-injection observability -------------------------------------------
_FAULT_ENTITIES: dict[str, MetricEntity] = {}
_FAULT_LOCK = threading.Lock()


def count_fault_fired(name: str) -> None:
    """Bump ``yb_faults_fired{name=...}`` on the process registry: one
    series per fault point, incremented every time the fault actually
    fires. The fault-sweep harness asserts its injection schedule
    against this counter, so a fault point that silently stops being
    evaluated shows up as a sweep failure. Never raises."""
    try:
        with _FAULT_LOCK:
            ent = _FAULT_ENTITIES.get(name)
            if ent is None:
                ent = _PROCESS_REGISTRY.entity(name=name)
                _FAULT_ENTITIES[name] = ent
        ent.counter("yb_faults_fired").increment()
    except Exception:  # noqa: BLE001 — accounting must not throw
        _SWALLOW_LOG.debug("count_fault_fired failed for %s", name)


def faults_fired(name: str) -> int:
    """Current ``yb_faults_fired{name=...}`` value (0 if never fired)."""
    with _FAULT_LOCK:
        ent = _FAULT_ENTITIES.get(name)
    return ent.counter("yb_faults_fired").get() if ent is not None else 0


# The lock of the resource-witness and write-path entities below.
_ENTITY_LOCK = threading.Lock()


# -- resource-witness observability -------------------------------------------
# Lock-hold duration bucket bounds (seconds): 1us .. ~4.2s, powers of 4.
LOCK_HOLD_S_BUCKETS = tuple(1e-6 * (4 ** i) for i in range(12))

_LOCK_HOLD_ENTITIES: dict[str, MetricEntity] = {}
_RESOURCE_WITNESS_ENTITY: MetricEntity | None = None


def observe_lock_hold_s(cls: str, seconds: float) -> None:
    """Record one lock hold interval (acquire -> release by one thread)
    into the per-owner-class histogram ``yb_lock_hold_seconds{cls=...}``
    on the process registry. Fed by the resource witness
    (utils/resources.py); a lock held across fsync/RPC shows up as a
    fat tail on its class. Never raises."""
    try:
        with _ENTITY_LOCK:
            ent = _LOCK_HOLD_ENTITIES.get(cls)
            if ent is None:
                ent = _PROCESS_REGISTRY.entity(cls=cls)
                _LOCK_HOLD_ENTITIES[cls] = ent
        ent.histogram("yb_lock_hold_seconds",
                      buckets=LOCK_HOLD_S_BUCKETS).observe(seconds)
    except Exception:  # noqa: BLE001 — accounting must not throw
        _SWALLOW_LOG.debug("observe_lock_hold_s failed for %s", cls)


def resource_witness_entity() -> MetricEntity:
    """The process-registry entity carrying the resource-witness
    counters (``yb_resource_pin_acquires`` / ``yb_resource_pin_releases``
    / ``yb_resource_holds_across_blocking``) — process-wide, so the
    series render on every daemon's /metrics scrape."""
    global _RESOURCE_WITNESS_ENTITY
    with _ENTITY_LOCK:
        if _RESOURCE_WITNESS_ENTITY is None:
            _RESOURCE_WITNESS_ENTITY = _PROCESS_REGISTRY.entity()
        return _RESOURCE_WITNESS_ENTITY


# -- write-path observability --------------------------------------------------
# WAL sync latency bucket bounds (milliseconds): 1/16 ms .. ~32 s.
WAL_SYNC_MS_BUCKETS = tuple(0.0625 * (2 ** i) for i in range(20))
# Batch-size bucket bounds (entries a group-commit round): 1 .. 4096.
BATCH_SIZE_BUCKETS = tuple(2 ** i for i in range(13))

_WRITE_PATH_ENTITY: MetricEntity | None = None


def _write_path_entity() -> MetricEntity:
    global _WRITE_PATH_ENTITY
    with _ENTITY_LOCK:
        if _WRITE_PATH_ENTITY is None:
            _WRITE_PATH_ENTITY = _PROCESS_REGISTRY.entity()
        return _WRITE_PATH_ENTITY


def observe_group_commit_batch(entries: int) -> None:
    """Record one leader-side group-commit round: bump the
    ``yb_group_commit_batch_size`` histogram with the number of Raft
    entries coalesced into this WAL sync + AppendEntries window. A p50
    stuck at 1 means concurrent writers are not actually sharing
    replication rounds. Never raises."""
    try:
        _write_path_entity().histogram(
            "yb_group_commit_batch_size",
            buckets=BATCH_SIZE_BUCKETS).observe(entries)
    except Exception:  # noqa: BLE001 — accounting must not throw
        _SWALLOW_LOG.debug("observe_group_commit_batch failed")


def observe_wal_sync_ms(ms: float) -> None:
    """Record one WAL group-commit sync duration (flush + fsync) on the
    ``yb_wal_sync_ms`` histogram. Never raises."""
    try:
        _write_path_entity().histogram(
            "yb_wal_sync_ms", buckets=WAL_SYNC_MS_BUCKETS).observe(ms)
    except Exception:  # noqa: BLE001 — accounting must not throw
        _SWALLOW_LOG.debug("observe_wal_sync_ms failed")
