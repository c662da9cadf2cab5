"""The storage-engine seam: the pluggable boundary the query layer scans through.

Reference analog: common::YQLStorageIf (src/yb/common/ql_storage_interface.h:31)
— the only interface the query execution layer uses to read a tablet, with
the engine selected where the tablet injects its storage
(src/yb/tablet/tablet.h:648). The seam also carries writes.

The port keeps its own registry: ``make_engine("gpu", schema, options)``
builds the PyTorch/CUDA engine (``storage/gpu_engine.py``). Options are read
from the ``options`` dict, each defaulting to the JAX package's flag default
(``compaction_trigger`` 4, ``memtable_flush_versions`` 1 << 60); the port's
few process-wide flags (the residency budget, the breaker's defaults) are
in ``utils/flags.py``.
"""

from __future__ import annotations

import abc

from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec


COMPACTION_TRIGGER = 4             # runs that start a compaction
MEMTABLE_FLUSH_VERSIONS = 1 << 60  # memtable versions that start a flush


class StorageEngine(abc.ABC):
    """Per-tablet storage: an LSM of MVCC row versions behind a scan API."""

    def __init__(self, schema: Schema, options: dict | None = None):
        self.schema = schema
        self.options = dict(options or {})

    # -- writes ------------------------------------------------------------
    @abc.abstractmethod
    def apply(self, rows: list[RowVersion]) -> None:
        """Apply committed row versions (the Raft-apply stage calls this)."""

    # -- reads -------------------------------------------------------------
    @abc.abstractmethod
    def scan(self, spec: ScanSpec) -> ScanResult:
        """MVCC scan/aggregate at spec.read_ht over [lower, upper)."""

    def scan_batch(self, specs: list[ScanSpec]) -> list[ScanResult]:
        """Execute many scans. Engines with a device data plane override
        this to issue the whole batch before waiting on any result."""
        return [self.scan(s) for s in specs]

    # -- lifecycle ---------------------------------------------------------
    @abc.abstractmethod
    def flush(self) -> None:
        """Persist the memtable as a new sorted run."""

    @abc.abstractmethod
    def compact(self, history_cutoff_ht: int = 0) -> None:
        """Merge all sorted runs into one, GCing history older than cutoff."""

    @abc.abstractmethod
    def stats(self) -> dict:
        """Observability counters (runs, rows, bytes, versions)."""

    def maybe_compact(self, history_cutoff_ht: int = 0) -> bool:
        """Universal-compaction trigger: compact when the run count reaches
        the ``compaction_trigger`` option (reference: universal style with
        num_levels=1, docdb_rocksdb_util.cc:476-482)."""
        trigger = self.options.get("compaction_trigger", COMPACTION_TRIGGER)
        if self.stats().get("num_runs", 0) >= trigger:
            self.compact(history_cutoff_ht)
            return True
        return False


_ENGINES: dict[str, type] = {}


def register_engine(name: str, cls: type) -> None:
    _ENGINES[name] = cls


def make_engine(name: str, schema: Schema,
                options: dict | None = None) -> StorageEngine:
    """Factory behind the ``tablet_storage_engine`` option."""
    if name == "gpu" and name not in _ENGINES:
        # Lazy: the engine module pulls in torch; host-only users of the
        # data model shouldn't pay for it.
        import yugabyte_db_tpu_torch.storage.gpu_engine  # noqa: F401
    if name not in _ENGINES:
        raise ValueError(f"unknown storage engine {name!r}; have {sorted(_ENGINES)}")
    return _ENGINES[name](schema, options)
