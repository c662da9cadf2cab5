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

The seam's defaults are the JAX seam's (``apply_block``, ``scan_batch``
with a ``deadline``, ``scan_batch_wire``, ``point_serve``,
``restore_entries``, ``alter_schema``, ``close``), with the same semantics.
Left out: the memstore tracker and its global flush trigger
(``_track_memstore``), which wait for the tablet server (ROADMAP.md §1
item 16).
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

    def apply_block(self, block: bytes) -> None:
        """Apply an encoded row block (storage.rowblock layout). The
        default decodes and delegates; engines with a block-aware memtable
        override it."""
        from yugabyte_db_tpu_torch.storage import rowblock

        self.apply(rowblock.rows_from_block(block))

    # -- reads -------------------------------------------------------------
    @abc.abstractmethod
    def scan(self, spec: ScanSpec) -> ScanResult:
        """MVCC scan/aggregate at spec.read_ht over [lower, upper)."""

    def scan_batch(self, specs: list[ScanSpec],
                   deadline=None) -> list[ScanResult]:
        """Execute many scans. Engines with a device data plane override
        this to issue the whole batch before waiting on any result.
        ``deadline`` (utils.retry.Deadline) is the RPC edge's propagated
        budget: the batch aborts with Code.TIMED_OUT instead of serving
        results nobody is waiting for."""
        out = []
        for s in specs:
            if deadline is not None:
                deadline.check("scan_batch")
            out.append(self.scan(s))
        return out

    def scan_batch_wire(self, specs: list[ScanSpec], fmt: str = "cql",
                        deadline=None):
        """Execute many scans and return each result as serialized
        protocol bytes (host_page.WirePage): fmt "cql" = CQL binary
        cells, "pg" = PG text DataRow messages, serialized in Python
        (models.wirefmt, the format definition). Reference contract: rows
        serialize once into rows_data (src/yb/common/ql_rowblock.h:66)
        and the YQL frontends forward bytes."""
        from yugabyte_db_tpu_torch.storage.host_page import wire_from_result

        return [wire_from_result(self, r, fmt)
                for r in self.scan_batch(specs, deadline=deadline)]

    def point_serve(self, keys: list[bytes], read_ht: int, col_id: int):
        """Batch point-value lookup from a native memtable: ``None`` when
        this engine cannot answer the batch definitively (sorted runs, a
        memtable without a native ``point_lookup``), and then the caller
        takes the general read path. The port's memtable has no native
        lookup (the native memtable is ROADMAP.md §1 item 16), so the
        port always answers ``None``: that is the contract, not a
        refusal. Otherwise a list aligned with ``keys`` whose entries are
        payload ``bytes``, ``None`` (absent row / NULL column), or
        ``False`` (value not natively servable: fall back per key)."""
        if getattr(self, "runs", None):
            return None
        lookup = getattr(getattr(self, "memtable", None),
                         "point_lookup", None)
        if lookup is None:
            return None
        return lookup(keys, read_ht, col_id)

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

    def restore_entries(self, entries) -> None:
        """Replace ALL engine content (memtable + runs + persisted files)
        with the given (key, versions) entries — the snapshot-restore
        primitive. Subclasses rebuild their run representations."""
        raise NotImplementedError

    def alter_schema(self, new_schema: Schema) -> None:
        """Adopt an evolved schema (ALTER TABLE). Key columns never
        change; value columns may be added (NULL for existing rows),
        dropped (values become invisible; ids are never reused), or
        renamed (ids are stable, so data is untouched)."""
        self.schema = new_schema

    def maybe_compact(self, history_cutoff_ht: int = 0) -> bool:
        """Universal-compaction trigger: compact when the run count reaches
        the ``compaction_trigger`` option (reference: universal style with
        num_levels=1, docdb_rocksdb_util.cc:476-482)."""
        trigger = self.options.get("compaction_trigger", COMPACTION_TRIGGER)
        if self.stats().get("num_runs", 0) >= trigger:
            self.compact(history_cutoff_ht)
            return True
        return False

    def close(self) -> None:
        """Let go of what the engine holds (the ``gpu`` engine: its
        device residency)."""


_ENGINES: dict[str, type] = {}


def register_engine(name: str, cls: type) -> None:
    _ENGINES[name] = cls


def require_engine(name: str) -> type:
    """The engine class registered as ``name``; raises ``ValueError``
    for a name no engine is registered under (the port registers only
    ``gpu``)."""
    if name == "gpu" and name not in _ENGINES:
        # Lazy: the engine module pulls in torch; host-only users of the
        # data model shouldn't pay for it.
        import yugabyte_db_tpu_torch.storage.gpu_engine  # noqa: F401
    if name not in _ENGINES:
        raise ValueError(f"unknown storage engine {name!r}; have {sorted(_ENGINES)}")
    return _ENGINES[name]


def make_engine(name: str, schema: Schema,
                options: dict | None = None) -> StorageEngine:
    """Factory behind the ``tablet_storage_engine`` option."""
    return require_engine(name)(schema, options)
