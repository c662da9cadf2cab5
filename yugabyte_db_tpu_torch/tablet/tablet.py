"""Tablet: one shard — storage engine + WAL + MVCC + operation pipeline.

Reference analog: src/yb/tablet/tablet.{h,cc} and the operation lifecycle of
operations/operation_driver.h:70-95 (Prepare -> Replicate(WAL) -> Apply),
with TabletBootstrap (tablet_bootstrap.cc) replaying the log over the
flushed frontier on restart.

Single-node consensus note: this tablet runs under a LocalConsensus-style
pipeline (append + fsync locally == replicated); consensus.RaftConsensus
drives the same hooks for replicated tablets — the tablet only sees
``replicate(entry) -> op_id`` and ``apply(entry)``.

The port's copy of the JAX package's ``tablet/tablet.py``, whole, on the
port's engines (``engine="gpu"``). Its files are the JAX tablet's byte for
byte: the WAL segments, the run files, ``tablet-meta.json`` and the
sidecars, so the port opens a directory the JAX tablet wrote (after its
metadata names the ``gpu`` engine). ``TabletMetadata.engine`` defaults
to ``"gpu"``: the JAX default, ``"cpu"``, is an engine the port does not
register, and the field is always written out. A replicated tablet runs
under ``TabletPeer`` (``tablet_peer.py``), whose ``consensus.RaftConsensus``
owns the log (``consensus_managed``).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass

from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.storage.engine import make_engine
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
# Canonical row wire codec (shared with RPC payloads).
from yugabyte_db_tpu_torch.storage.wire import decode_rows as _decode_rows
from yugabyte_db_tpu_torch.storage.wire import encode_rows as _encode_rows
from yugabyte_db_tpu_torch.tablet.mvcc import MvccManager
from yugabyte_db_tpu_torch.tablet.wal import Log, LogEntry, OpId
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock, HybridTime


@dataclass
class TabletMetadata:
    """The tablet superblock (reference: tablet_metadata.cc RaftGroupMetadata)."""

    tablet_id: str
    table_name: str
    schema: Schema
    partition_start: int
    partition_end: int
    engine: str = "gpu"              # tablet_storage_engine option
    flushed_op_index: int = 0        # WAL replay frontier
    # Secondary indexes the leader maintains on writes:
    # [{"name", "column", "index_table"}] (reference: the IndexMap the
    # tablet consults in UpdateQLIndexes, tablet.cc:1015).
    indexes: list = None
    # Sealed for a tablet split: every data RPC answers "tablet_split"
    # and the frozen state has been (or is being) forked into the
    # children. Persisted so a crash between the seal and the parent's
    # deletion cannot resurrect a writable parent — the seal entry
    # itself may sit below the flushed replay frontier by then
    # (reference: the kSplit tablet-data state of tablet_metadata.h).
    split_sealed: bool = False

    def __post_init__(self):
        if self.indexes is None:
            self.indexes = []

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "tablet_id": self.tablet_id,
                "table_name": self.table_name,
                "schema": self.schema.to_dict(),
                "partition_start": self.partition_start,
                "partition_end": self.partition_end,
                "engine": self.engine,
                "flushed_op_index": self.flushed_op_index,
                "indexes": self.indexes,
                "split_sealed": self.split_sealed,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "TabletMetadata":
        with open(path) as f:
            d = json.load(f)
        return TabletMetadata(
            d["tablet_id"], d["table_name"], Schema.from_dict(d["schema"]),
            d["partition_start"], d["partition_end"], d["engine"],
            d["flushed_op_index"], d.get("indexes") or [],
            d.get("split_sealed", False),
        )


class Tablet:
    """A live tablet. Thread-safe: writes serialize through the apply lock
    (the reference serializes through the single-threaded Preparer +
    per-tablet apply token)."""

    def __init__(self, meta: TabletMetadata, data_root: str,
                 clock: HybridClock | None = None,
                 engine_options: dict | None = None,
                 fsync: bool = True, consensus_managed: bool = False):
        self.meta = meta
        self.dir = os.path.join(data_root, meta.tablet_id)
        os.makedirs(self.dir, exist_ok=True)
        self.meta_path = os.path.join(self.dir, "tablet-meta.json")
        self.clock = clock or HybridClock()
        self.mvcc = MvccManager(self.clock)
        opts = dict(engine_options or {})
        opts.setdefault("data_dir", os.path.join(self.dir, "runs"))
        # unique per live instance: one process may host several replicas
        # of the same tablet id (MiniCluster)
        opts.setdefault("tracker_name", f"{meta.tablet_id}:{id(self):x}")
        self.engine = make_engine(meta.engine, meta.schema, opts)
        self.log = Log(os.path.join(self.dir, "wal"), fsync=fsync)
        self._write_lock = threading.Lock()
        self._term = 1
        # consensus_managed: a RaftConsensus owns the log (appends, term
        # tracking) and drives applies through apply_replicated(); the
        # tablet's own write() path is disabled.
        self.consensus_managed = consensus_managed
        self._last_index = self.log.last_appended.index
        self._applied_index = meta.flushed_op_index
        # Transaction machinery: every tablet can hold intents
        # (participant); tablets of the status table additionally run the
        # coordinator state machine. Both rebuild from sidecar snapshots +
        # WAL replay exactly like the engine.
        from yugabyte_db_tpu_torch.tablet.retryable import RetryableRequests
        from yugabyte_db_tpu_torch.txn.coordinator import (
            TXN_STATUS_TABLE, TransactionCoordinator)
        from yugabyte_db_tpu_torch.txn.participant import (
            TransactionParticipant)

        self.participant = TransactionParticipant(self.dir)
        self.retryable = RetryableRequests(self.dir)
        self.coordinator = (TransactionCoordinator(self.dir)
                            if meta.table_name == TXN_STATUS_TABLE else None)
        self.bootstrap()

    # -- bootstrap ----------------------------------------------------------
    def bootstrap(self) -> None:
        """Replay WAL entries newer than the flushed frontier into the
        engine (reference: TabletBootstrap::PlaySegments). Under consensus
        management only entries known committed (from the piggybacked commit
        watermark) are applied — the uncommitted tail is left for Raft to
        commit or truncate (tablet_bootstrap.cc hands those back as
        pending)."""
        # Replay happens before the peer serves, but holding the write
        # lock keeps the _last_index/_applied_index invariant uniform
        # (and a re-bootstrap racing a stray write is then safe too).
        with self._write_lock:
            all_entries = list(self.log.read_all(0))
            if self.consensus_managed:
                committed_frontier = max((e.committed for e in all_entries),
                                         default=0)
                # Consensus reuses this single decode pass for its entry
                # cache (avoids a second full-log read at startup).
                self.bootstrap_entries = all_entries
            else:
                committed_frontier = None  # local-consensus: all durable
            replayed = 0
            for entry in all_entries:
                self._last_index = max(self._last_index, entry.op_id.index)
                self.clock.update(HybridTime(entry.ht))
                if entry.op_id.index <= self.meta.flushed_op_index:
                    continue  # already durable in the flushed runs
                if committed_frontier is not None and \
                        entry.op_id.index > committed_frontier:
                    continue
                self._apply_entry_body(entry)
                if entry.op_type == "write":
                    replayed += 1
                self._applied_index = max(self._applied_index,
                                          entry.op_id.index)
            self._replayed_on_bootstrap = replayed

    def _apply_write_body(self, entry) -> None:
        """Apply a "write" entry. Bodies are one of: an encoded row BLOCK
        (bytes, storage.rowblock — the native write plane's zero-copy
        form), the legacy raw row list, or {"rows": <either>, "rid":
        [client_id, request_id]} — the rid is recorded for exactly-once
        retry dedup (retryable.py)."""
        # Leader fast path: the writer attached its already-stamped
        # RowVersions to the in-memory entry (tablet_peer.write), so the
        # leader's apply skips the wire round trip; followers and WAL
        # replay decode from the body. (Block bodies need no such
        # attachment: every replica ingests the block natively.)
        decoded = getattr(entry, "decoded_rows", None)
        body = entry.body
        rows = body["rows"] if isinstance(body, dict) else body
        if isinstance(rows, (bytes, bytearray)):
            self.engine.apply_block(rows)
        else:
            self.engine.apply(decoded if decoded is not None
                              else _decode_rows(rows))
        if isinstance(body, dict):
            rid = body.get("rid")
            if rid:
                self.retryable.record(rid[0], rid[1], entry.ht)

    def _apply_txn_op(self, entry) -> None:
        """Apply transaction ops (intents / commit-apply / abort-remove /
        coordinator status records) from the log."""
        if entry.op_type == "intents":
            self.participant.apply_intents_op(entry.body)
        elif entry.op_type == "apply_intents":
            self.participant.apply_commit_op(entry.body, self.engine.apply)
        elif entry.op_type == "remove_intents":
            self.participant.apply_remove_op(entry.body)
        elif entry.op_type == "txn_status" and self.coordinator is not None:
            self.coordinator.apply_status_op(entry.body)

    # -- snapshots (reference: Tablet::CreateCheckpoint, tablet.h:348,
    # via rocksdb hard-link checkpoints, checkpoint.cc:53; cluster RPCs
    # in backup.proto TabletSnapshotOp CREATE/RESTORE/DELETE) ------------
    def snapshots_dir(self) -> str:
        return os.path.join(self.dir, "snapshots")

    def list_snapshots(self) -> list[str]:
        d = self.snapshots_dir()
        if not os.path.isdir(d):
            return []
        return sorted(n for n in os.listdir(d) if not n.endswith(".tmp"))

    def _apply_snapshot_op(self, op_type: str, body: dict) -> None:
        """Apply a replicated snapshot op. Runs at a fixed log position on
        every replica, so each replica's snapshot captures the same
        logical state; all three ops are idempotent across WAL replays
        (a re-created snapshot re-captures the same position's state
        because replay applies entries in order)."""
        import shutil as _shutil

        sid = body["snapshot_id"]
        if "/" in sid or sid.startswith("."):
            raise ValueError(f"bad snapshot id {sid!r}")
        sdir = os.path.join(self.snapshots_dir(), sid)
        if op_type == "create_snapshot":
            if os.path.exists(sdir):
                return  # replayed: already captured at this position
            self.engine.flush()  # runs now hold every applied write
            tmp = sdir + ".tmp"
            _shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for path in self.engine.persist.files:
                dst = os.path.join(tmp, os.path.basename(path))
                try:
                    os.link(path, dst)  # hard link: cheap, immutable file
                except OSError:
                    _shutil.copy2(path, dst)
            with open(os.path.join(tmp, "snapshot-meta.json"), "w") as f:
                import json as _json

                _json.dump({"schema": self.meta.schema.to_dict(),
                            "ht": self.clock.now().value}, f)
            os.rename(tmp, sdir)
        elif op_type == "restore_snapshot":
            if not os.path.isdir(sdir):
                # Leaders validate existence before replicating; a miss
                # here (non-consensus misuse, manual dir removal) must
                # not wedge the apply stage.
                if not self.consensus_managed:
                    raise RuntimeError(f"snapshot {sid} not found")
                import logging

                logging.getLogger(__name__).error(
                    "tablet %s: restore of missing snapshot %s skipped",
                    self.meta.tablet_id, sid)
                return
            from yugabyte_db_tpu_torch.storage.merge import merge_entry_streams
            from yugabyte_db_tpu_torch.storage.run_io import load_run

            runs = [load_run(os.path.join(sdir, n))
                    for n in sorted(os.listdir(sdir))
                    if n.startswith("run-")]
            entries = list(merge_entry_streams(runs)) if runs else []
            self.engine.restore_entries(entries)
        else:  # delete_snapshot
            _shutil.rmtree(sdir, ignore_errors=True)

    def dump_snapshots(self) -> dict:
        """Every snapshot's logical content (for remote bootstrap: a
        re-seeded replica must be able to apply later restore_snapshot
        entries, so the snapshots travel with the storage payload)."""
        import json as _json

        from yugabyte_db_tpu_torch.storage.merge import merge_entry_streams
        from yugabyte_db_tpu_torch.storage.run_io import load_run

        out = {}
        for sid in self.list_snapshots():
            sdir = os.path.join(self.snapshots_dir(), sid)
            runs = [load_run(os.path.join(sdir, n))
                    for n in sorted(os.listdir(sdir))
                    if n.startswith("run-")]
            meta = {}
            mpath = os.path.join(sdir, "snapshot-meta.json")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    meta = _json.load(f)
            out[sid] = {"entries": list(merge_entry_streams(runs))
                        if runs else [], "meta": meta}
        return out

    @staticmethod
    def install_snapshots(tablet_dir: str, snapshots: dict) -> None:
        """Materialize dumped snapshots into a (re)built tablet dir."""
        import json as _json

        from yugabyte_db_tpu_torch.storage.run_io import RunPersistence

        for sid, blob in (snapshots or {}).items():
            sdir = os.path.join(tablet_dir, "snapshots", sid)
            os.makedirs(sdir, exist_ok=True)
            if blob["entries"]:
                RunPersistence(sdir).save_new(blob["entries"])
            with open(os.path.join(sdir, "snapshot-meta.json"), "w") as f:
                _json.dump(blob.get("meta") or {}, f)

    def snapshot_op(self, op_type: str, snapshot_id: str) -> None:
        """Direct snapshot op (non-consensus tablets; replicated tablets
        go through TabletPeer.replicate_txn_op)."""
        if self.consensus_managed:
            raise RuntimeError("snapshot ops go through the TabletPeer")
        with self._write_lock:
            self._apply_snapshot_op(op_type, {"snapshot_id": snapshot_id})

    def alter_schema(self, new_schema) -> None:
        """Direct schema change (non-consensus tablets; replicated
        tablets go through TabletPeer.alter_schema)."""
        if self.consensus_managed:
            raise RuntimeError("schema changes go through the TabletPeer")
        with self._write_lock:
            self._apply_alter_schema({"schema": new_schema.to_dict()})

    # -- write path ---------------------------------------------------------
    def write(self, rows: list[RowVersion],
              if_not_exists: bool = False) -> HybridTime:
        """Apply one write operation (a batch of row versions, HT-stamped
        here). Durable (WAL fsync) before apply, matching the reference's
        Replicate-before-Apply invariant.

        ``if_not_exists``: atomic uniqueness enforcement — the existence
        check runs under the same write lock as the apply, so concurrent
        duplicate inserts cannot both pass (the SQL INSERT contract;
        reference: the read-modify-write inside the tablet,
        cql_operation.cc QLWriteOperation)."""
        if self.consensus_managed:
            raise RuntimeError("writes must go through the TabletPeer")
        with self._write_lock:
            if if_not_exists:
                from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

                for r in rows:
                    if self.current_row_values(r.key) is not None:
                        raise AlreadyPresent(
                            "duplicate key value violates unique "
                            "constraint")
            rows = [self.resolve_increments(r) for r in rows]
            ht = self.clock.now()
            self.mvcc.add_pending(ht)
            try:
                stamped = [
                    RowVersion(r.key, ht=ht.value, tombstone=r.tombstone,
                               liveness=r.liveness, columns=r.columns,
                               expire_ht=r.resolve_ttl(ht.value),
                               write_id=i)
                    for i, r in enumerate(rows)
                ]
                self._last_index += 1
                op_id = OpId(self._term, self._last_index)
                # The append and the sync hold the write lock: the
                # standalone (non-consensus) tablet is single-writer BY
                # DESIGN — append order must match apply order into the
                # engine, and flush() swaps the memtable under this same
                # lock.
                self.log.append(LogEntry(op_id, ht.value, "write",
                                         _encode_rows(stamped)))
                self.log.sync()  # group commit point (batching comes from callers)
                self.engine.apply(stamped)
                self._applied_index = op_id.index
            except BaseException:
                self.mvcc.aborted(ht)
                raise
            self.mvcc.replicated(ht)
            return ht

    def apply_replicated(self, entry) -> None:
        """Apply one committed log entry (the Raft apply stage; reference:
        Tablet::ApplyRowOperations, tablet.cc:667). Rows carry their hybrid
        time already (stamped by the leader before replication). Runs under
        the write lock: engines have no internal locking, and flush() swaps
        the memtable under the same lock — an apply racing that swap would
        vanish while the replay frontier still advances past it."""
        with self._write_lock:
            self._apply_entry_body(entry)
            self._applied_index = max(self._applied_index, entry.op_id.index)
            self._last_index = max(self._last_index, entry.op_id.index)
        self.clock.update(HybridTime(entry.ht))

    def _apply_entry_body(self, entry) -> None:
        """The ONE dispatch for committed entries — the Raft apply stage
        and WAL-replay bootstrap both route through it, so no op type can
        apply live but silently vanish on replay."""
        if entry.op_type == "write":
            self._apply_write_body(entry)
        elif entry.op_type == "alter_schema":
            self._apply_alter_schema(entry.body)
        elif entry.op_type == "split_seal":
            self._apply_split_seal()
        elif entry.op_type in ("create_snapshot", "restore_snapshot",
                               "delete_snapshot"):
            self._apply_snapshot_op(entry.op_type, entry.body)
        else:
            self._apply_txn_op(entry)

    def _apply_split_seal(self) -> None:
        """Apply the split-seal entry: freeze this tablet for its split.
        Runs at one log position on every replica, so each rejects data
        RPCs from the same point in the write sequence; everything at or
        below the seal is captured by the parent's fork snapshot, and
        everything after it is bounced to the clients with the
        ``tablet_split`` code to retry against the children. Idempotent
        across WAL replays; persisted immediately so a post-flush crash
        cannot replay the tablet back into service unsealed."""
        if self.meta.split_sealed:
            return
        self.meta.split_sealed = True
        self.meta.save(self.meta_path)

    def _apply_alter_schema(self, body: dict) -> None:
        """Adopt a replicated schema change (idempotent across replays:
        versions only move forward). Reference: the AlterSchema operation
        (tablet.cc AlterSchema / ChangeMetadataOperation)."""
        from yugabyte_db_tpu_torch.models.schema import Schema

        new_schema = Schema.from_dict(body["schema"])
        if new_schema.version <= self.meta.schema.version:
            return  # stale replay
        self.meta.schema = new_schema
        self.meta.save(self.meta_path)
        self.engine.alter_schema(new_schema)

    # -- read path ----------------------------------------------------------
    def read_time(self) -> HybridTime:
        return self.mvcc.safe_time()

    def _read_fence(self, read_ht: int, deadline=None) -> None:
        """MVCC read fence for the pipelined-apply write path: a write is
        acked at COMMIT and applies asynchronously, with its pending HT
        holding safe time below it until the apply lands. A read at or
        above that HT must wait for the drain or it would miss an acked
        write. Best-effort on timeout: proceeding matches pre-pipelining
        behaviour, and apply lag is already bounded by write backpressure
        (--raft_max_inflight_ops)."""
        timeout = 10.0
        if deadline is not None:
            timeout = max(0.0, min(timeout, deadline.remaining()))
        self.mvcc.wait_for_safe_time(HybridTime(read_ht), timeout=timeout)

    def scan(self, spec: ScanSpec, deadline=None) -> ScanResult:
        self._read_fence(spec.read_ht, deadline)
        return self.engine.scan_batch([spec], deadline=deadline)[0]

    def scan_wire(self, spec: ScanSpec, fmt: str = "cql", deadline=None):
        """Scan serving serialized protocol bytes (storage page server;
        reference: rows_data serialized once at the tablet,
        src/yb/common/ql_rowblock.h:66)."""
        self._read_fence(spec.read_ht, deadline)
        return self.engine.scan_batch_wire([spec], fmt,
                                           deadline=deadline)[0]

    def scan_many(self, specs: list[ScanSpec],
                  deadline=None) -> list[ScanResult]:
        """One engine batch for many scans (the multi-key read RPC's
        storage hop — point gets share the bloom/merge machinery).
        ``deadline`` is the RPC edge's propagated budget (utils.retry)."""
        if specs:
            self._read_fence(max(s.read_ht for s in specs), deadline)
        return self.engine.scan_batch(specs, deadline=deadline)

    def scan_wire_many(self, specs: list[ScanSpec], fmt: str = "cql",
                       deadline=None):
        """One engine batch of wire-serialized scans — the batched read
        RPC's storage hop for the native request-batch serving path."""
        if specs:
            self._read_fence(max(s.read_ht for s in specs), deadline)
        return self.engine.scan_batch_wire(specs, fmt, deadline=deadline)

    def point_serve(self, keys: list[bytes], read_ht: int, col_id: int):
        """Native batch point-value serve. None unless the whole visible
        state is servable from the native memtable: pending transaction
        intents live outside the engine, so any intent on this tablet
        forces the general read path (which resolves them)."""
        if self.participant.txns:
            return None
        self._read_fence(read_ht)
        return self.engine.point_serve(keys, read_ht, col_id)

    # -- maintenance --------------------------------------------------------
    def flush(self) -> None:
        """Flush memtable to a durable run, advance the replay frontier,
        GC fully-flushed WAL segments. Transaction state (intents,
        coordinator records) snapshots alongside — it too stops being
        recoverable from the log once segments below the frontier go."""
        with self._write_lock:
            self.engine.flush()
            self.participant.snapshot()
            self.retryable.snapshot()
            if self.coordinator is not None:
                self.coordinator.snapshot()
            self.meta.flushed_op_index = self._applied_index
            # The save and the sync hold the write lock (the flush
            # barrier): the replay frontier may only advance (and WAL
            # segments drop) while no write can move the memtable out
            # from under the captured snapshot.
            self.meta.save(self.meta_path)
            self.log.sync()
            self.log.gc(self.meta.flushed_op_index + 1)

    def resolve_increments(self, row: RowVersion) -> RowVersion:
        """Turn pending counter deltas into absolute column values by
        reading the row's current state — callers MUST hold the lock
        that serializes writes to this tablet (the write lock here, the
        tserver's intent-admission lock on the replicated path), which
        is what makes concurrent increments atomic."""
        if not row.increments:
            return row
        by_id = {c.col_id: c.name for c in self.meta.schema.value_columns}
        cur = self.current_row_values(row.key) or {}
        columns = dict(row.columns)
        for cid, delta in row.increments.items():
            name = by_id.get(cid)
            if name is None:
                # stale client schema (column dropped/recreated): refuse
                # rather than append a value under a retired column id
                raise ValueError(f"unknown column id {cid} in increment")
            base = cur.get(name)
            columns[cid] = (base if isinstance(base, int) else 0) + delta
        return RowVersion(row.key, ht=row.ht, tombstone=row.tombstone,
                          liveness=row.liveness, columns=columns,
                          expire_ht=row.expire_ht, ttl_us=row.ttl_us,
                          write_id=row.write_id)

    def current_row_values(self, key: bytes) -> dict | None:
        """Merged value-column values of one row by name (None if the row
        doesn't exist) — the old-state read of index maintenance."""
        names = [c.name for c in self.meta.schema.value_columns]
        spec = ScanSpec(lower=key, upper=key + b"\x00",
                        read_ht=self.read_time().value,
                        projection=names, limit=1)
        res = self.engine.scan(spec)
        if not res.rows:
            return None
        return dict(zip(names, res.rows[0]))

    # -- transaction support -------------------------------------------------
    def latest_committed_ht(self, key: bytes) -> int:
        """Newest committed version ht of a row key (0 if none) — the
        first-committer-wins conflict check input."""
        eng = self.engine
        best = 0
        mem = getattr(eng, "memtable", None)
        if mem is not None:
            for v in mem.versions(key):
                best = max(best, v.ht)
        for run in getattr(eng, "runs", []):
            crun = getattr(run, "crun", run)  # TpuRun wraps; CpuRun is flat
            versions = (crun.find_versions(key) if hasattr(crun, "find_versions")
                        else crun.get(key))
            for v in versions:
                best = max(best, v.ht)
        return best

    def compact(self, history_cutoff_ht: int = 0) -> None:
        self.engine.compact(history_cutoff_ht)

    def stats(self) -> dict:
        s = self.engine.stats()
        s.update({
            "tablet_id": self.meta.tablet_id,
            "last_index": self._last_index,
            "applied_index": self._applied_index,
            "flushed_op_index": self.meta.flushed_op_index,
            "wal_segments": len(self.log.segment_paths()),
        })
        return s

    def close(self) -> None:
        self.log.close()
        self.engine.close()

    # -- lifecycle helpers ---------------------------------------------------
    @staticmethod
    def create(meta: TabletMetadata, data_root: str, **kwargs) -> "Tablet":
        tdir = os.path.join(data_root, meta.tablet_id)
        os.makedirs(tdir, exist_ok=True)
        meta.save(os.path.join(tdir, "tablet-meta.json"))
        return Tablet(meta, data_root, **kwargs)

    @staticmethod
    def open(tablet_id: str, data_root: str, **kwargs) -> "Tablet":
        meta = TabletMetadata.load(
            os.path.join(data_root, tablet_id, "tablet-meta.json"))
        return Tablet(meta, data_root, **kwargs)


