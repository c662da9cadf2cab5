"""TabletPeer: one replica of one tablet — Tablet storage + RaftConsensus.

Reference analog: src/yb/tablet/tablet_peer.{h,cc} — owns the tablet, the
consensus instance and the log; routes writes through the Raft pipeline
(Prepare -> Replicate -> Apply, operations/operation_driver.h:70-95) and
gates reads on leadership + leases.

Read semantics: leader replicas serve reads at the MVCC safe time while
holding the majority-ack lease; follower replicas can serve explicitly
requested stale reads at their last-applied state (the reference's
follower reads are opt-in the same way).

The port's copy of the JAX package's ``tablet/tablet_peer.py``, whole,
over the port's ``Tablet`` (on the ``gpu`` engine by default) and its
``consensus``. ``snapshot_for_bootstrap`` builds the remote-bootstrap
payload; the tablet server installs it on the receiving replica
(``tserver.tablet_manager.TSTabletManager.install_snapshot``).
"""

from __future__ import annotations

import os
import threading

from yugabyte_db_tpu_torch.consensus.metadata import (ConsensusMetadata,
                                                      RaftConfig)
from yugabyte_db_tpu_torch.consensus.raft import (NotLeader, RaftConsensus,
                                                  RaftOptions)
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.utils.trace import TRACE
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
from yugabyte_db_tpu_torch.tablet.tablet import (Tablet, TabletMetadata,
                                                 _encode_rows)
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock, HybridTime
from yugabyte_db_tpu_torch.utils.status import TabletSplit


def _key_hash(key: bytes) -> int:
    """Partition hash of an encoded DocKey: the big-endian uint16 after
    the hash tag byte (models/encoding.py encode_doc_key_prefix).
    Range-partitioned keys (no hash tag) all map to 0 — they live in a
    single full-range tablet and are never split."""
    import struct

    from yugabyte_db_tpu_torch.models.encoding import TAG_HASH
    if len(key) >= 3 and key[0] == TAG_HASH:
        return struct.unpack(">H", key[1:3])[0]
    return 0


class TabletPeer:
    def __init__(self, node_uuid: str, meta: TabletMetadata, data_root: str,
                 transport, initial_peers: list[str],
                 clock: HybridClock | None = None,
                 engine_options: dict | None = None,
                 fsync: bool = True, raft_opts: RaftOptions | None = None):
        self.node_uuid = node_uuid
        self.tablet = Tablet(meta, data_root, clock=clock,
                             engine_options=engine_options, fsync=fsync,
                             consensus_managed=True)
        cmeta = ConsensusMetadata(
            os.path.join(self.tablet.dir, "consensus-meta.json"),
            node_uuid, RaftConfig(list(initial_peers)))
        self.raft = RaftConsensus(
            meta.tablet_id, cmeta, self.tablet.log, transport,
            self.tablet.clock, self._apply, raft_opts,
            initial_applied_index=self.tablet._applied_index,
            preloaded_entries=self.tablet.bootstrap_entries)
        del self.tablet.bootstrap_entries  # one-shot handoff
        self._maintenance_lock = threading.Lock()
        # Serializes conflict-check + intent replication: without it two
        # concurrent writers to the same key both pass the check and both
        # plant intents (the reference holds its SharedLockManager batch
        # across the whole doc-write, shared_lock_manager.h).
        self._intent_lock = threading.Lock()
        # (client_id, request_id) -> (op_id, ht) of an APPENDED but not
        # yet applied write: a racing retry waits on the original entry
        # instead of appending a duplicate (the admission lock no longer
        # spans the majority wait). Two-phase writes (ts.write_admit /
        # ts.write_sync) leave entries registered past apply; admissions
        # purge applied ones lazily (_purge_inflight_rids).
        self._inflight_rids: dict = {}
        # op_id -> pending HybridTime of writes THIS replica admitted
        # into MVCC. Resolution rides the Raft outcome itself: the apply
        # stage calls mvcc.replicated, a log-suffix truncation calls
        # mvcc.aborted — so a pending HT can never leak (no waiter
        # required; clients may disappear after admission).
        self._mvcc_unresolved: dict = {}
        self.raft.on_entries_truncated = self._on_entries_truncated
        # Monotone count of data ops (writes + scans) this replica
        # served — reported raw in the master heartbeat, which turns
        # successive samples into the per-tablet op RATE the split
        # manager and leader balancer feed on. Bumped without a lock
        # (a lost increment only shaves the rate estimate).
        self.ops_seen = 0
        # Set (under _intent_lock) the moment a split seal is being
        # appended: admissions behind the flag bounce with TabletSplit
        # BEFORE entering the log, so every admitted write sits below
        # the seal entry and is captured by the fork snapshot.
        self._split_sealing = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.raft.start()

    def shutdown(self) -> None:
        self.raft.shutdown()
        self.tablet.close()

    @property
    def tablet_id(self) -> str:
        return self.tablet.meta.tablet_id

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    # -- write path ---------------------------------------------------------
    def write(self, rows: list[RowVersion], timeout=10.0,
              client_id: str | None = None,
              request_id: int | None = None) -> HybridTime:
        """Leader-side write: stamp a hybrid time, replicate through Raft,
        return once majority-durable (commit-time ack; apply is pipelined).

        A (client_id, request_id) pair makes the write EXACTLY-ONCE under
        client retries: a replayed id returns the original write's hybrid
        time without re-applying (retryable_requests.h:34). Admission
        (dedup check + stamp + append) and completion (majority wait)
        are split so the tserver's intent-admission lock covers ONLY
        admission — concurrent writes to one tablet pipeline through one
        replication round instead of serializing on full commit latency
        (reference: leader-side batching, src/yb/tablet/preparer.cc).
        Writes also require leader_ready() — an own-term entry applied —
        which guarantees every prior-term entry (including any original
        of a retried id) has already applied into the dedup registry
        before a new leader accepts writes."""
        admitted = self.write_admit(rows, client_id, request_id)
        return self.write_finish(admitted, timeout)

    def write_admit(self, rows: list[RowVersion],
                    client_id: str | None = None,
                    request_id: int | None = None):
        """Admission phase. The CALLER serializes admissions for one
        tablet (the tserver holds the intent-admission lock across this
        call). Returns an opaque token for write_finish."""
        if not (self.raft.is_leader() and self.raft.leader_ready()):
            raise NotLeader(self.node_uuid, self.raft.leader_uuid())
        if self._split_sealing or self.tablet.meta.split_sealed:
            raise TabletSplit(self.tablet_id)
        self._purge_inflight_rids()
        if any(r.increments for r in rows):
            # increments resolve under the tserver's intent-admission
            # lock (the serialization point); reaching here unresolved
            # would silently drop the delta
            raise ValueError("unresolved counter increments; route the "
                             "write through the tserver handler")
        rid = None
        rid_key = None
        if client_id is not None and request_id is not None:
            prev = self.tablet.retryable.seen(client_id, request_id)
            if prev is not None:
                return ("dup", HybridTime(prev))  # replay: original result
            rid_key = (client_id, request_id)
            inflight = self._inflight_rids.get(rid_key)
            if inflight is not None:
                # A retry raced its in-flight original (timeout + resend):
                # wait on the ORIGINAL entry, never append a second copy.
                return ("inflight",) + inflight
            rid = [client_id, request_id]
        ht = self.tablet.clock.now()
        TRACE("write: %d row(s) stamped at ht=%d", len(rows), ht.value)
        stamped = [
            RowVersion(r.key, ht=ht.value, tombstone=r.tombstone,
                       liveness=r.liveness, columns=r.columns,
                       expire_ht=r.resolve_ttl(ht.value), write_id=i)
            for i, r in enumerate(rows)
        ]
        self.tablet.mvcc.add_pending(ht)
        try:
            body = ({"rows": _encode_rows(stamped), "rid": rid}
                    if rid else _encode_rows(stamped))
            entry = self.raft.append_leader(
                "write", body, ht=ht.value, decoded_rows=stamped,
                on_append=lambda e: self._mvcc_unresolved.__setitem__(
                    e.op_id, ht))
            TRACE("write: appended %d.%d", entry.op_id.term,
                  entry.op_id.index)
        except BaseException:
            self.tablet.mvcc.aborted(ht)  # never entered the log
            raise
        if rid_key is not None:
            self._inflight_rids[rid_key] = (entry.op_id, ht)
        return ("appended", entry.op_id, ht, rid_key)

    def write_admit_block(self, block: bytes,
                          client_id: str | None = None,
                          request_id: int | None = None):
        """Admission phase of the native write plane: same contract as
        write_admit, but the batch arrives as an encoded row block
        (storage.rowblock) and is commit-stamped by ONE native pass —
        no per-row Python objects anywhere (reference: the C++
        leader-side batch assembly of src/yb/tablet/preparer.cc). The
        block then rides the WAL body and Raft replication verbatim."""
        from yugabyte_db_tpu_torch.storage import rowblock

        if not (self.raft.is_leader() and self.raft.leader_ready()):
            raise NotLeader(self.node_uuid, self.raft.leader_uuid())
        if self._split_sealing or self.tablet.meta.split_sealed:
            raise TabletSplit(self.tablet_id)
        self._purge_inflight_rids()
        rid = None
        rid_key = None
        if client_id is not None and request_id is not None:
            prev = self.tablet.retryable.seen(client_id, request_id)
            if prev is not None:
                return ("dup", HybridTime(prev))  # replay: original result
            rid_key = (client_id, request_id)
            inflight = self._inflight_rids.get(rid_key)
            if inflight is not None:
                return ("inflight",) + inflight
            rid = [client_id, request_id]
        ht = self.tablet.clock.now()
        TRACE("write: block stamped at ht=%d", ht.value)
        stamped = rowblock.stamp_block(block, ht.value)
        self.tablet.mvcc.add_pending(ht)
        try:
            body = {"rows": stamped, "rid": rid} if rid else stamped
            entry = self.raft.append_leader(
                "write", body, ht=ht.value,
                on_append=lambda e: self._mvcc_unresolved.__setitem__(
                    e.op_id, ht))
        except BaseException:
            self.tablet.mvcc.aborted(ht)  # never entered the log
            raise
        if rid_key is not None:
            self._inflight_rids[rid_key] = (entry.op_id, ht)
        return ("appended", entry.op_id, ht, rid_key)

    def _purge_inflight_rids(self) -> None:
        """Drop in-flight rid entries whose entry has applied (their
        outcome now lives in the durable dedup registry) — two-phase
        writes never pop their own entry. Amortized: only sweeps once
        the registry has accumulated a few entries."""
        if len(self._inflight_rids) <= 8:
            return
        applied = self.raft._applied_index
        for k, (op_id, _ht) in list(self._inflight_rids.items()):
            if op_id.index <= applied:
                self._inflight_rids.pop(k, None)

    def write_finish(self, admitted, timeout=10.0) -> HybridTime:
        """Completion phase: wait for COMMIT (majority-durable), not
        apply — the pipelined-apply ack point. The apply stage drains
        committed entries asynchronously behind the MVCC read fence
        (the pending HT added at admission holds safe time below this
        write until it applies), so an acked-but-unapplied write is
        never visible to a read and never lost (majority-durable WAL
        entries replay on restart). Safe to run OUTSIDE the admission
        lock. MVCC resolution is NOT the waiter's job — the apply stage
        / truncation hooks resolve the pending HT whether or not anyone
        is waiting. ``timeout`` is float seconds or a utils.retry
        Deadline. The rid registration is NOT popped on success: the
        entry may not have reached the durable dedup registry yet (that
        happens at apply) — _purge_inflight_rids sweeps it once
        applied."""
        kind = admitted[0]
        if kind == "dup":
            return admitted[1]
        if kind == "inflight":
            _k, op_id, ht = admitted
            self.raft.wait_committed(op_id, timeout)
            return ht
        _k, op_id, ht, rid_key = admitted
        try:
            self.raft.wait_committed(op_id, timeout)
        except NotLeader:
            if rid_key is not None:
                self._inflight_rids.pop(rid_key, None)
            raise
        return ht

    # -- transaction write path ---------------------------------------------
    def write_intents(self, txn_id: str, status_tablet: str, priority: int,
                      read_ht: int, rows: list[RowVersion],
                      timeout: float = 10.0) -> int:
        """Write provisional rows for a transaction: conflict-check on the
        leader, then replicate an "intents" entry (reference:
        Tablet::AcquireLocksAndPerformDocOperations + the intents write of
        PrepareTransactionWriteBatch, src/yb/docdb/docdb.h:169). Raises
        txn.participant.IntentConflict on conflict.

        Returns the entry's hybrid time. The caller MUST propagate it to
        the transaction's commit request: the coordinator ratchets its
        clock past every intent write before choosing commit_ht, so a
        pinned read that advanced this tablet's clock (and therefore this
        entry's ht) past its read time can never be overtaken by the
        commit (the HLC-propagation half of the safe-time contract)."""
        if not (self.raft.is_leader() and self.raft.leader_ready()):
            raise NotLeader(self.node_uuid, self.raft.leader_uuid())
        from yugabyte_db_tpu_torch.storage.wire import encode_rows
        with self._intent_lock:
            self.tablet.participant.check_conflicts(
                txn_id, [r.key for r in rows], read_ht,
                self.tablet.latest_committed_ht)
            body = {
                "txn_id": txn_id, "status_tablet": status_tablet,
                "priority": priority, "read_ht": read_ht,
                "rows": encode_rows(rows),
            }
            # Tracked in MVCC like a write: a pinned read below this
            # entry's ht must wait for the apply, or it would miss the
            # intents entirely (they'd land after its intent-gate check).
            # Justified hold: conflict check and log position must be
            # atomic — two conflicting transactions checked against the
            # same intent table could otherwise both replicate. Same
            # shape as the reference's intent-admission serialization.
            return self.replicate_txn_op("intents", body, timeout,
                                         track_mvcc=True)

    def alter_schema(self, new_schema, timeout: float = 10.0) -> None:
        """Replicate a schema change through this tablet's Raft log so
        every replica adopts it at the same log position (reference:
        AlterSchema as a ChangeMetadataOperation through consensus)."""
        self.replicate_txn_op("alter_schema",
                              {"schema": new_schema.to_dict()}, timeout)

    def replicate_txn_op(self, op_type: str, body: dict,
                         timeout: float = 10.0, ht: int | None = None,
                         track_mvcc: bool = False) -> int:
        """Replicate one transaction op through this tablet's Raft log and
        wait until applied locally. Returns the entry hybrid time."""
        if not self.raft.is_leader():
            raise NotLeader(self.node_uuid, self.raft.leader_uuid())
        if ht is None:
            ht = self.tablet.clock.now().value
        hto = HybridTime(ht)
        if track_mvcc:
            self.tablet.mvcc.add_pending(hto)
            on_append = lambda e: self._mvcc_unresolved.__setitem__(  # noqa: E731
                e.op_id, hto)
        else:
            on_append = None
        try:
            entry = self.raft.append_leader(op_type, body, ht=ht,
                                            on_append=on_append)
        except BaseException:
            if track_mvcc:
                self.tablet.mvcc.aborted(hto)
            raise
        self.raft.wait_applied(entry.op_id, timeout)
        return ht

    def _apply(self, entry) -> None:
        self.tablet.apply_replicated(entry)
        # Resolve the MVCC pending of a write this replica admitted —
        # AFTER the apply, so a reader released by the advancing safe
        # time always sees the applied rows.
        ht = self._mvcc_unresolved.pop(entry.op_id, None)
        if ht is not None:
            self.tablet.mvcc.replicated(ht)

    def _on_entries_truncated(self, entries) -> None:
        """A truncated suffix is a definite abort for every entry this
        replica admitted: release their MVCC pendings and drop their
        in-flight rid registrations (a retry must re-append)."""
        dropped_ids = set()
        for e in entries:
            dropped_ids.add(e.op_id)
            ht = self._mvcc_unresolved.pop(e.op_id, None)
            if ht is not None:
                self.tablet.mvcc.aborted(ht)
        if self._inflight_rids:
            for k, (op_id, _ht) in list(self._inflight_rids.items()):
                if op_id in dropped_ids:
                    self._inflight_rids.pop(k, None)

    # -- read path ----------------------------------------------------------
    def read_time(self) -> HybridTime:
        return self.tablet.mvcc.safe_time()

    def scan(self, spec: ScanSpec, allow_stale: bool = False,
             deadline=None) -> ScanResult:
        """Serve a scan. Leader-with-lease only, unless the caller opted
        into stale follower reads. ``deadline`` is the RPC edge's
        propagated budget (utils.retry.Deadline)."""
        if not allow_stale:
            if not self.raft.is_leader():
                raise NotLeader(self.node_uuid, self.raft.leader_uuid())
            if not self.raft.has_lease():
                raise NotLeader(self.node_uuid, None)
        TRACE("scan: read_ht=%d", spec.read_ht)
        res = self.tablet.scan(spec, deadline=deadline)
        TRACE("scan: %d row(s), %d scanned", len(res.rows),
              res.rows_scanned)
        return res

    def scan_wire(self, spec: ScanSpec, fmt: str = "cql",
                  allow_stale: bool = False, deadline=None):
        """Wire-serialized scan (leader-with-lease gate as scan)."""
        if not allow_stale:
            if not self.raft.is_leader():
                raise NotLeader(self.node_uuid, self.raft.leader_uuid())
            if not self.raft.has_lease():
                raise NotLeader(self.node_uuid, None)
        return self.tablet.scan_wire(spec, fmt, deadline=deadline)

    def scan_many(self, specs, allow_stale: bool = False, deadline=None):
        """Batched scans under ONE leader-with-lease gate (the
        multi-key read RPC)."""
        if not allow_stale:
            if not self.raft.is_leader():
                raise NotLeader(self.node_uuid, self.raft.leader_uuid())
            if not self.raft.has_lease():
                raise NotLeader(self.node_uuid, None)
        return self.tablet.scan_many(specs, deadline=deadline)

    def scan_wire_many(self, specs, fmt: str = "cql",
                       allow_stale: bool = False, deadline=None):
        """Batched wire-serialized scans under ONE leader-with-lease
        gate (the native request-batch serving path's read RPC)."""
        if not allow_stale:
            if not self.raft.is_leader():
                raise NotLeader(self.node_uuid, self.raft.leader_uuid())
            if not self.raft.has_lease():
                raise NotLeader(self.node_uuid, None)
        return self.tablet.scan_wire_many(specs, fmt, deadline=deadline)

    def point_serve(self, keys, read_ht: int, col_id: int,
                    allow_stale: bool = False):
        """Batched native point-value serve under one leader-with-lease
        gate. None when the tablet cannot answer natively."""
        if not allow_stale:
            if not self.raft.is_leader():
                raise NotLeader(self.node_uuid, self.raft.leader_uuid())
            if not self.raft.has_lease():
                raise NotLeader(self.node_uuid, None)
        return self.tablet.point_serve(keys, read_ht, col_id)

    # -- maintenance --------------------------------------------------------
    def flush(self) -> None:
        with self._maintenance_lock:
            # Pipelined apply: a write is acked at commit, so drain the
            # apply stage first or the flush could capture a memtable
            # missing acked rows (and advance no frontier for them).
            self.raft.wait_apply_drained()
            self.tablet.flush()
            # Everything at/below the flushed frontier is durable in the
            # engine's runs: bound the in-memory Raft entry cache too.
            # Lagging peers past the eviction floor are re-seeded via
            # remote bootstrap.
            self.raft.evict_cache(self.tablet.meta.flushed_op_index)

    def snapshot_for_bootstrap(self) -> dict:
        """Consistent remote-bootstrap payload pieces: flush, dump the
        runs, and capture the log tail under ONE maintenance-lock hold —
        a concurrent flush between the dump and the tail capture would
        otherwise evict entries out of both."""
        with self._maintenance_lock:
            self.raft.wait_apply_drained()
            self.tablet.flush()
            self.raft.evict_cache(self.tablet.meta.flushed_op_index)
            entries = self.tablet.engine.dump_entries()
            tail = self.raft.log_tail_snapshot()
            flushed = self.tablet.meta.flushed_op_index
        return {"entries": entries, "tail": tail,
                "flushed_op_index": flushed}

    # -- tablet splitting ----------------------------------------------------
    def split_key_hash(self) -> int | None:
        """The partition hash of this tablet's median RESIDENT key —
        the split point a size/load-triggered split divides the range
        at (reference: the mid-key the reference asks the largest SST
        for in TabletServiceAdminImpl::GetSplitKey). Flushes first so
        the memtable is counted. None when the resident keys span
        fewer than two distinct hash codes (nothing to divide)."""
        with self._maintenance_lock:
            self.raft.wait_apply_drained()
            self.tablet.flush()
            entries = self.tablet.engine.dump_entries()
        hashes = sorted({_key_hash(key) for key, _vers in entries})
        if len(hashes) < 2:
            return None
        # Split ABOVE the median hash: keys at the median stay in the
        # low child, so both children are non-empty by construction.
        return hashes[len(hashes) // 2]

    def split_seal(self, timeout=10.0) -> None:
        """Seal this tablet for a split: replicate a ``split_seal``
        entry through its own Raft log. The sealing flag flips under
        the intent-admission lock BEFORE the append, so every admitted
        write sits at a lower log index than the seal — once the seal
        entry applies (in order, behind them all), the tablet's state
        is the complete frozen prefix the children are forked from.
        Idempotent; leader-only."""
        if not (self.raft.is_leader() and self.raft.leader_ready()):
            raise NotLeader(self.node_uuid, self.raft.leader_uuid())
        with self._intent_lock:
            if self.tablet.meta.split_sealed:
                return
            self._split_sealing = True
        try:
            self.replicate_txn_op("split_seal", {}, timeout)
        except BaseException:
            # Replication failed (leader change / timeout): don't leave
            # this replica wedged rejecting writes for a seal that may
            # never commit — the flag re-arms if the master retries here.
            with self._intent_lock:
                if not self.tablet.meta.split_sealed:
                    self._split_sealing = False
            raise

    def split_fork_rows(self, lower: int, upper: int) -> list:
        """Range-clamped frozen rows of a SEALED parent: every
        (key, versions) entry whose partition hash falls in
        [lower, upper), tombstones and all — the seed payload for one
        child. The seal already froze the log, so after the apply
        drain + flush the dump is the tablet's final state."""
        if not self.tablet.meta.split_sealed:
            raise RuntimeError(
                f"tablet {self.tablet_id} is not sealed for split")
        with self._maintenance_lock:
            self.raft.wait_apply_drained()
            self.tablet.flush()
            entries = self.tablet.engine.dump_entries()
        return [(key, vers) for key, vers in entries
                if lower <= _key_hash(key) < upper]

    def split_seed(self, rows: list[RowVersion], timeout=10.0,
                   chunk: int = 1024) -> int:
        """Seed a CHILD tablet from its parent's forked rows: the child
        LEADER replicates ordinary ``write`` entries through the
        child's OWN Raft log (chunked), so every child replica builds
        the identical seeded state from the log — seeding each replica
        from its local parent copy would diverge, the replicas sit at
        different apply points. Rows keep their original hybrid times
        (the bodies are encoded pre-stamped), so MVCC visibility,
        TTL expiry and tombstone ordering match the parent exactly."""
        n = 0
        for i in range(0, len(rows), chunk):
            batch = rows[i:i + chunk]
            self.replicate_txn_op("write", _encode_rows(batch), timeout,
                                  track_mvcc=True)
            n += len(batch)
        return n

    def compact(self, history_cutoff_ht: int = 0) -> None:
        with self._maintenance_lock:
            self.tablet.compact(history_cutoff_ht)

    def stats(self) -> dict:
        s = self.tablet.stats()
        s["raft"] = self.raft.stats()
        return s
