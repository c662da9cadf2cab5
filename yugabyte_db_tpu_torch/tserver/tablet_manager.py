"""TSTabletManager: the set of tablet replicas hosted by one node.

Reference analog: src/yb/tserver/ts_tablet_manager.cc — opens every tablet
found on disk at startup (each under <fs_root>/tablet-data/<tablet_id>),
creates/deletes replicas on master request, and routes per-tablet RPCs.

The port's copy of the JAX package's ``tserver/tablet_manager.py``,
whole, remote-bootstrap install included; its replicas are the port's
``TabletPeer``s, and the files it installs are the JAX install's byte
for byte.
"""

from __future__ import annotations

import os
import shutil
import threading

from yugabyte_db_tpu_torch.consensus.raft import RaftOptions
from yugabyte_db_tpu_torch.tablet.tablet import TabletMetadata
from yugabyte_db_tpu_torch.tablet.tablet_peer import TabletPeer


class TabletAlreadyExists(Exception):
    pass


class TabletNotFound(Exception):
    pass


class TSTabletManager:
    def __init__(self, node_uuid: str, fs_root: str, transport,
                 raft_opts: RaftOptions | None = None,
                 engine_options: dict | None = None, fsync: bool = True):
        self.node_uuid = node_uuid
        self.data_root = os.path.join(fs_root, "tablet-data")
        os.makedirs(self.data_root, exist_ok=True)
        self.transport = transport
        self.raft_opts = raft_opts
        self.engine_options = engine_options
        self.fsync = fsync
        self._lock = threading.Lock()
        self._peers: dict[str, TabletPeer] = {}
        # Wired by the TabletServer: called (tablet_id, peer_uuid) when a
        # leader here finds a peer lagging past the log-cache floor.
        self.bootstrap_notifier = None
        self.bootstrap_installs = 0  # observability / tests
        # tablet_ids with a create in flight: reserved atomically under the
        # lock so two concurrent ts.create_tablet RPCs (master dispatch
        # racing the balancer's retry) can never both start a peer on the
        # same WAL directory.
        self._creating: set[str] = set()

    # -- lifecycle ----------------------------------------------------------
    def open_existing(self) -> int:
        """Open every tablet directory found on disk (startup path)."""
        opened = 0
        for tablet_id in sorted(os.listdir(self.data_root)):
            meta_path = os.path.join(self.data_root, tablet_id,
                                     "tablet-meta.json")
            if not os.path.exists(meta_path):
                continue
            meta = TabletMetadata.load(meta_path)
            self._start_peer(meta, initial_peers=[])
            opened += 1
        return opened

    def create_tablet(self, meta: TabletMetadata, peers: list[str]) -> TabletPeer:
        with self._lock:
            if meta.tablet_id in self._peers or \
                    meta.tablet_id in self._creating:
                raise TabletAlreadyExists(meta.tablet_id)
            self._creating.add(meta.tablet_id)
        try:
            tdir = os.path.join(self.data_root, meta.tablet_id)
            os.makedirs(tdir, exist_ok=True)
            meta.save(os.path.join(tdir, "tablet-meta.json"))
            return self._start_peer(meta, peers)
        finally:
            with self._lock:
                self._creating.discard(meta.tablet_id)

    def _start_peer(self, meta: TabletMetadata, initial_peers: list[str]) -> TabletPeer:
        peer = TabletPeer(self.node_uuid, meta, self.data_root,
                          self.transport, initial_peers,
                          engine_options=self.engine_options,
                          fsync=self.fsync, raft_opts=self.raft_opts)
        peer.raft.on_needs_bootstrap = self._notify_bootstrap
        with self._lock:
            self._peers[meta.tablet_id] = peer
        peer.start()
        return peer

    def _notify_bootstrap(self, tablet_id: str, peer_uuid: str) -> None:
        cb = self.bootstrap_notifier
        if cb is not None:
            cb(tablet_id, peer_uuid)

    def install_snapshot(self, tablet_id: str, payload: dict) -> None:
        """Rebuild one tablet from a remote-bootstrap payload: runs +
        sidecars + WAL tail + consensus metadata written to disk, then
        reopened through the NORMAL open path (bootstrap replays the tail
        over the flushed frontier) — reference:
        remote_bootstrap_client.cc installing the downloaded session."""
        from yugabyte_db_tpu_torch.consensus.metadata import (ConsensusMetadata,
                                                        RaftConfig)
        from yugabyte_db_tpu_torch.models.schema import Schema
        from yugabyte_db_tpu_torch.storage import wire
        from yugabyte_db_tpu_torch.storage.run_io import RunPersistence
        from yugabyte_db_tpu_torch.tablet.wal import Log, LogEntry
        from yugabyte_db_tpu_torch.utils import codec

        with self._lock:
            if tablet_id in self._creating:
                return
            self._creating.add(tablet_id)
            peer = self._peers.get(tablet_id)
            # Term fencing: a STALE ex-leader may still believe peers lag
            # and push a snapshot; destroying a healthy replica and
            # regressing its durable term would un-commit acknowledged
            # entries. Only install snapshots from the replica's present
            # or a newer term.
            if peer is not None and \
                    payload["term"] < peer.raft.cmeta.current_term:
                self._creating.discard(tablet_id)
                return
            self._peers.pop(tablet_id, None)
        try:
            if peer is not None:
                peer.shutdown()
            tdir = os.path.join(self.data_root, tablet_id)
            shutil.rmtree(tdir, ignore_errors=True)
            os.makedirs(tdir, exist_ok=True)

            meta = TabletMetadata(
                tablet_id, payload["table_name"],
                Schema.from_dict(payload["schema"]),
                payload["partition_start"], payload["partition_end"],
                payload["engine"], payload["flushed_op_index"],
                payload.get("indexes") or [])
            meta.save(os.path.join(tdir, "tablet-meta.json"))

            entries = [(key, wire.decode_rows(vers))
                       for key, vers in payload["runs"]]
            if entries:
                RunPersistence(os.path.join(tdir, "runs")).save_new(entries)
            from yugabyte_db_tpu_torch.tablet.tablet import Tablet as _Tablet

            _Tablet.install_snapshots(tdir, {
                sid: {"entries": [(k, wire.decode_rows(vers))
                                  for k, vers in blob["entries"]],
                      "meta": blob.get("meta") or {}}
                for sid, blob in (payload.get("snapshots") or {}).items()})
            for name, blob in (("intents.bin", payload.get("intents")),
                               ("retryable.bin", payload.get("retryable"))):
                if blob is not None:
                    with open(os.path.join(tdir, name), "wb") as f:
                        f.write(codec.encode(blob))
            if payload.get("txn_state") is not None:
                import json as _json

                with open(os.path.join(tdir, "txn_state.json"), "w") as f:
                    _json.dump(payload["txn_state"], f)

            log = Log(os.path.join(tdir, "wal"), fsync=self.fsync)
            for rec in payload["log"]:
                log.append(LogEntry.from_record(rec))
            log.sync()
            log.close()

            cmeta = ConsensusMetadata(
                os.path.join(tdir, "consensus-meta.json"), self.node_uuid,
                RaftConfig.from_dict(payload["config"]))
            cmeta.set_term(payload["term"])
            cmeta.flush()
            with self._lock:
                self.bootstrap_installs += 1
            # The peer starts while the tablet id is still reserved, so a
            # racing ts.create_tablet cannot start a second peer on the
            # same WAL directory in the gap.
            self._start_peer(
                TabletMetadata.load(
                    os.path.join(tdir, "tablet-meta.json")),
                initial_peers=[])
        finally:
            with self._lock:
                self._creating.discard(tablet_id)

    def delete_tablet(self, tablet_id: str) -> None:
        with self._lock:
            peer = self._peers.pop(tablet_id, None)
        if peer is not None:
            peer.shutdown()
        tdir = os.path.join(self.data_root, tablet_id)
        if os.path.isdir(tdir):
            shutil.rmtree(tdir)

    def shutdown(self) -> None:
        with self._lock:
            peers = list(self._peers.values())
            self._peers.clear()
        for p in peers:
            p.shutdown()

    # -- access -------------------------------------------------------------
    def get(self, tablet_id: str) -> TabletPeer:
        with self._lock:
            peer = self._peers.get(tablet_id)
        if peer is None:
            raise TabletNotFound(tablet_id)
        return peer

    def peers(self) -> list[TabletPeer]:
        with self._lock:
            return list(self._peers.values())

    def tablet_reports(self) -> list[dict]:
        """Per-tablet state for the master heartbeat (reference:
        TabletReportPB in master.proto)."""
        out = []
        for p in self.peers():
            rs = p.raft.stats()
            out.append({
                "tablet_id": p.tablet_id,
                "table_name": p.tablet.meta.table_name,
                "role": rs["role"],
                "term": rs["term"],
                "leader": rs["leader"],
                "peers": rs["config"]["peers"],
                # index names this replica maintains: the master compares
                # against the catalog and re-pushes ts.set_indexes on
                # mismatch (a lost push must not disable maintenance).
                "index_names": sorted(i["name"]
                                      for i in p.tablet.meta.indexes),
                # Split-manager inputs: on-disk size (WAL segments — a
                # cheap stat that tracks data written) and the raw data-op
                # counter; the master differentiates successive heartbeat
                # samples into the per-tablet op rate.
                "stats": {
                    "size_bytes": self._tablet_size_bytes(p),
                    "ops_seen": p.ops_seen,
                },
            })
        return out

    @staticmethod
    def _tablet_size_bytes(p: TabletPeer) -> int:
        total = 0
        for path in p.tablet.log.segment_paths():
            try:
                total += os.path.getsize(path)
            except OSError:
                pass  # segment GC'd between listing and stat
        return total
