"""TabletServer: the data-node daemon and its RPC service.

Reference analog: src/yb/tserver/tablet_server.cc (the daemon) +
tablet_service.cc (TabletServiceImpl::Write at :718, ::Read at :1001 — the
leader checks, tablet lookup, and the NOT_THE_LEADER error protocol that
drives client failover) + the consensus service routing per-tablet RPCs.

Service responses carry {"code": "ok"| "not_leader" | "not_found" | ...};
NOT_LEADER responses include the best leader hint, which the client's
MetaCache uses to re-route (the reference's TabletInvoker contract).

The port's copy of the JAX package's ``tserver/tablet_server.py``, whole,
on the port's tablets (the ``gpu`` engine). Two answers differ from the
JAX server's: ``ts.create_tablet``'s engine defaults to ``"gpu"`` (the
JAX default ``"cpu"`` is not registered in the port), and
``ts.redis_read_batch`` always replies ``{"fallback": True}`` (the port's
``point_serve`` answers None: the native memtable it reads is ROADMAP.md
§1 item 16). ``ts.multi_agg_scan`` / ``ts.multi_row_scan`` are served by
the port's ``MeshScanService`` (``tserver/mesh_scan.py``) on the mesh of
the server's cards, and reply ``{"code": "ineligible"}`` where the JAX
service does.
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.consensus.raft import NotLeader, RaftOptions
from yugabyte_db_tpu_torch.consensus.transport import send_with_retry
from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.storage import wire
from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec
from yugabyte_db_tpu_torch.tablet.tablet import TabletMetadata
from yugabyte_db_tpu_torch.tserver.heartbeater import Heartbeater
from yugabyte_db_tpu_torch.tserver.tablet_manager import (TabletNotFound,
                                                    TSTabletManager)
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.retry import Deadline, DeadlineExpired
from yugabyte_db_tpu_torch.utils.status import TabletSplit
from yugabyte_db_tpu_torch.utils.trace import TRACE, RpczStore, trace_request


class TabletServer:
    def __init__(self, uuid: str, fs_root: str, transport,
                 master_uuids: list[str],
                 raft_opts: RaftOptions | None = None,
                 engine_options: dict | None = None,
                 fsync: bool = True,
                 heartbeat_interval_s: float = 0.5,
                 advertised_addr=None, options=None, cloud_info=None):
        # Structured options (server.options.TabletServerOptions) override
        # the loose kwargs when provided (reference:
        # TabletServerOptions over gflags, server_base_options.h).
        if options is not None:
            fsync = options.fsync
            heartbeat_interval_s = options.heartbeat_interval_s
            engine_options = options.engine_options or engine_options
            cloud_info = getattr(options, "cloud_info", None) or cloud_info
        self.options = options
        self.uuid = uuid
        self.transport = transport
        self.advertised_addr = advertised_addr  # (host, port) when on TCP
        self.cloud_info = cloud_info or {}  # zone-aware placement labels
        # Data-dir identity: formats on first open, refuses a directory
        # owned by another server (reference: FsManager::Open,
        # src/yb/fs/fs_manager.cc).
        from yugabyte_db_tpu_torch import fs as _fs

        self.instance = _fs.format_or_open(fs_root, uuid)
        self.tablet_manager = TSTabletManager(
            uuid, fs_root, transport, raft_opts=raft_opts,
            engine_options=engine_options, fsync=fsync)
        self.heartbeater = Heartbeater(self, master_uuids,
                                       interval_s=heartbeat_interval_s)
        from yugabyte_db_tpu_torch.tserver.mesh_scan import MeshScanService
        from yugabyte_db_tpu_torch.tserver.txn_service import (TxnNotifier,
                                                         TxnRpcRouter)

        import threading as _threading

        self.mesh_scan = MeshScanService()
        self.txn_router = TxnRpcRouter(transport, master_uuids)
        self.txn_notifier = TxnNotifier(self, self.txn_router)
        self._rb_lock = _threading.Lock()
        self._rpc_lock = _threading.Lock()
        self._rb_in_flight: set[str] = set()
        # Observability: per-RPC counters/latency + per-tablet gauges
        # (reference: the protoc-gen-yrpc per-RPC metrics and
        # tablet_metrics.cc), scraped via the embedded webserver.
        from yugabyte_db_tpu_torch.utils.metrics import MetricRegistry

        self.metrics = MetricRegistry()
        self._rpc_entities: dict = {}
        self._tablet_entities: dict = {}
        self._collect_lock = _threading.Lock()
        self.metrics.add_collector(self._collect_tablet_metrics)
        self.webserver = None
        self.rpcz = RpczStore()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.tablet_manager.bootstrap_notifier = \
            self._request_remote_bootstrap
        self.tablet_manager.open_existing()
        self.heartbeater.start()
        self.txn_notifier.start()
        if self.options is not None and self.options.webserver:
            self.start_webserver(self.options.webserver_host,
                                 self.options.webserver_port)

    def shutdown(self) -> None:
        if self.webserver is not None:
            self.webserver.stop()
        self.txn_notifier.stop()
        self.heartbeater.stop()
        self.tablet_manager.shutdown()

    def process_heartbeat_response(self, resp: dict) -> None:
        for tablet_id in resp.get("tablets_to_delete", []):
            try:
                self.tablet_manager.delete_tablet(tablet_id)
            except Exception as e:  # noqa: BLE001 — retried next beat
                count_swallowed("tserver.delete_tablet", e)

    def start_webserver(self, host: str = "127.0.0.1", port: int = 0):
        """Expose /metrics, /varz, /healthz, /tablets over HTTP
        (reference: RpcAndWebServerBase, tserver-path-handlers.cc)."""
        from yugabyte_db_tpu_torch.server.webserver import Webserver

        self.webserver = Webserver(self.metrics, f"tserver-{self.uuid}")

        def _tablet_rows():
            # the ONE row builder: JSON API and HTML dashboard agree
            return [
                {"tablet_id": p.tablet_id,
                 "table": p.tablet.meta.table_name,
                 "role": "leader" if p.is_leader() else "follower",
                 "schema_version": p.tablet.meta.schema.version,
                 **{k: v for k, v in p.stats().items()
                    if not isinstance(v, dict)}}
                for p in self.tablet_manager.peers()]

        self.webserver.add_json_handler("/tablets", _tablet_rows)
        self.webserver.add_json_handler("/rpcz", self.rpcz.dump)
        self.webserver.add_dashboard("/dashboards/tablets", "Tablets",
                                     _tablet_rows)

        def _hbm_device_rows():
            # Per-device residency: /memz's hbm_cache.by_device as a
            # table, one row per mesh device (the labeled-gauge twin).
            from yugabyte_db_tpu_torch.storage.residency import hbm_cache

            stats = hbm_cache().stats()
            return [
                {"device": dev,
                 "resident_bytes": d["resident_bytes"],
                 "budget_bytes": d["budget_bytes"],
                 "pinned_bytes": d["pinned_bytes"],
                 "entries": d["entries"],
                 "utilization": (round(d["resident_bytes"]
                                       / d["budget_bytes"], 3)
                                 if d["budget_bytes"] else None)}
                for dev, d in sorted(stats["by_device"].items())]

        self.webserver.add_json_handler("/hbm-devices", _hbm_device_rows)
        self.webserver.add_dashboard("/dashboards/hbm-devices",
                                     "HBM devices", _hbm_device_rows)
        return self.webserver.start(host, port)

    def _rpc_entity(self, method: str):
        ent = self._rpc_entities.get(method)
        if ent is None:
            with self._rpc_lock:
                ent = self._rpc_entities.get(method)
                if ent is None:
                    ent = self.metrics.entity(daemon="tserver",
                                              uuid=self.uuid,
                                              method=method)
                    self._rpc_entities[method] = ent
        return ent

    def _collect_tablet_metrics(self) -> None:
        """Pre-scrape sync of per-tablet gauge entities with live peers.
        Serialized (concurrent scrapes would race entity registration)
        and snapshot-style: each tablet's stats dicts are built ONCE and
        the plain values stored, instead of callback fan-out re-taking
        the consensus lock per gauge."""
        with self._collect_lock:
            live = {p.tablet_id: p for p in self.tablet_manager.peers()}
            for tid in list(self._tablet_entities):
                if tid not in live:
                    self.metrics.remove_entity(
                        self._tablet_entities.pop(tid))
            for tid, peer in live.items():
                ent = self._tablet_entities.get(tid)
                if ent is None:
                    ent = self.metrics.entity(
                        daemon="tserver", uuid=self.uuid, tablet_id=tid)
                    self._tablet_entities[tid] = ent
                rs = peer.raft.stats()
                es = peer.tablet.engine.stats()
                ent.gauge("tablet_is_leader").set(
                    int(rs["role"] == "LEADER"))
                ent.gauge("tablet_last_index").set(rs["last_index"])
                ent.gauge("tablet_commit_index").set(rs["commit_index"])
                # Pipelined-apply backlog: entries acked at commit but
                # not yet applied into the engine. Nonzero transiently;
                # stuck-nonzero means the apply stage stalled.
                ent.gauge("yb_apply_lag_ops").set(
                    max(0, rs["commit_index"] - rs["applied_index"]))
                ent.gauge("tablet_run_versions").set(
                    es.get("run_versions", 0))
                ent.gauge("tablet_memtable_versions").set(
                    es.get("memtable_versions", 0))
                ent.gauge("tablet_num_runs").set(es.get("num_runs", 0))
                ent.gauge("tablet_intent_txns").set(
                    peer.tablet.participant.stats()["txns_with_intents"])

    # -- rpc dispatch --------------------------------------------------------
    def handle(self, method: str, payload: dict):
        import time as _time

        start = _time.monotonic()
        with trace_request(method) as t:
            try:
                return self._dispatch(method, payload)
            except TabletSplit as e:
                # The addressed tablet is sealed for (or replaced by) a
                # split: tell the client to invalidate exactly this
                # location entry and re-plan (tserver_error.h
                # TABLET_SPLIT). Raised by the admission seal gate, so
                # every write path funnels here.
                return {"code": "tablet_split", "tablet_id": e.tablet_id}
            finally:
                ent = self._rpc_entity(method)
                ent.counter("rpc_requests_total").increment()
                ent.histogram("rpc_latency_us").observe_duration_us(start)
                t.finish()  # duration must be final before sampling
                self.rpcz.record(t)

    def _dispatch(self, method: str, payload: dict):
        if method.startswith("raft."):
            try:
                peer = self.tablet_manager.get(payload["tablet_id"])
            except TabletNotFound:
                return {"code": "not_found", "term": 0, "granted": False,
                        "success": False, "last_index": 0}
            return peer.raft.handle(method, payload)
        handler = getattr(self, "_h_" + method.replace(".", "_"), None)
        if handler is None:
            raise ValueError(f"unknown method {method}")
        return handler(payload)

    # -- service handlers ----------------------------------------------------
    def _h_ts_create_tablet(self, p: dict):
        meta = TabletMetadata(
            p["tablet_id"], p["table_name"], Schema.from_dict(p["schema"]),
            p["partition_start"], p["partition_end"],
            p.get("engine", "gpu"), indexes=p.get("indexes") or [])
        try:
            self.tablet_manager.create_tablet(meta, p["peers"])
        except Exception as e:  # includes TabletAlreadyExists (idempotent)
            if "TabletAlreadyExists" not in type(e).__name__:
                raise
        self.heartbeater.trigger()
        return {"code": "ok"}

    def _h_ts_delete_tablet(self, p: dict):
        self.tablet_manager.delete_tablet(p["tablet_id"])
        return {"code": "ok"}

    # -- tablet splitting -----------------------------------------------------
    def _h_ts_get_split_key(self, p: dict):
        """Split phase 1: the master asks the parent leader for its
        split point — the median resident key hash (reference:
        TabletServiceAdminImpl::GetSplitKey). Refused when the tablet
        has no interior point (fewer than two distinct hashes, or the
        median collides with a partition bound)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if not (peer.raft.is_leader() and peer.raft.leader_ready()):
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        h = peer.split_key_hash()
        lo = peer.tablet.meta.partition_start
        hi = peer.tablet.meta.partition_end
        if h is None or not (lo < h < hi):
            return {"code": "error",
                    "message": "tablet has no interior split point"}
        return {"code": "ok", "split_hash": h}

    def _h_ts_split_seal(self, p: dict):
        """Split phase 4: stop admitting writes on the parent by
        replicating a split_seal entry through its own Raft log — every
        admitted write sits below the seal, so seal-applied implies all
        prior writes applied on this replica."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        try:
            peer.split_seal(timeout=float(p.get("timeout", 10.0)))
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            return {"code": "timed_out"}
        return {"code": "ok"}

    def _h_ts_split_fork(self, p: dict):
        """Split phase 5a: ship the sealed parent's frozen rows clamped
        to one child's hash range [lower, upper)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if not (peer.raft.is_leader() and peer.raft.leader_ready()):
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        try:
            entries = peer.split_fork_rows(p["lower"], p["upper"])
        except RuntimeError as e:
            return {"code": "error", "message": str(e)}
        return {"code": "ok",
                "rows": [[key, wire.encode_rows(vers)]
                         for key, vers in entries]}

    def _h_ts_split_seed(self, p: dict):
        """Split phase 5b: replicate the forked rows through the CHILD
        leader's Raft log as ordinary write entries carrying the
        original row hybrid times — every child replica converges on
        byte-identical state (per-replica local forking would
        diverge)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        rows = [v for _key, vers in p["rows"]
                for v in wire.decode_rows(vers)]
        try:
            n = peer.split_seed(rows,
                                timeout=float(p.get("timeout", 30.0)))
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            return {"code": "timed_out"}
        return {"code": "ok", "seeded": n}

    # -- remote bootstrap -----------------------------------------------------
    def _request_remote_bootstrap(self, tablet_id: str,
                                  peer_uuid: str) -> None:
        """Leader side: tell a lagging peer to re-seed itself from us
        (reference: the StartRemoteBootstrap RPC the leader's consensus
        queue fires, consensus_queue.cc -> remote_bootstrap_service.cc)."""
        try:
            resp = send_with_retry(self.transport, peer_uuid,
                                   "ts.start_remote_bootstrap",
                                   {"tablet_id": tablet_id,
                                    "source": self.uuid}, timeout_s=5.0)
            if resp.get("code") != "ok":
                count_swallowed("tserver.remote_bootstrap", resp.get("code"))
        except Exception as e:  # noqa: BLE001 — retried by the next trigger
            count_swallowed("tserver.remote_bootstrap", e)

    def _h_ts_start_remote_bootstrap(self, p: dict):
        import threading as _threading

        tid = p["tablet_id"]
        with self._rb_lock:
            if tid in self._rb_in_flight:
                return {"code": "ok", "detail": "already running"}
            self._rb_in_flight.add(tid)

        def run():
            try:
                resp = self.transport.send(
                    p["source"], "ts.rb_snapshot", {"tablet_id": tid},
                    timeout=60.0)
                if resp.get("code") == "ok":
                    self.tablet_manager.install_snapshot(tid,
                                                         resp["payload"])
            except Exception:  # noqa: BLE001 — leader re-triggers
                import logging

                logging.getLogger(__name__).exception(
                    "remote bootstrap of %s from %s failed", tid,
                    p["source"])
            finally:
                with self._rb_lock:
                    self._rb_in_flight.discard(tid)

        _threading.Thread(target=run, daemon=True,
                          name=f"rb-{tid[:12]}").start()
        return {"code": "ok"}

    def _h_ts_rb_snapshot(self, p: dict):
        """Source side of a remote-bootstrap session: flush (so the runs
        capture everything and the log tail is short), then ship runs +
        sidecars + log tail + consensus metadata
        (remote_bootstrap_session.cc)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if not (peer.raft.is_leader() and peer.raft.leader_ready()):
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        snap = peer.snapshot_for_bootstrap()
        t = peer.tablet
        payload = {
            "table_name": t.meta.table_name,
            "schema": t.meta.schema.to_dict(),
            "partition_start": t.meta.partition_start,
            "partition_end": t.meta.partition_end,
            "engine": t.meta.engine,
            "flushed_op_index": snap["flushed_op_index"],
            "indexes": t.meta.indexes,
            "runs": [[key, wire.encode_rows(vers)]
                     for key, vers in snap["entries"]],
            "intents": t.participant.dump(),
            "retryable": t.retryable.dump(),
            "txn_state": (t.coordinator.dump()
                          if t.coordinator is not None else None),
            "snapshots": {
                sid: {"entries": [[k, wire.encode_rows(vers)]
                                  for k, vers in blob["entries"]],
                      "meta": blob["meta"]}
                for sid, blob in t.dump_snapshots().items()},
        }
        payload.update(snap["tail"])
        return {"code": "ok", "payload": payload}

    def _h_ts_snapshot_op(self, p: dict):
        """Replicated tablet snapshot ops (reference: backup.proto
        TabletSnapshotOp CREATE/RESTORE/DELETE). Each replica captures /
        restores its own local snapshot at the same log position."""
        op = p.get("op")
        if op not in ("create_snapshot", "restore_snapshot",
                      "delete_snapshot"):
            return {"code": "error", "message": f"bad snapshot op {op!r}"}
        sid = p.get("snapshot_id") or ""
        if not sid or "/" in sid or "\\" in sid or sid.startswith(".") \
                or sid.endswith(".tmp"):
            # validated BEFORE replicating: a bad id raising inside the
            # apply stage would wedge every replica's apply thread
            return {"code": "error",
                    "message": f"bad snapshot id {sid!r}"}
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if not peer.raft.is_leader():
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        if op == "restore_snapshot" and \
                p["snapshot_id"] not in peer.tablet.list_snapshots():
            # validated BEFORE replicating: the apply stage must never
            # fail (an apply exception would wedge the tablet)
            return {"code": "error",
                    "message": f"snapshot {p['snapshot_id']} not found"}
        try:
            peer.replicate_txn_op(op, {"snapshot_id": p["snapshot_id"]})
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            return {"code": "timed_out"}
        except Exception as e:  # noqa: BLE001 (e.g. snapshot not found)
            return {"code": "error", "message": str(e)}
        return {"code": "ok"}

    def _h_ts_list_snapshots(self, p: dict):
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        # Leader-gated: a lagging follower hasn't applied the latest
        # snapshot ops and would list a stale set.
        if not peer.raft.is_leader():
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        return {"code": "ok",
                "snapshots": peer.tablet.list_snapshots()}

    def _h_ts_alter_schema(self, p: dict):
        """Adopt a new table schema on one tablet: the LEADER replicates
        it through the tablet's Raft log so every replica switches at the
        same log position (reference: the AlterSchema tablet op the
        master's async AlterTable task invokes)."""
        from yugabyte_db_tpu_torch.models.schema import Schema

        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        new_schema = Schema.from_dict(p["schema"])
        if new_schema.version <= peer.tablet.meta.schema.version:
            return {"code": "ok"}  # already adopted (idempotent retry)
        if not peer.raft.is_leader():
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        try:
            peer.alter_schema(new_schema)
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            return {"code": "timed_out"}
        return {"code": "ok"}

    def _h_ts_set_indexes(self, p: dict):
        """Install the base table's current index set on one tablet (the
        master pushes this after CREATE INDEX)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        peer.tablet.meta.indexes = list(p["indexes"])
        peer.tablet.meta.save(peer.tablet.meta_path)
        return {"code": "ok"}

    def _maintain_indexes(self, peer, rows,
                          insert_only: bool = False) -> dict | None:
        """Leader-side secondary-index maintenance for a base write
        (reference: Tablet::UpdateQLIndexes, tablet.cc:1015). Index
        entries are written FIRST: on a mid-flight failure the index may
        temporarily hold extra entries (lookups verify against the base
        row) but never misses one. Returns an error dict or None.

        ``insert_only`` (conditional INSERTs): the row must not exist,
        so maintenance treats the old state as absent — no tombstones
        are emitted. A later duplicate_key rejection then leaves at most
        a stale (base-verified-away) extra entry, never a removed one."""
        from yugabyte_db_tpu_torch.index import index_mutations, normalize_index
        from yugabyte_db_tpu_torch.models.encoding import decode_doc_key

        schema = peer.tablet.meta.schema
        key_names = [c.name for c in schema.key_columns]
        indexed_cids = set()
        for i in peer.tablet.meta.indexes:
            ni = normalize_index(i)
            for cname in ni["columns"] + ni["include"]:
                indexed_cids.add(schema.column(cname).col_id)
        for row in rows:
            # Writes that can't change any indexed value skip the old-row
            # read entirely (the hot non-indexed-update path).
            if not row.tombstone and not (indexed_cids & row.columns.keys()):
                continue
            _, hashed, ranges = decode_doc_key(row.key)
            base_kv = dict(zip(key_names, hashed + ranges))
            old = None if insert_only else \
                peer.tablet.current_row_values(row.key)
            for itable, _ischema, hc, rv in index_mutations(
                    schema, peer.tablet.meta.indexes, base_kv, old, row):
                loc = self._locate_by_hash(itable, hc)
                if loc is None:
                    return {"code": "error",
                            "message": f"cannot locate index {itable}"}
                resp = self.txn_router.tablet_rpc(
                    loc["tablet_id"], "ts.write",
                    {"rows": wire.encode_rows([rv])},
                    hint=loc.get("leader"))
                if resp is None or resp.get("code") != "ok":
                    return {"code": "error",
                            "message": f"index write failed: {resp}"}
        return None

    def _locate_by_hash(self, table_name: str, hash_code: int) -> dict | None:
        """Tablet of ``table_name`` owning ``hash_code`` (master lookup,
        briefly cached)."""
        import time as _time

        cached = getattr(self, "_tbl_loc_cache", None)
        if cached is None:
            cached = self._tbl_loc_cache = {}
        ent = cached.get(table_name)
        if ent is None or _time.monotonic() - ent[1] > 5.0:
            resp = None
            targets = list(self.heartbeater.master_uuids)
            for target in targets:
                try:
                    resp = self.transport.send(
                        target, "master.get_table_locations",
                        {"name": table_name}, timeout=2.0)
                except Exception as e:  # noqa: BLE001 — try next master
                    count_swallowed("tserver.get_table_locations", e)
                    continue
                if resp.get("code") == "not_leader":
                    hint = resp.get("leader_hint")
                    if hint and hint not in targets:
                        targets.append(hint)
                    continue
                break
            if resp is None or resp.get("code") != "ok":
                return None
            ent = (resp["tablets"], _time.monotonic())
            cached[table_name] = ent
        for t in ent[0]:
            if t["partition_start"] <= hash_code < t["partition_end"]:
                return t
        return ent[0][-1] if ent[0] else None

    def _h_ts_write(self, p: dict):
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        # ONE deadline for the whole write RPC: admission backpressure,
        # the commit wait, and any retry rounds debit the same budget.
        deadline = Deadline.after(float(p.get("timeout", 10.0)))
        peer.ops_seen += 1  # split-manager load signal
        if p.get("propagated_ht"):
            from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime as _HT

            peer.tablet.clock.update(_HT(p["propagated_ht"]))
        payload = p["rows"]
        if isinstance(payload, (bytes, bytearray)):
            # Native write plane: the batch is an encoded row block
            # (storage.rowblock) — admit it without materializing rows.
            # The session only packs plain blind writes into blocks, so
            # the slow machinery (conditionals, counters) can't be
            # needed; tablets with secondary indexes or any pending
            # transaction intents drop to the row path below (the
            # intent lock spans the emptiness check + admission, so an
            # intent admitted concurrently can't be missed).
            from yugabyte_db_tpu_torch.storage import rowblock

            fast = (not peer.tablet.meta.indexes
                    and not p.get("if_not_exists"))
            admitted = None
            if fast:
                with peer._intent_lock:
                    if not peer.tablet.participant.txns:
                        try:
                            admitted = peer.write_admit_block(
                                payload, client_id=p.get("client_id"),
                                request_id=p.get("request_id"))
                        except NotLeader as e:
                            return {"code": "not_leader",
                                    "leader_hint": e.leader_hint}
            if admitted is not None:
                try:
                    ht = peer.write_finish(admitted, timeout=deadline)
                except NotLeader as e:
                    return {"code": "not_leader",
                            "leader_hint": e.leader_hint}
                except TimeoutError:
                    return {"code": "timed_out"}
                return self._write_ok(ht)
            rows = rowblock.rows_from_block(payload)
        else:
            rows = wire.decode_rows(payload)
        # Non-transactional writes still resolve against pending intents:
        # they act as a highest-priority writer and wound any pending txn
        # holding intents on these keys (reference: single-row operations
        # go through the same conflict resolution). The check and the
        # write happen under the intent-admission lock, so an intent write
        # cannot slip between them (and vice versa: an admitted intent's
        # conflict check sees this write applied).
        if peer.tablet.meta.indexes and peer.raft.is_leader():
            err = self._maintain_indexes(
                peer, rows, insert_only=bool(p.get("if_not_exists")))
            if err is not None:
                return err
        keys = [r.key for r in rows]
        needs_full_lock = bool(p.get("if_not_exists")) or \
            any(r.increments for r in rows)
        for _attempt in range(3):
            admitted = None
            with peer._intent_lock:
                conflicting = peer.tablet.participant.pending_on_keys(keys)
                if not conflicting:
                    if needs_full_lock:
                        # Read-modify admission (conditional insert /
                        # counter resolve): the lock must span the check
                        # AND the append+wait so a concurrent duplicate /
                        # increment observes the first one applied.
                        if p.get("if_not_exists"):
                            if peer.raft.is_leader() and any(
                                    peer.tablet.current_row_values(k)
                                    is not None for k in keys):
                                return {"code": "duplicate_key"}
                        if any(r.increments for r in rows):
                            if not peer.raft.is_leader():
                                return {"code": "not_leader", "leader_hint":
                                        peer.raft.leader_uuid()}
                            try:
                                rows = [peer.tablet.resolve_increments(r)
                                        for r in rows]
                            except ValueError as e:
                                return {"code": "error", "message": str(e)}
                        try:
                            ht = peer.write(
                                rows, timeout=deadline,
                                client_id=p.get("client_id"),
                                request_id=p.get("request_id"))
                        except NotLeader as e:
                            return {"code": "not_leader",
                                    "leader_hint": e.leader_hint}
                        except TimeoutError:
                            return {"code": "timed_out"}
                        return self._write_ok(ht)
                    # Blind-write fast path: admission (dedup + stamp +
                    # append) under the lock, the majority wait OUTSIDE
                    # it — concurrent writers pipeline through one
                    # replication round instead of serializing on full
                    # commit latency (reference: preparer.cc batching).
                    try:
                        admitted = peer.write_admit(
                            rows, client_id=p.get("client_id"),
                            request_id=p.get("request_id"))
                    except NotLeader as e:
                        return {"code": "not_leader",
                                "leader_hint": e.leader_hint}
            if admitted is not None:
                try:
                    ht = peer.write_finish(admitted, timeout=deadline)
                except NotLeader as e:
                    return {"code": "not_leader",
                            "leader_hint": e.leader_hint}
                except TimeoutError:
                    return {"code": "timed_out"}
                return self._write_ok(ht)
            err = self._resolve_write_conflicts(
                peer, {"priority": 1 << 62}, conflicting)
            if err is not None:
                return err
        return {"code": "conflict", "message": "intents kept reappearing"}

    def _h_ts_write_admit(self, p: dict):
        """Admission half of the two-phase write: append + start
        replication, return WITHOUT waiting for commit. The client
        pipelines admissions across all its tablets from one thread,
        then collects outcomes with ts.write_sync — the (client_id,
        request_id) pair is the resume token, durable across leader
        changes because it is replicated inside the entry body
        (reference: the fully-async client write pipeline of
        src/yb/client/async_rpc.cc over Preparer batching)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        payload = p.get("rows")
        cid, rid = p.get("client_id"), p.get("request_id")
        if not isinstance(payload, (bytes, bytearray)) or cid is None or \
                rid is None or p.get("if_not_exists") or \
                peer.tablet.meta.indexes:
            return self._h_ts_write(p)  # full synchronous write
        peer.ops_seen += 1  # split-manager load signal
        if p.get("propagated_ht"):
            from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime as _HT

            peer.tablet.clock.update(_HT(p["propagated_ht"]))
        admitted = None
        with peer._intent_lock:
            if not peer.tablet.participant.txns:
                try:
                    admitted = peer.write_admit_block(payload, cid, rid)
                except NotLeader as e:
                    return {"code": "not_leader",
                            "leader_hint": e.leader_hint}
        if admitted is None:
            return self._h_ts_write(p)  # pending intents: slow path
        if admitted[0] == "dup":
            return self._write_ok(admitted[1])
        return {"code": "ok", "admitted": True}

    def _h_ts_write_sync(self, p: dict):
        """Completion half of the two-phase write: resolve the outcome
        of an admitted (client_id, request_id). Any replica that already
        APPLIED the write answers from its dedup registry; the leader
        waits for an in-flight one; an id nobody knows means the entry
        was lost to a leader change before commit — the client must
        re-send the full write (same id, so dedup keeps it exactly
        once)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        cid, rid = p["client_id"], p["request_id"]
        from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime as _HT

        prev = peer.tablet.retryable.seen(cid, rid)
        if prev is not None:
            return self._write_ok(_HT(prev))
        inflight = peer._inflight_rids.get((cid, rid))
        if inflight is None:
            if peer.raft.is_leader():
                if not peer.raft.leader_ready():
                    # A fresh leader may still hold the admitted entry
                    # uncommitted from the prior term; only once its own
                    # no_op has applied (and with it every surviving
                    # prior-term entry, into the dedup registry) is
                    # "unknown id" proof the entry was lost.
                    return {"code": "timed_out"}
                return {"code": "ok", "retry_write": True}
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        try:
            ht = peer.write_finish(
                ("inflight",) + inflight,
                timeout=Deadline.after(float(p.get("timeout", 10.0))))
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            return {"code": "timed_out"}
        return self._write_ok(ht)

    @staticmethod
    def _write_ok(ht) -> dict:
        from yugabyte_db_tpu_torch.utils.fault_injection import maybe_fault

        if maybe_fault("fault.ts_write_respond_failed"):
            # the write APPLIED; the client sees a failure and retries —
            # exactly-once dedup must absorb it
            return {"code": "timed_out", "injected_fault": True}
        return {"code": "ok", "ht": ht.value}

    @staticmethod
    def _pin_read_point(peer, read_ht: int, timeout: float) -> dict | None:
        """Pin an explicit client read point on one tablet: advance the
        local clock past it so no later write lands at <= read_ht, then
        wait until every in-flight write below it resolves (reference:
        MvccManager::SafeTime wait in Tablet::DoHandleQLReadRequest).
        Returns an error response dict, or None on success."""
        from yugabyte_db_tpu_torch.utils.flags import FLAGS
        from yugabyte_db_tpu_torch.utils.hybrid_time import (BITS_FOR_LOGICAL,
                                                       HybridTime)
        # Never let a client-supplied read point ratchet the clock
        # beyond the skew bound — an arbitrary far-future read_ht would
        # poison every subsequent write HT on this tablet. (Logical
        # clocks in tests have no wall-clock skew semantics: no bound.)
        bound_fn = getattr(peer.tablet.clock, "max_global_now", None)
        if bound_fn is not None and read_ht > bound_fn().value + (
                FLAGS.get("max_clock_skew_us") << BITS_FOR_LOGICAL):
            return {"code": "invalid_read_time"}
        peer.tablet.clock.update(HybridTime(read_ht))
        # Default below the client's 5s per-attempt transport timeout
        # (client.py tablet_rpc) so the clean "timed_out" reply reaches
        # the caller instead of a transport error.
        if not peer.tablet.mvcc.wait_for_safe_time(
                HybridTime(read_ht), timeout=timeout):
            return {"code": "timed_out"}
        return None

    def _rpc_deadline(self, p: dict) -> Deadline:
        """The propagated deadline of one read RPC: the client debits
        its retry budget into ``payload["timeout"]`` (client.py
        tablet_rpc), and every stage below — safe-time wait, engine
        batch, device dispatch rounds — debits this one Deadline."""
        return Deadline.after(float(p.get("timeout", 4.0)))

    def _read_gate(self, p: dict, specs: list | None = None,
                   deadline: Deadline | None = None):
        """The shared read prologue of every scan RPC: tablet lookup,
        HLC causality (ratchet past everything the client observed
        BEFORE choosing the read time, so a fresh read cannot miss its
        own writes), read-point pinning, and intent resolution. With
        ``specs`` (the batch RPC) the gate pins once at the maximum
        explicit read point and resolves intents per spec.
        Returns (peer, specs, None) or (None, None, error-response)."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return None, None, {"code": "not_found"}
        if peer._split_sealing or peer.tablet.meta.split_sealed:
            # A sealed parent must not serve reads: once the split
            # commits, its children take new writes the frozen parent
            # would silently miss.
            return None, None, {"code": "tablet_split",
                                "tablet_id": peer.tablet_id}
        if p.get("propagated_ht"):
            from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime as _HT

            peer.tablet.clock.update(_HT(p["propagated_ht"]))
        if specs is None:
            specs = [wire.decode_spec(p["spec"])]
        peer.ops_seen += len(specs)  # split-manager load signal
        explicit = [s.read_ht for s in specs if s.read_ht != wire.MAX_HT]
        if explicit:
            timeout = (deadline.timeout() if deadline is not None
                       else p.get("timeout", 4.0))
            err = self._pin_read_point(peer, max(explicit), timeout)
            if err is not None:
                return None, None, err
        prop = p.get("propagated_ht") or 0
        if prop and any(s.read_ht == wire.MAX_HT for s in specs):
            # Session read-your-writes under pipelined apply: writes ack
            # at COMMIT, and the apply stage drains asynchronously — a
            # fresh read must wait for safe time to reach everything the
            # client already observed (its own acked writes ride in
            # propagated_ht), or it would read below them.
            from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime as _HT

            timeout = (deadline.timeout() if deadline is not None
                       else p.get("timeout", 4.0))
            if not peer.tablet.mvcc.wait_for_safe_time(_HT(prop),
                                                       timeout=timeout):
                return None, None, {"code": "timed_out"}
        read_ht = peer.read_time().value
        for s in specs:
            if s.read_ht == wire.MAX_HT:
                s.read_ht = read_ht
            err = self._resolve_read_intents(peer, s)
            if err is not None:
                return None, None, err
        TRACE("read point resolved")
        return peer, specs, None

    def _h_ts_scan(self, p: dict):
        deadline = self._rpc_deadline(p)
        peer, specs, err = self._read_gate(p, deadline=deadline)
        if err is not None:
            return err
        spec = specs[0]
        try:
            res = peer.scan(spec, allow_stale=p.get("allow_stale", False),
                            deadline=deadline)
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except DeadlineExpired:
            return {"code": "timed_out"}
        out = wire.encode_result(res)
        out["code"] = "ok"
        out["read_ht"] = spec.read_ht
        return out

    def _h_ts_scan_batch(self, p: dict):
        """Many scans (typically point gets) in ONE RPC: one read gate,
        one engine batch — the server hop of the client's multi-key
        reads (reference: the batcher packing many ops into one
        tserver call, src/yb/client/batcher.h:80)."""
        deadline = self._rpc_deadline(p)
        peer, specs, err = self._read_gate(
            p, [wire.decode_spec(s) for s in p["specs"]],
            deadline=deadline)
        if err is not None:
            return err
        try:
            results = peer.scan_many(
                specs, allow_stale=p.get("allow_stale", False),
                deadline=deadline)
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except DeadlineExpired:
            return {"code": "timed_out"}
        out = [wire.encode_result(r) for r in results]
        return {"code": "ok", "results": out,
                "read_ht": max(s.read_ht for s in specs)}

    def _h_ts_scan_wire(self, p: dict):
        """Scan returning SERIALIZED result-page bytes (fmt "cql" = CQL
        cells, "pg" = PG DataRow messages) — the reference's rows_data
        contract (src/yb/common/ql_rowblock.h:66): rows serialize once
        at the tablet and every layer above forwards bytes."""
        deadline = self._rpc_deadline(p)
        peer, specs, err = self._read_gate(p, deadline=deadline)
        if err is not None:
            return err
        spec = specs[0]
        try:
            pg = peer.scan_wire(spec, p.get("fmt", "cql"),
                                allow_stale=p.get("allow_stale", False),
                                deadline=deadline)
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except DeadlineExpired:
            return {"code": "timed_out"}
        return {"code": "ok", "data": pg.data, "nrows": pg.nrows,
                "resume": pg.resume, "columns": pg.columns,
                "read_ht": spec.read_ht}

    def _h_ts_scan_wire_batch(self, p: dict):
        """Many wire-serialized scans in ONE RPC — the batched read hop
        of the native request-batch serving path (docs/serving-path.md):
        one read gate, one engine batch, one serialized result page per
        spec. Replaces a per-op ts.scan_wire round trip for every
        eligible prepared point SELECT in a pipelined CQL batch."""
        deadline = self._rpc_deadline(p)
        peer, specs, err = self._read_gate(
            p, [wire.decode_spec(s) for s in p["specs"]],
            deadline=deadline)
        if err is not None:
            return err
        try:
            pages = peer.scan_wire_many(
                specs, p.get("fmt", "cql"),
                allow_stale=p.get("allow_stale", False),
                deadline=deadline)
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except DeadlineExpired:
            return {"code": "timed_out"}
        return {"code": "ok",
                "pages": [{"data": pg.data, "nrows": pg.nrows,
                           "resume": pg.resume, "columns": pg.columns}
                          for pg in pages],
                "read_ht": max(s.read_ht for s in specs)}

    def _h_ts_redis_read_batch(self, p: dict):
        """Batched redis point GETs served straight from the native
        memtable (yb_wp.Memtable.point_lookup) — no ScanSpec, no
        RowVersion materialization. Strictly an optimization of the
        scan-batch path: whenever the tablet cannot answer natively AND
        definitively (sorted runs, spilled rows, pending txn intents,
        pure-Python memtable) it replies {"code": "ok", "fallback":
        True} ("ok" so the client's TabletInvoker retry loop hands the
        reply straight back) and the frontend re-issues the batch
        through session.get_many, whose gate also resolves intents.
        Values are the raw stored payloads; None = absent row or NULL
        column; False = fall back for that key only."""
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if peer._split_sealing or peer.tablet.meta.split_sealed:
            return {"code": "tablet_split", "tablet_id": peer.tablet_id}
        peer.ops_seen += len(p["keys"])  # split-manager load signal
        if p.get("propagated_ht"):
            from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime as _HT

            peer.tablet.clock.update(_HT(p["propagated_ht"]))
        read_ht = peer.read_time().value
        try:
            values = peer.point_serve(
                p["keys"], read_ht, p["col_id"],
                allow_stale=p.get("allow_stale", False))
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        if values is None:
            return {"code": "ok", "fallback": True, "read_ht": read_ht}
        return {"code": "ok", "values": values, "read_ht": read_ht}

    def _resolve_read_intents(self, peer, spec) -> dict | None:
        """Intent-aware read gate (the IntentAwareIterator contract,
        src/yb/docdb/intent_aware_iterator.h:62-81, as a pre-scan gate):
        for each foreign txn with intents in the scanned range, ask its
        status tablet for the state AT spec.read_ht. The coordinator
        ratchets its clock past the asker's read time first, so:
          pending  -> any future commit lands above read_ht: ignore;
          aborted  -> ignore (cleaned lazily);
          committed with commit_ht <= read_ht -> the rows MUST be visible:
                      wait for the local apply to land, then scan.
        """
        part = peer.tablet.participant
        overlapping = part.txns_overlapping(spec.lower, spec.upper)
        for txn_id, meta in overlapping.items():
            resp = self.txn_router.tablet_rpc(
                meta["status_tablet"], "ts.txn_status",
                {"txn_id": txn_id, "read_ht": spec.read_ht})
            if resp is None or resp.get("code") != "ok":
                return {"code": "timed_out",
                        "detail": f"cannot resolve txn {txn_id}"}
            if resp["status"] == "committed" and \
                    resp["commit_ht"] <= spec.read_ht:
                if not part.wait_gone(txn_id, timeout=3.0):
                    return {"code": "timed_out",
                            "detail": f"txn {txn_id} apply lagging"}
        return None

    # -- transaction service --------------------------------------------------
    def _h_ts_write_intents(self, p: dict):
        """Provisional write with server-side conflict resolution
        (reference: docdb::ResolveTransactionConflicts,
        src/yb/docdb/conflict_resolution.cc)."""
        from yugabyte_db_tpu_torch.txn.participant import IntentConflict

        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if peer._split_sealing or peer.tablet.meta.split_sealed:
            # Intent writes bypass write_admit's seal gate — check here.
            return {"code": "tablet_split", "tablet_id": peer.tablet_id}
        rows = wire.decode_rows(p["rows"])
        for _attempt in range(3):
            try:
                ht = peer.write_intents(p["txn_id"], p["status_tablet"],
                                        p["priority"], p["read_ht"], rows)
                return {"code": "ok", "ht": ht}
            except NotLeader as e:
                return {"code": "not_leader", "leader_hint": e.leader_hint}
            except TimeoutError:
                return {"code": "timed_out"}
            except IntentConflict as e:
                if not e.conflicting:
                    return {"code": "conflict", "message": str(e)}
                err = self._resolve_write_conflicts(peer, p, e.conflicting)
                if err is not None:
                    return err
        return {"code": "conflict", "message": "conflicts kept reappearing"}

    def _resolve_write_conflicts(self, peer, p, conflicting) -> dict | None:
        """Resolve pending foreign intents blocking a write: finish
        committed/aborted txns locally; for live ones run the priority
        duel — the higher-priority writer wounds the lower (aborts it at
        its coordinator), otherwise the writer loses. None = retry."""
        for other_id, other_status_tablet, other_prio in conflicting:
            resp = self.txn_router.tablet_rpc(
                other_status_tablet, "ts.txn_status",
                {"txn_id": other_id,
                 "read_ht": peer.tablet.clock.now().value})
            if resp is None or resp.get("code") != "ok":
                return {"code": "timed_out",
                        "detail": f"cannot resolve txn {other_id}"}
            try:
                if resp["status"] == "committed":
                    peer.replicate_txn_op(
                        "apply_intents",
                        {"txn_id": other_id, "commit_ht": resp["commit_ht"]},
                        ht=resp["commit_ht"])
                elif resp["status"] == "aborted":
                    peer.replicate_txn_op("remove_intents",
                                          {"txn_id": other_id})
                else:  # pending: the duel
                    if p["priority"] > other_prio:
                        ab = self.txn_router.tablet_rpc(
                            other_status_tablet, "ts.txn_abort",
                            {"txn_id": other_id})
                        if ab is None or ab.get("code") not in (
                                "ok", "aborted"):
                            return {"code": "conflict",
                                    "message": f"cannot wound {other_id}"}
                        peer.replicate_txn_op("remove_intents",
                                              {"txn_id": other_id})
                    else:
                        return {"code": "conflict",
                                "message": f"blocked by higher-priority "
                                           f"txn {other_id}"}
            except NotLeader as e:
                return {"code": "not_leader", "leader_hint": e.leader_hint}
        return None

    def _h_ts_apply_txn(self, p: dict):
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if not peer.raft.is_leader():
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        if peer.tablet.participant.has_intents(p["txn_id"]):
            # Transactional writes maintain secondary indexes at APPLY
            # time, before the rows become readable — the same
            # index-before-base ordering as plain writes. (The reference
            # writes index intents inside the txn; this simpler commit-
            # time maintenance trades a txn-atomic index for the same
            # never-miss-once-visible invariant.)
            if peer.tablet.meta.indexes:
                rec = peer.tablet.participant.txns.get(p["txn_id"])
                if rec is not None:
                    err = self._maintain_indexes(peer, rec["rows"])
                    if err is not None:
                        return err
            try:
                peer.replicate_txn_op(
                    "apply_intents",
                    {"txn_id": p["txn_id"], "commit_ht": p["commit_ht"]},
                    ht=p["commit_ht"])
            except NotLeader as e:
                return {"code": "not_leader", "leader_hint": e.leader_hint}
        return {"code": "ok"}

    def _h_ts_remove_txn(self, p: dict):
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        if not peer.raft.is_leader():
            return {"code": "not_leader",
                    "leader_hint": peer.raft.leader_uuid()}
        if peer.tablet.participant.has_intents(p["txn_id"]):
            try:
                peer.replicate_txn_op("remove_intents",
                                      {"txn_id": p["txn_id"]})
            except NotLeader as e:
                return {"code": "not_leader", "leader_hint": e.leader_hint}
        return {"code": "ok"}

    # -- coordinator service (status tablet) ----------------------------------
    def _coord_peer(self, p: dict):
        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return None, {"code": "not_found"}
        if peer.tablet.coordinator is None:
            return None, {"code": "error", "message": "not a status tablet"}
        # leader_ready (own-term entry applied) guarantees every
        # prior-term in-flight commit is applied before we answer status
        # queries — a new leader must not promise "pending" while an old
        # leader's commit entry is still committing through its log.
        if not (peer.raft.is_leader() and peer.raft.has_lease()
                and peer.raft.leader_ready()):
            return None, {"code": "not_leader",
                          "leader_hint": peer.raft.leader_uuid()}
        return peer, None

    def _h_ts_txn_create(self, p: dict):
        peer, err = self._coord_peer(p)
        if err is not None:
            return err
        try:
            peer.replicate_txn_op("txn_status", {
                "action": "create", "txn_id": p["txn_id"]})
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        return {"code": "ok", "read_ht": peer.tablet.clock.now().value}

    def _h_ts_txn_heartbeat(self, p: dict):
        peer, err = self._coord_peer(p)
        if err is not None:
            return err
        alive = peer.tablet.coordinator.heartbeat(p["txn_id"])
        return {"code": "ok" if alive else "aborted"}

    def _h_ts_txn_status(self, p: dict):
        peer, err = self._coord_peer(p)
        if err is not None:
            return err
        # resolve_status ratchets the coordinator clock past the asker's
        # read time and waits out in-flight commits, making a "pending"
        # answer a promise that any later commit lands above read_ht
        # (the StatusRequest serving contract).
        st = peer.tablet.coordinator.resolve_status(
            p["txn_id"], p["read_ht"], peer.tablet.clock)
        if st is None:
            return {"code": "timed_out"}
        return {"code": "ok", **st}

    def _h_ts_txn_commit(self, p: dict):
        peer, err = self._coord_peer(p)
        if err is not None:
            return err
        coord = peer.tablet.coordinator
        st = coord.status(p["txn_id"])
        if st["status"] == "committed":
            return {"code": "ok", "commit_ht": st["commit_ht"]}  # retry
        if st["status"] == "aborted":
            return {"code": "aborted"}
        # HLC propagation: every intent write's hybrid time (max'ed by the
        # client) must ratchet this clock before the commit time is
        # chosen, so commit_ht exceeds every intent write — and therefore
        # every read time any participant tablet has already served past.
        from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime

        peer.tablet.clock.update(HybridTime(p.get("propagated_ht", 0)))
        commit_ht = coord.choose_commit_ht(p["txn_id"], peer.tablet.clock)
        # Deadline propagation (PR-7 convention): the append's
        # backpressure wait and the apply wait debit the client's one
        # remaining budget instead of a fresh hardcoded 10 s each.
        deadline = Deadline.after(float(p.get("timeout", 10.0)))
        try:
            entry = peer.raft.append_leader("txn_status", {
                "action": "commit", "txn_id": p["txn_id"],
                "commit_ht": commit_ht,
                "participants": p.get("participants", []),
            }, ht=commit_ht, deadline=deadline)
        except NotLeader as e:
            coord.finish_commit_attempt(p["txn_id"])
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            coord.finish_commit_attempt(p["txn_id"])
            return {"code": "timed_out"}
        try:
            # Commit stays an apply-time barrier (NOT the commit-time
            # ack of plain writes): the coordinator's status registry
            # must reflect "committed" before the client is told so.
            peer.raft.wait_applied(entry.op_id, deadline)
        except NotLeader as e:
            # Entry truncated: the commit definitively did not happen.
            coord.finish_commit_attempt(p["txn_id"])
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        except TimeoutError:
            # Outcome UNKNOWN: the entry may still commit with this
            # commit_ht, so the in-flight marker must stay until Raft
            # resolves it (else a status query could promise "pending").
            import threading as _threading

            def _resolve():
                try:
                    while True:
                        try:
                            peer.raft.wait_applied(entry.op_id,
                                                   Deadline.after(10.0))
                            break
                        except NotLeader:
                            break
                        except TimeoutError:
                            if not peer.raft._running:
                                break
                            continue
                except Exception:  # never die silently
                    import logging

                    logging.getLogger(__name__).exception(
                        "commit resolution for txn %s failed", p["txn_id"])
                finally:
                    # The in-flight marker must not leak on any path —
                    # a stuck marker wedges every later status query.
                    coord.finish_commit_attempt(p["txn_id"])

            _threading.Thread(target=_resolve, daemon=True).start()
            return {"code": "timed_out"}
        coord.finish_commit_attempt(p["txn_id"])
        # A racing abort may have been ordered first: report the outcome
        # the log actually chose.
        st = coord.status(p["txn_id"])
        if st["status"] != "committed":
            return {"code": "aborted"}
        self.txn_notifier.trigger()
        return {"code": "ok", "commit_ht": st["commit_ht"]}

    def _h_ts_txn_abort(self, p: dict):
        peer, err = self._coord_peer(p)
        if err is not None:
            return err
        coord = peer.tablet.coordinator
        st = coord.status(p["txn_id"])
        if st["status"] == "committed":
            return {"code": "committed", "commit_ht": st["commit_ht"]}
        if st["status"] == "aborted":
            return {"code": "ok"}
        try:
            peer.replicate_txn_op("txn_status", {
                "action": "abort", "txn_id": p["txn_id"],
                "participants": p.get("participants", []),
            })
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        st = coord.status(p["txn_id"])
        if st["status"] == "committed":
            return {"code": "committed", "commit_ht": st["commit_ht"]}
        self.txn_notifier.trigger()
        return {"code": "ok"}

    def _multi_scan_peers(self, p: dict):
        """Shared front half of the multi-tablet mesh scan handlers:
        gather the named peers (all must be leaders holding leases on
        THIS server), pin one repeatable read point across all of them,
        and resolve blocking intents. Returns (peers, spec, None) or
        (None, None, error-reply)."""
        peers = []
        for tid in p["tablet_ids"]:
            try:
                peer = self.tablet_manager.get(tid)
            except TabletNotFound:
                return None, None, {"code": "not_found", "tablet_id": tid}
            if not (peer.raft.is_leader() and peer.raft.has_lease()):
                return None, None, {"code": "not_leader", "tablet_id": tid,
                                    "leader_hint": peer.raft.leader_uuid()}
            peers.append(peer)
        spec = wire.decode_spec(p["spec"])
        if spec.read_ht == wire.MAX_HT:
            # Every tablet can already serve its own safe time; the min is
            # serveable by all without waiting and repeatable everywhere.
            spec.read_ht = min(pr.read_time().value for pr in peers)
        else:
            # One deadline across ALL pins: serial per-peer waits must not
            # sum past the client's propagated budget.
            deadline = self._rpc_deadline(p)
            for peer in peers:
                if deadline.expired():
                    return None, None, {"code": "timed_out"}
                err = self._pin_read_point(peer, spec.read_ht,
                                           deadline.timeout())
                if err is not None:
                    return None, None, err
        for peer in peers:
            err = self._resolve_read_intents(peer, spec)
            if err is not None:
                return None, None, err
        return peers, spec, None

    def _h_ts_multi_agg_scan(self, p: dict):
        """Aggregate over MANY tablets this server leads, as ONE device
        program over the mesh (tablets on the "t" axis, blocks on "b",
        psum/pmax combine over ICI — tserver.mesh_scan). The client falls
        back to per-tablet ts.scan + host combine on any non-ok reply."""
        peers, spec, err = self._multi_scan_peers(p)
        if err is not None:
            return err
        res = self.mesh_scan.aggregate(peers, spec)
        if res is None:
            return {"code": "ineligible"}
        out = wire.encode_result(res)
        out["code"] = "ok"
        out["read_ht"] = spec.read_ht
        return out

    def _h_ts_multi_row_scan(self, p: dict):
        """One LIMIT row page over MANY tablets this server leads, as ONE
        device program over the mesh (the packed MVCC row gather sharded
        on ("t", "b"), match counts psum over ICI — tserver.mesh_scan).
        ``resume`` carries the previous page's cross-tablet resume token,
        opaque to the client; tablet_ids must repeat in the same order
        every page. The client falls back to per-tablet ts.scan paging on
        any non-ok reply."""
        peers, spec, err = self._multi_scan_peers(p)
        if err is not None:
            return err
        res = self.mesh_scan.rows(peers, spec, resume=p.get("resume"))
        if res is None:
            return {"code": "ineligible"}
        out = wire.encode_result(res)
        out["code"] = "ok"
        out["read_ht"] = spec.read_ht
        return out

    def _h_ts_flush(self, p: dict):
        self.tablet_manager.get(p["tablet_id"]).flush()
        return {"code": "ok"}

    def _h_ts_compact(self, p: dict):
        self.tablet_manager.get(p["tablet_id"]).compact(
            p.get("history_cutoff_ht", 0))
        return {"code": "ok"}

    def _h_ts_change_config(self, p: dict):
        peer = self.tablet_manager.get(p["tablet_id"])
        try:
            peer.raft.change_config(p["peers"])
        except NotLeader as e:
            return {"code": "not_leader", "leader_hint": e.leader_hint}
        return {"code": "ok"}

    def _h_ts_transfer_leadership(self, p: dict):
        peer = self.tablet_manager.get(p["tablet_id"])
        peer.raft.transfer_leadership(p["target"])
        return {"code": "ok"}

    def _h_ts_checksum(self, p: dict):
        """Checksum of this replica's visible rows at a read hybrid time
        (reference: ChecksumService / ysck checksum scans,
        src/yb/tserver/tserver_service.proto Checksum). Reads LOCALLY
        (leader or follower) — the caller pins one read_ht across all
        replicas and retries transient divergence while appliers catch
        up. Without read_ht the replica picks its safe time and returns
        it so the caller can pin the rest of the group to it."""
        import hashlib

        from yugabyte_db_tpu_torch.utils import codec

        try:
            peer = self.tablet_manager.get(p["tablet_id"])
        except TabletNotFound:
            return {"code": "not_found"}
        read_ht = p.get("read_ht")
        if read_ht is None:
            read_ht = peer.read_time().value
        else:
            # Same consistency gates as ts.scan: wait out in-flight writes
            # below the pinned point and committed-but-unapplied intents,
            # so applier lag isn't misreported as corruption.
            err = self._pin_read_point(peer, read_ht, p.get("timeout", 4.0))
            if err is not None:
                return err
        spec = ScanSpec(lower=b"", upper=b"", read_ht=read_ht)
        err = self._resolve_read_intents(peer, spec)
        if err is not None:
            return err
        h = hashlib.sha256()
        total = 0
        resume = b""
        while True:
            page = ScanSpec(lower=resume, upper=b"", read_ht=read_ht,
                            limit=4096)
            res = peer.scan(page, allow_stale=True)
            for row in res.rows:
                h.update(codec.encode(row))
            total += len(res.rows)
            if res.resume_key is None:
                break
            resume = res.resume_key
        return {"code": "ok", "read_ht": read_ht, "rows": total,
                "checksum": h.hexdigest()}

    def _h_ts_status(self, p: dict):
        return {
            "code": "ok",
            "uuid": self.uuid,
            "tablets": {pr.tablet_id: pr.stats()
                        for pr in self.tablet_manager.peers()},
        }
