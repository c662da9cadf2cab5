"""Master daemon: Raft-replicated catalog + control-plane services.

Reference analog: src/yb/master/master.cc + catalog_manager.cc. The sys
catalog is itself a Raft group over the master set (sys_catalog.h:75 "the
sys catalog is a tablet"); CreateTable picks placements over live tservers
and async-creates replicas on them (CreateTabletsFromTable,
catalog_manager.cc:2274, async_rpc_tasks.cc); TS liveness and tablet
leadership are soft state from heartbeats; a background loop re-replicates
tablets off dead tservers (ClusterLoadBalancer's remove/add logic,
cluster_balance.cc).

The port's copy of the JAX package's ``master/master.py``, whole. Its
one departure: a table's engine defaults to ``"gpu"`` (the JAX default
``"cpu"`` is not registered in the port; ROADMAP.md §1 item 16). The sys
catalog's WAL segments and ``consensus-meta.json`` are the JAX master's,
byte for byte, so either package's master opens the other's directory.
"""

from __future__ import annotations

import os
import threading
import time
import uuid as uuid_mod

from yugabyte_db_tpu_torch.consensus.metadata import ConsensusMetadata, RaftConfig
from yugabyte_db_tpu_torch.consensus.raft import NotLeader, RaftConsensus, RaftOptions
from yugabyte_db_tpu_torch.master.catalog import CatalogState
from yugabyte_db_tpu_torch.master.load_balancer import LeaderBalancer
from yugabyte_db_tpu_torch.master.split_manager import SplitError, SplitManager
from yugabyte_db_tpu_torch.master.ts_manager import TSManager
from yugabyte_db_tpu_torch.models.partition import PartitionSchema
from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.tablet.wal import Log
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.retry import Deadline
from yugabyte_db_tpu_torch.utils.trace import RpczStore, trace_request

SYS_CATALOG_ID = "sys.catalog"


class Master:
    def __init__(self, uuid: str, fs_root: str, transport,
                 master_uuids: list[str],
                 raft_opts: RaftOptions | None = None,
                 fsync: bool = True,
                 ts_unresponsive_timeout_s: float | None = None,
                 balance_interval_s: float = 1.0,
                 missing_replica_grace_s: float = 10.0,
                 advertised_addr=None, options=None):
        # Structured options (server.options.MasterOptions) override the
        # loose kwargs when provided.
        if options is not None:
            fsync = options.fsync
            ts_unresponsive_timeout_s = options.resolved_ts_timeout()
            balance_interval_s = options.balance_interval_s
            missing_replica_grace_s = options.missing_replica_grace_s
        self.options = options
        self.uuid = uuid
        self.transport = transport
        self.advertised_addr = advertised_addr
        from yugabyte_db_tpu_torch import fs as _fs

        self.instance = _fs.format_or_open(fs_root, uuid)
        self.catalog = CatalogState()
        self.ts_manager = TSManager(ts_unresponsive_timeout_s)
        self.split_manager = SplitManager(self)
        self.load_balancer = LeaderBalancer(self)
        self.balance_interval_s = balance_interval_s
        self.clock = HybridClock()
        sys_dir = os.path.join(fs_root, "sys-catalog")
        os.makedirs(sys_dir, exist_ok=True)
        self._log = Log(os.path.join(sys_dir, "wal"), fsync=fsync)
        cmeta = ConsensusMetadata(
            os.path.join(sys_dir, "consensus-meta.json"), uuid,
            RaftConfig(list(master_uuids)))
        self.raft = RaftConsensus(SYS_CATALOG_ID, cmeta, self._log, transport,
                                  self.clock, self._apply_catalog, raft_opts)
        self._running = False
        self._balancer_thread: threading.Thread | None = None
        self._fixing: dict[str, float] = {}  # tablet_id -> fix start time
        # (tablet_id, replica) creates that FAILED to dispatch: the balancer
        # retries exactly these directly. Recreating any other missing
        # replica in place would be unsafe — a voter that lost its disk must
        # not be handed a fresh empty log while still counted in the config
        # (it could elect a leader without committed entries). Missing
        # replicas NOT tracked here (e.g. the set was lost to a master
        # restart) are repaired through a config cycle instead
        # (_repair_live_missing_replicas).
        self._failed_creates: set[tuple[str, str]] = set()
        self._seq_lock = threading.Lock()  # serializes sequence allocs
        # (table_id, tablet_id) whose leaders haven't adopted the latest
        # catalog schema yet; the balancer retries delivery.
        self._pending_alters: set[tuple[str, str]] = set()
        self.missing_replica_grace_s = missing_replica_grace_s
        # (tablet_id, replica) -> first time a live tserver's heartbeat was
        # seen not reporting a replica the catalog assigns to it.
        self._missing_seen: dict[tuple[str, str], float] = {}
        from yugabyte_db_tpu_torch.utils.metrics import MetricRegistry

        self.metrics = MetricRegistry()
        self._rpc_entities: dict = {}
        self._rpc_lock = threading.Lock()
        ent = self.metrics.entity(daemon="master", uuid=uuid)
        ent.gauge("master_is_leader", lambda: int(self.is_leader()))
        ent.gauge("master_num_tables",
                  lambda: len(self.catalog.list_tables()))
        ent.gauge("master_num_tablets",
                  lambda: len(self.catalog.known_tablet_ids()))
        ent.gauge("master_live_tservers",
                  lambda: len(self.ts_manager.live_tservers()))
        self.webserver = None
        self.rpcz = RpczStore()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._running = True
        if self.options is not None and self.options.webserver:
            self.start_webserver(self.options.webserver_host,
                                 self.options.webserver_port)
        self.raft.start()
        self._balancer_thread = threading.Thread(
            target=self._balancer_loop, name=f"balancer-{self.uuid}",
            daemon=True)
        self._balancer_thread.start()

    def shutdown(self) -> None:
        self._running = False
        if self.webserver is not None:
            self.webserver.stop()
        self.raft.shutdown()
        if self._balancer_thread is not None:
            self._balancer_thread.join(timeout=5.0)
        self._log.close()

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    def _apply_catalog(self, entry) -> None:
        if entry.op_type == "catalog":
            self.catalog.apply(entry.body)

    def start_webserver(self, host: str = "127.0.0.1", port: int = 0):
        from yugabyte_db_tpu_torch.server.webserver import Webserver

        self.webserver = Webserver(self.metrics, f"master-{self.uuid}")

        # single row builders per entity: JSON API and dashboards agree
        def _tables_rows():
            return [{"name": t.name, "table_id": t.table_id,
                     "state": t.state, "num_tablets": t.num_tablets,
                     "schema_version": t.schema.get("version", 0),
                     "indexes": [i["name"] for i in t.indexes]}
                    for t in self.catalog.list_tables()]

        def _tablets_rows():
            # split lineage annotations: a serving child links back to
            # its parent; lineage records themselves are separate rows.
            child_of = {c: pid
                        for pid, s in self.catalog.splits.items()
                        for c in s["children"]}
            return [{"tablet_id": i.tablet_id, "table_id": i.table_id,
                     "leader": self.ts_manager.leader_of(i.tablet_id),
                     "replicas": i.replicas,
                     "split_parent": child_of.get(i.tablet_id)}
                    for t in self.catalog.list_tables()
                    for i in self.catalog.tablets_of(t.table_id)]

        def _splits_rows():
            return [{"parent": r["parent"],
                     "children": " ".join(r["children"]),
                     "split_hash": r["split_hash"],
                     "state": r["state"]}
                    for r in self.catalog.split_lineage()]

        self.webserver.add_json_handler("/tables", _tables_rows)
        self.webserver.add_json_handler("/tablets", _tablets_rows)
        self.webserver.add_json_handler("/tablet-splits", _splits_rows)
        self.webserver.add_json_handler("/rpcz", self.rpcz.dump)

        def _tservers_rows():
            import time as _t

            live = {d.uuid for d in self.ts_manager.live_tservers()}
            return [{"uuid": d.uuid, "live": d.uuid in live,
                     "tablets": d.num_live_tablets,
                     # balancer skew input: leaders this tserver hosts
                     "leaders": sum(1 for r in d.tablet_roles.values()
                                    if r == "leader"),
                     "last_heartbeat_age_s": round(
                         _t.monotonic() - d.last_heartbeat, 1)}
                    for d in self.ts_manager.all_tservers()]

        self.webserver.add_dashboard("/dashboards/tables", "Tables",
                                     _tables_rows)
        self.webserver.add_dashboard("/dashboards/tablets", "Tablets",
                                     _tablets_rows)
        self.webserver.add_dashboard("/dashboards/tablet-splits",
                                     "Tablet splits", _splits_rows)
        self.webserver.add_dashboard("/dashboards/tablet-servers",
                                     "Tablet servers", _tservers_rows)
        return self.webserver.start(host, port)

    def _rpc_entity(self, method: str):
        ent = self._rpc_entities.get(method)
        if ent is None:
            with self._rpc_lock:
                ent = self._rpc_entities.get(method)
                if ent is None:
                    ent = self.metrics.entity(daemon="master",
                                              uuid=self.uuid,
                                              method=method)
                    self._rpc_entities[method] = ent
        return ent

    # -- rpc dispatch --------------------------------------------------------
    def handle(self, method: str, payload: dict):
        start = time.monotonic()
        with trace_request(method) as t:
            try:
                return self._dispatch(method, payload)
            finally:
                ent = self._rpc_entity(method)
                ent.counter("rpc_requests_total").increment()
                ent.histogram("rpc_latency_us").observe_duration_us(start)
                t.finish()  # duration must be final before sampling
                self.rpcz.record(t)

    def _dispatch(self, method: str, payload: dict):
        if method.startswith("raft."):
            return self.raft.handle(method, payload)
        handler = getattr(self, "_h_" + method.replace(".", "_"), None)
        if handler is None:
            raise ValueError(f"unknown method {method}")
        return handler(payload)

    def _not_leader(self) -> dict:
        return {"code": "not_leader", "leader_hint": self.raft.leader_uuid()}

    @staticmethod
    def _op_deadline(p: dict) -> Deadline:
        """The client's remaining budget for a replicated catalog op
        (PR-7 deadline propagation): the append backpressure wait and
        the apply wait debit this ONE deadline instead of restarting a
        hardcoded 10 s at each layer."""
        return Deadline.after(float(p.get("timeout", 10.0)))

    # -- ddl ----------------------------------------------------------------
    def _h_master_create_table(self, p: dict):
        if not self.raft.is_leader():
            return self._not_leader()
        name = p["name"]
        if self.catalog.table_by_name(name) is not None:
            return {"code": "already_present", "table_id":
                    self.catalog.table_by_name(name).table_id}
        schema = Schema.from_dict(p["schema"])
        num_tablets = p.get("num_tablets", 4)
        rf = p.get("replication_factor", 3)
        engine = p.get("engine", "gpu")
        live = sorted(self.ts_manager.live_tservers(),
                      key=lambda d: d.num_live_tablets)
        if len(live) < rf:
            return {"code": "error",
                    "message": f"{len(live)} live tservers < RF {rf}"}
        table_id = uuid_mod.uuid4().hex[:16]
        parts = PartitionSchema(
            num_tablets, hash_partitioned=schema.num_hash > 0
        ).create_partitions()
        tablets = []
        # Topology-aware placement: spread each tablet's replicas across
        # the fewest-used (cloud, region, zone) groups, least-loaded
        # tserver within a group; load counts include this table's own
        # placements so tablets spread too (reference:
        # CatalogManager::SelectReplicas honoring PlacementInfoPB,
        # src/yb/master/master.proto:186-197).
        load = {d.uuid: d.num_live_tablets for d in live}
        for i, part in enumerate(parts):
            replicas = self._select_replicas(live, rf, load)
            for r in replicas:
                load[r] += 1
            tablets.append({
                "tablet_id": f"{table_id}-t{i:04d}",
                "partition_start": part.start,
                "partition_end": part.end,
                "replicas": replicas,
            })
        op = {"op": "create_table", "table_id": table_id, "name": name,
              "schema": schema.to_dict(), "num_tablets": len(parts),
              "engine": engine, "tablets": tablets}
        try:
            self.raft.replicate("catalog", op, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        errors = self._dispatch_tablet_creates(op)
        if errors:
            return {"code": "partial", "table_id": table_id, "errors": errors}
        return {"code": "ok", "table_id": table_id}

    @staticmethod
    def _zone_of(desc) -> tuple:
        ci = desc.cloud_info or {}
        return (ci.get("cloud", ""), ci.get("region", ""),
                ci.get("zone", ""))

    def _select_replicas(self, live, rf: int, load: dict,
                         exclude=(), existing_zones=()) -> list[str]:
        """Pick up to ``rf`` tservers spreading across availability
        zones: each pick takes the least-used zone (counting
        ``existing_zones`` — the zones of replicas the tablet already
        has), then the least-loaded tserver within it. Falls back to
        packing zones once every zone is used (small clusters)."""
        import collections as _c

        by_zone: dict[tuple, list] = {}
        for d in live:
            if d.uuid in exclude:
                continue
            by_zone.setdefault(self._zone_of(d), []).append(d)
        for descs in by_zone.values():
            descs.sort(key=lambda d: load.get(d.uuid, 0))
        used = _c.Counter(existing_zones)
        picks: list[str] = []
        for _ in range(rf):
            candidates = [(used[z], load.get(descs[0].uuid, 0), z)
                          for z, descs in by_zone.items() if descs]
            if not candidates:
                break
            _u, _l, z = min(candidates)
            d = by_zone[z].pop(0)
            picks.append(d.uuid)
            used[z] += 1
        return picks

    @staticmethod
    def _create_tablet_req(tablet_id: str, table_name: str, schema,
                           partition_start, partition_end, engine: str,
                           peers: list[str],
                           indexes: list | None = None) -> dict:
        """The one canonical ts.create_tablet payload (built in three
        places: initial dispatch, dead-TS re-replication, create retry)."""
        return {"tablet_id": tablet_id, "table_name": table_name,
                "schema": schema, "partition_start": partition_start,
                "partition_end": partition_end, "engine": engine,
                "peers": peers, "indexes": list(indexes or [])}

    def _dispatch_tablet_creates(self, op: dict) -> list[str]:
        errors = []
        for td in op["tablets"]:
            for replica in td["replicas"]:
                req = self._create_tablet_req(
                    td["tablet_id"], op["name"], op["schema"],
                    td["partition_start"], td["partition_end"],
                    op.get("engine", "gpu"), td["replicas"])
                try:
                    resp = self.transport.send(replica, "ts.create_tablet",
                                               req, timeout=5.0)
                    if resp.get("code") != "ok":
                        self._failed_creates.add((td["tablet_id"], replica))
                        errors.append(f"{td['tablet_id']}@{replica}: "
                                      f"{resp.get('code')}")
                except Exception as e:  # noqa: BLE001 — balancer retries
                    self._failed_creates.add((td["tablet_id"], replica))
                    errors.append(f"{td['tablet_id']}@{replica}: {e}")
        return errors

    def _h_master_alter_table(self, p: dict):
        """ALTER TABLE: replicate the new schema into the sys catalog,
        then push it to every tablet leader (reference:
        CatalogManager::AlterTable + async AlterTable RPCs to tservers).
        Tablet leaders replicate the change through their own Raft log."""
        if not self.raft.is_leader():
            return self._not_leader()
        t = self.catalog.table_by_name(p["name"])
        if t is None:
            return {"code": "not_found"}
        new_schema = p["schema"]
        cur = t.schema.get("version", 0)
        if new_schema.get("version", 0) <= cur:
            # A client retry of the SAME ALTER is idempotent success; a
            # DIFFERENT schema at a consumed version lost a concurrent
            # DDL race and must re-plan from the current schema.
            if new_schema.get("version", 0) == cur and \
                    new_schema.get("columns") == t.schema.get("columns"):
                return {"code": "ok", "version": cur}
            return {"code": "version_mismatch", "current_version": cur}
        if new_schema.get("version", 0) != cur + 1:
            return {"code": "version_mismatch",
                    "current_version": cur}
        try:
            self.raft.replicate("catalog", {
                "op": "alter_table", "table_id": t.table_id,
                "schema": new_schema}, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        errors = []
        for info in self.catalog.tablets_of(t.table_id):
            if not self._deliver_schema(info, new_schema):
                errors.append(info.tablet_id)
        if errors:
            # The catalog already holds the new schema: the balancer loop
            # retries delivery until every tablet leader replicated it.
            self._pending_alters.update(
                (t.table_id, tid) for tid in errors)
            return {"code": "partial", "tablets": errors}
        return {"code": "ok", "version": new_schema.get("version", 0)}

    def _h_master_create_index(self, p: dict):
        """Create a secondary index: an index TABLE (hash = the indexed
        column, range = the base PK) plus an IndexInfo record on the base
        table; base-tablet leaders learn the index set via ts.set_indexes
        and maintain it in their write path (reference:
        CatalogManager::CreateTable's index branch + Tablet::UpdateQLIndexes)."""
        if not self.raft.is_leader():
            return self._not_leader()
        from yugabyte_db_tpu_torch.index import index_schema, index_table_name

        base = self.catalog.table_by_name(p["table"])
        if base is None:
            return {"code": "not_found"}
        columns = list(p.get("columns") or
                       ([p["column"]] if p.get("column") else []))
        include = list(p.get("include") or [])
        if not columns:
            return {"code": "error", "message": "no indexed columns"}
        name = p.get("index_name") or \
            f"{p['table']}_{'_'.join(columns)}_idx"
        if any(i["name"] == name for i in base.indexes):
            return {"code": "already_present", "index_table":
                    next(i["index_table"] for i in base.indexes
                         if i["name"] == name)}
        base_schema = Schema.from_dict(base.schema)
        itable = index_table_name(p["table"], columns, p.get("index_name"))
        try:
            ischema = index_schema(base_schema, columns, itable, include)
        except (ValueError, KeyError) as e:
            return {"code": "error", "message": str(e)}
        # Inherit the base table's replication factor (its tablets'
        # replica count) unless the caller overrides it.
        base_tablets = self.catalog.tablets_of(base.table_id)
        base_rf = (len(base_tablets[0].replicas) if base_tablets else 3)
        create = self._h_master_create_table({
            "name": itable, "schema": ischema.to_dict(),
            "num_tablets": p.get("num_tablets", base.num_tablets),
            "replication_factor": p.get("replication_factor", base_rf),
            "engine": base.engine,
        })
        if create["code"] not in ("ok", "partial", "already_present"):
            return create
        op = {"op": "create_index", "table_id": base.table_id,
              "index": {"name": name, "column": columns[0],
                        "columns": columns, "include": include,
                        "index_table": itable}}
        try:
            self.raft.replicate("catalog", op, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        self._push_index_sets(base.table_id)
        return {"code": "ok", "index_table": itable}

    def _push_index_sets(self, table_id: str) -> None:
        """Tell every replica of the base table its current index set."""
        t = self.catalog.tables.get(table_id)
        if t is None:
            return
        for info in self.catalog.tablets_of(table_id):
            for replica in info.replicas:
                # Best effort: replicas recover the index set from
                # ts.create_tablet on restart, but a refused push should
                # still be visible somewhere.
                try:
                    resp = self.transport.send(replica, "ts.set_indexes", {
                        "tablet_id": info.tablet_id,
                        "indexes": list(t.indexes),
                    }, timeout=5.0)
                    if resp.get("code") != "ok":
                        count_swallowed("master.push_index_sets",
                                        resp.get("code"))
                except Exception as e:  # noqa: BLE001
                    count_swallowed("master.push_index_sets", e)

    def _h_master_drop_index(self, p: dict):
        if not self.raft.is_leader():
            return self._not_leader()
        base = self.catalog.table_by_name(p["table"])
        if base is None:
            return {"code": "not_found"}
        idx = next((i for i in base.indexes if i["name"] == p["name"]),
                   None)
        if idx is None:
            return {"code": "not_found"}
        try:
            self.raft.replicate("catalog", {
                "op": "drop_index", "table_id": base.table_id,
                "name": p["name"]}, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        self._push_index_sets(base.table_id)
        self._h_master_delete_table({"name": idx["index_table"]})
        return {"code": "ok"}

    def _h_master_delete_table(self, p: dict):
        if not self.raft.is_leader():
            return self._not_leader()
        t = self.catalog.table_by_name(p["name"])
        if t is None:
            return {"code": "not_found"}
        tablets = self.catalog.tablets_of(t.table_id)
        try:
            self.raft.replicate("catalog",
                                {"op": "delete_table", "table_id": t.table_id},
                                timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        for info in tablets:
            for replica in info.replicas:
                try:
                    resp = self.transport.send(replica, "ts.delete_tablet",
                                               {"tablet_id": info.tablet_id},
                                               timeout=5.0)
                    if resp.get("code") not in ("ok", "not_found"):
                        count_swallowed("master.delete_tablet",
                                        resp.get("code"))
                except Exception as e:  # noqa: BLE001 — heartbeat GC retries
                    count_swallowed("master.delete_tablet", e)
        return {"code": "ok"}

    # -- tablet splitting / leader balancing (admin RPCs) --------------------
    def _h_master_split_tablet(self, p: dict):
        """Manually split one tablet (yb_admin split_tablet). Works
        regardless of the automatic-splitting flags — the thresholds
        gate the background pass, not the protocol."""
        if not self.raft.is_leader():
            return self._not_leader()
        tid = p["tablet_id"]
        info = self.catalog.tablets.get(tid)
        if info is None:
            return {"code": "not_found"}
        if p.get("table"):
            t = self.catalog.table_by_name(p["table"])
            if t is None or info.table_id != t.table_id:
                return {"code": "not_found",
                        "message": f"tablet {tid} is not in table "
                                   f"{p['table']}"}
        try:
            res = self.split_manager.split(
                tid, timeout=float(p.get("timeout", 30.0)))
        except NotLeader:
            return self._not_leader()
        except SplitError as e:
            return {"code": "error", "message": str(e)}
        return {"code": "ok", **res}

    def _h_master_rebalance(self, p: dict):
        """Run one forced leader-balancing pass (yb_admin rebalance);
        returns the move made, or move=None when already balanced."""
        if not self.raft.is_leader():
            return self._not_leader()
        move = self.load_balancer.run_pass(force=True)
        return {"code": "ok", "move": move,
                "leader_counts": self.ts_manager.leader_counts()}

    # -- lookups ------------------------------------------------------------
    def _h_master_get_table(self, p: dict):
        t = self.catalog.table_by_name(p["name"])
        if t is None:
            return {"code": "not_found"}
        return {"code": "ok", "table_id": t.table_id, "name": t.name,
                "schema": t.schema, "num_tablets": t.num_tablets,
                "engine": t.engine, "indexes": list(t.indexes)}

    def _h_master_get_table_locations(self, p: dict):
        t = self.catalog.table_by_name(p["name"])
        if t is None:
            return {"code": "not_found"}
        out = []
        for info in self.catalog.tablets_of(t.table_id):
            out.append({
                "tablet_id": info.tablet_id,
                "partition_start": info.partition_start,
                "partition_end": info.partition_end,
                "replicas": [
                    {"uuid": r, "addr": self.ts_manager.addr_of(r),
                     "cloud_info": self.ts_manager.cloud_info_of(r)}
                    for r in info.replicas
                ],
                "leader": self.ts_manager.leader_of(info.tablet_id),
            })
        out.sort(key=lambda d: d["partition_start"])
        return {"code": "ok", "table_id": t.table_id, "schema": t.schema,
                "tablets": out}

    def _h_master_locate_tablet(self, p: dict):
        """Replica set + freshest known leader of one tablet (used by the
        transaction notifier/resolvers to route per-tablet RPCs)."""
        info = self.catalog.tablets.get(p["tablet_id"])
        if info is None:
            return {"code": "not_found"}
        return {"code": "ok", "tablet_id": info.tablet_id,
                "replicas": list(info.replicas),
                "leader": self.ts_manager.leader_of(info.tablet_id)}

    def _h_master_list_tables(self, p: dict):
        return {"code": "ok", "tables": [
            {"table_id": t.table_id, "name": t.name, "state": t.state,
             "num_tablets": t.num_tablets}
            for t in self.catalog.list_tables()
        ]}

    # -- auth/roles (reference: CreateRole/GrantRevokeRole/
    # GrantRevokePermission, master.proto:1383-1388) ------------------------
    def _h_master_auth_op(self, p: dict):
        """Replicate one role/permission mutation through the catalog.
        The op is validated against current state first so obvious
        errors (duplicate role, unknown role) fail without a Raft round;
        apply-time errors surface as error responses."""
        if not self.raft.is_leader():
            return self._not_leader()
        op = dict(p["auth"])
        try:
            # Dry-run validation against a copy keeps apply() (the
            # replicated path) deterministic and non-throwing.
            from yugabyte_db_tpu_torch.auth import RoleStore

            RoleStore.from_dict(self.catalog.auth.to_dict()).apply(op)
        except Exception as e:  # noqa: BLE001
            return {"code": "error", "message": str(e)}
        try:
            self.raft.replicate("catalog", op, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        return {"code": "ok"}

    def _h_master_get_auth(self, p: dict):
        # Leader-only: a follower may lag the latest role DDL and a
        # stale mirror would let a just-revoked permission keep working.
        if not self.raft.is_leader():
            return self._not_leader()
        return {"code": "ok", "auth": self.catalog.auth.to_dict()}

    def _h_master_type_op(self, p: dict):
        """CREATE/DROP TYPE through the replicated catalog (reference:
        CatalogManager::CreateUDType/DeleteUDType)."""
        if not self.raft.is_leader():
            return self._not_leader()
        action = p["action"]
        name = p["name"]
        if action == "create":
            if name in self.catalog.types:
                return {"code": "already_present"}
            op = {"op": "create_type", "name": name,
                  "fields": [list(f) for f in p["fields"]]}
        else:
            if name not in self.catalog.types:
                return {"code": "not_found"}
            for t in self.catalog.list_tables():
                for c in t.schema.get("columns", []):
                    if c.get("udt") == name:
                        return {"code": "error", "message":
                                f"type {name} in use by table {t.name}"}
            op = {"op": "drop_type", "name": name}
        try:
            self.raft.replicate("catalog", op, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        return {"code": "ok"}

    def _h_master_misc_op(self, p: dict):
        """Views + sequences through the replicated catalog; sequence
        allocation is serialized here so every allocation returns a
        distinct base (holes on crash/retry are allowed — PG nextval's
        own contract)."""
        action = p["action"]
        if action == "get_view":
            q = self.catalog.views.get(p["name"])
            return ({"code": "ok", "query": q} if q is not None
                    else {"code": "not_found"})
        if action == "list_keyspaces":
            return {"code": "ok",
                    "keyspaces": sorted(self.catalog.user_keyspaces)}
        if not self.raft.is_leader():
            return self._not_leader()
        if action == "create_view":
            if p["name"] in self.catalog.views and not p.get("replace"):
                return {"code": "already_present"}
            op = {"op": "create_view", "name": p["name"],
                  "query": p["query"]}
        elif action == "drop_view":
            if p["name"] not in self.catalog.views:
                return {"code": "not_found"}
            op = {"op": "drop_view", "name": p["name"]}
        elif action == "create_keyspace":
            if p["name"] in self.catalog.user_keyspaces:
                return {"code": "already_present"}
            op = {"op": "create_keyspace", "name": p["name"]}
        elif action == "drop_keyspace":
            if p["name"] not in self.catalog.user_keyspaces:
                return {"code": "not_found"}
            op = {"op": "drop_keyspace", "name": p["name"]}
        elif action == "create_sequence":
            if p["name"] in self.catalog.sequences:
                return {"code": "already_present"}
            op = {"op": "create_sequence", "name": p["name"]}
        elif action == "drop_sequence":
            if p["name"] not in self.catalog.sequences:
                return {"code": "not_found"}
            op = {"op": "drop_sequence", "name": p["name"]}
        elif action == "sequence_next":
            if p["name"] not in self.catalog.sequences:
                return {"code": "not_found"}
            n = int(p.get("n", 1))
            with self._seq_lock:
                base = self.catalog.sequences[p["name"]]
                try:
                    # Justified hold: the read of `base` must be atomic
                    # with the alloc's position in the Raft log — two
                    # racing nexts reading the same base would both hand
                    # out [base, base+n). _seq_lock serializes only
                    # sequence allocation, never the general catalog path.
                    # yb-lint: disable=iholds/lock-across-blocking
                    self.raft.replicate("catalog", {
                        "op": "sequence_alloc", "name": p["name"],
                        "n": n}, timeout=self._op_deadline(p))
                except NotLeader:
                    return self._not_leader()
            return {"code": "ok", "base": base}
        else:
            return {"code": "error", "message": f"bad action {action}"}
        try:
            self.raft.replicate("catalog", op, timeout=self._op_deadline(p))
        except NotLeader:
            return self._not_leader()
        return {"code": "ok"}

    def _h_master_snapshot_op(self, p: dict):
        """Master-coordinated cluster snapshots (reference: the
        CreateSnapshot/RestoreSnapshot master RPCs fanning
        backup.proto TabletSnapshotOp to every tablet, tracked as
        SysSnapshotEntryPB states in the sys catalog). States:
        CREATING -> COMPLETE | FAILED; restore/delete require
        COMPLETE. The registry rides the replicated catalog, so it
        survives master failover and restarts."""
        action = p.get("action")
        if action == "list":
            return {"code": "ok", "snapshots": {
                sid: dict(rec)
                for sid, rec in self.catalog.snapshots.items()}}
        if not self.raft.is_leader():
            return self._not_leader()
        sid = p.get("snapshot_id") or ""
        if not sid:
            return {"code": "error", "message": "missing snapshot_id"}
        if action == "create":
            if not p.get("table"):
                return {"code": "error", "message": "missing table"}
            t = self.catalog.table_by_name(p["table"])
            if t is None:
                return {"code": "not_found"}
            if sid in self.catalog.snapshots:
                return {"code": "already_present"}
            tablets = self.catalog.tablets_of(t.table_id)
            try:
                self.raft.replicate("catalog", {
                    "op": "snapshot_record", "snapshot_id": sid,
                    "table": p["table"], "state": "CREATING",
                    "tablets": [ti.tablet_id for ti in tablets]},
                    timeout=self._op_deadline(p))
            except NotLeader:
                return self._not_leader()
            errs = self._snapshot_fanout(tablets, sid, "create_snapshot")
            state = "FAILED" if errs else "COMPLETE"
            try:
                self.raft.replicate("catalog", {
                    "op": "snapshot_record", "snapshot_id": sid,
                    "table": p["table"], "state": state,
                    "tablets": [ti.tablet_id for ti in tablets]},
                    timeout=self._op_deadline(p))
            except NotLeader:
                return self._not_leader()
            if errs:
                return {"code": "error",
                        "message": f"snapshot {sid}: {errs[0]}"}
            return {"code": "ok", "tablets": len(tablets)}
        rec = self.catalog.snapshots.get(sid)
        if rec is None:
            return {"code": "not_found"}
        t = self.catalog.table_by_name(rec["table"])
        if t is None:
            return {"code": "not_found",
                    "message": f"table {rec['table']} gone"}
        tablets = self.catalog.tablets_of(t.table_id)
        if action == "restore":
            if rec["state"] != "COMPLETE":
                return {"code": "error",
                        "message": f"snapshot {sid} is {rec['state']}"}
            errs = self._snapshot_fanout(tablets, sid,
                                         "restore_snapshot")
            if errs:
                return {"code": "error",
                        "message": f"restore {sid}: {errs[0]}"}
            return {"code": "ok", "tablets": len(tablets)}
        if action == "delete":
            errs = self._snapshot_fanout(tablets, sid, "delete_snapshot")
            if errs:
                # Keep the registry entry so the delete is retryable;
                # removing it would orphan per-tablet snapshot data on
                # the replicas that did not get the op.
                return {"code": "error",
                        "message": f"delete {sid}: {errs[0]}"}
            try:
                self.raft.replicate("catalog", {
                    "op": "snapshot_remove", "snapshot_id": sid},
                    timeout=self._op_deadline(p))
            except NotLeader:
                return self._not_leader()
            return {"code": "ok"}
        return {"code": "error", "message": f"bad action {action!r}"}

    def _snapshot_fanout(self, tablets, sid: str, op: str) -> list[str]:
        """Run one snapshot op on every tablet's LEADER (follow
        not_leader hints); returns error strings (empty = success)."""
        errs = []
        for ti in tablets:
            payload = {"tablet_id": ti.tablet_id, "snapshot_id": sid,
                       "op": op}
            last = "no replicas"
            done = False
            tried = set()
            candidates = list(ti.replicas)
            while candidates:
                dst = candidates.pop(0)
                if dst in tried:
                    continue
                tried.add(dst)
                try:
                    resp = self.transport.send(dst, "ts.snapshot_op",
                                               payload, timeout=10.0)
                except Exception as e:  # noqa: BLE001 — try the next
                    last = str(e)
                    continue
                if resp.get("code") == "ok":
                    done = True
                    break
                last = resp.get("message", resp.get("code"))
                hint = resp.get("leader_hint")
                if hint and hint not in tried:
                    candidates.insert(0, hint)
            if not done:
                errs.append(f"{ti.tablet_id}: {last}")
        return errs

    def _h_master_list_types(self, p: dict):
        return {"code": "ok", "types": {
            n: [list(f) for f in fs]
            for n, fs in self.catalog.types.items()}}

    def _h_master_list_tservers(self, p: dict):
        now_dead = {d.uuid for d in self.ts_manager.dead_tservers()}
        return {"code": "ok", "tservers": [
            {"uuid": d.uuid, "addr": d.addr, "alive": d.uuid not in now_dead,
             "num_live_tablets": d.num_live_tablets,
             "cloud_info": dict(d.cloud_info)}
            for d in self.ts_manager.all_tservers()
        ]}

    # -- heartbeats ----------------------------------------------------------
    def _h_master_ts_heartbeat(self, p: dict):
        if not self.raft.is_leader():
            return self._not_leader()
        self.ts_manager.heartbeat(p)
        resp = {"code": "ok", "master_uuid": self.uuid}
        st = self.raft.stats()
        # Orphan GC is destructive: a new leader's LOCAL watermarks can lag
        # the true cluster commit until its own-term no_op is applied, so a
        # just-committed table could look absent from the catalog. Gate on
        # leader_ready() (own-term entry applied) AND fully-applied.
        if self.raft.leader_ready() and \
                st["applied_index"] >= st["commit_index"]:
            # Catalog fully applied: safe to identify orphaned replicas
            # (reference: master orders deletion of tablets not in catalog,
            # and of replicas no longer in the tablet's config).
            known = self.catalog.known_tablet_ids()
            now = time.monotonic()
            to_delete = []
            for t in p.get("tablets", []):
                tid = t["tablet_id"]
                if tid not in known:
                    to_delete.append(tid)
                    continue
                if now - self._fixing.get(tid, 0) < 30.0:
                    continue  # re-replication in flight; don't race it
                info = self.catalog.tablets.get(tid)
                if info is not None and p["ts_uuid"] not in info.replicas:
                    to_delete.append(tid)
                # Index-set reconciliation: a lost ts.set_indexes push
                # must not leave a replica maintaining a stale index set.
                if info is not None and "index_names" in t:
                    table = self.catalog.tables.get(info.table_id)
                    if table is not None:
                        want = sorted(i["name"] for i in table.indexes)
                        if want != t["index_names"]:
                            try:
                                r = self.transport.send(
                                    p["ts_uuid"], "ts.set_indexes", {
                                        "tablet_id": tid,
                                        "indexes": list(table.indexes),
                                    }, timeout=2.0)
                                if r.get("code") != "ok":
                                    count_swallowed("master.hb_set_indexes",
                                                    r.get("code"))
                            except Exception as e:  # noqa: BLE001 — next beat
                                count_swallowed("master.hb_set_indexes", e)
            resp["tablets_to_delete"] = sorted(to_delete)
        return resp

    def _rpc_ok(self, dst: str, method: str, payload: dict,
                timeout: float = 5.0) -> dict:
        resp = self.transport.send(dst, method, payload, timeout=timeout)
        if resp.get("code") != "ok":
            raise RuntimeError(f"{method} to {dst}: {resp}")
        return resp

    # -- re-replication (ClusterLoadBalancer's failure-recovery half) --------
    def _balancer_loop(self) -> None:
        while self._running:
            time.sleep(self.balance_interval_s)
            if not self._running or not self.raft.is_leader():
                continue
            try:
                self._rereplicate_once()
            except Exception as e:  # noqa: BLE001 — next tick retries
                count_swallowed("master.rereplicate_tick", e)
            try:
                self._retry_pending_alters()
            except Exception as e:  # noqa: BLE001 — next tick retries
                count_swallowed("master.retry_alters_tick", e)
            try:
                self.split_manager.run_pass()
            except Exception as e:  # noqa: BLE001 — next tick retries
                count_swallowed("master.split_tick", e)
            try:
                self.load_balancer.run_pass()
            except Exception as e:  # noqa: BLE001 — next tick retries
                count_swallowed("master.balance_tick", e)

    def _deliver_schema(self, info, schema_dict: dict) -> bool:
        """Push a schema version to one tablet's leader (whichever
        replica that is); True once a leader replicated it."""
        for replica in info.replicas:
            try:
                resp = self.transport.send(
                    replica, "ts.alter_schema",
                    {"tablet_id": info.tablet_id, "schema": schema_dict},
                    timeout=5.0)
                if resp.get("code") == "ok":
                    return True
            except Exception as e:  # noqa: BLE001 — try other replicas
                count_swallowed("master.alter_schema", e)
                continue
        return False

    def _retry_pending_alters(self) -> None:
        if not self.raft.leader_ready() or not self._pending_alters:
            return
        for table_id, tablet_id in list(self._pending_alters):
            t = self.catalog.tables.get(table_id)
            info = self.catalog.tablets.get(tablet_id)
            if t is None or info is None or \
                    self._deliver_schema(info, t.schema):
                self._pending_alters.discard((table_id, tablet_id))

    def _rereplicate_once(self) -> None:
        live = sorted(self.ts_manager.live_tservers(),
                      key=lambda d: d.num_live_tablets)
        if not live:
            return
        self._recreate_missing_replicas(live)
        self._repair_live_missing_replicas(live)
        dead = {d.uuid for d in self.ts_manager.dead_tservers()}
        if not dead:
            return
        now = time.monotonic()
        for t in self.catalog.list_tables():
            for info in self.catalog.tablets_of(t.table_id):
                bad = [r for r in info.replicas if r in dead]
                if not bad:
                    continue
                if now - self._fixing.get(info.tablet_id, 0) < 10.0:
                    continue  # a fix is already in flight
                without_dead = [r for r in info.replicas if r != bad[0]]
                # Zone-aware replacement: avoid the zones the surviving
                # replicas already occupy when another zone has capacity.
                live_by_uuid = {d.uuid: d for d in live}
                existing_zones = [self._zone_of(live_by_uuid[r])
                                  for r in without_dead if r in live_by_uuid]
                picks = self._select_replicas(
                    live, 1, {d.uuid: d.num_live_tablets for d in live},
                    exclude=set(info.replicas), existing_zones=existing_zones)
                if not picks:
                    continue
                self._fixing[info.tablet_id] = now
                replacement = picks[0]
                with_new = without_dead + [replacement]
                leader = self.ts_manager.leader_of(info.tablet_id)
                if leader is None or leader in dead or leader not in \
                        without_dead:
                    continue  # wait for the group to elect a live leader
                try:
                    # Raft membership changes are one server at a time:
                    # REMOVE the dead replica, then ADD the replacement
                    # (reference: ChangeConfig REMOVE_SERVER/ADD_SERVER).
                    self._rpc_ok(leader, "ts.change_config", {
                        "tablet_id": info.tablet_id,
                        "peers": without_dead,
                    }, timeout=10.0)
                    # Not a voter yet: the leader's change_config adds it.
                    self._rpc_ok(replacement, "ts.create_tablet",
                                 self._create_tablet_req(
                                     info.tablet_id, t.name, t.schema,
                                     info.partition_start, info.partition_end,
                                     t.engine, without_dead,
                                     indexes=t.indexes), timeout=5.0)
                    self._rpc_ok(leader, "ts.change_config", {
                        "tablet_id": info.tablet_id,
                        "peers": with_new,
                    }, timeout=10.0)
                    self.raft.replicate("catalog", {
                        "op": "set_tablet_replicas",
                        "tablet_id": info.tablet_id,
                        "replicas": with_new,
                    })
                except Exception:  # noqa: BLE001 — retried next tick
                    self._fixing.pop(info.tablet_id, None)

    def _repair_live_missing_replicas(self, live) -> None:
        """A live, heartbeating tserver that persistently does NOT report a
        replica the catalog assigns to it either never created it (the
        dispatch failure was lost with a master restart/failover, so
        _failed_creates can't retry it) or lost its disk. Both repair
        safely through a config cycle: REMOVE the replica from the group,
        hand the tserver a fresh one, ADD it back — it rejoins as a new
        member and catches up from the leader, never voting on the
        strength of an empty log (reference: the load balancer's
        remove-then-add path, src/yb/master/cluster_balance.cc)."""
        if not self.raft.leader_ready():
            return
        now = time.monotonic()
        live_by_uuid = {d.uuid: d for d in live}
        tracked = set()
        for t in self.catalog.list_tables():
            for info in self.catalog.tablets_of(t.table_id):
                for r in info.replicas:
                    key = (info.tablet_id, r)
                    d = live_by_uuid.get(r)
                    if d is None or key in self._failed_creates:
                        continue  # dead-TS / direct-retry paths own these
                    if info.tablet_id in d.tablet_roles:
                        # Hosted — but is it a MEMBER? If a previous repair
                        # cycle crashed between its create and add-back
                        # steps, the replica hosts an orphan copy outside
                        # the group config; finish the add-back (the raft
                        # config arrives with the leader's heartbeat).
                        cfg = self.ts_manager.config_of(info.tablet_id)
                        if cfg is None or r in cfg:
                            continue
                        tracked.add(key)
                        first = self._missing_seen.setdefault(key, now)
                        if now - first < self.missing_replica_grace_s:
                            continue
                        if now - self._fixing.get(info.tablet_id, 0) < 10.0:
                            continue
                        leader = self.ts_manager.leader_of(info.tablet_id)
                        if leader is None or leader not in live_by_uuid:
                            continue
                        self._fixing[info.tablet_id] = now
                        try:
                            self._rpc_ok(leader, "ts.change_config", {
                                "tablet_id": info.tablet_id,
                                "peers": sorted(set(cfg) | {r}),
                            }, timeout=10.0)
                            self._missing_seen.pop(key, None)
                            tracked.discard(key)
                        except Exception:  # noqa: BLE001 — next tick
                            self._fixing.pop(info.tablet_id, None)
                        continue
                    tracked.add(key)
                    first = self._missing_seen.setdefault(key, now)
                    if now - first < self.missing_replica_grace_s:
                        continue
                    if now - self._fixing.get(info.tablet_id, 0) < 10.0:
                        continue
                    others = [x for x in info.replicas if x != r]
                    leader = self.ts_manager.leader_of(info.tablet_id)
                    if not others or leader is None or leader not in others \
                            or leader not in live_by_uuid:
                        continue  # RF=1 or no live leader: cannot cycle
                    self._fixing[info.tablet_id] = now
                    try:
                        self._rpc_ok(leader, "ts.change_config", {
                            "tablet_id": info.tablet_id, "peers": others,
                        }, timeout=10.0)
                        self._rpc_ok(r, "ts.create_tablet",
                                     self._create_tablet_req(
                                         info.tablet_id, t.name, t.schema,
                                         info.partition_start,
                                         info.partition_end, t.engine,
                                         others, indexes=t.indexes),
                                     timeout=5.0)
                        self._rpc_ok(leader, "ts.change_config", {
                            "tablet_id": info.tablet_id,
                            "peers": info.replicas,
                        }, timeout=10.0)
                        self._missing_seen.pop(key, None)
                        tracked.discard(key)
                    except Exception:  # noqa: BLE001 — next tick retries
                        self._fixing.pop(info.tablet_id, None)
        # Forget pairs that are no longer missing (reported again, table
        # dropped, or replica re-placed).
        for key in list(self._missing_seen):
            if key not in tracked:
                self._missing_seen.pop(key, None)

    def _recreate_missing_replicas(self, live) -> None:
        """Retry ts.create_tablet for replicas whose ORIGINAL create failed
        (tracked in _failed_creates — create_table returned 'partial').
        Restricted to tracked failures on purpose: a live tserver merely not
        reporting a tablet may have lost its disk, and handing a still-voting
        replica a fresh empty log could elect a leader without committed
        entries. Those are repaired by remote bootstrap, not re-creation."""
        if not self.raft.leader_ready() or not self._failed_creates:
            return  # local catalog view may lag; don't act on it
        now = time.monotonic()
        live_uuids = {d.uuid for d in live}
        for tablet_id, replica in list(self._failed_creates):
            info = self.catalog.tablets.get(tablet_id)
            if info is None or replica not in info.replicas:
                self._failed_creates.discard((tablet_id, replica))
                continue  # table dropped or replica re-placed meanwhile
            if replica not in live_uuids:
                continue  # dead-TS path handles it
            if now - self._fixing.get(tablet_id, 0) < 10.0:
                continue
            t = self.catalog.tables.get(info.table_id)
            if t is None:
                continue
            self._fixing[tablet_id] = now
            try:
                resp = self.transport.send(replica, "ts.create_tablet",
                                           self._create_tablet_req(
                                               tablet_id, t.name, t.schema,
                                               info.partition_start,
                                               info.partition_end, t.engine,
                                               info.replicas,
                                               indexes=t.indexes),
                                           timeout=5.0)
                if resp.get("code") == "ok":
                    self._failed_creates.discard((tablet_id, replica))
                else:
                    count_swallowed("master.recreate_replica",
                                    resp.get("code"))
            except Exception as e:  # noqa: BLE001 — next tick retries
                count_swallowed("master.recreate_replica", e)
