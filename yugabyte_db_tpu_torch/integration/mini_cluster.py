"""MiniCluster: N masters + M tservers, one process.

Reference analog: src/yb/integration-tests/mini_cluster.{h,cc}. Two
transports: "local" (in-process, with partition/isolate fault injection —
the ExternalMiniCluster kill-testing role) and "socket" (real loopback TCP
through the rpc layer, one Messenger per daemon).

The port's copy of the JAX package's ``integration/mini_cluster.py``.
Its tablets run on the port's ``gpu`` engine, on the device that
``engine_options={"device": ...}`` names: ``"cuda"`` unless the caller
asks for another (the tests ask for ``"cpu"``). ``start_cql_server``
and ``start_pg_server`` put the port's YCQL and YSQL frontends over a
``ClientCluster`` of this cluster.
"""

from __future__ import annotations

import os
import time

from yugabyte_db_tpu_torch.client import YBClient
from yugabyte_db_tpu_torch.consensus.raft import RaftOptions
from yugabyte_db_tpu_torch.consensus.transport import LocalTransport
from yugabyte_db_tpu_torch.master.master import Master
from yugabyte_db_tpu_torch.tserver.tablet_server import TabletServer

FAST_RAFT = RaftOptions(election_timeout_s=0.2, heartbeat_interval_s=0.04,
                        lease_s=0.5, rpc_timeout_s=1.0)


class MiniCluster:
    def __init__(self, data_root: str, num_masters: int = 1,
                 num_tservers: int = 3, transport: str = "local",
                 raft_opts: RaftOptions = FAST_RAFT, fsync: bool = False,
                 engine_options: dict | None = None,
                 ts_unresponsive_timeout_s: float = 2.0,
                 heartbeat_interval_s: float = 0.2,
                 ts_cloud_info: dict | None = None):
        self.data_root = data_root
        self.raft_opts = raft_opts
        self.fsync = fsync
        self.engine_options = (dict(engine_options) if engine_options
                               else {"device": "cuda"})
        self.heartbeat_interval_s = heartbeat_interval_s
        self.ts_unresponsive_timeout_s = ts_unresponsive_timeout_s
        # uuid -> {"cloud","region","zone"} labels (zone-aware placement)
        self.ts_cloud_info = ts_cloud_info or {}
        self.master_uuids = [f"m-{i}" for i in range(num_masters)]
        self.tserver_uuids = [f"ts-{i}" for i in range(num_tservers)]
        self.masters: dict[str, Master] = {}
        self.tservers: dict[str, TabletServer] = {}
        self._messengers: dict[str, object] = {}
        self.transport_kind = transport
        if transport == "local":
            self.transport = LocalTransport()
        elif transport == "socket":
            from yugabyte_db_tpu_torch.rpc import SocketTransport
            self.transport = SocketTransport()
        else:
            raise ValueError(transport)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MiniCluster":
        for uuid in self.master_uuids:
            self.start_master(uuid)
        for uuid in self.tserver_uuids:
            self.start_tserver(uuid)
        return self

    def _node_transport(self, uuid: str):
        if self.transport_kind == "local":
            return self.transport.bind(uuid)
        return self.transport

    def _wire_handler(self, uuid: str, handler) -> tuple | None:
        if self.transport_kind == "local":
            self.transport.register(uuid, handler)
            return None
        from yugabyte_db_tpu_torch.rpc import Messenger
        m = Messenger(uuid)
        host, port = m.listen("127.0.0.1", 0, handler)
        self.transport.set_address(uuid, host, port)
        self._messengers[uuid] = m
        return (host, port)

    def start_master(self, uuid: str) -> Master:
        master = Master(uuid, os.path.join(self.data_root, uuid),
                        self._node_transport(uuid), self.master_uuids,
                        raft_opts=self.raft_opts, fsync=self.fsync,
                        ts_unresponsive_timeout_s=self.ts_unresponsive_timeout_s,
                        balance_interval_s=0.3)
        master.advertised_addr = self._wire_handler(uuid, master.handle)
        self.masters[uuid] = master
        master.start()
        return master

    def start_tserver(self, uuid: str) -> TabletServer:
        ts = TabletServer(uuid, os.path.join(self.data_root, uuid),
                          self._node_transport(uuid), self.master_uuids,
                          raft_opts=self.raft_opts,
                          engine_options=self.engine_options,
                          fsync=self.fsync,
                          heartbeat_interval_s=self.heartbeat_interval_s,
                          cloud_info=self.ts_cloud_info.get(uuid))
        ts.advertised_addr = self._wire_handler(uuid, ts.handle)
        self.tservers[uuid] = ts
        ts.start()
        return ts

    def stop_tserver(self, uuid: str) -> None:
        """Stop a tserver (the ExternalMiniCluster 'kill')."""
        if self.transport_kind == "local":
            self.transport.unregister(uuid)
        else:
            m = self._messengers.pop(uuid, None)
            if m is not None:
                m.shutdown()
        ts = self.tservers.pop(uuid, None)
        if ts is not None:
            ts.shutdown()

    def restart_tserver(self, uuid: str) -> TabletServer:
        return self.start_tserver(uuid)

    def shutdown(self) -> None:
        for uuid in list(self.tservers):
            self.stop_tserver(uuid)
        for uuid, master in list(self.masters.items()):
            if self.transport_kind == "local":
                self.transport.unregister(uuid)
            else:
                m = self._messengers.pop(uuid, None)
                if m is not None:
                    m.shutdown()
            master.shutdown()
        self.masters.clear()
        if self.transport_kind == "socket":
            self.transport.close()

    # -- helpers ------------------------------------------------------------
    def client(self, name: str = "client",
               cloud_info: dict | None = None) -> YBClient:
        if self.transport_kind == "local":
            return YBClient(self.transport.bind(name), self.master_uuids,
                            cloud_info=cloud_info)
        return YBClient(self.transport, self.master_uuids,
                        cloud_info=cloud_info)

    def start_webservers(self) -> dict:
        """Start an embedded HTTP server (metrics/varz/tablets) on every
        daemon; returns {uuid: (host, port)}."""
        addrs = {}
        for uuid, m in self.masters.items():
            addrs[uuid] = m.start_webserver()
        for uuid, ts in self.tservers.items():
            addrs[uuid] = ts.start_webserver()
        self.web_addrs = addrs
        return addrs

    def leader_master(self, timeout_s: float = 10.0) -> Master:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for m in self.masters.values():
                if m.is_leader():
                    return m
            time.sleep(0.02)
        raise TimeoutError("no master leader")

    def wait_tservers_registered(self, n: int | None = None,
                                 timeout_s: float = 10.0) -> None:
        want = n if n is not None else len(self.tservers)
        master = self.leader_master(timeout_s)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(master.ts_manager.live_tservers()) >= want:
                return
            time.sleep(0.02)
        raise TimeoutError(
            f"{len(master.ts_manager.live_tservers())}/{want} tservers")

    def start_cql_server(self, host: str = "127.0.0.1", port: int = 0,
                         **cluster_kwargs):
        """Start a CQL native-protocol proxy over this cluster (the
        reference shape: the tserver process spawns the CQL server on
        port 9042, tablet_server_main.cc:211). Returns (server, (host,
        port)); caller shuts the server down."""
        from yugabyte_db_tpu_torch.yql.cql.client_cluster import ClientCluster
        from yugabyte_db_tpu_torch.yql.cql.server import CQLServer

        server = CQLServer(ClientCluster(self.client("cql-proxy"),
                                         **cluster_kwargs))
        addr = server.listen(host, port)
        return server, addr

    def start_pg_server(self, host: str = "127.0.0.1", port: int = 0,
                        **cluster_kwargs):
        """Start a PostgreSQL wire-protocol frontend over this cluster
        (the reference shape: the tserver spawns the SQL frontend on port
        5433, tablet_server_main.cc:160). Returns (server, (host, port));
        caller shuts the server down."""
        from yugabyte_db_tpu_torch.yql.cql.client_cluster import ClientCluster
        from yugabyte_db_tpu_torch.yql.pgsql.wire import PgServer

        server = PgServer(ClientCluster(self.client("pg-proxy"),
                                        **cluster_kwargs))
        addr = server.listen(host, port)
        return server, addr
