"""Structured daemon options layered over flags.

Reference analog: src/yb/server/server_base_options.h
(ServerBaseOptions) and the per-daemon TabletServerOptions /
MasterOptions — a typed bag of knobs constructed once at daemon start,
with defaults drawn from the flag registry.

The port's copy of the JAX package's ``server/options.py``. Its one
departure: ``TabletServerOptions.tablet_storage_engine`` defaults to
``"gpu"`` (the JAX default ``"cpu"`` is not registered in the port;
ROADMAP.md §1 item 16).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.utils.flags import FLAGS


@dataclass
class ServerOptions:
    fsync: bool = True
    webserver: bool = False          # start the embedded HTTP server
    webserver_host: str = "127.0.0.1"
    webserver_port: int = 0          # 0 = ephemeral
    engine_options: dict = field(default_factory=dict)


@dataclass
class TabletServerOptions(ServerOptions):
    heartbeat_interval_s: float = 0.5
    tablet_storage_engine: str = "gpu"
    # Topology labels for zone-aware placement (reference: CloudInfoPB,
    # src/yb/master/master.proto:172): {"cloud", "region", "zone"}.
    cloud_info: dict | None = None


@dataclass
class MasterOptions(ServerOptions):
    # None -> resolved from the follower_unavailable flag at construction
    # (not frozen at import time).
    ts_unresponsive_timeout_s: float | None = None
    balance_interval_s: float = 1.0
    missing_replica_grace_s: float = 10.0

    def resolved_ts_timeout(self) -> float:
        if self.ts_unresponsive_timeout_s is not None:
            return self.ts_unresponsive_timeout_s
        return FLAGS.get("follower_unavailable_considered_failed_sec")
