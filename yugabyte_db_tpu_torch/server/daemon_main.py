"""Daemon entry point: run one master or tserver as a real OS process.

Reference analog: src/yb/master/master_main.cc and
src/yb/tserver/tablet_server_main.cc:107 — the production processes
yb-ctl spawns. Each process owns a Messenger listening on its RPC port,
a SocketTransport with the cluster's address book, and an embedded
webserver.

Usage:
  python -m yugabyte_db_tpu_torch.server.daemon_main --role tserver \
      --uuid ts-0 --data-dir /data/ts-0 \
      --topology m-0=127.0.0.1:7100,ts-0=127.0.0.1:9100,... \
      --masters m-0 --web-port 9200

The port's copy of the JAX package's ``server/daemon_main.py``, both
roles, plus ``--device`` (default ``cuda``), which the tablet server's
engines take as ``engine_options={"device": ...}``, so that a caller asks
for the CPU (``--device cpu``, as the tests do). A master builds no
engine; it accepts the option all the same.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def parse_topology(spec: str) -> dict[str, tuple[str, int]]:
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        uuid, addr = part.split("=", 1)
        host, port = addr.rsplit(":", 1)
        out[uuid] = (host, int(port))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="yb-daemon")
    ap.add_argument("--role", choices=("master", "tserver"), required=True)
    ap.add_argument("--uuid", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--topology", required=True,
                    help="uuid=host:port,... for every daemon")
    ap.add_argument("--masters", required=True,
                    help="comma-separated master uuids")
    ap.add_argument("--web-port", type=int, default=0)
    ap.add_argument("--no-fsync", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the torch device of the tablets' gpu engines")
    args = ap.parse_args(argv)

    from yugabyte_db_tpu_torch.rpc import Messenger, SocketTransport

    topology = parse_topology(args.topology)
    if args.uuid not in topology:
        ap.error(f"--topology lacks own uuid {args.uuid}")
    host, port = topology[args.uuid]
    master_uuids = [u.strip() for u in args.masters.split(",") if u.strip()]

    transport = SocketTransport()
    for uuid, (h, p) in topology.items():
        transport.set_address(uuid, h, p)

    if args.role == "master":
        from yugabyte_db_tpu_torch.master.master import Master

        daemon = Master(args.uuid, args.data_dir, transport, master_uuids,
                        fsync=not args.no_fsync)
    else:
        from yugabyte_db_tpu_torch.tserver.tablet_server import TabletServer

        daemon = TabletServer(args.uuid, args.data_dir, transport,
                              master_uuids, fsync=not args.no_fsync,
                              engine_options={"device": args.device})
    messenger = Messenger(args.uuid, num_workers=16)
    # Consensus traffic rides a dedicated pool: user writes block their
    # workers on majority replication, and the raft RPCs that complete
    # that majority must never queue behind them (reference: separate
    # ServicePools per service, src/yb/rpc/service_pool.cc).
    messenger.add_service_pool("raft.", 8)
    bound = messenger.listen(host, port, daemon.handle)
    daemon.advertised_addr = bound
    daemon.start()
    web_addr = daemon.start_webserver("127.0.0.1", args.web_port)
    print(f"{args.role} {args.uuid} rpc={bound[0]}:{bound[1]} "
          f"web={web_addr[0]}:{web_addr[1]}", flush=True)

    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    stop.wait()
    daemon.shutdown()
    messenger.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
