"""Tablet server: the data-node daemon.

Reference analog: src/yb/tserver/ — TabletServer (tablet_server.cc) hosting
TabletPeers through TSTabletManager (ts_tablet_manager.cc), serving
reads/writes (TabletServiceImpl, tablet_service.cc:718,1001), and
heartbeating to the master (heartbeater.h:54).

The port's copy of the JAX package's ``tserver/__init__.py``, whole.
"""

from yugabyte_db_tpu_torch.tserver.tablet_server import TabletServer

__all__ = ["TabletServer"]
