"""Master: the control plane — catalog, placement, liveness, balancing.

Reference analog: src/yb/master/ — CatalogManager (catalog_manager.cc,
CreateTable at :2015, CreateTabletsFromTable at :2274), the sys catalog
persisted through a Raft-replicated tablet (sys_catalog.h:75), TSManager
liveness from heartbeats (ts_manager.h), and ClusterLoadBalancer
(cluster_balance.cc). Masters form their own Raft group; only the leader
mutates the catalog, and every mutation is a replicated sys-catalog entry.

The port's copy of the JAX package's ``master/`` package, whole, on the
port's consensus, WAL and tablet servers. Its sys-catalog files (WAL
segments and ``consensus-meta.json``) are the JAX master's, byte for
byte; a table's engine defaults to ``"gpu"``.
"""

from yugabyte_db_tpu_torch.master.master import Master

__all__ = ["Master"]
