"""Client library: location-aware, batching, retrying cluster access.

Reference analog: src/yb/client/ — YBClient (client.cc), YBSession +
Batcher grouping ops per tablet (batcher.h:80), MetaCache mapping
partition ranges to tablets and leaders (meta_cache.cc), and
TabletInvoker's replica-failover retry policy (tablet_rpc.h:52). The YQL
frontends sit on this API exactly as the reference's CQL/Redis/pggate
frontends sit on the C++ client.

The port's copy of the JAX package's ``client/`` package, whole.
"""

from yugabyte_db_tpu_torch.client.client import YBClient, YBTable
from yugabyte_db_tpu_torch.client.session import YBSession
from yugabyte_db_tpu_torch.client.transaction import (TransactionManager,
                                                YBTransaction)

__all__ = ["TransactionManager", "YBClient", "YBTable", "YBSession",
           "YBTransaction"]
