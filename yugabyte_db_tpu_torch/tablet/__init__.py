"""The tablet: one shard of a table.

Reference analog: src/yb/tablet (Tablet, MvccManager, operation pipeline,
TabletBootstrap) + src/yb/consensus/log* (the WAL). A tablet owns its
storage engine behind the pluggable seam (tablet.h:648), an MVCC manager
for safe-time reads (mvcc.h:46), and its durability comes from its log —
the storage engine has no WAL of its own, matching the reference's
disabled-rocksdb-WAL design (consensus/README).

The port's copy of the JAX package's ``tablet`` package: ``Tablet`` on the
``gpu`` engine, its WAL, MVCC manager and retryable-request registry.
Left out: ``TabletPeer`` and the consensus it drives, which come in later
slices (ROADMAP.md §1 item 12).
"""

from yugabyte_db_tpu_torch.tablet.mvcc import MvccManager
from yugabyte_db_tpu_torch.tablet.tablet import Tablet, TabletMetadata
from yugabyte_db_tpu_torch.tablet.wal import Log, LogEntry, OpId

__all__ = ["Log", "LogEntry", "MvccManager", "OpId", "Tablet",
           "TabletMetadata"]
