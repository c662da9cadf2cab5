"""Storage: MVCC row versions, the memtable, columnar runs and the
``gpu`` storage engine behind the engine seam."""

from yugabyte_db_tpu_torch.storage.row_version import RowVersion, MAX_HT
from yugabyte_db_tpu_torch.storage.scan_spec import (AggSpec, Predicate,
                                                     ScanResult, ScanSpec)
from yugabyte_db_tpu_torch.storage.engine import StorageEngine, make_engine
