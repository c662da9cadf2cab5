"""Secondary indexes: schema derivation + write-path maintenance.

Reference analog: src/yb/common/index.h (IndexInfo) and the index update
hook in the tablet write path (Tablet::UpdateQLIndexes,
src/yb/tablet/tablet.cc:1015) — the leader computes index mutations from
the old and new row states and issues them to the index table.

The port's copy of the JAX package's ``index/__init__.py``, whole.
"""

from yugabyte_db_tpu_torch.index.maintenance import (index_entry, index_mutations,
                                               index_schema,
                                               index_table_name,
                                               normalize_index)

__all__ = ["index_entry", "index_mutations", "index_schema",
           "index_table_name", "normalize_index"]
