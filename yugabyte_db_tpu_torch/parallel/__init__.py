"""Device-mesh parallelism: multi-tablet scans and aggregates.

The reference has NO intra-node scan parallelism — one thread walks one
RocksDB iterator per tablet (src/yb/docdb/doc_rowwise_iterator.cc:545), and
multi-tablet aggregates are merged client-side
(src/yb/docdb/pgsql_operation.cc:473, yql/cql/ql/exec/eval_aggr.cc). Here
the tablet axis is data-parallel ("t") and the block axis within a tablet
sequence-parallel ("b"): tablets shard over the mesh's "t" axis, each
tablet's device-resident block sequence over "b", and the aggregate
combine that the reference does client-side is one launch of a hand
kernel over every piece's partial (``ops.mesh.combine``, BASELINE
configuration 5). The port's copy of the JAX package's ``parallel/``.
"""

from yugabyte_db_tpu_torch.parallel.mesh import DeviceMesh, mesh_from_visible
from yugabyte_db_tpu_torch.parallel.sharded import (MeshSpecError,
                                                    ShardedTablets,
                                                    sharded_aggregate,
                                                    sharded_row_page)
