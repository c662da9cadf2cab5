"""The YSQL layer: SQL frontend, pggate-shaped API, PG wire server.

Reference analog: the YSQL stack — PostgreSQL backend over pggate
(src/yb/yql/pggate/pggate.h:58) lowering to PgsqlReadOperation /
PgDocWriteOp (src/yb/docdb/pgsql_operation.cc:345, pg_doc_op.h:142).
Redesigned single-runtime: a SQL parser (parser.py) and executor
(executor.py) drive the same Cluster seam as the CQL frontend, with
grouped/expression aggregates pushed down to the storage engines (the
TPU engine runs them as one device dispatch per tablet); pggate.py is
the embedding API (PgApi/PgSession/PgStatement), wire.py the FE/BE v3
protocol server, and tpch.py the TPC-H Q1/Q6 workload bench.py measures.

The port's copy of the JAX package's ``yql/pgsql/``. ``PgProcessor``
takes whatever cluster it is given: the port's ``LocalCluster`` and
``ClientCluster`` create their tables on the ``gpu`` engine, on the card
unless ``engine_options={"device": "cpu"}`` asks for the plain versions.
On the card the pushed-down aggregates, row scans and flushes launch the
engine's kernels (``csrc/flat_agg.cu``, ``mvcc_resolve.cu``,
``group_agg.cu``, ``row_gather.cu``, ``flush.cu``).
"""

from yugabyte_db_tpu_torch.yql.pgsql.executor import PgProcessor, PgResult
from yugabyte_db_tpu_torch.yql.pgsql.operations import PgsqlReadOp
from yugabyte_db_tpu_torch.yql.pgsql.parser import parse_script, parse_statement
from yugabyte_db_tpu_torch.yql.pgsql.pggate import PgApi, PgSession, PgStatement
from yugabyte_db_tpu_torch.yql.pgsql.tpch import (LINEITEM_COLUMNS,
                                            generate_lineitem, q1_result,
                                            q1_spec, q6_result, q6_spec)
from yugabyte_db_tpu_torch.yql.pgsql.wire import PgServer

__all__ = [
    "LINEITEM_COLUMNS",
    "PgApi",
    "PgProcessor",
    "PgResult",
    "PgServer",
    "PgSession",
    "PgStatement",
    "PgsqlReadOp",
    "generate_lineitem",
    "parse_script",
    "parse_statement",
    "q1_result",
    "q1_spec",
    "q6_result",
    "q6_spec",
]
