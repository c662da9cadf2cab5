"""YCQL: the Cassandra-compatible query language frontend.

Reference analog: src/yb/yql/cql/ql — QLProcessor (ql_processor.h:55) with
parse -> analyze -> execute phases (parser/parser_gram.y, sem/analyzer.cc,
exec/executor.cc). Here: a recursive-descent parser (no bison), a binder
against the catalog schema, and an executor that pushes scans/writes
through the client to tablets.
"""

from yugabyte_db_tpu_torch.yql.cql.parser import parse_statement
from yugabyte_db_tpu_torch.yql.cql.processor import QLProcessor
