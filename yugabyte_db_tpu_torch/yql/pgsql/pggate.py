"""PgApi: the pggate-shaped embedding API.

Reference analog: pggate's C API object model — PgApiImpl
(src/yb/yql/pggate/pggate.h:58) owning sessions (PgSession,
pg_session.cc) and statement objects (PgSelect/PgInsert/PgUpdate/
PgDelete, pg_select.cc etc.) that the PostgreSQL backend creates via
YBCPgNewSelect / binds / executes via YBCPgExecSelect + YBCPgDmlFetch.
Here the backend is the in-repo SQL frontend (parser + PgProcessor),
so the statement object wraps a parsed AST and replays it with bound
parameters — the prepared-statement shape.
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.yql.pgsql.executor import PgProcessor, PgResult
from yugabyte_db_tpu_torch.yql.pgsql.parser import parse_statement


class PgStatement:
    """A prepared statement: parse once, execute many with $N params
    (reference: PgDocOp reuse across YBCPgExec* calls)."""

    def __init__(self, session: "PgSession", sql: str):
        self.session = session
        self.sql = sql
        self.ast = parse_statement(sql)

    def execute(self, params: list | None = None) -> PgResult | None:
        return self.session.processor.execute(self.ast, params)


class PgSession:
    """One connection's execution context (reference: PgSession —
    per-connection state over the shared client)."""

    def __init__(self, api: "PgApi"):
        self.api = api
        self.processor = PgProcessor(api.cluster)
        self._statements: dict[str, PgStatement] = {}

    def execute(self, sql: str, params: list | None = None):
        return self.processor.execute(sql, params)

    def prepare(self, sql: str) -> PgStatement:
        stmt = self._statements.get(sql)
        if stmt is None:
            stmt = self._statements[sql] = PgStatement(self, sql)
        return stmt


class PgApi:
    """Process-wide pggate entry point over a Cluster seam (LocalCluster
    for in-process tablets, ClientCluster for a real cluster)."""

    def __init__(self, cluster):
        self.cluster = cluster

    def new_session(self) -> PgSession:
        return PgSession(self)
