"""The port's YSQL frontend (``yugabyte_db_tpu_torch.yql.pgsql``: parser,
``PgProcessor``, pggate, ``PgServer``, tpch) under the assertions of the
JAX package's ``tests/test_pgsql.py``, ``test_pg_extended.py``,
``test_pg_prefetch.py`` and the SQL case of ``test_tpch.py``, with its
tablets on the ``gpu`` engine over CPU tensors; and a differential: one
seeded statement script through the JAX ``PgProcessor`` (engines ``cpu``
and ``tpu``) and the port's, whose ``PgResult``s must be equal, a
transaction script over both packages' ``MiniCluster``, the lineitem
generator row for row, and TPC-H Q1/Q6 through both packages' SQL.
"""

import math
import random
import socket
import struct
import threading
import time

import numpy as np
import pytest

from test_torch_data import cpu_local_cluster, cpu_mini_cluster
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.storage.expr import BinOp, Col, Const
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent,
                                                InvalidArgument, NotFound)
from yugabyte_db_tpu_torch.yql.cql.client_cluster import ClientCluster
from yugabyte_db_tpu_torch.yql.cql.processor import QLProcessor
from yugabyte_db_tpu_torch.yql.pgsql import (PgApi, PgProcessor, PgServer,
                                             parse_statement, tpch)
from yugabyte_db_tpu_torch.yql.pgsql import ast


# -- parser ------------------------------------------------------------------

def test_parse_create_table():
    stmt = parse_statement(
        "CREATE TABLE t (a INT, b BIGINT, c TEXT, d DOUBLE PRECISION, "
        "e BOOLEAN, PRIMARY KEY ((a), b)) SPLIT INTO 7 TABLETS")
    assert stmt.hash_keys == ["a"] and stmt.range_keys == ["b"]
    assert stmt.num_tablets == 7
    types = {c.name: c.dtype for c in stmt.columns}
    assert types == {"a": DataType.INT32, "b": DataType.INT64,
                     "c": DataType.STRING, "d": DataType.DOUBLE,
                     "e": DataType.BOOL}


def test_parse_inline_pk_and_varchar():
    stmt = parse_statement(
        "CREATE TABLE u (id TEXT PRIMARY KEY, n VARCHAR(32))")
    assert stmt.hash_keys == ["id"] and stmt.range_keys == []
    assert stmt.columns[1].dtype == DataType.STRING


def test_parse_insert_multi_row():
    stmt = parse_statement(
        "INSERT INTO t (a, b) VALUES (1, 'x'), (2, 'y'), (3, NULL)")
    assert stmt.columns == ["a", "b"]
    assert stmt.rows == [[1, "x"], [2, "y"], [3, None]]


def test_parse_select_exprs_and_clauses():
    stmt = parse_statement(
        "SELECT a, sum(p * (100 - d)) AS rev, count(*) FROM t "
        "WHERE s BETWEEN 5 AND 9 AND q IN (1, 2, 3) AND a <> 0 "
        "GROUP BY a ORDER BY a DESC LIMIT 10")
    assert stmt.group_by == ["a"]
    assert stmt.order_by[0].column == "a" and stmt.order_by[0].desc
    assert stmt.limit == 10
    rels = {(r.column, r.op): r.value for r in stmt.where}
    assert rels[("s", ">=")] == 5 and rels[("s", "<=")] == 9
    assert rels[("q", "IN")] == (1, 2, 3)
    assert rels[("a", "!=")] == 0
    rev = stmt.items[1]
    assert rev.alias == "rev"
    assert isinstance(rev.expr, ast.Agg) and rev.expr.fn == "sum"
    assert rev.expr.arg == BinOp("*", Col("p"),
                                 BinOp("-", Const(100), Col("d")))


def test_parse_bind_markers():
    stmt = parse_statement("SELECT a FROM t WHERE a = $1 AND b > $2")
    assert stmt.where[0].value == ast.BindMarker(0)
    assert stmt.where[1].value == ast.BindMarker(1)


def test_parse_errors():
    for bad in ("SELECT FROM t", "CREATE TABLE t (a INT)",
                "INSERT INTO t (a) VALUES (1, 2)", "FROBNICATE x"):
        with pytest.raises(InvalidArgument):
            parse_statement(bad)


# -- executor ----------------------------------------------------------------

@pytest.fixture()
def pg():
    cluster = cpu_local_cluster(num_tablets=4)
    yield PgProcessor(cluster)
    cluster.close()


def _setup_kv(pg):
    pg.execute("CREATE TABLE kv (k TEXT, r BIGINT, v TEXT, n BIGINT, "
               "PRIMARY KEY ((k), r))")
    pg.execute("INSERT INTO kv (k, r, v, n) VALUES "
               "('a', 1, 'va', 10), ('a', 2, 'vb', 20), "
               "('b', 1, 'vc', 30), ('c', 1, NULL, 40)")


def test_pg_crud(pg):
    _setup_kv(pg)
    res = pg.execute("SELECT k, r, v, n FROM kv ORDER BY k, r")
    assert res.rows == [("a", 1, "va", 10), ("a", 2, "vb", 20),
                        ("b", 1, "vc", 30), ("c", 1, None, 40)]
    # PG rejects duplicate PKs (CQL would upsert)
    with pytest.raises(AlreadyPresent):
        pg.execute("INSERT INTO kv (k, r, v) VALUES ('a', 1, 'dup')")
    # UPDATE with arithmetic over the old row value, arbitrary WHERE
    res = pg.execute("UPDATE kv SET n = n + 100 WHERE n >= 20")
    assert res.command == "UPDATE 3"
    res = pg.execute("SELECT n FROM kv ORDER BY n")
    assert [r[0] for r in res.rows] == [10, 120, 130, 140]
    # DELETE by non-key predicate
    res = pg.execute("DELETE FROM kv WHERE n > 125")
    assert res.command == "DELETE 2"
    res = pg.execute("SELECT k, r FROM kv ORDER BY k, r")
    assert res.rows == [("a", 1), ("a", 2)]


def test_pg_null_bound_pk_rejected(pg):
    _setup_kv(pg)
    # a NULL arriving via $N must hit the not-null PK check too
    with pytest.raises(InvalidArgument):
        pg.execute("INSERT INTO kv (k, r, v) VALUES ($1, $2, $3)",
                   params=[None, 1, "x"])


def test_pg_comments_and_multi_statement():
    from yugabyte_db_tpu_torch.yql.pgsql import parse_script

    stmts = parse_script("SELECT a FROM t; -- done")
    assert len(stmts) == 1
    stmts = parse_script("-- leading comment\nSELECT a FROM t;\n"
                         "SELECT b FROM t -- trailing")
    assert len(stmts) == 2


def test_pg_point_and_binds(pg):
    _setup_kv(pg)
    res = pg.execute("SELECT v FROM kv WHERE k = $1 AND r = $2",
                     params=["a", 2])
    assert res.rows == [("vb",)]
    res = pg.execute("SELECT k, r FROM kv WHERE n IN (10, 30) "
                     "ORDER BY k")
    assert res.rows == [("a", 1), ("b", 1)]


def test_pg_aggregates_group_order(pg):
    _setup_kv(pg)
    res = pg.execute(
        "SELECT k, count(*) AS c, sum(n) AS s, avg(n) AS a FROM kv "
        "GROUP BY k ORDER BY k")
    assert res.columns == ["k", "c", "s", "a"]
    assert res.rows == [("a", 2, 30, 15.0), ("b", 1, 30, 30.0),
                        ("c", 1, 40, 40.0)]
    res = pg.execute("SELECT count(*), min(n), max(n) FROM kv")
    assert res.rows == [(4, 10, 40)]
    # expression aggregate across tablets
    res = pg.execute("SELECT sum(n * 2) FROM kv")
    assert res.rows == [(200,)]


def test_pg_limit_and_star(pg):
    _setup_kv(pg)
    res = pg.execute("SELECT * FROM kv ORDER BY n DESC LIMIT 2")
    assert [r[3] for r in res.rows] == [40, 30]


def test_pg_secondary_index(pg):
    _setup_kv(pg)
    pg.execute("CREATE INDEX kv_by_v ON kv (v)")
    handle = pg.cluster.table("kv")
    assert any(i["name"] == "kv_by_v" for i in handle.indexes)
    # backfill covered the pre-existing rows; maintenance covers new ones
    pg.execute("INSERT INTO kv (k, r, v, n) VALUES ('d', 9, 'vb', 50)")
    res = pg.execute("SELECT k, r FROM kv WHERE v = 'vb' ORDER BY k")
    assert res.rows == [("a", 2), ("d", 9)]
    # the read is actually index-driven: it touches only the index
    # prefix + two base point reads (vs a 4-tablet full scan)
    res = pg.execute("SELECT n FROM kv WHERE v = 'va'")
    assert res.rows == [(10,)]
    pg.execute("DROP INDEX kv_by_v")
    with pytest.raises(NotFound):
        pg.execute("DROP INDEX kv_by_v")


def test_pg_ddl_errors(pg):
    _setup_kv(pg)
    with pytest.raises(AlreadyPresent):
        pg.execute("CREATE TABLE kv (x INT PRIMARY KEY)")
    pg.execute("CREATE TABLE IF NOT EXISTS kv (x INT PRIMARY KEY)")
    pg.execute("DROP TABLE IF EXISTS nope")
    with pytest.raises(NotFound):
        pg.execute("DROP TABLE nope")


# -- pggate API --------------------------------------------------------------

def test_pggate_prepared_statements():
    cluster = cpu_local_cluster(num_tablets=2)
    try:
        api = PgApi(cluster)
        s = api.new_session()
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b TEXT)")
        ins = s.prepare("INSERT INTO t (a, b) VALUES ($1, $2)")
        for i in range(10):
            ins.execute([i, f"s{i}"])
        assert s.prepare("INSERT INTO t (a, b) VALUES ($1, $2)") is ins
        sel = s.prepare("SELECT b FROM t WHERE a = $1")
        assert sel.execute([7]).rows == [("s7",)]
    finally:
        cluster.close()


# -- TPC-H through SQL -------------------------------------------------------

def test_tpch_q1_q6_through_pg_sql():
    cluster = cpu_local_cluster(num_tablets=4)
    try:
        pg = PgProcessor(cluster)
        cols = ", ".join(
            f"{c.name} {'BIGINT' if c.dtype == DataType.INT64 else 'INT'}"
            if c.dtype != DataType.STRING else f"{c.name} TEXT"
            for c in tpch.LINEITEM_COLUMNS)
        pg.execute(f"CREATE TABLE lineitem ({cols}, "
                   "PRIMARY KEY ((l_orderkey), l_linenumber))")
        rows = list(tpch.generate_lineitem(1200))
        batch = []
        for r in rows:
            batch.append("(" + ", ".join(
                f"'{v}'" if isinstance(v, str) else str(v)
                for v in r.values()) + ")")
        names = ", ".join(rows[0])
        pg.execute(f"INSERT INTO lineitem ({names}) VALUES "
                   + ", ".join(batch))
        res = pg.execute(tpch.q1_sql())
        cutoff = 10471
        want = {}
        for r in rows:
            if r["l_shipdate"] > cutoff:
                continue
            k = (r["l_returnflag"], r["l_linestatus"])
            acc = want.setdefault(k, [0, 0, 0])
            acc[0] += r["l_quantity"]
            acc[1] += (r["l_extendedprice"] * (100 - r["l_discount"])
                       * (100 + r["l_tax"]))
            acc[2] += 1
        assert [r[:2] for r in res.rows] == sorted(want)
        for row in res.rows:
            acc = want[(row[0], row[1])]
            assert row[2] == acc[0]              # sum_qty
            assert row[5] == acc[1]              # sum_charge
            assert row[8] == acc[2]              # count_order
            assert row[6] == pytest.approx(acc[0] / acc[2])  # avg_qty
        res6 = pg.execute(tpch.q6_sql())
        want6 = sum(r["l_extendedprice"] * r["l_discount"] for r in rows
                    if 9131 <= r["l_shipdate"] < 9131 + 365
                    and 5 <= r["l_discount"] <= 7
                    and r["l_quantity"] < 24)
        assert res6.rows[0][0] == want6
    finally:
        cluster.close()


# -- wire protocol -----------------------------------------------------------

class MiniPgClient:
    """Just enough libpq to drive the simple-query protocol."""

    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.buf = b""

    def close(self):
        self.sock.close()

    def startup(self, ssl_probe=False):
        if ssl_probe:
            self.sock.sendall(struct.pack(">II", 8, 80877103))
            resp = self.sock.recv(1)
            assert resp == b"N", resp
        params = (b"user\x00tester\x00database\x00db\x00\x00")
        payload = struct.pack(">I", 196608) + params
        self.sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        msgs = self.read_until_ready()
        assert msgs[0][0] == b"R"  # AuthenticationOk
        assert any(t == b"S" for t, _ in msgs)

    def query(self, sql: str):
        payload = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack(">I", len(payload) + 4)
                          + payload)
        return self.read_until_ready()

    def read_msg(self):
        while len(self.buf) < 5:
            d = self.sock.recv(65536)
            assert d, "connection closed"
            self.buf += d
        tag = self.buf[:1]
        (length,) = struct.unpack_from(">I", self.buf, 1)
        while len(self.buf) < 1 + length:
            d = self.sock.recv(65536)
            assert d, "connection closed"
            self.buf += d
        payload = self.buf[5:1 + length]
        self.buf = self.buf[1 + length:]
        return tag, payload

    def read_until_ready(self):
        msgs = []
        while True:
            tag, payload = self.read_msg()
            msgs.append((tag, payload))
            if tag == b"Z":
                return msgs

    @staticmethod
    def rows_of(msgs):
        rows = []
        for tag, payload in msgs:
            if tag != b"D":
                continue
            (n,) = struct.unpack_from(">H", payload, 0)
            off = 2
            row = []
            for _ in range(n):
                (ln,) = struct.unpack_from(">i", payload, off)
                off += 4
                if ln < 0:
                    row.append(None)
                else:
                    row.append(payload[off:off + ln].decode())
                    off += ln
            rows.append(tuple(row))
        return rows


def test_pg_wire_end_to_end():
    cluster = cpu_local_cluster(num_tablets=2)
    server = PgServer(cluster)
    try:
        host, port = server.listen("127.0.0.1", 0)
        c = MiniPgClient(host, port)
        c.startup(ssl_probe=True)
        msgs = c.query("CREATE TABLE w (a BIGINT PRIMARY KEY, b TEXT)")
        assert any(t == b"C" for t, _ in msgs)
        c.query("INSERT INTO w (a, b) VALUES (1, 'one'), (2, 'two')")
        msgs = c.query("SELECT a, b FROM w ORDER BY a")
        assert MiniPgClient.rows_of(msgs) == [("1", "one"), ("2", "two")]
        # multi-statement simple query
        msgs = c.query("INSERT INTO w (a, b) VALUES (3, NULL); "
                       "SELECT count(*) FROM w")
        assert MiniPgClient.rows_of(msgs) == [("3",)]
        # NULL comes back with length -1
        msgs = c.query("SELECT b FROM w WHERE a = 3")
        assert MiniPgClient.rows_of(msgs) == [(None,)]
        # errors produce ErrorResponse then ReadyForQuery
        msgs = c.query("SELECT nope FROM missing")
        assert msgs[0][0] == b"E" and msgs[-1][0] == b"Z"
        msgs = c.query("NOT SQL AT ALL")
        assert msgs[0][0] == b"E"
        # duplicate key -> 23505
        msgs = c.query("INSERT INTO w (a, b) VALUES (1, 'dup')")
        assert msgs[0][0] == b"E" and b"23505" in msgs[0][1]
        c.close()
    finally:
        server.shutdown()
        cluster.close()


def test_pg_wire_over_mini_cluster():
    """The full distributed shape: PG wire server -> pggate-style
    processor -> ClientCluster -> master/tserver RPCs."""
    import tempfile


    with tempfile.TemporaryDirectory() as root:
        mc = cpu_mini_cluster(root, num_tservers=3).start()
        server = None
        try:
            mc.wait_tservers_registered()
            server = PgServer(ClientCluster(mc.client("pg-proxy")))
            host, port = server.listen("127.0.0.1", 0)
            c = MiniPgClient(host, port)
            c.startup()
            c.query("CREATE TABLE d (k TEXT PRIMARY KEY, n BIGINT)")
            c.query("INSERT INTO d (k, n) VALUES ('x', 1), ('y', 2), "
                    "('z', 3)")
            msgs = c.query("SELECT k FROM d WHERE n >= 2 ORDER BY k")
            assert MiniPgClient.rows_of(msgs) == [("y",), ("z",)]
            msgs = c.query("SELECT sum(n) FROM d")
            assert MiniPgClient.rows_of(msgs) == [("6",)]
            c.close()
        finally:
            if server is not None:
                server.shutdown()
            mc.shutdown()


def test_sql_transactions_end_to_end():
    """BEGIN/COMMIT/ROLLBACK through the SQL layer over the distributed
    transaction subsystem: snapshot isolation, read-your-writes point
    reads, first-committer-wins conflicts as SerializationFailure."""
    import tempfile

    from yugabyte_db_tpu_torch.yql.pgsql.executor import SerializationFailure

    with tempfile.TemporaryDirectory() as root:
        mc = cpu_mini_cluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            s1 = PgProcessor(ClientCluster(mc.client("s1")))
            s2 = PgProcessor(ClientCluster(mc.client("s2")))
            s1.execute("CREATE TABLE acct (id TEXT PRIMARY KEY, "
                       "bal BIGINT)")
            s1.execute("INSERT INTO acct (id, bal) VALUES ('a', 100), "
                       "('b', 50)")

            # atomic transfer, invisible to s2 until commit
            s1.execute("BEGIN")
            assert s1.in_txn
            s1.execute("UPDATE acct SET bal = bal - 30 WHERE id = 'a'")
            s1.execute("UPDATE acct SET bal = bal + 30 WHERE id = 'b'")
            # read-your-writes inside the txn
            r = s1.execute("SELECT bal FROM acct WHERE id = 'a'")
            assert r.rows == [(70,)]
            # s2 still sees the pre-txn state
            r = s2.execute("SELECT bal FROM acct WHERE id = 'a'")
            assert r.rows == [(100,)]
            s1.execute("COMMIT")
            assert not s1.in_txn
            r = s2.execute("SELECT bal FROM acct WHERE id = 'b'")
            assert r.rows == [(80,)]

            # rollback discards everything
            s1.execute("BEGIN")
            s1.execute("UPDATE acct SET bal = 0 WHERE id = 'a'")
            s1.execute("ROLLBACK")
            r = s2.execute("SELECT bal FROM acct WHERE id = 'a'")
            assert r.rows == [(70,)]

            # INSERT inside a txn + duplicate detection
            s1.execute("BEGIN")
            s1.execute("INSERT INTO acct (id, bal) VALUES ('c', 1)")
            with pytest.raises(AlreadyPresent):
                s1.execute("INSERT INTO acct (id, bal) VALUES ('c', 2)")
            s1.execute("ROLLBACK")

            # write-write conflict: first committer wins — exactly one
            # side fails, with a transaction-conflict error
            from yugabyte_db_tpu_torch.client.client import TabletOpFailed
            from yugabyte_db_tpu_torch.txn.errors import (TransactionAborted,
                                                    TransactionConflict)

            conflict_errs = (SerializationFailure, TransactionConflict,
                             TransactionAborted, TabletOpFailed)
            s1.execute("BEGIN")
            s2.execute("BEGIN")
            s1.execute("UPDATE acct SET bal = 1 WHERE id = 'a'")
            outcomes = []
            for s, sql in ((s2, "UPDATE acct SET bal = 2 WHERE id = 'a'"),
                           (s1, "COMMIT"), (s2, "COMMIT")):
                try:
                    s.execute(sql)
                    outcomes.append("ok")
                except conflict_errs:
                    outcomes.append("conflict")
                except InvalidArgument:
                    outcomes.append("aborted-block")
            assert "conflict" in outcomes, outcomes
            for s in (s1, s2):
                if s.in_txn:
                    s.execute("ROLLBACK")
        finally:
            mc.shutdown()


def test_pg_wire_transactions():
    """The FE/BE protocol carries transaction state: ReadyForQuery says
    'T' inside a transaction, 'I' when idle."""
    import tempfile


    with tempfile.TemporaryDirectory() as root:
        mc = cpu_mini_cluster(root, num_tservers=3).start()
        server = None
        try:
            mc.wait_tservers_registered()
            server, (host, port) = mc.start_pg_server()
            c = MiniPgClient(host, port)
            c.startup()
            c.query("CREATE TABLE t (k TEXT PRIMARY KEY, v BIGINT)")
            msgs = c.query("BEGIN")
            assert msgs[-1] == (b"Z", b"T")
            c.query("INSERT INTO t (k, v) VALUES ('x', 1)")
            msgs = c.query("SELECT v FROM t WHERE k = 'x'")
            assert MiniPgClient.rows_of(msgs) == [("1",)]
            msgs = c.query("COMMIT")
            assert msgs[-1] == (b"Z", b"I")
            msgs = c.query("SELECT count(*) FROM t")
            assert MiniPgClient.rows_of(msgs) == [("1",)]
            c.close()
        finally:
            if server is not None:
                server.shutdown()
            mc.shutdown()


# -- the extended query protocol (JAX tests/test_pg_extended.py) -------------

_U32 = struct.Struct(">I")


class ExtClient:
    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.buf = b""
        body = _U32.pack(196608) + b"user\x00pg\x00\x00"
        self.sock.sendall(_U32.pack(len(body) + 4) + body)
        # consume until ReadyForQuery
        while True:
            tag, _payload = self.read_msg()
            if tag == b"Z":
                break

    def close(self):
        self.sock.close()

    def send(self, tag: bytes, payload: bytes = b""):
        self.sock.sendall(tag + _U32.pack(len(payload) + 4) + payload)

    def read_msg(self):
        while len(self.buf) < 5:
            chunk = self.sock.recv(65536)
            assert chunk, "closed"
            self.buf += chunk
        tag = self.buf[:1]
        (ln,) = _U32.unpack_from(self.buf, 1)
        while len(self.buf) < 1 + ln:
            chunk = self.sock.recv(65536)
            assert chunk, "closed"
            self.buf += chunk
        payload = self.buf[5:1 + ln]
        self.buf = self.buf[1 + ln:]
        return tag, payload

    # -- extended-protocol helpers ------------------------------------------
    def parse(self, name: str, query: str):
        self.send(b"P", name.encode() + b"\x00" + query.encode()
                  + b"\x00" + struct.pack(">H", 0))

    def bind(self, portal: str, stmt: str, params: list):
        out = portal.encode() + b"\x00" + stmt.encode() + b"\x00"
        out += struct.pack(">H", 0)        # all-text param formats
        out += struct.pack(">H", len(params))
        for p in params:
            if p is None:
                out += struct.pack(">i", -1)
            else:
                b = str(p).encode()
                out += struct.pack(">i", len(b)) + b
        out += struct.pack(">H", 0)        # result formats: default text
        self.send(b"B", out)

    def describe_portal(self, portal: str):
        self.send(b"D", b"P" + portal.encode() + b"\x00")

    def execute(self, portal: str, max_rows: int = 0):
        self.send(b"E", portal.encode() + b"\x00"
                  + struct.pack(">i", max_rows))

    def sync(self):
        self.send(b"S")

    def drain_until_ready(self):
        msgs = []
        while True:
            tag, payload = self.read_msg()
            msgs.append((tag, payload))
            if tag == b"Z":
                return msgs

    def run(self, query: str, params: list = ()):  # full PQexecParams flow
        self.parse("", query)
        self.bind("", "", list(params))
        self.describe_portal("")
        self.execute("")
        self.sync()
        return self.drain_until_ready()


def _rows(msgs):
    out = []
    for tag, payload in msgs:
        if tag != b"D":
            continue
        (n,) = struct.unpack_from(">H", payload, 0)
        pos, row = 2, []
        for _ in range(n):
            (ln,) = struct.unpack_from(">i", payload, pos)
            pos += 4
            if ln < 0:
                row.append(None)
            else:
                row.append(payload[pos:pos + ln].decode())
                pos += ln
        out.append(tuple(row))
    return out


def _tags(msgs):
    return [t for t, _p in msgs]


@pytest.fixture
def cli():
    server = PgServer(cpu_local_cluster(num_tablets=2))
    host, port = server.listen("127.0.0.1", 0)
    c = ExtClient(host, port)
    yield c
    c.close()
    server.shutdown()


def test_extended_ddl_dml_select(cli):
    msgs = cli.run("CREATE TABLE t (k INT PRIMARY KEY, v TEXT, d FLOAT8)")
    assert b"1" in _tags(msgs) and b"2" in _tags(msgs)
    assert b"C" in _tags(msgs) and b"Z" in _tags(msgs)

    # parameterized inserts: text params coerced to column types
    for i in range(5):
        msgs = cli.run("INSERT INTO t (k, v, d) VALUES ($1, $2, $3)",
                       [i, f"row{i}", i * 1.5])
        assert b"E" not in _tags(msgs), msgs
    msgs = cli.run("SELECT k, v, d FROM t WHERE k >= $1 ORDER BY k", [3])
    tags = _tags(msgs)
    # Describe produced a RowDescription before the data rows.
    assert tags.index(b"T") < tags.index(b"D")
    assert _rows(msgs) == [("3", "row3", "4.5"), ("4", "row4", "6.0")]


def test_extended_named_statement_reuse(cli):
    cli.run("CREATE TABLE n (k INT PRIMARY KEY, v BIGINT)")
    cli.parse("ins", "INSERT INTO n (k, v) VALUES ($1, $2)")
    for i in range(3):
        cli.bind("", "ins", [i, i * 100])
        cli.execute("")
    cli.sync()
    msgs = cli.drain_until_ready()
    assert _tags(msgs).count(b"C") == 3   # three CommandCompletes
    msgs = cli.run("SELECT count(*) FROM n")
    assert _rows(msgs) == [("3",)]


def test_extended_error_skips_until_sync(cli):
    cli.run("CREATE TABLE e (k INT PRIMARY KEY)")
    cli.parse("", "INSERT INTO e (k) VALUES ($1)")
    cli.bind("", "", ["notanint"])
    cli.describe_portal("")
    cli.execute("")      # must be skipped after the bind error surfaces
    cli.sync()
    msgs = cli.drain_until_ready()
    tags = _tags(msgs)
    assert b"E" in tags                  # one ErrorResponse
    assert tags[-1] == b"Z"              # and recovery at Sync
    # the connection works again afterwards
    msgs = cli.run("INSERT INTO e (k) VALUES ($1)", [7])
    assert b"E" not in _tags(msgs)
    assert _rows(cli.run("SELECT k FROM e")) == [("7",)]


def test_extended_unknown_statement_errors(cli):
    cli.bind("", "missing", [])
    cli.sync()
    msgs = cli.drain_until_ready()
    assert _tags(msgs)[0] == b"E"


def test_extended_null_param(cli):
    cli.run("CREATE TABLE np (k INT PRIMARY KEY, v TEXT)")
    cli.run("INSERT INTO np (k, v) VALUES ($1, $2)", [1, None])
    assert _rows(cli.run("SELECT v FROM np WHERE k = $1", [1])) == [(None,)]


# -- prefetching (JAX tests/test_pg_prefetch.py) ------------------------------

@pytest.fixture
def pg_disk(tmp_path):
    cluster = cpu_local_cluster(str(tmp_path), num_tablets=4)
    proc = PgProcessor(cluster)
    yield proc
    cluster.close()


def seed_big(pg_disk, n=400):
    pg_disk.execute("CREATE TABLE big (id bigint PRIMARY KEY, g text, "
               "v bigint)")
    for i in range(n):
        pg_disk.execute(f"INSERT INTO big (id, g, v) VALUES "
                   f"({i}, 'g{i % 3}', {i * 7})")


def test_prefetch_overlaps_tablet_scans(pg_disk):
    seed_big(pg_disk)
    handle = pg_disk.cluster.table("big")
    inflight = [0]
    peak = [0]
    lock = threading.Lock()

    orig = {}
    for t in handle.tablets:
        orig[id(t)] = t.scan

        def make(t):
            inner = t.scan

            def slow_scan(spec):
                with lock:
                    inflight[0] += 1
                    peak[0] = max(peak[0], inflight[0])
                try:
                    time.sleep(0.05)
                    return inner(spec)
                finally:
                    with lock:
                        inflight[0] -= 1
            return slow_scan
        t.scan = make(t)

    r = pg_disk.execute("SELECT count(*), sum(v) FROM big")
    assert r.rows == [(400, sum(i * 7 for i in range(400)))]
    assert peak[0] > 1, "tablet scans did not overlap"

    peak[0] = 0
    r = pg_disk.execute("SELECT id FROM big WHERE v >= 0 ORDER BY id "
                        "LIMIT 5")
    assert [x[0] for x in r.rows] == [0, 1, 2, 3, 4]
    assert peak[0] > 1


def test_prefetch_results_match_sequential(pg_disk):
    seed_big(pg_disk, n=200)
    r = pg_disk.execute("SELECT g, count(*), sum(v), min(v), max(v) "
                        "FROM big GROUP BY g ORDER BY g")
    assert len(r.rows) == 3
    assert sum(row[1] for row in r.rows) == 200
    r2 = pg_disk.execute("SELECT id, v FROM big WHERE id < 50 "
                         "ORDER BY id")
    assert len(r2.rows) == 50


# -- TPC-H through the SQL frontend (JAX tests/test_tpch.py) ------------------

def test_q1_q6_through_sql_frontend():
    cluster = cpu_local_cluster(num_tablets=4)
    try:
        ql = QLProcessor(cluster)
        cols = ", ".join(
            f"{c.name} {c.dtype.name}" for c in tpch.LINEITEM_COLUMNS)
        ql.execute(
            "CREATE TABLE lineitem (" + cols +
            ", PRIMARY KEY ((l_orderkey), l_linenumber))")
        handle = cluster.table("default.lineitem")
        rows = list(tpch.generate_lineitem(1500))
        for r in rows:
            names = ", ".join(r)
            vals = ", ".join(
                f"'{v}'" if isinstance(v, str) else str(v)
                for v in r.values())
            ql.execute(f"INSERT INTO lineitem ({names}) VALUES ({vals})")
        res = ql.execute(tpch.q1_sql())
        assert res.columns[:2] == ["l_returnflag", "l_linestatus"]
        assert [r[:2] for r in res.rows] == sorted(r[:2] for r in res.rows)
        # oracle recomputation in python
        cutoff = 10471
        want = {}
        for r in rows:
            if r["l_shipdate"] > cutoff:
                continue
            k = (r["l_returnflag"], r["l_linestatus"])
            acc = want.setdefault(k, [0, 0, 0, 0, 0])
            acc[0] += r["l_quantity"]
            acc[1] += r["l_extendedprice"]
            acc[2] += r["l_extendedprice"] * (100 - r["l_discount"])
            acc[3] += (r["l_extendedprice"] * (100 - r["l_discount"])
                       * (100 + r["l_tax"]))
            acc[4] += 1
        for row in res.rows:
            k = (row[0], row[1])
            acc = want[k]
            assert row[2] == acc[0]          # sum_qty
            assert row[3] == acc[1]          # sum_base_price
            assert row[4] == acc[2]          # sum_disc_price
            assert row[5] == acc[3]          # sum_charge
            assert row[8] == acc[4]          # count_order
            assert row[6] == acc[0] / acc[4]  # avg_qty
        res6 = ql.execute(tpch.q6_sql())
        want6 = sum(
            r["l_extendedprice"] * r["l_discount"] for r in rows
            if 9131 <= r["l_shipdate"] < 9131 + 365
            and 5 <= r["l_discount"] <= 7 and r["l_quantity"] < 24)
        assert res6.rows[0][0] == want6
    finally:
        cluster.close()


# -- the port's departure: DML on a schema-qualified table --------------------

def test_dml_takes_a_schema_qualified_table(tmp_path):
    """PostgreSQL's INSERT, UPDATE and DELETE take ``schema.table`` as its
    SELECT does. The port's parser takes it in all four (the JAX parser
    takes a bare name in DML only: a departure, ROADMAP.md §3), so SQL
    writes reach a table that CQL made in a keyspace."""
    from yugabyte_db_tpu.utils.status import StatusError as JStatusError
    from yugabyte_db_tpu.yql.pgsql import parse_statement as j_parse

    for sql in ("INSERT INTO smoke.bench (k, r) VALUES ('x', 1)",
                "UPDATE smoke.bench SET a = 1 WHERE k = 'x' AND r = 1",
                "DELETE FROM smoke.bench WHERE k = 'x' AND r = 1"):
        with pytest.raises(JStatusError):
            j_parse(sql)
        assert parse_statement(sql).table == "smoke.bench"
    cluster = cpu_local_cluster(str(tmp_path), num_tablets=2)
    try:
        ql = QLProcessor(cluster)
        ql.execute("CREATE KEYSPACE smoke")
        ql.execute("CREATE TABLE smoke.bench (k text, r bigint, a bigint, "
                   "PRIMARY KEY ((k), r))")
        pg = PgProcessor(cluster)
        pg.execute("INSERT INTO smoke.bench (k, r, a) VALUES ('x', 1, 10), "
                   "('y', 2, 20), ('z', 3, 30)")
        with pytest.raises(AlreadyPresent):
            pg.execute("INSERT INTO smoke.bench (k, r, a) VALUES ('x', 1, 0)")
        pg.execute("UPDATE smoke.bench SET a = 11 WHERE k = 'x' AND r = 1")
        pg.execute("DELETE FROM smoke.bench WHERE a > 25")
        assert sorted(pg.execute("SELECT k, r, a FROM smoke.bench").rows) \
            == [("x", 1, 11), ("y", 2, 20)]
        assert ql.execute("SELECT a FROM smoke.bench WHERE k = 'x' "
                          "AND r = 1").rows == [(11,)]
    finally:
        cluster.close()

def test_full_key_select_reads_its_row_on_its_tablet(pg):
    """The port's second departure: a SELECT whose WHERE binds every
    primary-key column by '=' reads that key's row on the tablet that
    owns it (PG's primary-key read); the other predicates still apply,
    and a NULL key value or a partial key scans every tablet as the JAX
    executor does."""
    _setup_kv(pg)
    specs = []
    for t in pg.cluster.table("kv").tablets:
        def spied(spec, scan=t.scan, tid=id(t)):
            specs.append((tid, spec))
            return scan(spec)
        t.scan = spied
    assert pg.execute("SELECT v, n FROM kv WHERE k = 'a' AND r = 2").rows \
        == [("vb", 20)]
    assert len(specs) == 1 and specs[0][1].lower is not None \
        and specs[0][1].upper == specs[0][1].lower + b"\x00"
    specs.clear()
    assert pg.execute("SELECT v FROM kv WHERE k = 'a' AND r = 2 "
                      "AND n > 20").rows == []
    assert pg.execute("SELECT v FROM kv WHERE r = $1 AND k = $2",
                      [1, "b"]).rows == [("vc",)]
    assert len(specs) == 2
    specs.clear()
    assert pg.execute("SELECT r FROM kv WHERE k = 'a' ORDER BY r").rows \
        == [(1,), (2,)]
    assert pg.execute("SELECT r FROM kv WHERE k = NULL AND r = 1").rows \
        == []
    assert len(specs) == 2 * len(pg.cluster.table("kv").tablets)

# -- the differential: one statement script, two packages ---------------------

NKEYS = 40
NROWS = 240
INSERT_BATCH = 40
# DOUBLE sums and averages: ``tests/test_engine_diff.py``'s tolerance.
APPROX = ("sum_c", "avg_c")


def _lit(v):
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return repr(v)


def statement_script(seed: int = 23):
    """The script: ``(op, sql)`` steps made from ``seed`` with
    ``random``/numpy, the same SQL text for both sides. ``("q", sql)``
    runs a statement and compares its ``PgResult``; ``("flush",)``
    flushes every tablet."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    a = nrng.integers(-10**12, 10**12, NROWS)
    d = nrng.integers(-10**6, 10**6, NROWS)
    c = nrng.choice([0.5, -1.25, 3.0, 1e6, 2.75, np.nan], NROWS)
    steps = [("q", "CREATE TABLE bench (k TEXT, r BIGINT, a BIGINT, "
                   "c DOUBLE PRECISION, d INT, g INT, s TEXT, "
                   "PRIMARY KEY ((k), r))"),
             ("q", "CREATE INDEX bench_by_s ON bench (s)")]
    for lo in range(0, NROWS, INSERT_BATCH):
        values = []
        for i in range(lo, lo + INSERT_BATCH):
            cv = None if np.isnan(c[i]) else float(c[i])
            values.append(f"('u{i % NKEYS:03d}', {i}, {int(a[i])}, "
                          f"{_lit(cv)}, {int(d[i])}, {i % 5}, "
                          f"'s{rng.randrange(60)}')")
        steps.append(("q", "INSERT INTO bench (k, r, a, c, d, g, s) "
                      "VALUES " + ", ".join(values)))
    cut = int(np.median(d))
    aggs = ("SELECT count(*), sum(a), min(a), max(a), sum(d), "
            "sum(c) AS sum_c, avg(c) AS avg_c, avg(a) AS avg_a, "
            "count(c) FROM bench")
    reads = [
        ("q", aggs),
        ("q", aggs + f" WHERE d >= {cut}"),
        ("q", "SELECT count(*), sum(a), min(d), max(d) FROM bench "
              "WHERE k = 'u007'"),
        ("q", "SELECT g, count(*), sum(a), sum(d), min(s) FROM bench "
              "GROUP BY g ORDER BY g"),
        ("q", "SELECT g, count(*), sum(d * 3 - g) FROM bench "
              f"WHERE a < 0 GROUP BY g HAVING count(*) > 20 ORDER BY g"),
        ("q", "SELECT g, avg(d) AS avg_d FROM bench GROUP BY g "
              "HAVING sum(a) > 0 ORDER BY g"),
        ("q", "SELECT a, c, d, s FROM bench WHERE k = 'u011' AND r = 51"),
        ("q", "SELECT r, a FROM bench WHERE k = 'u003' ORDER BY r"),
        ("q", "SELECT k, r, d FROM bench WHERE d >= 0 "
              "ORDER BY k, r LIMIT 15 OFFSET 30"),
        ("q", f"SELECT k, r, a FROM bench WHERE d < {cut} LIMIT 7"),
        ("q", "SELECT k, r, s FROM bench WHERE s = 's17' ORDER BY k, r"),
        ("q", "SELECT * FROM bench WHERE k = 'u005' ORDER BY r DESC "
              "LIMIT 3"),
        ("q", "SELECT DISTINCT g FROM bench WHERE d > 0 ORDER BY g"),
    ]
    steps += reads
    steps.append(("flush",))
    steps += reads
    for i in rng.sample(range(NROWS), 12):
        steps.append(("q", f"UPDATE bench SET d = "
                      f"{rng.randrange(-10**6, 10**6)}, a = a + {i} "
                      f"WHERE k = 'u{i % NKEYS:03d}' AND r = {i}"))
    steps.append(("q", f"UPDATE bench SET s = 's17', g = 9 "
                  f"WHERE g = 2 AND a < 0"))
    steps.append(("q", f"DELETE FROM bench WHERE d > {cut + 500_000}"))
    steps.append(("q", "DELETE FROM bench WHERE k = 'u019' AND r = 59"))
    steps += reads                      # the writes over a run, unflushed
    steps.append(("flush",))
    steps += reads                      # multi-version runs
    return steps


def run_script(PG, cluster, steps):
    """Run ``steps`` through one package's processor over ``cluster``;
    returns one ``(sql, (columns, rows, command))`` per compared step."""
    proc = PG(cluster)
    out = []
    try:
        for step in steps:
            if step[0] == "q":
                res = proc.execute(step[1])
                out.append((step[1], None if res is None else
                            (list(res.columns), list(res.rows),
                             res.command)))
            else:
                for handle in cluster.tables.values():
                    for t in handle.tablets:
                        t.flush()
    finally:
        cluster.close()
    return out


def assert_same_results(want, got):
    assert len(want) == len(got)
    for (label, w), (_l, g) in zip(want, got):
        if w is None or g is None:
            assert w is None and g is None, label
            continue
        cols, rows_w, command = w
        assert g[0] == cols, label
        assert g[2] == command, label
        rows_g = g[1]
        assert len(rows_g) == len(rows_w), label
        for rw, rg in zip(rows_w, rows_g):
            assert len(rw) == len(rg), label
            for name, vw, vg in zip(cols, rw, rg):
                if name.startswith(APPROX) and vw is not None:
                    assert vg == pytest.approx(vw, rel=1e-4, abs=1e-4), \
                        (label, name)
                elif isinstance(vw, float) and math.isnan(vw):
                    assert isinstance(vg, float) and math.isnan(vg), label
                else:
                    assert vg == vw and type(vg) is type(vw), \
                        (label, name, vw, vg)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    cluster = cpu_local_cluster(str(tmp_path_factory.mktemp("port")),
                                num_tablets=4,
                                engine_options={"rows_per_block": 16})
    return run_script(PgProcessor, cluster, statement_script())


@pytest.mark.parametrize("engine", ["cpu", "tpu"])
def test_statement_script_matches_the_jax_processor(engine, port_results,
                                                    tmp_path):
    """DDL, multi-row INSERT, UPDATE and DELETE by arbitrary WHERE,
    aggregates with GROUP BY / HAVING over 4 tablets, LIMIT / OFFSET and
    an index-driven read, before and after flushes: equal ``PgResult``s
    on the JAX processor and the port's."""
    import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
    from yugabyte_db_tpu.yql.cql.processor import LocalCluster as JLocal
    from yugabyte_db_tpu.yql.pgsql import PgProcessor as JPg

    steps = statement_script()
    assert port_results and len(port_results) == sum(
        1 for s in steps if s[0] == "q")
    want = run_script(JPg, JLocal(str(tmp_path), num_tablets=4,
                                  engine=engine,
                                  engine_options={"rows_per_block": 16}),
                      steps)
    assert_same_results(want, port_results)


TXN_SCRIPT = [
    "CREATE TABLE acct (id TEXT PRIMARY KEY, bal BIGINT, tag TEXT)",
    "INSERT INTO acct (id, bal, tag) VALUES " + ", ".join(
        f"('a{i:02d}', {100 * i - 700}, 't{i % 3}')" for i in range(24)),
    "BEGIN",
    "UPDATE acct SET bal = bal - 30 WHERE id = 'a05'",
    "UPDATE acct SET bal = bal + 30 WHERE id = 'a06'",
    "INSERT INTO acct (id, bal, tag) VALUES ('b01', 5, 't9'), "
    "('b02', 6, 't9')",
    "SELECT id, bal FROM acct WHERE id = 'a05'",
    "COMMIT",
    "SELECT tag, count(*), sum(bal), min(bal), max(bal) FROM acct "
    "GROUP BY tag ORDER BY tag",
    "BEGIN",
    "UPDATE acct SET bal = 0 WHERE tag = 't1'",
    "DELETE FROM acct WHERE id = 'a07'",
    "INSERT INTO acct (id, bal, tag) VALUES ('c01', 1, 't8')",
    "SELECT count(*), sum(bal) FROM acct WHERE id = 'a07'",
    "ROLLBACK",
    "SELECT tag, count(*), sum(bal) FROM acct GROUP BY tag ORDER BY tag",
    "SELECT id, bal FROM acct WHERE bal > 500 ORDER BY id LIMIT 5 "
    "OFFSET 2",
    "SELECT count(*) FROM acct WHERE id = 'c01'",
]


def test_transactions_match_the_jax_processor(tmp_path):
    """A transaction that commits and one that rolls back, through each
    package's ``PgProcessor`` over its ``MiniCluster`` (the
    transactions need the distributed seam): equal ``PgResult``s."""
    from yugabyte_db_tpu.integration import MiniCluster as JMini
    from yugabyte_db_tpu.yql.cql.client_cluster import \
        ClientCluster as JClient
    from yugabyte_db_tpu.yql.pgsql import PgProcessor as JPg

    answers = []
    for Mini, Client, Pg, root in (
            (JMini, JClient, JPg, tmp_path / "jax"),
            (cpu_mini_cluster, ClientCluster, PgProcessor,
             tmp_path / "port")):
        mc = Mini(str(root), num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            pg = Pg(Client(mc.client("pg"), num_tablets=2))
            out = []
            for sql in TXN_SCRIPT:
                res = pg.execute(sql)
                out.append((sql, (list(res.columns), list(res.rows),
                                  res.command)))
            answers.append(out)
        finally:
            mc.shutdown()
    assert_same_results(answers[0], answers[1])
    final = dict(answers[1])
    assert final[TXN_SCRIPT[-1]][1] == [(0,)]     # the rollback's insert


# -- TPC-H through both packages ----------------------------------------------

def test_generate_lineitem_matches_the_jax_generator():
    from yugabyte_db_tpu.yql.pgsql import tpch as jtpch

    assert list(tpch.generate_lineitem(1200)) == \
        list(jtpch.generate_lineitem(1200))
    assert list(tpch.generate_lineitem(50, seed=7)) == \
        list(jtpch.generate_lineitem(50, seed=7))
    assert [(c.name, c.dtype.name, c.kind.name)
            for c in tpch.LINEITEM_COLUMNS] == \
        [(c.name, c.dtype.name, c.kind.name)
         for c in jtpch.LINEITEM_COLUMNS]
    assert tpch.q1_sql() == jtpch.q1_sql()
    assert tpch.q6_sql() == jtpch.q6_sql()


# lineitem as the JAX SQL test declares it, and with ``tpch``'s own types
# (discount and tax INT8): only the latter's products have narrow factors.
LINEITEM_DDL = ("CREATE TABLE lineitem (l_orderkey BIGINT, "
                "l_linenumber INT, l_quantity INT, l_extendedprice BIGINT, "
                "l_discount {narrow}, l_tax {narrow}, l_returnflag TEXT, "
                "l_linestatus TEXT, l_shipdate INT, "
                "PRIMARY KEY ((l_orderkey), l_linenumber))")


def _tpch_answers(Pg, cluster, rows, narrow="INT"):
    try:
        pg = Pg(cluster)
        pg.execute(LINEITEM_DDL.format(narrow=narrow))
        names = ", ".join(rows[0])
        for lo in range(0, len(rows), 300):
            pg.execute(f"INSERT INTO lineitem ({names}) VALUES " + ", ".join(
                "(" + ", ".join(_lit(v) for v in r.values()) + ")"
                for r in rows[lo:lo + 300]))
        for handle in cluster.tables.values():
            for t in handle.tablets:
                t.flush()
        return [(list(res.columns), list(res.rows)) for res in
                (pg.execute(tpch.q1_sql()), pg.execute(tpch.q6_sql()))]
    finally:
        cluster.close()


@pytest.mark.parametrize("narrow", ["INT", "TINYINT"])
def test_tpch_q1_q6_through_sql_match_the_jax_package(tmp_path, narrow):
    from yugabyte_db_tpu.yql.cql.processor import LocalCluster as JLocal
    from yugabyte_db_tpu.yql.pgsql import PgProcessor as JPg

    rows = list(tpch.generate_lineitem(1200))
    want = _tpch_answers(JPg, JLocal(str(tmp_path / "j"), num_tablets=4),
                         rows, narrow)
    got = _tpch_answers(PgProcessor, cpu_local_cluster(
        str(tmp_path / "p"), num_tablets=4,
        engine_options={"rows_per_block": 64}), rows, narrow)
    assert got == want
    (q1_cols, q1_rows), (_c6, q6_rows) = got
    assert q1_cols[:2] == ["l_returnflag", "l_linestatus"]
    assert q1_rows and q6_rows[0][0] > 0



def test_tpch_q1_q6_through_sql_take_the_grouped_route(tmp_path,
                                                      monkeypatch):
    """Q1 through SQL asks for 9 aggregates (its two avg columns lower to
    sum and count); the port's executor pushes each distinct one once,
    so the engine gets 7, within the grouped kernel's descriptor
    (``group_agg.MAX_AGGS``), and, over lineitem with ``tpch``'s own
    types, plans K8 on every tablet for Q1 and Q6 alike, not the row
    path."""
    from yugabyte_db_tpu_torch.ops import group_agg
    from yugabyte_db_tpu_torch.storage import gpu_engine

    preps = []
    prep = gpu_engine.GpuStorageEngine._grouped_prep

    def recorded(self, trun, spec, exact_preds):
        out = prep(self, trun, spec, exact_preds)
        preps.append((len(spec.aggregates), out))
        return out

    monkeypatch.setattr(gpu_engine.GpuStorageEngine, "_grouped_prep",
                        recorded)
    rows = list(tpch.generate_lineitem(1200))
    _tpch_answers(PgProcessor, cpu_local_cluster(
        str(tmp_path), num_tablets=4,
        engine_options={"rows_per_block": 64}), rows, "TINYINT")
    assert len(preps) == 8                      # 2 queries x 4 tablets
    assert sorted({n for n, _p in preps}) == [1, 7]
    assert all(n <= group_agg.MAX_AGGS and type(p).__name__ == "_GroupPrep"
               for n, p in preps)
