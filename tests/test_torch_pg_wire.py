"""The port's PostgreSQL wire server (``yql/pgsql/wire.py`` ``PgServer``)
and driver (``drivers/minipg.py`` ``PgConnection``).

- The port's server answers one frame script (SSL probe, startup, simple
  and extended queries, errors and their recovery, catalog reads, an
  unsupported message) and the cleartext-password handshake with the
  JAX server's bytes, message for message. The server sends no backend
  key, so nothing differs by process.
- The JAX driver works against the port's server.
- The pg cases of the JAX package's ``tests/test_driver_interop.py``,
  ``test_pgsql_surface.py``, ``test_auth.py``, ``test_types_matrix.py``,
  ``test_alter.py`` and ``test_collections.py`` run over the port's
  ``MiniCluster.start_pg_server`` with the port's ``PgConnection``.
"""

import socket
import struct

import pytest

from test_torch_data import cpu_local_cluster, cpu_mini_cluster
from yugabyte_db_tpu_torch.auth import hash_password
from yugabyte_db_tpu_torch.drivers import PgConnection, PgError
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent,
                                                InvalidArgument, NotFound)
from yugabyte_db_tpu_torch.yql.cql.client_cluster import ClientCluster
from yugabyte_db_tpu_torch.yql.pgsql.wire import PgServer

_U32 = struct.Struct(">I")


# -- the frame script, through both packages' servers -------------------------

def _frame(tag: bytes, payload: bytes = b"") -> bytes:
    return tag + _U32.pack(len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _startup(user: str = "tester") -> bytes:
    body = _U32.pack(196608) + _cstr("user") + _cstr(user) + \
        _cstr("database") + _cstr("db") + b"\x00"
    return _U32.pack(len(body) + 4) + body


def _query(sql: str) -> bytes:
    return _frame(b"Q", _cstr(sql))


def _parse(name: str, sql: str) -> bytes:
    return _frame(b"P", _cstr(name) + _cstr(sql) + struct.pack(">H", 0))


def _bind(portal: str, stmt: str, params) -> bytes:
    out = _cstr(portal) + _cstr(stmt) + struct.pack(">HH", 0, len(params))
    for p in params:
        if p is None:
            out += struct.pack(">i", -1)
        else:
            b = str(p).encode()
            out += struct.pack(">i", len(b)) + b
    return _frame(b"B", out + struct.pack(">H", 0))


def _describe(target: bytes, name: str) -> bytes:
    return _frame(b"D", target + _cstr(name))


def _execute(portal: str = "", max_rows: int = 0) -> bytes:
    return _frame(b"E", _cstr(portal) + struct.pack(">i", max_rows))


def _close(target: bytes, name: str) -> bytes:
    return _frame(b"C", target + _cstr(name))


SYNC = _frame(b"S")

# (frames to send, what to read back): "ssl" one byte, "msg" one message,
# "ready" every message up to ReadyForQuery.
FRAME_SCRIPT = [
    (_U32.pack(8) + _U32.pack(80877103), "ssl"),
    (_startup(), "ready"),
    (_query("CREATE TABLE w (a BIGINT PRIMARY KEY, b TEXT, "
            "c DOUBLE PRECISION, f BOOLEAN, g INT)"), "ready"),
    (_query("INSERT INTO w (a, b, c, f, g) VALUES (1, 'one', 1.5, true, 0),"
            " (2, 'two', -0.25, false, 1), (3, NULL, NULL, NULL, 0), "
            "(4, 'it''s', 1e300, true, 1)"), "ready"),
    (_query("SELECT a, b, c, f FROM w ORDER BY a"), "ready"),
    (_query("SELECT * FROM w WHERE a = 2"), "ready"),
    (_query("INSERT INTO w (a, b) VALUES (5, 'five'); "
            "SELECT count(*), sum(a), min(b), max(c) FROM w; "
            "SELECT b FROM w WHERE a = 3"), "ready"),
    (_query("SELECT g, count(*), sum(a) FROM w GROUP BY g ORDER BY g"),
     "ready"),
    (_query("SELECT a, sum(a) OVER (PARTITION BY g ORDER BY a) AS run "
            "FROM w ORDER BY a"), "ready"),
    (_query("SELECT a FROM w ORDER BY a LIMIT 2 OFFSET 1"), "ready"),
    (_query(""), "ready"),
    (_query("SELECT nope FROM missing"), "ready"),
    (_query("NOT SQL AT ALL"), "ready"),
    (_query("INSERT INTO w (a, b) VALUES (1, 'dup')"), "ready"),
    (_query("UPDATE w SET b = 'uno', g = 7 WHERE a = 1"), "ready"),
    (_query("DELETE FROM w WHERE c < 0"), "ready"),
    (_query("BEGIN"), "ready"),
    (_parse("", "INSERT INTO w (a, b, c) VALUES ($1, $2, $3)")
     + _bind("", "", [10, "ten", 2.5]) + _describe(b"P", "")
     + _execute() + SYNC, "ready"),
    (_parse("sel", "SELECT a, b FROM w WHERE a >= $1 ORDER BY a")
     + _describe(b"S", "sel") + _bind("", "sel", [3])
     + _describe(b"P", "") + _execute() + _bind("", "sel", [5])
     + _execute() + SYNC, "ready"),
    (_bind("", "sel", [None]) + _describe(b"P", "") + _execute() + SYNC,
     "ready"),
    (_parse("", "INSERT INTO w (a) VALUES ($1)") + _bind("", "", ["x"])
     + _describe(b"P", "") + _execute() + SYNC, "ready"),
    (_bind("", "missing", []) + _execute() + SYNC, "ready"),
    (_close(b"S", "sel") + _frame(b"H") + _bind("", "sel", [1]) + SYNC,
     "ready"),
    (_query("SELECT tablename FROM pg_catalog.pg_tables"), "ready"),
    (_query("SELECT column_name, data_type FROM information_schema.columns"
            " WHERE table_name = 'w'"), "ready"),
    (_query("SELECT count(*) FROM pg_catalog.pg_tables WHERE "
            "tablename = 'w'"), "ready"),
    (_frame(b"F", b"\x00\x00\x00\x00"), "ready"),
    (_query("DROP TABLE w"), "ready"),
    (_query("SELECT a FROM w"), "ready"),
]

AUTH_SCRIPT = [
    [(_startup("postgres"), "msg"), (_frame(b"p", _cstr("wrong")), "msg")],
    [(_startup("postgres"), "msg"), (_frame(b"p", _cstr("pg")), "ready"),
     (_query("SELECT 1"), "ready")],
    [(_startup("nobody"), "msg"), (_frame(b"p", _cstr("pg")), "msg")],
]


class FrameClient:
    """Raw FE/BE frames over a socket; each read returns the messages'
    bytes as the server wrote them."""

    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.buf = b""

    def close(self):
        self.sock.close()

    def _fill(self, n):
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            assert chunk, "connection closed"
            self.buf += chunk

    def _take(self, n):
        self._fill(n)
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def read_msg(self):
        self._fill(5)
        (ln,) = _U32.unpack_from(self.buf, 1)
        return self._take(1 + ln)

    def run(self, frames, reader):
        self.sock.sendall(frames)
        if reader == "ssl":
            return [self._take(1)]
        if reader == "msg":
            return [self.read_msg()]
        msgs = []
        while True:
            msgs.append(self.read_msg())
            if msgs[-1][:1] == b"Z":
                return msgs


def _answers(server, scripts):
    host, port = server.listen("127.0.0.1", 0)
    out = []
    try:
        for script in scripts:
            c = FrameClient(host, port)
            try:
                out.append([c.run(frames, reader)
                            for frames, reader in script])
            finally:
                c.close()
    finally:
        server.shutdown()
    return out


def _jax_server(tmp_path):
    from yugabyte_db_tpu.yql.cql.processor import LocalCluster as JLocal
    from yugabyte_db_tpu.yql.pgsql.wire import PgServer as JPgServer

    cluster = JLocal(str(tmp_path / "jax"), num_tablets=2)
    return JPgServer(cluster), cluster


def _port_server(tmp_path):
    cluster = cpu_local_cluster(str(tmp_path / "port"), num_tablets=2,
                                engine_options={"rows_per_block": 16})
    return PgServer(cluster), cluster


def test_port_server_answers_the_jax_server_frame_for_frame(tmp_path):
    answers = []
    for make in (_jax_server, _port_server):
        server, cluster = make(tmp_path)
        try:
            answers.append(_answers(server, [FRAME_SCRIPT]))
        finally:
            cluster.close()
    want, got = answers
    for (frames, _r), w, g in zip(FRAME_SCRIPT, want[0], got[0]):
        assert g == w, frames
    tags = [m[:1] for step in got[0] for m in step]
    for tag in (b"N", b"R", b"S", b"T", b"D", b"C", b"E", b"I", b"1",
                b"2", b"t", b"n", b"3", b"Z"):
        assert tag in tags, tag


def test_password_handshake_matches_the_jax_server(tmp_path):
    from yugabyte_db_tpu.auth import hash_password as j_hash_password
    from yugabyte_db_tpu.utils.flags import FLAGS as JFLAGS

    answers = []
    for make, flags, hasher in ((_jax_server, JFLAGS, j_hash_password),
                                (_port_server, FLAGS, hash_password)):
        server, cluster = make(tmp_path)
        cluster.auth_op({"op": "auth_create_role", "name": "postgres",
                         "can_login": True,
                         "salted_hash": hasher("pg")})
        flags.set("ysql_require_auth", True)
        try:
            answers.append(_answers(server, AUTH_SCRIPT))
        finally:
            flags.set("ysql_require_auth", False)
            cluster.close()
    assert answers[1] == answers[0]
    wrong, right, nobody = answers[1]
    assert wrong[0][0] == _frame(b"R", _U32.pack(3))
    assert wrong[1][0][:1] == b"E" and b"28P01" in wrong[1][0]
    assert right[1][0] == _frame(b"R", _U32.pack(0))
    assert nobody[1][0][:1] == b"E" and b"28P01" in nobody[1][0]


def test_jax_driver_against_the_port_server(tmp_path):
    from yugabyte_db_tpu.drivers import PgConnection as JPgConnection
    from yugabyte_db_tpu.drivers import PgError as JPgError

    server, cluster = _port_server(tmp_path)
    host, port = server.listen("127.0.0.1", 0)
    conn = JPgConnection(host, port, user="app")
    try:
        conn.execute("CREATE TABLE t (k BIGINT PRIMARY KEY, v TEXT, "
                     "d DOUBLE PRECISION)")
        conn.execute_params("INSERT INTO t (k, v, d) VALUES ($1, $2, $3)",
                            [1, "one", 0.5])
        conn.prepare("ins", "INSERT INTO t (k, v, d) VALUES ($1, $2, $3)")
        for i in range(2, 6):
            conn.execute_prepared("ins", [i, f"r{i}", i * 1.5])
        res = conn.execute("SELECT k, v, d FROM t ORDER BY k")
        assert res.columns == ["k", "v", "d"]
        assert res.rows == [(1, "one", 0.5)] + [
            (i, f"r{i}", i * 1.5) for i in range(2, 6)]
        res = conn.execute_params("SELECT count(*), sum(k) FROM t "
                                  "WHERE k >= $1", [3])
        assert res.rows == [(3, 12)]
        with pytest.raises(JPgError) as ei:
            conn.execute("SELECT * FROM missing")
        assert ei.value.code == "42P01"
        assert conn.execute("SELECT 1").rows == [(1,)]
        assert conn.txn_status == b"I"
    finally:
        conn.close()
        server.shutdown()
        cluster.close()


def test_ysql_require_auth_matches_the_jax_flag():
    """The flag the PG server reads at startup: the JAX name, default,
    help text and tags."""
    from yugabyte_db_tpu.utils.flags import FLAGS as JFLAGS

    port = {f.name: f for f in FLAGS.all()}["ysql_require_auth"]
    jax = {f.name: f for f in JFLAGS.all()}["ysql_require_auth"]
    assert (port.default, port.help, port.tags) == \
        (jax.default, jax.help, jax.tags)
    assert port.default is False


# -- the JAX pg cases over the port's MiniCluster.start_pg_server -------------

class WireSession:
    """A ``PgProcessor``-shaped session over the port's ``PgConnection``:
    ``execute`` returns the driver's result set, and an ErrorResponse
    raises the status error its SQLSTATE names (the server's mapping),
    any other ``PgError``."""

    _ERRORS = {"42601": InvalidArgument, "23505": AlreadyPresent,
               "42P01": NotFound}

    def __init__(self, conn):
        self.conn = conn

    def execute(self, sql):
        try:
            return self.conn.execute(sql)
        except PgError as e:
            cls = self._ERRORS.get(e.code)
            if cls is None:
                raise
            raise cls(e.message) from e


@pytest.fixture
def mini(tmp_path):
    mc = cpu_mini_cluster(str(tmp_path), num_masters=1,
                          num_tservers=3).start()
    mc.wait_tservers_registered()
    yield mc
    mc.shutdown()


@pytest.fixture
def pg(mini):
    """The JAX ``test_driver_interop.py`` fixture's connection, served by
    ``MiniCluster.start_pg_server``."""
    server, (host, port) = mini.start_pg_server()
    conn = PgConnection(host, port, user="app")
    yield conn
    conn.close()
    server.shutdown()


@pytest.fixture
def local_pg(tmp_path):
    server = PgServer(cpu_local_cluster(str(tmp_path / "local"),
                                        num_tablets=2))
    host, port = server.listen("127.0.0.1", 0)
    conn = PgConnection(host, port, user="app")
    yield WireSession(conn)
    conn.close()
    server.shutdown()
    server.cluster.close()


@pytest.fixture
def dist_pg(pg):
    return WireSession(pg)


# JAX tests/test_driver_interop.py (PostgreSQL)

def test_pg_simple_query_flow(pg):
    pg.execute("CREATE TABLE t (k INT PRIMARY KEY, v TEXT, d FLOAT8)")
    pg.execute("INSERT INTO t (k, v, d) VALUES (1, 'one', 1.5)")
    pg.execute("INSERT INTO t (k, v, d) VALUES (2, 'two', 2.5)")
    res = pg.execute("SELECT k, v, d FROM t ORDER BY k")
    assert res.columns == ["k", "v", "d"]
    assert res.rows == [(1, "one", 1.5), (2, "two", 2.5)]
    assert res.command_tag.startswith("SELECT")
    assert pg.txn_status == b"I"


def test_pg_execparams_extended_flow(pg):
    pg.execute("CREATE TABLE t (k INT PRIMARY KEY, v TEXT)")
    pg.execute_params("INSERT INTO t (k, v) VALUES ($1, $2)",
                      [1, "hello"])
    pg.execute_params("INSERT INTO t (k, v) VALUES ($1, $2)",
                      [2, "world"])
    res = pg.execute_params("SELECT v FROM t WHERE k = $1", [2])
    assert res.rows == [("world",)]


def test_pg_named_prepared(pg):
    pg.execute("CREATE TABLE t (k INT PRIMARY KEY, v TEXT)")
    pg.prepare("ins", "INSERT INTO t (k, v) VALUES ($1, $2)")
    for i in range(5):
        pg.execute_prepared("ins", [i, f"r{i}"])
    res = pg.execute("SELECT count(*) FROM t")
    assert res.rows == [(5,)]


def test_pg_window_over_wire(pg):
    pg.execute("CREATE TABLE s (id BIGINT PRIMARY KEY, g TEXT, "
               "x BIGINT)")
    for i, (g, x) in enumerate([("a", 10), ("a", 30), ("b", 20)], 1):
        pg.execute(f"INSERT INTO s (id, g, x) VALUES ({i}, '{g}', {x})")
    res = pg.execute("SELECT id, sum(x) OVER (PARTITION BY g ORDER BY "
                     "id) AS run FROM s ORDER BY id")
    assert res.rows == [(1, 10), (2, 40), (3, 20)]


def test_pg_error_and_recovery(pg):
    with pytest.raises(PgError) as ei:
        pg.execute("SELECT * FROM missing_table")
    assert ei.value.message
    res = pg.execute("SELECT 1")
    assert res.rows == [(1,)]


def test_pg_transaction_status(pg):
    pg.execute("CREATE TABLE t (k INT PRIMARY KEY)")
    pg.execute("BEGIN")
    assert pg.txn_status == b"T"
    pg.execute("INSERT INTO t (k) VALUES (1)")
    pg.execute("COMMIT")
    assert pg.txn_status == b"I"
    assert pg.execute("SELECT count(*) FROM t").rows == [(1,)]


# JAX tests/test_pgsql_surface.py

def _load(pg):
    pg.execute("CREATE TABLE emp (id INT PRIMARY KEY, dept TEXT, "
               "salary BIGINT)")
    pg.execute("CREATE TABLE dept (name TEXT PRIMARY KEY, region TEXT)")
    for i in range(9):
        pg.execute(f"INSERT INTO emp (id, dept, salary) VALUES "
                   f"({i}, 'd{i % 3}', {i * 100})")
    pg.execute("INSERT INTO dept (name, region) VALUES ('d0', 'east')")
    pg.execute("INSERT INTO dept (name, region) VALUES ('d1', 'west')")
    pg.execute("INSERT INTO dept (name, region) VALUES ('dx', 'void')")


def test_right_join_preserves_unmatched_right(dist_pg):
    pg = dist_pg
    _load(pg)
    rows = pg.execute(
        "SELECT emp.id, dept.name FROM emp RIGHT JOIN dept "
        "ON emp.dept = dept.name").rows
    ids_by_dept = {}
    for i, name in rows:
        ids_by_dept.setdefault(name, []).append(i)
    assert sorted(ids_by_dept["d0"]) == [0, 3, 6]
    assert ids_by_dept["dx"] == [None]
    assert "d2" not in ids_by_dept  # left-only depts drop on RIGHT join


def test_full_join_preserves_both_sides(dist_pg):
    pg = dist_pg
    _load(pg)
    rows = pg.execute(
        "SELECT emp.id, emp.dept, dept.name FROM emp FULL JOIN dept "
        "ON emp.dept = dept.name").rows
    # 9 matched-or-left rows + 1 right-only (dx)
    assert len(rows) == 10
    assert (None, None, "dx") in rows
    d2 = [r for r in rows if r[1] == "d2"]
    assert d2 and all(r[2] is None for r in d2)  # left preserved


def test_full_join_where_applies_after_join(dist_pg):
    pg = dist_pg
    _load(pg)
    rows = pg.execute(
        "SELECT emp.id, dept.name FROM emp FULL JOIN dept "
        "ON emp.dept = dept.name WHERE dept.region = 'void'").rows
    assert rows == [(None, "dx")]


@pytest.mark.parametrize("fixture", ["local_pg", "dist_pg"])
def test_views_round_trip(fixture, request):
    pg = request.getfixturevalue(fixture)
    _load(pg)
    pg.execute("CREATE VIEW rich AS SELECT id, salary FROM emp "
               "WHERE salary >= 400")
    rows = pg.execute("SELECT id FROM rich WHERE salary < 700 "
                      "ORDER BY id").rows
    assert rows == [(4,), (5,), (6,)]
    assert len(pg.execute("SELECT * FROM rich").rows) == 5
    with pytest.raises(InvalidArgument):
        pg.execute("CREATE VIEW rich AS SELECT id FROM emp")
    pg.execute("CREATE OR REPLACE VIEW rich AS SELECT id FROM emp "
               "WHERE salary >= 800")
    assert pg.execute("SELECT * FROM rich").rows == [(8,)]
    pg.execute("DROP VIEW rich")
    with pytest.raises((InvalidArgument, NotFound)):
        pg.execute("SELECT * FROM rich")


@pytest.mark.parametrize("fixture", ["local_pg", "dist_pg"])
def test_sequences(fixture, request):
    pg = request.getfixturevalue(fixture)
    pg.execute("CREATE SEQUENCE ids")
    assert pg.execute("SELECT nextval('ids')").rows == [(1,)]
    assert pg.execute("SELECT nextval('ids')").rows == [(2,)]
    assert pg.execute("SELECT currval('ids')").rows == [(2,)]
    pg.execute("CREATE TABLE st (id INT PRIMARY KEY, v INT)")
    pg.execute("INSERT INTO st (id, v) VALUES (nextval('ids'), 7)")
    assert pg.execute("SELECT id, v FROM st").rows == [(3, 7)]
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT nextval('nope')")
    pg.execute("DROP SEQUENCE ids")
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT nextval('ids')")


def test_savepoints(dist_pg):
    pg = dist_pg
    pg.execute("CREATE TABLE acc (id INT PRIMARY KEY, bal INT)")
    pg.execute("BEGIN")
    pg.execute("INSERT INTO acc (id, bal) VALUES (1, 100)")
    pg.execute("SAVEPOINT s1")
    pg.execute("INSERT INTO acc (id, bal) VALUES (2, 200)")
    pg.execute("SAVEPOINT s2")
    pg.execute("INSERT INTO acc (id, bal) VALUES (3, 300)")
    pg.execute("ROLLBACK TO SAVEPOINT s2")   # drops id=3
    pg.execute("INSERT INTO acc (id, bal) VALUES (4, 400)")
    pg.execute("ROLLBACK TO s1")             # drops 2 and 4
    pg.execute("INSERT INTO acc (id, bal) VALUES (5, 500)")
    pg.execute("RELEASE SAVEPOINT s1")
    pg.execute("COMMIT")
    rows = sorted(pg.execute("SELECT id, bal FROM acc").rows)
    assert rows == [(1, 100), (5, 500)]
    # rollback-to a released/unknown savepoint fails the block
    pg.execute("BEGIN")
    with pytest.raises(Exception):
        pg.execute("ROLLBACK TO SAVEPOINT nope")
    pg.execute("ROLLBACK")


# JAX tests/test_auth.py (the PG wire)

def test_pg_wire_password_auth(mini):
    ClientCluster(mini.client("admin")).auth_op(
        {"op": "auth_create_role", "name": "postgres", "can_login": True,
         "salted_hash": hash_password("pg")})
    FLAGS.set("ysql_require_auth", True)
    server, (host, port) = mini.start_pg_server()
    try:
        # wrong password fails closed
        with pytest.raises(PgError) as ei:
            PgConnection(host, port, user="postgres", password="wrong")
        assert ei.value.code == "28P01"
        assert "authentication failed" in ei.value.message
        # right password authenticates and serves queries
        conn = PgConnection(host, port, user="postgres", password="pg")
        try:
            conn.execute("CREATE TABLE ta (k INT PRIMARY KEY)")
            assert conn.execute("SELECT count(*) FROM ta").rows == [(0,)]
        finally:
            conn.close()
    finally:
        FLAGS.set("ysql_require_auth", False)
        server.shutdown()


# JAX tests/test_types_matrix.py (the PG frontend), the values as the
# wire renders them (``models.wirefmt.pg_text``)

def test_pg_frontend_typed_table(pg):
    pg.execute("CREATE TABLE m (id bigint PRIMARY KEY, "
               "amt numeric(10,2), u uuid, ip inet, d date, t time)")
    pg.execute("INSERT INTO m (id, amt, u, ip, d, t) VALUES "
               "(1, '99.95', 'c0fe0000-0000-1000-8000-00805f9b34fb',"
               " '192.168.0.1', '2023-12-25', '08:30:00')")
    r = pg.execute("SELECT amt, u, ip, d, t FROM m WHERE id = 1")
    assert r.rows == [("99.95", "c0fe0000-0000-1000-8000-00805f9b34fb",
                       "192.168.0.1", "2023-12-25", "08:30:00")]


# JAX tests/test_alter.py (the SQL frontend)

def test_pgsql_alter(pg):
    pg.execute("CREATE TABLE t (k TEXT PRIMARY KEY, v BIGINT)")
    pg.execute("INSERT INTO t (k, v) VALUES ('a', 1)")
    pg.execute("ALTER TABLE t ADD COLUMN w TEXT")
    pg.execute("INSERT INTO t (k, v, w) VALUES ('b', 2, 'yes')")
    res = pg.execute("SELECT k, v, w FROM t ORDER BY k")
    assert res.rows == [("a", 1, None), ("b", 2, "yes")]
    pg.execute("ALTER TABLE t RENAME COLUMN v TO n")
    res = pg.execute("SELECT sum(n) FROM t")
    assert res.rows == [(3,)]
    pg.execute("ALTER TABLE t DROP COLUMN w")
    res = pg.execute("SELECT * FROM t ORDER BY k")
    assert res.columns == ["k", "n"]


# JAX tests/test_collections.py (JSONB through the SQL frontend)

def test_jsonb_pgsql(pg):
    pg.execute("CREATE TABLE docs (id BIGINT PRIMARY KEY, j JSONB)")
    pg.execute("""INSERT INTO docs (id, j) VALUES
        (1, '{"name": "ada", "tags": ["x", "y"], "n": {"d": 7}}'),
        (2, '{"name": "bob", "n": {"d": 9}}')""")
    res = pg.execute("SELECT j FROM docs WHERE id = 1")
    assert '"name":"ada"' in res.rows[0][0].replace(" ", "")
    # -> returns json, ->> returns text; paths chain
    res = pg.execute("SELECT id, j -> 'name' FROM docs ORDER BY id")
    assert res.rows == [(1, "ada"), (2, "bob")]
    res = pg.execute("SELECT j -> 'n' ->> 'd' FROM docs ORDER BY id")
    assert res.rows == [("7",), ("9",)]
    res = pg.execute("SELECT j -> 'tags' -> 0 FROM docs WHERE id = 1")
    assert res.rows == [("x",)]
    res = pg.execute("SELECT j ->> 'n' FROM docs WHERE id = 2")
    assert res.rows == [('{"d":9}',)]
    # missing keys are NULL
    res = pg.execute("SELECT j -> 'nope' FROM docs WHERE id = 1")
    assert res.rows == [(None,)]
    with pytest.raises(PgError) as ei:
        pg.execute("INSERT INTO docs (id, j) VALUES (3, 'not json')")
    assert ei.value.code == "42601"
