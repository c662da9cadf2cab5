"""The port's CQL wire layer: the v4 frame codec held byte for byte
against the JAX package's, the port's ``CQLServer`` answering the same
frames as the JAX server, then the JAX ``tests/test_cql_wire.py`` and the
CQL parts of ``tests/test_driver_interop.py`` and
``tests/test_serving_path.py`` mirrored over the port's
``MiniCluster.start_cql_server`` (the ``gpu`` engine on CPU tensors) with
the port's ``CqlConnection``. One case runs the JAX driver against the
port's server, and one holds the port driver's bind widths to the CQL
spec.
"""

import datetime
import decimal
import struct
import uuid

import pytest

import test_torch_data as D
from test_torch_data import CqlWireClient as WireClient
from test_torch_data import CqlWireError as CqlError
from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.drivers import CqlConnection
from yugabyte_db_tpu_torch.drivers import CqlError as DriverError
from yugabyte_db_tpu_torch.utils import hybrid_time as t_ht
from yugabyte_db_tpu_torch.utils.metrics import swallowed_errors
from yugabyte_db_tpu_torch.yql.cql import processor as procmod
from yugabyte_db_tpu_torch.yql.cql import wire_protocol as W
from yugabyte_db_tpu_torch.yql.cql.client_cluster import ClientCluster
from yugabyte_db_tpu_torch.yql.cql.server import CQLServer


# -- the frame codec, byte for byte ------------------------------------------

def _value_cases(dt_mod):
    DT = dt_mod.DataType
    return [
        (DT.INT8, [0, -128, 127]),
        (DT.INT16, [-32768, 32767, 5]),
        (DT.INT32, [-2**31, 2**31 - 1, 0, None]),
        (DT.INT64, [-2**63, 2**63 - 1, 12345678901]),
        (DT.COUNTER, [7, -7]),
        (DT.TIMESTAMP, [1_700_000_000_000_000]),
        (DT.FLOAT, [0.0, -0.0, 1.5, 0.1]),
        (DT.DOUBLE, [0.1, -2.5e300, 3.0]),
        (DT.BOOL, [True, False]),
        (DT.STRING, ["", "héllo", "x" * 300]),
        (DT.BINARY, [b"", b"\x00\xff"]),
        (DT.DECIMAL, [decimal.Decimal("3.1415"), decimal.Decimal("-12e5")]),
        (DT.VARINT, [0, -1, 2**80]),
        (DT.UUID, [uuid.UUID(int=0x1234567890abcdef1234567890abcdef)]),
        (DT.DATE, [datetime.date(1969, 12, 31), datetime.date(2024, 2, 29)]),
        (DT.TIME, [datetime.time(13, 45, 7, 250)]),
    ]


def test_values_encode_and_decode_as_the_jax_codec():
    import yugabyte_db_tpu.models.datatypes as j_dt
    import yugabyte_db_tpu.yql.cql.wire_protocol as JW
    import yugabyte_db_tpu_torch.models.datatypes as t_dt

    for (jdt, values), (tdt, _v) in zip(_value_cases(j_dt),
                                         _value_cases(t_dt)):
        assert jdt.name == tdt.name and JW.cql_type_id(jdt) == \
            W.cql_type_id(tdt)
        for v in values:
            raw = W.encode_value(tdt, v)
            assert raw == JW.encode_value(jdt, v), (tdt.name, v)
            assert W.decode_value(tdt, raw) == JW.decode_value(jdt, raw), \
                (tdt.name, v)


def test_result_frames_equal_the_jax_frames():
    import yugabyte_db_tpu.models.datatypes as j_dt
    import yugabyte_db_tpu.yql.cql.wire_protocol as JW
    import yugabyte_db_tpu_torch.models.datatypes as t_dt

    def frames(M, DT):
        cols = [("k", DT.STRING), ("r", DT.INT64), ("a", DT.INT32),
                ("c", DT.DOUBLE), ("f", DT.FLOAT), ("b", DT.BOOL)]
        rows = [("u1", 1, -5, 0.25, 1.5, True),
                ("u2", -2, None, None, -0.0, False)]
        data = b"".join(M.Writer().bytes_(M.encode_value(dt, v)).getvalue()
                        for row in rows for (_n, dt), v in zip(cols, row))
        return [
            M.rows_result(3, "ks", "t", cols, rows),
            M.rows_result(4, "ks", "t", cols, rows, paging_state=b"\x01p"),
            M.rows_result_wire(5, "ks", "t", cols, len(rows), data),
            M.rows_result_wire(6, "ks", "t", cols, len(rows), data,
                               paging_state=b"\x02"),
            M.void_result(7),
            M.set_keyspace_result(8, "ks"),
            M.schema_change_result(9, "CREATED", "KEYSPACE", "ks"),
            M.schema_change_result(10, "DROPPED", "TABLE", "ks", "t"),
            M.prepared_result(11, b"\x0f" * 16, "ks", "t", cols[:3]),
            M.error_frame(12, M.ERR_INVALID, "bad statement"),
            M.frame(M.OP_READY, 13, b""),
        ]

    want = frames(JW, j_dt.DataType)
    got = frames(W, t_dt.DataType)
    assert got == want
    # rows_data route and row route give one frame for the same rows.
    assert got[2][W.HEADER.size:] == got[0][W.HEADER.size:]


# -- the servers, frame for frame --------------------------------------------

T0 = 1_700_000_000_000_000
POINT = "SELECT a, c FROM t WHERE k = ? AND r = ?"
INSERT = "INSERT INTO t (k, r, a, d) VALUES (?, ?, ?, ?)"


def _server_script():
    """Raw requests: (op, ...) with op one of query / prepare / execute /
    pages / flush (every tablet). Every reply frame's bytes are
    compared."""
    steps = [("query", "CREATE KEYSPACE ks"), ("query", "USE ks"),
             ("query", "CREATE TABLE t (k text, r bigint, a bigint, "
                       "c double, d int, PRIMARY KEY ((k), r)) "
                       "WITH tablets = 3")]
    for i in range(60):
        steps.append(("query", "INSERT INTO t (k, r, a, c, d) VALUES "
                      f"('u{i % 9}', {i}, {i * 7919 - 200000}, "
                      f"{i * 0.25}, {(i * 37) % 11})"))
    reads = [
        ("query", "SELECT count(*), sum(a), min(a), max(a), sum(d) FROM t"),
        ("query", "SELECT d, count(*), sum(a) FROM t GROUP BY d"),
        ("query", "SELECT k, r, a, c FROM t WHERE k = 'u3'"),
        ("pages", "SELECT k, r, a, d FROM t", 7),
        ("pages", "SELECT k, r, a FROM t WHERE d >= 5 ALLOW FILTERING", 4),
        ("prepare", POINT),
        ("execute", POINT, [b"u4", struct.pack(">q", 13)]),
        ("execute", POINT, [b"u4", struct.pack(">q", 14)]),   # a miss
    ]
    steps += reads + [("flush",)] + reads + [
        ("prepare", INSERT),
        ("execute", INSERT, [b"u9", struct.pack(">q", 100),
                        struct.pack(">q", -1), struct.pack(">i", 4)]),
        ("execute", INSERT, [b"u9", struct.pack(">q", 101),
                        struct.pack(">q", -1), struct.pack(">q", 4)]),
        ("query", "SELECT * FROM nosuch"),
        ("query", "SELEC nonsense"),
        ("query", "SELECT count(*) FROM t WHERE d = 4 ALLOW FILTERING"),
        ("query", "SELECT * FROM system.local"),
        ("query", "SELECT keyspace_name, table_name FROM "
                  "system_schema.tables WHERE keyspace_name = 'ks'"),
        ("query", "SELECT column_name, kind, position, type FROM "
                  "system_schema.columns WHERE keyspace_name = 'ks' "
                  "AND table_name = 't'"),
        ("flush",),
    ] + reads
    return steps


def _run_server_script(LocalCluster, Server, hybrid_time, root, **kw):
    cluster = LocalCluster(root, num_tablets=3, **kw)
    now = [T0]
    cluster.clock = hybrid_time.HybridClock(now_micros=lambda: now[0])
    server = Server(cluster)
    host, port = server.listen("127.0.0.1", 0)
    cli = WireClient(host, port)
    replies, stmt_ids = [], {}
    try:
        cli.startup()
        for step in _server_script():
            op = step[0]
            if op == "query":
                w = W.Writer().long_string(step[1])
                cli._query_params(w, None, None, None)
                cli._send(W.OP_QUERY, w.getvalue())
                replies.append(cli._recv_frame())
            elif op == "prepare":
                cli._send(W.OP_PREPARE,
                          W.Writer().long_string(step[1]).getvalue())
                reply = cli._recv_frame()
                r = W.Reader(reply[2])
                assert r.int32() == W.RESULT_PREPARED
                stmt_ids[step[1]] = r.short_bytes()
                replies.append(reply)
            elif op == "flush":
                for handle in cluster.tables.values():
                    for t in handle.tablets:
                        t.flush()
            elif op == "execute":
                w = W.Writer().short_bytes(stmt_ids[step[1]])
                cli._query_params(w, step[2], None, None)
                cli._send(W.OP_EXECUTE, w.getvalue())
                replies.append(cli._recv_frame())
            else:
                state = None
                while True:
                    w = W.Writer().long_string(step[1])
                    cli._query_params(w, None, step[2], state)
                    cli._send(W.OP_QUERY, w.getvalue())
                    reply = cli._recv_frame()
                    replies.append(reply)
                    r = W.Reader(reply[2])
                    assert r.int32() == W.RESULT_ROWS
                    flags = r.int32()
                    r.int32()
                    if not flags & 0x0002:
                        break
                    state = r.bytes_()
        return replies
    finally:
        cli.close()
        server.shutdown()
        cluster.close()


def test_port_server_answers_frame_for_frame_as_the_jax_server(
        tmp_path, monkeypatch):
    import yugabyte_db_tpu.yql.cql.vtables as j_vtables
    import yugabyte_db_tpu_torch.yql.cql.vtables as t_vtables
    from yugabyte_db_tpu.utils import hybrid_time as j_ht
    from yugabyte_db_tpu.yql.cql.processor import LocalCluster as JLocal
    from yugabyte_db_tpu.yql.cql.server import CQLServer as JServer

    # Each process draws its own host id; system.local reports it.
    for vt in (j_vtables, t_vtables):
        monkeypatch.setattr(vt, "_HOST_ID", str(uuid.UUID(int=7)))

    want = _run_server_script(JLocal, JServer, j_ht, str(tmp_path / "j"),
                              engine="cpu",
                              engine_options={"rows_per_block": 16})
    got = _run_server_script(D.cpu_local_cluster, CQLServer, t_ht,
                             str(tmp_path / "p"),
                             engine_options={"rows_per_block": 16})
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, i
    # The script's error and paging replies really are in it.
    assert sum(op == W.OP_ERROR for _s, op, _b in got) == 3
    assert len(got) > 100


# -- tests/test_cql_wire.py, mirrored -----------------------------------------

def _i32(v):  # CQL INT serialization
    return struct.pack(">i", v)


def _i64(v):
    return struct.pack(">q", v)


@pytest.fixture
def cql_cluster(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    c.wait_tservers_registered()
    server, (host, port) = c.start_cql_server()
    cli = WireClient(host, port)
    cli.startup()
    yield cli
    cli.close()
    server.shutdown()
    c.shutdown()


def test_ddl_dml_select_over_socket(cql_cluster):
    cli = cql_cluster
    kind, _, _ = cli.query(
        "CREATE TABLE users (id INT, name TEXT, score DOUBLE, "
        "PRIMARY KEY (id))")
    assert kind == W.RESULT_SCHEMA_CHANGE
    for i in range(10):
        kind, _, _ = cli.query(
            f"INSERT INTO users (id, name, score) "
            f"VALUES ({i}, 'user{i}', {i}.5)")
        assert kind == W.RESULT_VOID
    cols, rows, paging = cli.query(
        "SELECT id, name, score FROM users WHERE id = 7")
    assert [c[0] for c in cols] == ["id", "name", "score"]
    assert [c[1] for c in cols] == [W.T_INT, W.T_VARCHAR, W.T_DOUBLE]
    assert len(rows) == 1
    assert struct.unpack(">i", rows[0][0])[0] == 7
    assert rows[0][1] == b"user7"
    assert struct.unpack(">d", rows[0][2])[0] == 7.5


def test_paging_over_socket(cql_cluster):
    cli = cql_cluster
    cli.query("CREATE TABLE pages (k INT, v TEXT, PRIMARY KEY (k))")
    for i in range(25):
        cli.query(f"INSERT INTO pages (k, v) VALUES ({i}, 'v{i}')")
    got = []
    paging = None
    pages = 0
    while True:
        cols, rows, paging = cli.query(
            "SELECT k, v FROM pages", page_size=7, paging_state=paging)
        got.extend(struct.unpack(">i", r[0])[0] for r in rows)
        pages += 1
        assert len(rows) <= 7
        if paging is None:
            break
        assert pages < 20
    assert sorted(got) == list(range(25))
    assert pages >= 4


def test_prepare_execute_over_socket(cql_cluster):
    cli = cql_cluster
    cli.query("CREATE TABLE pe (id INT, n BIGINT, s TEXT, "
              "PRIMARY KEY (id))")
    stmt_id, bind_types = cli.prepare(
        "INSERT INTO pe (id, n, s) VALUES (?, ?, ?)")
    assert bind_types == [W.T_INT, W.T_BIGINT, W.T_VARCHAR]
    for i in range(5):
        kind, _, _ = cli.execute(
            stmt_id, [_i32(i), _i64(i * 1000), f"s{i}".encode()])
        assert kind == W.RESULT_VOID
    sel_id, sel_binds = cli.prepare("SELECT n, s FROM pe WHERE id = ?")
    assert sel_binds == [W.T_INT]
    cols, rows, _ = cli.execute(sel_id, [_i32(3)])
    assert len(rows) == 1
    assert struct.unpack(">q", rows[0][0])[0] == 3000
    assert rows[0][1] == b"s3"


def test_error_frame_over_socket(cql_cluster):
    cli = cql_cluster
    with pytest.raises(CqlError) as ei:
        cli.query("SELECT * FROM missing_table")
    assert ei.value.code in (W.ERR_INVALID, W.ERR_SERVER)
    with pytest.raises(CqlError):
        cli.query("THIS IS NOT CQL")
    # connection still usable after errors
    kind, _, _ = cli.query(
        "CREATE TABLE after_err (k INT, PRIMARY KEY (k))")
    assert kind == W.RESULT_SCHEMA_CHANGE


def test_aggregates_over_socket(cql_cluster):
    cli = cql_cluster
    cli.query("CREATE TABLE agg (k INT, v BIGINT, PRIMARY KEY (k))")
    for i in range(20):
        cli.query(f"INSERT INTO agg (k, v) VALUES ({i}, {i * 10})")
    cols, rows, _ = cli.query("SELECT count(*), sum(v), avg(v) FROM agg")
    assert len(rows) == 1
    assert struct.unpack(">q", rows[0][0])[0] == 20


def test_limit_bind_marker_and_paging_snapshot(cql_cluster):
    cli = cql_cluster
    cli.query("CREATE TABLE lim (k INT, v INT, PRIMARY KEY (k))")
    for i in range(12):
        cli.query(f"INSERT INTO lim (k, v) VALUES ({i}, {i})")
    stmt_id, binds = cli.prepare("SELECT k FROM lim LIMIT ?")
    assert binds == [W.T_INT]
    _cols, rows, _ = cli.execute(stmt_id, [_i32(5)])
    assert len(rows) == 5
    # Paged scans pin one snapshot: a row inserted mid-scan must not
    # appear in later pages.
    got = []
    paging = None
    first = True
    while True:
        _c, rows, paging = cli.query("SELECT k FROM lim",
                                     page_size=4, paging_state=paging)
        got.extend(struct.unpack(">i", r[0])[0] for r in rows)
        if first:
            first = False
            cli.query("INSERT INTO lim (k, v) VALUES (1000, 1000)")
        if paging is None:
            break
    assert sorted(got) == list(range(12))


# -- tests/test_driver_interop.py (its CQL part), mirrored --------------------

@pytest.fixture
def cql(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    c.wait_tservers_registered()
    server = CQLServer(ClientCluster(c.client()))
    host, port = server.listen("127.0.0.1", 0)
    conn = CqlConnection(host, port)
    yield conn
    conn.close()
    server.shutdown()
    c.shutdown()


def test_cql_handshake_reports_supported(cql):
    assert "CQL_VERSION" in cql.supported


def test_cql_control_connection_discovery(cql):
    cql.execute("CREATE KEYSPACE app")
    cql.execute("CREATE TABLE app.users (id bigint PRIMARY KEY, "
                "name text, score double)")
    topo = cql.discover()
    assert topo["local"].get("cql_version") or topo["local"], topo
    assert "app" in topo["schema"]
    assert "users" in topo["schema"]["app"]["tables"]
    assert set(topo["schema"]["app"]["tables"]["users"]) == {
        "id", "name", "score"}


def test_cql_dml_roundtrip_typed(cql):
    cql.execute("CREATE KEYSPACE ks")
    cql.execute("USE ks")
    cql.execute("CREATE TABLE t (k bigint PRIMARY KEY, v text, "
                "d double, b boolean)")
    cql.execute("INSERT INTO t (k, v, d, b) VALUES (1, 'one', 1.5, true)")
    cql.execute("INSERT INTO t (k, v, d, b) VALUES (2, 'two', -2.5, "
                "false)")
    res = cql.execute("SELECT k, v, d, b FROM t WHERE k = 1")
    assert res.columns == ["k", "v", "d", "b"]
    assert res.rows == [(1, "one", 1.5, True)]


def test_cql_prepared_statements(cql):
    cql.execute("CREATE KEYSPACE pks")
    cql.execute("USE pks")
    cql.execute("CREATE TABLE t (k bigint PRIMARY KEY, v text)")
    ins = cql.prepare("INSERT INTO t (k, v) VALUES (?, ?)")
    for i in range(10):
        cql.execute_prepared(ins, [i, f"row{i}"])
    sel = cql.prepare("SELECT v FROM t WHERE k = ?")
    res = cql.execute_prepared(sel, [7])
    assert res.rows == [("row7",)]


def test_cql_prepared_binds_use_column_wire_types(cql):
    """Bind serialization must follow the PREPARED metadata: an `int`
    column takes 4 bytes on the wire and `float` a 4-byte IEEE single —
    not the 8-byte guess made from the Python value's type."""
    cql.execute("CREATE KEYSPACE wks")
    cql.execute("USE wks")
    cql.execute("CREATE TABLE t (k int PRIMARY KEY, s smallint, "
                "y tinyint, f float, d double)")
    ins = cql.prepare("INSERT INTO t (k, s, y, f, d) "
                      "VALUES (?, ?, ?, ?, ?)")
    from yugabyte_db_tpu_torch.drivers.minicql import (T_DOUBLE, T_FLOAT,
                                                       T_INT, T_SMALLINT,
                                                       T_TINYINT)
    assert [s[0] for s in ins.bind_specs] == [
        T_INT, T_SMALLINT, T_TINYINT, T_FLOAT, T_DOUBLE]
    cql.execute_prepared(ins, [7, -300, 5, 1.5, -2.25])
    # Int binds into a float column are coerced by the typed encoder.
    cql.execute_prepared(ins, [-40000, 12, -3, 2, 3])
    sel = cql.prepare("SELECT k, s, y, f, d FROM t WHERE k = ?")
    assert cql.execute_prepared(sel, [7]).rows == [(7, -300, 5, 1.5,
                                                   -2.25)]
    assert cql.execute_prepared(sel, [-40000]).rows == [
        (-40000, 12, -3, 2.0, 3.0)]


def test_cql_paging_loop(cql):
    cql.execute("CREATE KEYSPACE pg2")
    cql.execute("USE pg2")
    cql.execute("CREATE TABLE t (k bigint PRIMARY KEY, v bigint)")
    for i in range(57):
        cql.execute(f"INSERT INTO t (k, v) VALUES ({i}, {i * 10})")
    first = cql.execute("SELECT k, v FROM t", page_size=10)
    assert len(first.rows) == 10 and first.has_more_pages
    res = cql.fetch_all("SELECT k, v FROM t", page_size=10)
    assert len(res.rows) == 57
    assert {k for k, _v in res.rows} == set(range(57))


def test_cql_pipelined_prepared_with_errors(cql):
    """Stream-multiplexed pipelining: errors come back in-place and the
    connection stays usable (no desync from stale frames)."""
    cql.execute("CREATE KEYSPACE plk")
    cql.execute("USE plk")
    cql.execute("CREATE TABLE t (k bigint PRIMARY KEY, v bigint)")
    ins = cql.prepare("INSERT INTO t (k, v) VALUES (?, ?)")
    vals = [[i, i * 2] for i in range(40)]
    vals[7] = [7, "not-an-int"]    # per-request failure mid-window
    vals[23] = [23, "bad"]
    out = cql.execute_prepared_many(ins, vals, window=16)
    assert sum(isinstance(r, DriverError) for r in out) == 2
    assert isinstance(out[7], DriverError)
    assert isinstance(out[23], DriverError)
    # connection still healthy: later pipelined + sync calls work
    sel = cql.prepare("SELECT v FROM t WHERE k = ?")
    res = cql.execute_prepared_many(sel, [[i] for i in (1, 7, 39)])
    assert [r.rows for r in res] == [[(2,)], [], [(78,)]]
    assert cql.execute("SELECT count(*) FROM t").rows == [(38,)]


def test_driver_bursts_reach_the_batch_path(cql, monkeypatch):
    """The port driver's departure: ``execute_prepared_many`` writes each
    refill of its window in one socket write, so the server's pipelined
    batch path serves the point SELECTs (the JAX driver writes one frame
    at a time, and most frames then arrive alone)."""
    cql.execute("CREATE KEYSPACE bp")
    cql.execute("USE bp")
    cql.execute("CREATE TABLE t (k bigint PRIMARY KEY, v text)")
    ins = cql.prepare("INSERT INTO t (k, v) VALUES (?, ?)")
    cql.execute_prepared_many(ins, [[i, f"v{i}"] for i in range(40)])
    served = []
    orig = procmod.QLProcessor.execute_wire_point_batch

    def spy(self, items):
        out = orig(self, items)
        served.append(sum(r is not None for r in out))
        return out

    monkeypatch.setattr(procmod.QLProcessor, "execute_wire_point_batch",
                        spy)
    sel = cql.prepare("SELECT v FROM t WHERE k = ?")
    res = cql.execute_prepared_many(sel, [[i] for i in range(60)],
                                    window=16)
    assert [r.rows for r in res] == [[(f"v{i}",)] if i < 40 else []
                                     for i in range(60)]
    assert sum(served) == 60 and len(served) < 60


def test_cql_error_frame(cql):
    with pytest.raises(DriverError) as ei:
        cql.execute("SELECT * FROM nosuch.table")
    assert ei.value.code != 0 or ei.value.message


# -- the bind widths, against the CQL spec ------------------------------------

def test_bound_int_smallint_float_read_back_as_the_spec_gives(cql):
    """A prepared INSERT binding ``int``, ``smallint`` and ``float``
    columns through the port's driver: each value goes out at its
    column's width (§6 of the v4 spec: 4-byte and 2-byte two's
    complement, a 4-byte IEEE 754 single) and reads back as that width
    holds it. A value past the width is refused by the driver."""
    from yugabyte_db_tpu_torch.drivers.minicql import encode_cql_typed

    cql.execute("CREATE KEYSPACE bw")
    cql.execute("USE bw")
    cql.execute("CREATE TABLE t (k int PRIMARY KEY, s smallint, f float)")
    ins = cql.prepare("INSERT INTO t (k, s, f) VALUES (?, ?, ?)")
    widths = [len(encode_cql_typed(v, spec))
              for v, spec in zip([1, 1, 1.0], ins.bind_specs)]
    assert widths == [4, 2, 4]
    cases = [(2**31 - 1, 2**15 - 1, 0.1), (-2**31, -2**15, -3.4e38),
             (0, 0, 16777217.0), (5, -1, 1.5)]
    for k, s, f in cases:
        cql.execute_prepared(ins, [k, s, f])
    sel = cql.prepare("SELECT k, s, f FROM t WHERE k = ?")
    for k, s, f in cases:
        single = struct.unpack(">f", struct.pack(">f", f))[0]
        assert cql.execute_prepared(sel, [k]).rows == [(k, s, single)]
    for bad in ([2**31, 0, 0.0], [1, 2**15, 0.0]):
        with pytest.raises(DriverError):
            cql.execute_prepared(ins, bad)


# -- the JAX driver against the port's server ---------------------------------

def test_jax_driver_against_the_port_server(cql, tmp_path):
    from yugabyte_db_tpu.drivers import CqlConnection as JaxConnection

    cql.execute("CREATE KEYSPACE x")
    cql.execute("CREATE TABLE x.t (k bigint PRIMARY KEY, v text, d int)")
    host, port = cql.sock.getpeername()
    jc = JaxConnection(host, port)
    try:
        jc.execute("USE x")
        ins = jc.prepare("INSERT INTO t (k, v, d) VALUES (?, ?, ?)")
        out = jc.execute_prepared_many(
            ins, [[i, f"v{i}", i * 3] for i in range(30)])
        assert all(r.kind == "void" for r in out), out[:3]
        sel = jc.prepare("SELECT k, v, d FROM t WHERE k = ?")
        res = jc.execute_prepared_many(sel, [[i] for i in range(30)])
        assert [r.rows for r in res] == [[(i, f"v{i}", i * 3)]
                                         for i in range(30)]
        assert jc.fetch_all("SELECT k FROM t", page_size=7).rows and \
            len(jc.fetch_all("SELECT k FROM t", page_size=7).rows) == 30
        topo = jc.discover()
        assert set(topo["schema"]["x"]["tables"]["t"]) == {"k", "v", "d"}
        # The port's driver reads what the JAX driver wrote.
        cql.execute("USE x")
        assert cql.execute("SELECT count(*), sum(d) FROM t").rows == [
            (30, 3 * sum(range(30)))]
    finally:
        jc.close()


# -- tests/test_serving_path.py (its CQL part), mirrored ----------------------

@pytest.fixture
def cql_rig(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    c.wait_tservers_registered()
    server, (host, port) = c.start_cql_server()
    cli = WireClient(host, port)
    cli.startup()
    cli.query("CREATE KEYSPACE sp")
    cli.query("USE sp")
    cli.query("CREATE TABLE t (k bigint PRIMARY KEY, v text, d double)")
    for i in range(30):
        cli.query(f"INSERT INTO t (k, v, d) VALUES ({i}, 'val{i}', "
                  f"{i * 0.5})")
    yield cli
    cli.close()
    server.shutdown()
    c.shutdown()


BATCH_SITES = ("cql.batch_plan", "cql.batch_serve", "cql.batch_continue",
               "cql.batch_decode", "cql.batch_execute")


def test_cql_prepared_point_select_batch_byte_identical(cql_rig,
                                                        monkeypatch):
    sel, _binds = cql_rig.prepare("SELECT k, v, d FROM t WHERE k = ?")
    frames = [(100 + i, sel, [_i64(i)]) for i in range(20)]
    frames += [(200, sel, [_i64(999)]),             # miss -> empty rows
               (201, b"\x00" * 16, [_i64(1)])]      # unknown stmt -> error
    swallowed = {s: swallowed_errors(s) for s in BATCH_SITES}
    served = []
    orig = procmod.QLProcessor.execute_wire_point_batch

    def spy(self, items):
        out = orig(self, items)
        served.extend(r is not None for r in out)
        return out

    monkeypatch.setattr(procmod.QLProcessor, "execute_wire_point_batch",
                        spy)
    batched = cql_rig.execute_many(frames)
    assert served and all(served), "batch path did not serve every frame"
    assert batched[201][0] == W.OP_ERROR
    # No error was swallowed and re-run on the way.
    assert {s: swallowed_errors(s) for s in BATCH_SITES} == swallowed
    # Same frames with the batch executor refusing everything: each
    # frame runs the canonical per-op handle_call path.
    monkeypatch.setattr(procmod.QLProcessor, "execute_wire_point_batch",
                        lambda self, items: [None] * len(items))
    fallback = cql_rig.execute_many(frames)
    assert fallback == batched


def test_cql_batch_mixed_with_nonpoint_select(cql_rig):
    """A pipelined window mixing point SELECTs with a full-table scan:
    the scan falls back per-op inside the SAME batch and every reply
    stays stream-paired."""
    sel, _binds = cql_rig.prepare("SELECT v FROM t WHERE k = ?")
    scan, _binds = cql_rig.prepare("SELECT k FROM t")
    frames = [(1, sel, [_i64(3)]), (2, scan, []), (3, sel, [_i64(4)])]
    replies = cql_rig.execute_many(frames)
    for stream in (1, 2, 3):
        opcode, body = replies[stream]
        assert opcode == W.OP_RESULT
        assert W.Reader(body).int32() == W.RESULT_ROWS
    # the scan really returned the whole table
    r = W.Reader(replies[2][1])
    assert r.int32() == W.RESULT_ROWS
    flags = r.int32()
    ncols = r.int32()
    if flags & 0x0002:
        r.bytes_()
    if flags & 0x0001:
        r.string()
        r.string()
    for _ in range(ncols):
        r.string()
        r.short()
    assert r.int32() == 30
