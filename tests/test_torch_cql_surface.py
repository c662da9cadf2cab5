"""The port's YCQL surface beyond plain statements, under the
assertions of the JAX package's ``tests/test_vtables.py`` (the stock
driver's handshake: ``system.local``, ``system.peers``,
``system_schema.*``), ``tests/test_cql_udt.py`` and the CQL cases of
``tests/test_collections.py``, ``tests/test_auth.py``,
``tests/test_index.py`` and ``tests/test_alter.py``, over both cluster
seams: the port's ``LocalCluster`` and its ``MiniCluster`` through
``ClientCluster``, every tablet on the ``gpu`` engine over CPU tensors.
"""

import tempfile
import time

import pytest

from test_torch_data import CqlWireClient as WireClient
from test_torch_data import cpu_local_cluster as LocalCluster
from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.auth import hash_password
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.status import InvalidArgument, NotFound
from yugabyte_db_tpu_torch.yql.cql import wire_protocol as W
from yugabyte_db_tpu_torch.yql.cql.client_cluster import ClientCluster
from yugabyte_db_tpu_torch.yql.cql.processor import QLProcessor, Unauthorized
from yugabyte_db_tpu_torch.yql.cql.server import CQLServer


# -- tests/test_vtables.py, mirrored ---------------------------------------

@pytest.fixture
def wire(tmp_path):
    cluster = LocalCluster(num_tablets=2)
    server = CQLServer(cluster)
    host, port = server.listen("127.0.0.1", 0)
    cli = WireClient(host, port)
    cli.startup()
    yield cli
    cli.close()
    server.shutdown()


def _text_cell(b):
    return None if b is None else b.decode()


def test_driver_handshake_sequence(wire):
    cli = wire
    # Schema the driver will discover.
    cli.query("CREATE TABLE users (id INT, r BIGINT, name TEXT, "
              "score DOUBLE, PRIMARY KEY ((id), r))")

    # 1. system.local — one row, the handshake's first read.
    cols, rows, _p = cli.query("SELECT * FROM system.local")
    names = [c[0] for c in cols]
    assert len(rows) == 1
    local = dict(zip(names, rows[0]))
    assert _text_cell(local["key"]) == "local"
    assert _text_cell(local["cql_version"]) == "3.4.4"
    assert _text_cell(local["partitioner"]).endswith("Murmur3Partitioner")
    for required in ("cluster_name", "data_center", "rack", "host_id",
                     "release_version", "rpc_address", "tokens",
                     "native_protocol_version", "schema_version"):
        assert required in names, required

    # 2. system.peers — valid result (empty for a single node) with the
    #    column set the driver reads.
    cols, rows, _p = cli.query("SELECT * FROM system.peers")
    names = [c[0] for c in cols]
    for required in ("peer", "rpc_address", "data_center", "rack",
                     "host_id", "tokens"):
        assert required in names, required

    # 3. schema metadata.
    cols, rows, _p = cli.query("SELECT keyspace_name FROM "
                               "system_schema.keyspaces")
    keyspaces = {_text_cell(r[0]) for r in rows}
    assert {"default", "system", "system_schema"} <= keyspaces

    cols, rows, _p = cli.query(
        "SELECT keyspace_name, table_name FROM system_schema.tables "
        "WHERE keyspace_name = 'default'")
    tables = {(_text_cell(r[0]), _text_cell(r[1])) for r in rows}
    assert ("default", "users") in tables

    cols, rows, _p = cli.query(
        "SELECT column_name, kind, position, type FROM "
        "system_schema.columns WHERE keyspace_name = 'default' AND "
        "table_name = 'users'")
    got = {_text_cell(r[0]): (_text_cell(r[1]), _text_cell(r[3]))
           for r in rows}
    assert got["id"] == ("partition_key", "int")
    assert got["r"] == ("clustering", "bigint")
    assert got["name"] == ("regular", "text")
    assert got["score"] == ("regular", "double")


def test_vtable_count_and_limit(wire):
    cli = wire
    cols, rows, _p = cli.query("SELECT count(*) FROM system.peers")
    assert [c[0] for c in cols] == ["count"]
    cli.query("CREATE TABLE t1 (k INT, PRIMARY KEY (k))")
    cli.query("CREATE TABLE t2 (k INT, PRIMARY KEY (k))")
    _c, rows, _p = cli.query(
        "SELECT table_name FROM system_schema.tables LIMIT 1")
    assert len(rows) == 1


def test_peers_reflect_distributed_tservers(tmp_path):
    mc = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    try:
        mc.wait_tservers_registered()
        p = QLProcessor(ClientCluster(mc.client()))
        res = p.execute("SELECT peer, rpc_address FROM system.peers")
        # 3 tservers -> this node + 2 peers.
        assert len(res.rows) == 2
    finally:
        mc.shutdown()


def test_vtables_readable_without_table_permission():
    """Handshake must work for ANY authenticated role (no grants)."""
    FLAGS.set("use_cassandra_authentication", True)
    try:
        cluster = LocalCluster(num_tablets=2)
        cluster.auth_op({"op": "auth_create_role", "name": "app",
                         "can_login": True,
                         "salted_hash": hash_password("x")})
        p = QLProcessor(cluster, login_role="app")
        assert p.execute("SELECT key FROM system.local").rows
        with pytest.raises(Unauthorized):
            p.execute("CREATE TABLE t (k INT, PRIMARY KEY (k))")
    finally:
        FLAGS.set("use_cassandra_authentication", False)


# -- tests/test_cql_udt.py, mirrored ---------------------------------------

@pytest.fixture
def local_ql():
    cluster = LocalCluster(num_tablets=2)
    ql = QLProcessor(cluster)
    yield ql
    cluster.close()


@pytest.fixture
def dist_ql(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    c.wait_tservers_registered()
    ql = QLProcessor(ClientCluster(c.client()))
    yield ql
    c.shutdown()


@pytest.mark.parametrize("fixture", ["local_ql", "dist_ql"])
def test_udt_round_trip(fixture, request):
    ql = request.getfixturevalue(fixture)
    ql.execute("CREATE TYPE address (street TEXT, city TEXT, zip INT)")
    ql.execute("CREATE TABLE people (id INT PRIMARY KEY, name TEXT, "
               "home FROZEN<address>)")
    ql.execute("INSERT INTO people (id, name, home) VALUES (1, 'ann', "
               "{'street': '1 Main', 'city': 'Springfield', 'zip': 11111})")
    ql.execute("INSERT INTO people (id, name, home) VALUES (2, 'bob', "
               "{'city': 'Shelbyville'})")  # missing fields -> NULL
    rows = ql.execute("SELECT id, home FROM people").dicts()
    by_id = {r["id"]: r["home"] for r in rows}
    assert by_id[1] == {"street": "1 Main", "city": "Springfield",
                       "zip": 11111}
    assert by_id[2] == {"street": None, "city": "Shelbyville", "zip": None}
    # UPDATE replaces the frozen value wholesale.
    ql.execute("UPDATE people SET home = {'city': 'Ogdenville'} "
               "WHERE id = 1")
    rows = ql.execute("SELECT home FROM people WHERE id = 1").rows
    assert rows[0][0]["city"] == "Ogdenville"


@pytest.mark.parametrize("fixture", ["local_ql", "dist_ql"])
def test_udt_validation_and_drop_guard(fixture, request):
    ql = request.getfixturevalue(fixture)
    ql.execute("CREATE TYPE pt (x INT, y INT)")
    with pytest.raises(Exception):
        ql.execute("CREATE TYPE pt (x INT)")  # duplicate
    ql.execute("CREATE TYPE IF NOT EXISTS pt (x INT)")  # tolerated
    with pytest.raises(InvalidArgument):
        ql.execute("CREATE TABLE t0 (id INT PRIMARY KEY, p nosuchtype)")
    ql.execute("CREATE TABLE t1 (id INT PRIMARY KEY, p FROZEN<pt>)")
    with pytest.raises(InvalidArgument):
        ql.execute("INSERT INTO t1 (id, p) VALUES (1, {'x': 1, 'z': 9})")
    with pytest.raises(Exception):
        ql.execute("DROP TYPE pt")  # in use by t1
    ql.execute("DROP TABLE t1")
    ql.execute("DROP TYPE pt")
    with pytest.raises(NotFound):
        ql.execute("DROP TYPE pt")
    ql.execute("DROP TYPE IF EXISTS pt")


# -- tests/test_collections.py (its CQL cases), mirrored -------------------

@pytest.fixture()
def coll_ql():
    cluster = LocalCluster(num_tablets=2)
    yield QLProcessor(cluster)
    cluster.close()


def test_list_operations(coll_ql):
    ql = coll_ql
    ql.execute("CREATE TABLE t (k TEXT, l LIST<INT>, PRIMARY KEY ((k)))")
    ql.execute("INSERT INTO t (k, l) VALUES ('a', [1, 2, 3])")
    assert ql.execute("SELECT l FROM t").rows == [([1, 2, 3],)]
    ql.execute("UPDATE t SET l = l + [4, 5] WHERE k = 'a'")
    assert ql.execute("SELECT l FROM t").rows == [([1, 2, 3, 4, 5],)]
    ql.execute("UPDATE t SET l = [0] + l WHERE k = 'a'")
    assert ql.execute("SELECT l FROM t").rows == [([0, 1, 2, 3, 4, 5],)]
    ql.execute("UPDATE t SET l = l - [2, 4] WHERE k = 'a'")
    assert ql.execute("SELECT l FROM t").rows == [([0, 1, 3, 5],)]
    ql.execute("UPDATE t SET l[1] = 99 WHERE k = 'a'")
    assert ql.execute("SELECT l FROM t").rows == [([0, 99, 3, 5],)]
    with pytest.raises(InvalidArgument):
        ql.execute("UPDATE t SET l[50] = 1 WHERE k = 'a'")


def test_set_operations(coll_ql):
    ql = coll_ql
    ql.execute("CREATE TABLE t (k TEXT, s SET<TEXT>, PRIMARY KEY ((k)))")
    ql.execute("INSERT INTO t (k, s) VALUES ('a', {'x', 'y', 'x'})")
    assert ql.execute("SELECT s FROM t").rows == [(["x", "y"],)]
    ql.execute("UPDATE t SET s = s + {'a', 'y'} WHERE k = 'a'")
    assert ql.execute("SELECT s FROM t").rows == [(["a", "x", "y"],)]
    ql.execute("UPDATE t SET s = s - {'x'} WHERE k = 'a'")
    assert ql.execute("SELECT s FROM t").rows == [(["a", "y"],)]


def test_map_operations(coll_ql):
    ql = coll_ql
    ql.execute("CREATE TABLE t (k TEXT, m MAP<TEXT, INT>, "
               "PRIMARY KEY ((k)))")
    ql.execute("INSERT INTO t (k, m) VALUES ('a', {'b': 2, 'a': 1})")
    assert ql.execute("SELECT m FROM t").rows == [({"a": 1, "b": 2},)]
    ql.execute("UPDATE t SET m['c'] = 3 WHERE k = 'a'")
    ql.execute("UPDATE t SET m = m + {'d': 4, 'a': 10} WHERE k = 'a'")
    assert ql.execute("SELECT m FROM t").rows == [
        ({"a": 10, "b": 2, "c": 3, "d": 4},)]
    ql.execute("UPDATE t SET m = m - {'b', 'd'} WHERE k = 'a'")
    assert ql.execute("SELECT m FROM t").rows == [({"a": 10, "c": 3},)]
    # element set on a NULL map creates it
    ql.execute("INSERT INTO t (k) VALUES ('fresh')")
    ql.execute("UPDATE t SET m['first'] = 1 WHERE k = 'fresh'")
    res = ql.execute("SELECT m FROM t WHERE k = 'fresh'")
    assert res.rows == [({"first": 1},)]


def test_collections_survive_flush_both_engines():
    for engine in ("gpu",):
        cluster = LocalCluster(num_tablets=1, engine=engine,
                               engine_options={"rows_per_block": 8})
        try:
            ql = QLProcessor(cluster)
            ql.execute("CREATE TABLE t (k TEXT, l LIST<INT>, "
                       "m MAP<TEXT, INT>, PRIMARY KEY ((k)))")
            for i in range(20):
                ql.execute(f"INSERT INTO t (k, l, m) VALUES "
                           f"('r{i:02d}', [{i}, {i + 1}], "
                           f"{{'v': {i}}})")
            for t in cluster.table("default.t").tablets:
                t.flush()
            res = ql.execute("SELECT k, l, m FROM t WHERE k = 'r07'")
            assert res.rows == [("r07", [7, 8], {"v": 7})]
            res = ql.execute("SELECT count(*) FROM t")
            assert res.rows[0][0] == 20
        finally:
            cluster.close()


def test_jsonb_cql_storage(coll_ql):
    ql = coll_ql
    ql.execute("CREATE TABLE j (k TEXT, doc JSONB, PRIMARY KEY ((k)))")
    ql.execute('INSERT INTO j (k, doc) VALUES '
               '(\'a\', \'{"z": 1, "a": [true, null]}\')')
    res = ql.execute("SELECT doc FROM j")
    assert res.rows == [({"a": [True, None], "z": 1},)]


def test_counter_increments(coll_ql):
    ql = coll_ql
    ql.execute("CREATE TABLE c (k TEXT, hits COUNTER, "
               "PRIMARY KEY ((k)))")
    ql.execute("UPDATE c SET hits = hits + 1 WHERE k = 'page'")
    ql.execute("UPDATE c SET hits = hits + 5 WHERE k = 'page'")
    ql.execute("UPDATE c SET hits = hits - 2 WHERE k = 'page'")
    res = ql.execute("SELECT hits FROM c WHERE k = 'page'")
    assert res.rows == [(4,)]


def test_counter_concurrent_increments_distributed():
    """Counter deltas resolve atomically at the tablet leader: N
    concurrent incrementing sessions must never lose an increment."""
    import threading

    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            setup = QLProcessor(ClientCluster(mc.client("cql-setup")))
            setup.execute("CREATE TABLE hits (k TEXT, n COUNTER, "
                          "PRIMARY KEY ((k)))")
            errs = []

            def worker(w):
                try:
                    ql = QLProcessor(ClientCluster(mc.client(f"c{w}")))
                    for _ in range(25):
                        ql.execute("UPDATE hits SET n = n + 1 "
                                   "WHERE k = 'page'")
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(w,))
                  for w in range(4)]
            [t.start() for t in ts]
            [t.join() for t in ts]
            assert not errs, errs[:1]
            res = setup.execute("SELECT n FROM hits WHERE k = 'page'")
            assert res.rows == [(100,)]
            # fused-sign subtraction parses too: 'n = n -10'
            setup.execute("UPDATE hits SET n = n -10 WHERE k = 'page'")
            res = setup.execute("SELECT n FROM hits WHERE k = 'page'")
            assert res.rows == [(90,)]
        finally:
            mc.shutdown()


# -- tests/test_auth.py (its CQL cases), mirrored --------------------------

@pytest.fixture
def auth_on():
    FLAGS.set("use_cassandra_authentication", True)
    yield
    FLAGS.set("use_cassandra_authentication", False)


def test_cql_role_ddl_and_lists():
    p = QLProcessor(LocalCluster(num_tablets=2))
    p.execute("CREATE ROLE admin WITH PASSWORD = 'pw' AND LOGIN = true "
              "AND SUPERUSER = true")
    p.execute("CREATE ROLE reader WITH PASSWORD = 'r' AND LOGIN = true")
    p.execute("GRANT SELECT ON ALL KEYSPACES TO reader")
    roles = p.execute("LIST ROLES")
    assert [r[0] for r in roles.rows] == ["admin", "reader"]
    perms = p.execute("LIST ALL PERMISSIONS")
    assert ("reader", "data", "SELECT") in perms.rows
    p.execute("REVOKE SELECT ON ALL KEYSPACES FROM reader")
    assert not p.execute("LIST ALL PERMISSIONS").rows
    p.execute("ALTER ROLE reader WITH SUPERUSER = true")
    roles = p.execute("LIST ROLES").dicts()
    assert roles[1]["is_superuser"] is True
    p.execute("DROP ROLE reader")
    assert len(p.execute("LIST ROLES").rows) == 1
    # idempotent forms
    p.execute("CREATE ROLE IF NOT EXISTS admin")
    p.execute("DROP ROLE IF EXISTS ghost")


def test_cql_enforcement_fails_closed(auth_on):
    cluster = LocalCluster(num_tablets=2)
    root = QLProcessor(cluster, login_role="root")
    # Bootstrap superuser applied directly to the store (the reference
    # seeds the cassandra superuser at initdb time).
    cluster.auth_op({"op": "auth_create_role", "name": "root",
                     "superuser": True, "can_login": True,
                     "salted_hash": hash_password("rootpw")})
    root.execute("CREATE TABLE t (k INT PRIMARY KEY, v TEXT)")
    root.execute("INSERT INTO t (k, v) VALUES (1, 'a')")
    root.execute("CREATE ROLE reader WITH PASSWORD = 'r' AND LOGIN = true")

    unauth = QLProcessor(cluster)       # no login at all
    with pytest.raises(Unauthorized):
        unauth.execute("SELECT * FROM t")

    reader = QLProcessor(cluster, login_role="reader")
    for stmt in ("SELECT * FROM t",
                 "INSERT INTO t (k, v) VALUES (2, 'b')",
                 "CREATE TABLE t2 (k INT PRIMARY KEY)",
                 "DROP TABLE t",
                 "ALTER TABLE t ADD x INT",
                 "CREATE ROLE sneaky",
                 "GRANT SELECT ON ALL KEYSPACES TO reader"):
        with pytest.raises(Unauthorized):
            reader.execute(stmt)

    root.execute("GRANT SELECT ON TABLE t TO reader")
    assert reader.execute("SELECT * FROM t").rows == [(1, "a")]
    with pytest.raises(Unauthorized):   # SELECT != MODIFY
        reader.execute("INSERT INTO t (k, v) VALUES (3, 'c')")
    root.execute("GRANT MODIFY ON KEYSPACE default TO reader")
    reader.execute("INSERT INTO t (k, v) VALUES (3, 'c')")
    root.execute("REVOKE SELECT ON TABLE t FROM reader")
    with pytest.raises(Unauthorized):
        reader.execute("SELECT * FROM t")


def test_cql_wire_auth_handshake(tmp_path, auth_on):

    cluster = LocalCluster(num_tablets=2)
    cluster.auth_op({"op": "auth_create_role", "name": "cassandra",
                     "superuser": True, "can_login": True,
                     "salted_hash": hash_password("cassandra")})
    server = CQLServer(cluster)
    host, port = server.listen("127.0.0.1", 0)
    try:
        cli = WireClient(host, port)
        w = W.Writer()
        w.short(1)
        w.string("CQL_VERSION").string("3.4.4")
        cli._send(W.OP_STARTUP, w.getvalue())
        _s, opcode, body = cli._recv_frame()
        assert opcode == W.OP_AUTHENTICATE
        assert b"PasswordAuthenticator" in body
        # wrong password -> credentials error
        bad = W.Writer().bytes_(b"\x00cassandra\x00wrong").getvalue()
        cli._send(W.OP_AUTH_RESPONSE, bad)
        _s, opcode, body = cli._recv_frame()
        assert opcode == W.OP_ERROR
        # right password -> AUTH_SUCCESS, then statements flow
        good = W.Writer().bytes_(b"\x00cassandra\x00cassandra").getvalue()
        cli._send(W.OP_AUTH_RESPONSE, good)
        _s, opcode, _b = cli._recv_frame()
        assert opcode == W.OP_AUTH_SUCCESS
        kind, _, _ = cli.query(
            "CREATE TABLE ta (k INT, PRIMARY KEY (k))")
        assert kind == W.RESULT_SCHEMA_CHANGE
        cli.close()
        # a fresh connection that skips auth is rejected on QUERY
        cli2 = WireClient(host, port)
        cli2._send(W.OP_STARTUP, w.getvalue())
        _s, opcode, _b = cli2._recv_frame()
        assert opcode == W.OP_AUTHENTICATE
        with pytest.raises(Exception):
            cli2.query("SELECT * FROM ta")
        cli2.close()
    finally:
        server.shutdown()


def test_roles_replicate_through_master(tmp_path):

    mc = MiniCluster(str(tmp_path), num_masters=3, num_tservers=3).start()
    try:
        mc.wait_tservers_registered()
        cc = ClientCluster(mc.client())
        p = QLProcessor(cc)
        p.execute("CREATE ROLE dadmin WITH PASSWORD = 'd' AND "
                  "LOGIN = true AND SUPERUSER = true")
        p.execute("GRANT SELECT ON ALL KEYSPACES TO dadmin")
        with pytest.raises(Exception):
            p.execute("CREATE ROLE dadmin")  # duplicate rejected
        # a second client session observes the replicated store
        cc2 = ClientCluster(mc.client("c2"))
        st = cc2.auth_store()
        assert st.check_login("dadmin", "d")
        assert st.authorize("dadmin", "SELECT", "data/ks/t")
        assert ("dadmin", "data", "SELECT") in st.list_perms()
    finally:
        mc.shutdown()


# -- tests/test_index.py, mirrored -----------------------------------------

def wait_for(pred, timeout=15.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = pred()
        if r:
            return r
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def _setup(ql, n=30):
    ql.execute("CREATE TABLE emp (id INT, dept TEXT, salary BIGINT, "
               "PRIMARY KEY (id))")
    for i in range(n):
        ql.execute(f"INSERT INTO emp (id, dept, salary) "
                   f"VALUES ({i}, 'dept{i % 5}', {i * 100})")


@pytest.mark.parametrize("fixture", ["local_ql", "dist_ql"])
def test_index_lookup_after_create(fixture, request):
    ql = request.getfixturevalue(fixture)
    _setup(ql)
    # Backfill: index created AFTER the rows exist.
    ql.execute("CREATE INDEX emp_dept ON emp (dept)")

    def rows_via_index():
        res = ql.execute("SELECT id, dept FROM emp WHERE dept = 'dept2'")
        return sorted(r[0] for r in res.rows)
    wait_for(lambda: rows_via_index() == [2, 7, 12, 17, 22, 27],
             msg="index backfill visible")
    # New writes maintained.
    ql.execute("INSERT INTO emp (id, dept, salary) "
               "VALUES (100, 'dept2', 1)")
    wait_for(lambda: 100 in rows_via_index(), msg="index maintenance")
    # Updates move entries between index keys.
    ql.execute("UPDATE emp SET dept = 'dept9' WHERE id = 2")
    wait_for(lambda: 2 not in rows_via_index(), msg="old entry removed")
    res = ql.execute("SELECT id FROM emp WHERE dept = 'dept9'")
    assert [r[0] for r in res.rows] == [2]
    # Deletes drop entries.
    ql.execute("DELETE FROM emp WHERE id = 7")
    wait_for(lambda: 7 not in rows_via_index(), msg="delete maintenance")


@pytest.mark.parametrize("fixture", ["local_ql", "dist_ql"])
def test_index_respects_other_predicates_and_limit(fixture, request):
    ql = request.getfixturevalue(fixture)
    _setup(ql)
    ql.execute("CREATE INDEX emp_dept2 ON emp (dept)")

    def q():
        return ql.execute("SELECT id FROM emp WHERE dept = 'dept1' "
                          "AND salary >= 1000")
    wait_for(lambda: sorted(r[0] for r in q().rows) == [11, 16, 21, 26],
             msg="index + extra predicate")
    res = ql.execute("SELECT id FROM emp WHERE dept = 'dept1' LIMIT 2")
    assert len(res.rows) == 2


def test_drop_index(local_ql):
    ql = local_ql
    _setup(ql, n=10)
    ql.execute("CREATE INDEX di ON emp (dept)")
    assert ql.execute("SELECT id FROM emp WHERE dept = 'dept3'").rows
    ql.execute("DROP INDEX di")
    # Still answerable (full scan path), index table gone.
    res = ql.execute("SELECT id FROM emp WHERE dept = 'dept3'")
    assert sorted(r[0] for r in res.rows) == [3, 8]
    assert not any("__idx__" in t or t == "default.di"
                   for t in ql.cluster.tables)


def test_null_indexed_values_skipped(local_ql):
    ql = local_ql
    ql.execute("CREATE TABLE n (k INT, v TEXT, PRIMARY KEY (k))")
    ql.execute("CREATE INDEX nv ON n (v)")
    ql.execute("INSERT INTO n (k, v) VALUES (1, 'x')")
    ql.execute("INSERT INTO n (k) VALUES (2)")  # v NULL: no entry
    res = ql.execute("SELECT k FROM n WHERE v = 'x'")
    assert [r[0] for r in res.rows] == [1]
    ih = ql.cluster.table("default.n_v_idx"
                          if "default.n_v_idx" in ql.cluster.tables
                          else "default.nv")
    total = sum(len(t.scan(
        __import__("yugabyte_db_tpu_torch.storage.scan_spec",
                   fromlist=["ScanSpec"]).ScanSpec()).rows)
        for t in ih.tablets)
    assert total == 1


def test_index_set_reconciled_after_lost_push(tmp_path):
    """A replica that missed ts.set_indexes (or restarted with stale
    metadata) gets the catalog's index set re-pushed via heartbeat
    reconciliation."""
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    try:
        c.wait_tservers_registered()
        ql = QLProcessor(ClientCluster(c.client()))
        ql.execute("CREATE TABLE rec (k INT, v TEXT, PRIMARY KEY (k))")
        ql.execute("CREATE INDEX rec_v ON rec (v)")
        # Simulate a lost push: wipe the index set everywhere.
        for ts in c.tservers.values():
            for peer in ts.tablet_manager.peers():
                if peer.tablet.meta.table_name == "default.rec":
                    peer.tablet.meta.indexes = []

        def restored():
            return all(
                peer.tablet.meta.indexes
                for ts in c.tservers.values()
                for peer in ts.tablet_manager.peers()
                if peer.tablet.meta.table_name == "default.rec")
        wait_for(restored, msg="heartbeat index reconciliation")
        ql.execute("INSERT INTO rec (k, v) VALUES (1, 'hello')")
        wait_for(lambda: [r[0] for r in ql.execute(
            "SELECT k FROM rec WHERE v = 'hello'").rows] == [1],
            msg="maintenance after reconciliation")
    finally:
        c.shutdown()


def _setup_multi(ql, n=40):
    ql.execute("CREATE TABLE mc (id INT, dept TEXT, grade INT, "
               "salary BIGINT, name TEXT, PRIMARY KEY (id))")
    for i in range(n):
        ql.execute(
            f"INSERT INTO mc (id, dept, grade, salary, name) VALUES "
            f"({i}, 'd{i % 3}', {i % 4}, {i * 100}, 'emp{i}')")


@pytest.mark.parametrize("fixture", ["local_ql", "dist_ql"])
def test_multi_column_index_lookup(fixture, request):
    ql = request.getfixturevalue(fixture)
    _setup_multi(ql)
    ql.execute("CREATE INDEX mc_dg ON mc (dept, grade)")

    def rows():
        return ql.execute(
            "SELECT id, salary FROM mc WHERE dept = 'd1' AND grade = 2"
        ).rows

    expect = sorted((i, i * 100) for i in range(40)
                    if i % 3 == 1 and i % 4 == 2)
    wait_for(lambda: sorted(rows()) == expect, msg="multi-col lookup")
    # Updates move entries between compound keys.
    ql.execute("UPDATE mc SET grade = 2 WHERE id = 1")  # d1, was grade 1
    wait_for(lambda: (1, 100) in rows(), msg="index follows update")
    ql.execute("DELETE FROM mc WHERE id = 13")  # was d1/grade 1? 13%3=1,13%4=1
    ql.execute("UPDATE mc SET dept = 'd9' WHERE id = 6")
    wait_for(lambda: all(r[0] != 6 for r in rows()),
             msg="index drops moved row")


@pytest.mark.parametrize("fixture", ["local_ql", "dist_ql"])
def test_covered_index_serves_without_base_reads(fixture, request):
    ql = request.getfixturevalue(fixture)
    _setup_multi(ql)
    ql.execute("CREATE INDEX mc_dept ON mc (dept) INCLUDE (salary)")

    def q():
        return ql.execute(
            "SELECT id, salary FROM mc WHERE dept = 'd0'").rows

    expect = sorted((i, i * 100) for i in range(40) if i % 3 == 0)
    wait_for(lambda: sorted(q()) == expect, msg="covered lookup")
    # The covered read must not touch the base table: poke a hole by
    # scanning with base tablets instrumented (local cluster only).
    if fixture == "local_ql":
        handle = ql.cluster.table(ql._qualify("mc"))
        calls = []
        for t in handle.tablets:
            orig = t.scan
            t.scan = (lambda spec, _o=orig: (calls.append(1), _o(spec))[1])
        rows = q()
        assert sorted(rows) == expect
        assert not calls, "covered query read the base table"
    # Covered values follow updates.
    ql.execute("UPDATE mc SET salary = 999999 WHERE id = 0")
    wait_for(lambda: (0, 999999) in q(), msg="covered value updated")


# -- tests/test_alter.py (its CQL cases), mirrored -------------------------

def test_cql_alter_and_batch():
    cluster = LocalCluster(num_tablets=2)
    try:
        ql = QLProcessor(cluster)
        ql.execute("CREATE TABLE t (k TEXT, v INT, PRIMARY KEY ((k)))")
        ql.execute("INSERT INTO t (k, v) VALUES ('x', 1)")
        ql.execute("ALTER TABLE t ADD w BIGINT")
        res = ql.execute("SELECT k, v, w FROM t")
        assert res.rows == [("x", 1, None)]
        ql.execute("INSERT INTO t (k, v, w) VALUES ('y', 2, 99)")
        res = ql.execute("SELECT k, w FROM t WHERE w = 99")
        assert res.rows == [("y", 99)]
        ql.execute("ALTER TABLE t RENAME v TO vv")
        res = ql.execute("SELECT vv FROM t WHERE k = 'x'")
        assert res.rows == [(1,)]
        ql.execute("ALTER TABLE t DROP vv")
        with pytest.raises(InvalidArgument):
            ql.execute("SELECT vv FROM t")
        # BATCH: multiple DML in one statement
        ql.execute("BEGIN BATCH "
                   "INSERT INTO t (k, w) VALUES ('b1', 1); "
                   "INSERT INTO t (k, w) VALUES ('b2', 2); "
                   "UPDATE t SET w = 100 WHERE k = 'b1'; "
                   "DELETE FROM t WHERE k = 'y'; "
                   "APPLY BATCH")
        res = ql.execute("SELECT k, w FROM t")
        got = dict(res.rows)
        assert got["b1"] == 100 and got["b2"] == 2 and "y" not in got
        with pytest.raises(InvalidArgument):
            ql.execute("BEGIN BATCH SELECT k FROM t; APPLY BATCH")
    finally:
        cluster.close()


def test_alter_through_master_and_restart():
    from yugabyte_db_tpu_torch.client.session import YBSession
    from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec
    from yugabyte_db_tpu_torch.yql.cql.processor import QLProcessor as QP

    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            ql = QP(ClientCluster(client))
            ql.execute("CREATE TABLE kv (k TEXT, v BIGINT, "
                       "PRIMARY KEY ((k)))")
            s = YBSession(client)
            table = client.open_table("default.kv")
            for i in range(20):
                s.insert(table, {"k": f"r{i:02d}", "v": i})
            s.flush()
            ql.execute("ALTER TABLE kv ADD extra TEXT")

            # every replica adopts the replicated change (followers apply
            # asynchronously behind the leader's commit)
            def versions():
                return [peer.tablet.meta.schema.version
                        for ts in mc.tservers.values()
                        for peer in ts.tablet_manager.peers()
                        if peer.tablet.meta.table_name == "default.kv"]

            import time as _time
            deadline = _time.monotonic() + 10.0
            while _time.monotonic() < deadline and \
                    not all(v == 1 for v in versions()):
                _time.sleep(0.05)
            assert all(v == 1 for v in versions()), versions()
            ql.execute("INSERT INTO kv (k, v, extra) "
                       "VALUES ('zz', 99, 'new')")
            res = ql.execute("SELECT k, extra FROM kv WHERE k = 'zz'")
            assert res.rows == [("zz", "new")]
            res = ql.execute("SELECT k, extra FROM kv WHERE k = 'r05'")
            assert res.rows == [("r05", None)]
            # the new schema survives a tserver restart (meta + WAL replay)
            victim = next(iter(mc.tservers))
            mc.stop_tserver(victim)
            mc.restart_tserver(victim)
            ts = mc.tservers[victim]
            for peer in ts.tablet_manager.peers():
                if peer.tablet.meta.table_name == "default.kv":
                    assert peer.tablet.meta.schema.version == 1
        finally:
            mc.shutdown()
