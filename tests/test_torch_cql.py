"""The port's YCQL frontend (``yugabyte_db_tpu_torch.yql.cql``: parser,
``QLProcessor``, ``LocalCluster``) under the assertions of the JAX
package's ``tests/test_cql.py``, with its tablets on the ``gpu`` engine
over CPU tensors, and a differential: one seeded statement script through
the JAX ``QLProcessor`` (engines ``cpu`` and ``tpu``) and the port's,
whose ``ResultSet``s must be equal.
"""

import math
import random

import numpy as np
import pytest

from test_torch_data import cpu_local_cluster
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent,
                                                InvalidArgument, NotFound,
                                                StatusError)
from yugabyte_db_tpu_torch.yql.cql import QLProcessor, parse_statement
from yugabyte_db_tpu_torch.yql.cql.processor import LocalCluster


@pytest.fixture
def ql(tmp_path):
    cluster = cpu_local_cluster(str(tmp_path), num_tablets=3,
                                engine_options={"rows_per_block": 16})
    proc = QLProcessor(cluster)
    yield proc
    cluster.close()


def seed_kv(ql, n=30):
    ql.execute("CREATE TABLE kv (k text, r int, v int, s text, "
               "PRIMARY KEY ((k), r))")
    for i in range(n):
        ql.execute(f"INSERT INTO kv (k, r, v, s) VALUES "
                   f"('key{i % 5}', {i}, {i * 10}, 'val{i}')")


# -- parsing ----------------------------------------------------------------

def test_parse_create_table():
    s = parse_statement(
        "CREATE TABLE IF NOT EXISTS ks.t (a text, b bigint, c double, "
        "PRIMARY KEY ((a), b)) WITH tablets = 7")
    assert s.name == "ks.t" and s.if_not_exists
    assert s.hash_keys == ["a"] and s.range_keys == ["b"]
    assert s.properties == {"tablets": 7}


def test_parse_literals():
    s = parse_statement(
        "INSERT INTO t (a, b, c, d, e, f) VALUES "
        "('it''s', -3, 2.5, true, null, 0x0aFF)")
    assert s.values == ["it's", -3, 2.5, True, None, bytes([0x0A, 0xFF])]


def test_parse_select_shapes():
    s = parse_statement("SELECT count(*), sum(v) AS total FROM t "
                        "WHERE k = 'a' AND r >= 3 LIMIT 10 ALLOW FILTERING")
    assert s.items[0].agg_fn == "count" and s.items[1].alias == "total"
    assert [r.op for r in s.where] == ["=", ">="]
    assert s.limit == 10 and s.allow_filtering


def test_parse_errors():
    for bad in ["SELEC * FROM t", "INSERT INTO t (a) VALUES (1, 2)",
                "CREATE TABLE t (a int)", "SELECT * FROM t WHERE a ~ 3"]:
        with pytest.raises(StatusError):
            parse_statement(bad)


# -- DDL --------------------------------------------------------------------

def test_create_use_drop(ql):
    ql.execute("CREATE KEYSPACE app")
    ql.execute("USE app")
    ql.execute("CREATE TABLE t (a int PRIMARY KEY, b text)")
    assert "app.t" in ql.cluster.tables
    with pytest.raises(AlreadyPresent):
        ql.execute("CREATE TABLE t (a int PRIMARY KEY)")
    ql.execute("CREATE TABLE IF NOT EXISTS t (a int PRIMARY KEY)")
    ql.execute("DROP TABLE t")
    with pytest.raises(NotFound):
        ql.execute("SELECT * FROM t")
    ql.execute("DROP TABLE IF EXISTS t")


def test_float_key_rejected(ql):
    with pytest.raises(InvalidArgument):
        ql.execute("CREATE TABLE t (a double PRIMARY KEY, b int)")


# -- DML + SELECT -----------------------------------------------------------

def test_insert_select_point(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT v, s FROM kv WHERE k = 'key1' AND r = 6")
    assert rs.columns == ["v", "s"] and rs.rows == [(60, "val6")]


def test_partition_scan_ordered_by_range(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT r FROM kv WHERE k = 'key2'")
    assert [r[0] for r in rs.rows] == [2, 7, 12, 17, 22, 27]


def test_range_bounds(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT r FROM kv WHERE k = 'key2' AND r > 7 AND r <= 22")
    assert [r[0] for r in rs.rows] == [12, 17, 22]


def test_full_scan_with_filter(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT v FROM kv WHERE v >= 250 ALLOW FILTERING")
    assert sorted(r[0] for r in rs.rows) == [250, 260, 270, 280, 290]


def test_limit(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT * FROM kv LIMIT 7")
    assert len(rs.rows) == 7


def test_update_upsert_and_overwrite(ql):
    seed_kv(ql, n=5)
    ql.execute("UPDATE kv SET v = 111, s = 'new' WHERE k = 'key1' AND r = 1")
    rs = ql.execute("SELECT v, s FROM kv WHERE k = 'key1' AND r = 1")
    assert rs.rows == [(111, "new")]
    # upsert semantics: UPDATE on a new key creates the column data
    ql.execute("UPDATE kv SET v = 5 WHERE k = 'fresh' AND r = 0")
    rs = ql.execute("SELECT v, s FROM kv WHERE k = 'fresh' AND r = 0")
    assert rs.rows == [(5, None)]


def test_delete_row_and_column(ql):
    seed_kv(ql, n=5)
    ql.execute("DELETE FROM kv WHERE k = 'key3' AND r = 3")
    assert ql.execute("SELECT * FROM kv WHERE k = 'key3' AND r = 3").rows == []
    ql.execute("DELETE s FROM kv WHERE k = 'key2' AND r = 2")
    rs = ql.execute("SELECT v, s FROM kv WHERE k = 'key2' AND r = 2")
    assert rs.rows == [(20, None)]


def test_dml_requires_full_key(ql):
    seed_kv(ql, n=5)
    with pytest.raises(InvalidArgument):
        ql.execute("UPDATE kv SET v = 1 WHERE k = 'key1'")
    with pytest.raises(InvalidArgument):
        ql.execute("DELETE FROM kv WHERE r = 3")


def test_aggregates_multi_tablet(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT count(*), sum(v), min(v), max(v), avg(v) FROM kv")
    n = 30
    vals = [i * 10 for i in range(n)]
    assert rs.rows == [(n, sum(vals), 0, 290, sum(vals) / n)]


def test_aggregate_with_predicate(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT count(*), sum(v) FROM kv WHERE v < 100 "
                    "ALLOW FILTERING")
    assert rs.rows == [(10, sum(i * 10 for i in range(10)))]


def test_aggregate_single_partition(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT count(*), max(r) FROM kv WHERE k = 'key0'")
    assert rs.rows == [(6, 25)]


def test_in_predicate(ql):
    seed_kv(ql)
    rs = ql.execute("SELECT r FROM kv WHERE k = 'key0' AND r IN (0, 5, 10) "
                    "ALLOW FILTERING")
    assert sorted(r[0] for r in rs.rows) == [0, 5, 10]


def test_ttl_expiry(ql):
    ql.execute("CREATE TABLE e (a int PRIMARY KEY, b int)")
    ql.execute("INSERT INTO e (a, b) VALUES (1, 10) USING TTL 3600")
    ql.execute("INSERT INTO e (a, b) VALUES (2, 20)")
    assert len(ql.execute("SELECT * FROM e").rows) == 2
    # Jump the shared clock past the TTL: row 1 disappears.
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    clk = ql.cluster.clock
    clk.update(HybridTime.from_micros(
        clk.now().physical_micros + 2 * 3600 * 1_000_000))
    rs = ql.execute("SELECT a FROM e")
    assert [r[0] for r in rs.rows] == [2]


def test_mixed_agg_plain_rejected(ql):
    seed_kv(ql, n=3)
    with pytest.raises(InvalidArgument):
        ql.execute("SELECT k, count(*) FROM kv")


def test_insert_if_not_exists(ql):
    ql.execute("CREATE TABLE u (a int PRIMARY KEY, b int)")
    ql.execute("INSERT INTO u (a, b) VALUES (1, 10)")
    rs = ql.execute("INSERT INTO u (a, b) VALUES (1, 99) IF NOT EXISTS")
    assert rs.columns == ["[applied]"] and rs.rows == [(False,)]
    assert ql.execute("SELECT b FROM u WHERE a = 1").rows == [(10,)]
    rs = ql.execute("INSERT INTO u (a, b) VALUES (2, 20) IF NOT EXISTS")
    assert rs.rows == [(True,)]
    assert ql.execute("SELECT b FROM u WHERE a = 2").rows == [(20,)]


def test_eq_on_trailing_range_column_filters(ql):
    ql.execute("CREATE TABLE m (h int, r1 int, r2 int, v int, "
               "PRIMARY KEY ((h), r1, r2))")
    for r1 in range(3):
        for r2 in range(3):
            ql.execute(f"INSERT INTO m (h, r1, r2, v) VALUES "
                       f"(1, {r1}, {r2}, {r1 * 10 + r2})")
    rs = ql.execute("SELECT v FROM m WHERE h = 1 AND r2 = 2 ALLOW FILTERING")
    assert sorted(r[0] for r in rs.rows) == [2, 12, 22]


def test_create_keyspace_with_replication(ql):
    ql.execute("CREATE KEYSPACE rf3 WITH replication = "
               "{'class': 'SimpleStrategy', 'replication_factor': 3}")
    ql.execute("USE rf3")
    ql.execute("CREATE TABLE t (a int PRIMARY KEY)")
    assert "rf3.t" in ql.cluster.tables


def test_delete_unknown_column_rejected(ql):
    ql.execute("CREATE TABLE d (a int PRIMARY KEY, b int)")
    with pytest.raises(InvalidArgument):
        ql.execute("DELETE nosuch FROM d WHERE a = 1")


# -- the engine departure -----------------------------------------------------

def test_local_cluster_defaults_to_gpu_and_refuses_cpu(tmp_path):
    cluster = cpu_local_cluster(str(tmp_path / "a"))
    try:
        assert cluster.engine == "gpu"
    finally:
        cluster.close()
    # The port registers no ``cpu`` engine: naming it fails as
    # ``make_engine`` fails, at construction, with no quiet fallback.
    with pytest.raises(ValueError, match="unknown storage engine 'cpu'"):
        LocalCluster(str(tmp_path / "b"), engine="cpu")


# -- the differential: one statement script, two packages ---------------------

NKEYS = 40
NROWS = 200
T0 = 1_700_000_000_000_000   # the standing clock's first microsecond
TTL_S = 100
# DOUBLE sums and averages: ``tests/test_engine_diff.py``'s tolerance.
APPROX_PREFIXES = ("sum(c)", "avg(c)")


def _lit(v):
    if v is None:
        return "null"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return repr(v)


def statement_script(seed: int = 11):
    """The script: ``(op, ...)`` steps, made from ``seed`` with
    ``random``/numpy, the same plain Python values for both sides.

    ``("q", sql)`` runs a statement and compares its ``ResultSet``;
    ``("pages", sql, n, wire)`` pages a SELECT to its end ``n`` rows at a
    time (``wire``: the CQL server's pre-serialized cells) and compares
    every page; ``("flush",)`` flushes every tablet; ``("clock", us)``
    moves the standing clock on."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    a = nrng.integers(-10**12, 10**12, NROWS)
    d = nrng.integers(-10**6, 10**6, NROWS)
    c = nrng.choice([0.5, -1.25, 3.0, 1e6, 2.75, np.nan], NROWS)
    steps = [("q", "CREATE KEYSPACE ks"), ("q", "USE ks"),
             ("q", "CREATE TABLE bench (k text, r bigint, a bigint, "
                   "c double, d int, g int, s text, "
                   "PRIMARY KEY ((k), r)) WITH tablets = 3")]
    for i in range(NROWS):
        cv = None if np.isnan(c[i]) else float(c[i])
        ttl = f" USING TTL {TTL_S}" if rng.random() < 0.1 else ""
        steps.append(("q", "INSERT INTO bench (k, r, a, c, d, g, s) "
                      f"VALUES ('u{i % NKEYS:03d}', {i}, {int(a[i])}, "
                      f"{_lit(cv)}, {int(d[i])}, {i % 5}, "
                      f"'s{rng.randrange(1000)}'){ttl}"))
    cut = int(np.median(d))
    aggs = ("SELECT count(*), sum(a), min(a), max(a), sum(d), sum(c), "
            "avg(a) FROM bench")
    reads = [
        ("q", aggs),
        ("q", aggs + f" WHERE d >= {cut} ALLOW FILTERING"),
        ("q", "SELECT count(*), sum(a), min(d), max(d) FROM bench "
              "WHERE k = 'u007'"),
        ("q", "SELECT g, count(*), sum(a), sum(d) FROM bench GROUP BY g"),
        ("q", "SELECT g, count(*), sum(a) FROM bench "
              f"WHERE a < 0 GROUP BY g ALLOW FILTERING"),
        ("q", "SELECT a, c, d, s FROM bench WHERE k = 'u011' AND r = 51"),
        ("q", "SELECT r, a FROM bench WHERE k = 'u003'"),
        ("q", "SELECT r, d FROM bench WHERE k = 'u003' AND r > 50 "
              "AND r <= 163"),
        ("q", "SELECT r FROM bench WHERE k = 'u005' AND r IN (5, 45, 85, "
              "999) ALLOW FILTERING"),
        ("q", "SELECT * FROM bench LIMIT 13"),
        ("q", f"SELECT k, r, a FROM bench WHERE d < {cut} "
              "ALLOW FILTERING"),
        ("pages", "SELECT k, r, a, c, d, s FROM bench", 17, False),
        ("pages", "SELECT k, r, a, c, d, s FROM bench", 23, True),
        ("pages", f"SELECT k, r, d FROM bench WHERE d >= {cut} "
                  "ALLOW FILTERING", 9, True),
    ]
    steps += reads
    steps.append(("flush",))
    steps += reads
    for i in rng.sample(range(NROWS), 60):
        d_new = rng.randrange(-10**6, 10**6)
        steps.append(("q", f"UPDATE bench SET d = {d_new}"
                      f", a = {rng.randrange(-10**12, 10**12)} "
                      f"WHERE k = 'u{i % NKEYS:03d}' AND r = {i}"))
    for i in rng.sample(range(NROWS), 20):
        steps.append(("q", f"DELETE FROM bench WHERE k = 'u{i % NKEYS:03d}' "
                      f"AND r = {i}"))
    for i in rng.sample(range(NROWS), 10):
        steps.append(("q", f"DELETE c FROM bench WHERE k = "
                      f"'u{i % NKEYS:03d}' AND r = {i}"))
    steps += reads                      # the updates over a run, unflushed
    steps.append(("flush",))
    steps += reads                      # multi-version runs
    steps.append(("clock", 2 * TTL_S * 1_000_000))
    steps += reads                      # past every TTL
    return steps


def _standing_clock(side_hybrid_time):
    now = [T0]
    return now, side_hybrid_time.HybridClock(now_micros=lambda: now[0])


def run_script(QL, LC, hybrid_time, root, steps, **cluster_kwargs):
    """Run ``steps`` through one package's processor; returns one record
    per compared step."""
    cluster = LC(root, num_tablets=3, **cluster_kwargs)
    now, cluster.clock = _standing_clock(hybrid_time)
    proc = QL(cluster)
    out = []
    try:
        for step in steps:
            op = step[0]
            if op == "q":
                rs = proc.execute(step[1])
                out.append((step[1], None if rs is None else _record(rs)))
            elif op == "pages":
                _sql, size, wire = step[1:]
                state, pages = None, []
                while True:
                    rs = proc.execute(_sql, page_size=size,
                                      paging_state=state,
                                      wire_results=wire)
                    pages.append(_record(rs))
                    state = rs.paging_state
                    if state is None:
                        break
                    assert len(pages) < 100, _sql
                out.append((f"{_sql} pages of {size} wire={wire}", pages))
            elif op == "flush":
                for handle in cluster.tables.values():
                    for t in handle.tablets:
                        t.flush()
            elif op == "clock":
                now[0] += step[1]
    finally:
        cluster.close()
    return out


def _record(rs):
    return (list(rs.columns), list(rs.rows), rs.paging_state,
            rs.wire_data, rs.wire_rows)


def assert_same_records(want, got):
    assert len(want) == len(got)
    for (label, w), (_l, g) in zip(want, got):
        if w is None or g is None:
            assert w is None and g is None, label
            continue
        pages_w = w if isinstance(w, list) else [w]
        pages_g = g if isinstance(g, list) else [g]
        assert len(pages_w) == len(pages_g), label
        for pw, pg in zip(pages_w, pages_g):
            cols, rows_w, state_w, wire_w, nwire_w = pw
            assert pg[0] == cols, label
            assert pg[2] == state_w, label        # paging_state bytes
            assert pg[3] == wire_w, label         # wire_data bytes
            assert pg[4] == nwire_w, label
            rows_g = pg[1]
            assert len(rows_g) == len(rows_w), label
            for rw, rg in zip(rows_w, rows_g):
                assert len(rw) == len(rg), label
                for name, vw, vg in zip(cols, rw, rg):
                    if name.startswith(APPROX_PREFIXES) and vw is not None:
                        assert vg == pytest.approx(vw, rel=1e-4, abs=1e-4), \
                            (label, name)
                    elif isinstance(vw, float) and math.isnan(vw):
                        assert isinstance(vg, float) and math.isnan(vg), label
                    else:
                        assert vg == vw and type(vg) is type(vw), \
                            (label, name, vw, vg)


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    from yugabyte_db_tpu_torch.utils import hybrid_time as t_ht

    return run_script(QLProcessor, cpu_local_cluster, t_ht,
                      str(tmp_path_factory.mktemp("port")),
                      statement_script(),
                      engine_options={"rows_per_block": 16})


@pytest.mark.parametrize("engine", ["cpu", "tpu"])
def test_statement_script_matches_the_jax_processor(engine, port_records,
                                                    tmp_path):
    import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
    from yugabyte_db_tpu.utils import hybrid_time as j_ht
    from yugabyte_db_tpu.yql.cql.processor import (LocalCluster as JLocal,
                                                   QLProcessor as JQL)

    steps = statement_script()
    assert port_records and len(port_records) == sum(
        1 for s in steps if s[0] in ("q", "pages"))
    want = run_script(JQL, JLocal, j_ht, str(tmp_path), steps,
                      engine=engine, engine_options={"rows_per_block": 16})
    assert_same_records(want, port_records)


def test_collections_flush_under_dictionary_encoding_as_the_jax_engine(
        tmp_path):
    """A LIST, SET and MAP column through a flush under ``plane_encoding``
    "auto": the device flush builds a dictionary over each varlen column,
    whose values here are unhashable containers. The port's flush once
    raised ``TypeError`` there where the JAX ``tpu`` engine serves; both
    now give the same answers."""
    import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
    from yugabyte_db_tpu.yql.cql.processor import (LocalCluster as JLocal,
                                                   QLProcessor as JQL)

    script = ["CREATE TABLE t (k text, l list<int>, s set<text>, "
              "m map<text, int>, PRIMARY KEY ((k)))"]
    for i in range(24):
        script.append(f"INSERT INTO t (k, l, s, m) VALUES ('r{i:02d}', "
                      f"[{i}, {i % 3}], {{'x{i % 4}', 'y'}}, "
                      f"{{'v': {i}, 'w': {i % 2}}})")
    reads = ["SELECT k, l, s, m FROM t", "SELECT count(*) FROM t",
             "SELECT l, m FROM t WHERE k = 'r07'"]
    answers = []
    for proc, cluster in (
            (JQL, JLocal(str(tmp_path / "j"), num_tablets=2, engine="tpu",
                         engine_options={"rows_per_block": 8})),
            (QLProcessor, cpu_local_cluster(
                str(tmp_path / "p"), num_tablets=2,
                engine_options={"rows_per_block": 8,
                                "plane_encoding": "auto"}))):
        ql = proc(cluster)
        try:
            for sql in script:
                ql.execute(sql)
            for handle in cluster.tables.values():
                for t in handle.tablets:
                    t.flush()
            ql.execute("UPDATE t SET l = l + [99] WHERE k = 'r07'")
            answers.append([ql.execute(sql).rows for sql in reads])
        finally:
            cluster.close()
    assert answers[1] == answers[0]
    assert answers[0][2] == [([7, 1, 99], {"v": 7, "w": 1})]
