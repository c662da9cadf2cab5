"""SQL executor features on the port's ``PgProcessor`` (its tablets on the
``gpu`` engine over CPU tensors) under the assertions of the JAX
package's ``tests/test_sql_features.py`` (CTEs, OFFSET, correlated
subqueries, scalar functions, UNION / EXCEPT / INTERSECT, [NOT] EXISTS),
``test_sql_relational.py`` (joins, DISTINCT, HAVING, subqueries, TPC-H
Q3) and ``test_window.py`` (window functions); and the false
uncorrelated EXISTS under an aggregate, held to PostgreSQL's semantics
on a keyed table and on a keyless (virtual) one.

Reference capability: everything stock PG 11.2's executor provides above
the FDW scans (src/postgres/src/backend/executor).
"""

import random

import pytest

from test_torch_data import cpu_local_cluster
from yugabyte_db_tpu_torch.utils.status import InvalidArgument
from yugabyte_db_tpu_torch.yql.pgsql import PgProcessor

# The JAX ``test_sql_relational.py`` cases run over three tablets.
THREE_TABLETS = pytest.mark.parametrize("pg", [3], indirect=True,
                                        ids=["3tablets"])


@pytest.fixture
def pg(request, tmp_path):
    cluster = cpu_local_cluster(str(tmp_path),
                                num_tablets=getattr(request, "param", 2),
                                engine_options={"rows_per_block": 16})
    proc = PgProcessor(cluster)
    yield proc
    cluster.close()


def seed(pg):
    pg.execute("CREATE TABLE items (id bigint PRIMARY KEY, cat text, "
               "price bigint, qty int, name text)")
    data = [
        (1, "a", 100, 3, "apple"),
        (2, "a", 250, 1, "avocado"),
        (3, "b", 80, 7, "banana"),
        (4, "b", 300, 2, "berry"),
        (5, "b", 150, 5, "bread"),
        (6, "c", 40, 9, "candy"),
    ]
    for row in data:
        pg.execute("INSERT INTO items (id, cat, price, qty, name) VALUES "
                   f"({row[0]}, '{row[1]}', {row[2]}, {row[3]}, "
                   f"'{row[4]}')")
    return data


# -- OFFSET ------------------------------------------------------------------

def test_offset_with_order_and_limit(pg):
    seed(pg)
    r = pg.execute("SELECT id FROM items ORDER BY price DESC "
                   "LIMIT 2 OFFSET 1")
    assert r.rows == [(2,), (5,)]
    # OFFSET alone and OFFSET-before-LIMIT order both parse.
    r = pg.execute("SELECT id FROM items ORDER BY id OFFSET 4")
    assert r.rows == [(5,), (6,)]
    r = pg.execute("SELECT id FROM items ORDER BY id OFFSET 2 LIMIT 2")
    assert r.rows == [(3,), (4,)]
    r = pg.execute("SELECT id FROM items ORDER BY id OFFSET 99")
    assert r.rows == []


def test_offset_without_order(pg):
    seed(pg)
    all_ids = {r[0] for r in pg.execute("SELECT id FROM items").rows}
    got = pg.execute("SELECT id FROM items OFFSET 2").rows
    assert len(got) == 4 and {r[0] for r in got} <= all_ids


# -- CTEs --------------------------------------------------------------------

def test_cte_basic(pg):
    seed(pg)
    r = pg.execute(
        "WITH cheap AS (SELECT id, cat, price FROM items "
        "WHERE price < 200) "
        "SELECT id FROM cheap ORDER BY id")
    assert r.rows == [(1,), (3,), (5,), (6,)]


def test_cte_aggregate_over_cte(pg):
    seed(pg)
    r = pg.execute(
        "WITH b AS (SELECT * FROM items WHERE cat = 'b') "
        "SELECT count(*), sum(price), min(qty) FROM b")
    assert r.rows == [(3, 530, 2)]
    r = pg.execute(
        "WITH t AS (SELECT cat, price FROM items) "
        "SELECT cat, sum(price) FROM t GROUP BY cat ORDER BY cat")
    assert r.rows == [("a", 350), ("b", 530), ("c", 40)]


def test_cte_chained_and_filtered(pg):
    seed(pg)
    r = pg.execute(
        "WITH b AS (SELECT id, price FROM items WHERE cat = 'b'), "
        "pricey AS (SELECT id, price FROM b WHERE price >= 150) "
        "SELECT id FROM pricey ORDER BY price DESC LIMIT 1")
    assert r.rows == [(4,)]


def test_cte_expressions_and_alias(pg):
    seed(pg)
    r = pg.execute(
        "WITH t AS (SELECT id, price * qty AS total FROM items) "
        "SELECT id, total FROM t c WHERE c.total >= 500 ORDER BY id")
    assert r.rows == [(3, 560), (4, 600), (5, 750)]


def test_cte_name_shadows_table(pg):
    seed(pg)
    r = pg.execute(
        "WITH items AS (SELECT id FROM items WHERE cat = 'c') "
        "SELECT count(*) FROM items")
    assert r.rows == [(1,)]


# -- correlated subqueries ---------------------------------------------------

def test_correlated_scalar_subquery(pg):
    seed(pg)
    # Rows at their category's max price.
    r = pg.execute(
        "SELECT id FROM items i WHERE price = "
        "(SELECT max(price) FROM items i2 WHERE i2.cat = i.cat) "
        "ORDER BY id")
    assert r.rows == [(2,), (4,), (6,)]


def test_correlated_inequality(pg):
    seed(pg)
    # Rows above their category's average price.
    r = pg.execute(
        "SELECT id FROM items i WHERE price > "
        "(SELECT avg(price) FROM items i2 WHERE i2.cat = i.cat) "
        "ORDER BY id")
    assert r.rows == [(2,), (4,)]


def test_correlated_in_subquery(pg):
    seed(pg)
    pg.execute("CREATE TABLE tags (id bigint PRIMARY KEY, item bigint, "
               "tag text)")
    for i, (item, tag) in enumerate([(1, "x"), (3, "x"), (4, "y")]):
        pg.execute(f"INSERT INTO tags (id, item, tag) VALUES "
                   f"({i}, {item}, 'x')" if tag == "x" else
                   f"INSERT INTO tags (id, item, tag) VALUES "
                   f"({i}, {item}, 'y')")
    r = pg.execute(
        "SELECT id FROM items i WHERE id IN "
        "(SELECT item FROM tags t WHERE t.tag = 'x') ORDER BY id")
    assert r.rows == [(1,), (3,)]


def test_uncorrelated_subquery_still_works(pg):
    seed(pg)
    r = pg.execute(
        "SELECT id FROM items WHERE price = "
        "(SELECT max(price) FROM items)")
    assert r.rows == [(4,)]


def test_col_vs_col_predicate(pg):
    seed(pg)
    r = pg.execute("SELECT id FROM items WHERE qty > price ORDER BY id")
    assert r.rows == []
    r = pg.execute("SELECT id FROM items i WHERE i.price > i.qty "
                   "ORDER BY id")
    assert len(r.rows) == 6


# -- scalar functions --------------------------------------------------------

def test_scalar_functions_projection(pg):
    seed(pg)
    r = pg.execute(
        "SELECT upper(name), lower(cat), length(name), abs(0 - price) "
        "FROM items WHERE id = 1")
    assert r.rows == [("APPLE", "a", 5, 100)]
    r = pg.execute("SELECT coalesce(name, 'none'), nullif(cat, 'a') "
                   "FROM items WHERE id = 1")
    assert r.rows == [("apple", None)]
    r = pg.execute("SELECT greatest(price, qty), least(price, qty) "
                   "FROM items WHERE id = 3")
    assert r.rows == [(80, 7)]
    r = pg.execute("SELECT concat(cat, '-', name), substring(name, 2, 3)"
                   " FROM items WHERE id = 6")
    assert r.rows == [("c-candy", "and")]
    r = pg.execute("SELECT mod(price, 7), round(price * 3), floor(qty), "
                   "ceil(qty) FROM items WHERE id = 5")
    assert r.rows == [(150 % 7, 450, 5, 5)]


def test_scalar_functions_nest_in_exprs(pg):
    seed(pg)
    r = pg.execute("SELECT length(name) + qty, abs(qty - length(name)) "
                   "FROM items WHERE id = 3")
    assert r.rows == [(13, 1)]
    r = pg.execute("SELECT id FROM items WHERE id = 1")
    assert r.rows == [(1,)]


def test_scalar_functions_over_cte_and_view(pg):
    seed(pg)
    r = pg.execute(
        "WITH t AS (SELECT name, qty FROM items WHERE cat = 'b') "
        "SELECT upper(name) FROM t ORDER BY name LIMIT 2")
    assert r.rows == [("BANANA",), ("BERRY",)]
    pg.execute("CREATE VIEW v AS SELECT name, price FROM items "
               "WHERE cat = 'a'")
    r = pg.execute("SELECT concat(name, '!') FROM v ORDER BY name")
    assert r.rows == [("apple!",), ("avocado!",)]


def test_functions_null_semantics(pg):
    pg.execute("CREATE TABLE nv (id bigint PRIMARY KEY, s text, n int)")
    pg.execute("INSERT INTO nv (id) VALUES (1)")
    r = pg.execute("SELECT upper(s), length(s), abs(n), "
                   "coalesce(s, 'dflt'), concat(s, 'x'), "
                   "greatest(n, id), nullif(id, 99) FROM nv")
    assert r.rows == [(None, None, None, "dflt", "x", 1, 1)]


def test_with_recursive_rejected(pg):
    seed(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("WITH RECURSIVE r AS (SELECT id FROM items) "
                   "SELECT * FROM r")


# -- UNION / UNION ALL -------------------------------------------------------

def test_union_dedup_and_all(pg):
    seed(pg)
    r = pg.execute("SELECT cat FROM items WHERE price < 100 "
                   "UNION SELECT cat FROM items WHERE qty > 4 "
                   "ORDER BY cat")
    assert r.rows == [("b",), ("c",)]
    r = pg.execute("SELECT cat FROM items WHERE price < 100 "
                   "UNION ALL SELECT cat FROM items WHERE qty > 4 "
                   "ORDER BY cat")
    assert r.rows == [("b",), ("b",), ("b",), ("c",), ("c",)]


def test_union_order_limit_offset_bind_to_whole(pg):
    seed(pg)
    r = pg.execute("SELECT id FROM items WHERE cat = 'a' "
                   "UNION SELECT id FROM items WHERE cat = 'b' "
                   "ORDER BY id DESC LIMIT 3 OFFSET 1")
    assert r.rows == [(4,), (3,), (2,)]


def test_union_three_way_mixed(pg):
    seed(pg)
    # left-assoc: (a UNION ALL a) UNION b -> dedups everything so far
    r = pg.execute("SELECT cat FROM items WHERE id = 1 "
                   "UNION ALL SELECT cat FROM items WHERE id = 2 "
                   "UNION SELECT cat FROM items WHERE id = 3 "
                   "ORDER BY cat")
    assert r.rows == [("a",), ("b",)]


def test_union_arity_mismatch(pg):
    seed(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT id FROM items UNION SELECT id, cat FROM items")


def test_union_in_cte_and_view(pg):
    seed(pg)
    r = pg.execute("WITH u AS (SELECT id FROM items WHERE id <= 2 "
                   "UNION SELECT id FROM items WHERE id >= 5) "
                   "SELECT count(*) FROM u")
    assert r.rows == [(4,)]
    pg.execute("CREATE VIEW uv AS SELECT id FROM items WHERE cat = 'a' "
               "UNION SELECT id FROM items WHERE cat = 'c'")
    r = pg.execute("SELECT id FROM uv ORDER BY id")
    assert r.rows == [(1,), (2,), (6,)]


def test_union_with_aggregates_per_branch(pg):
    seed(pg)
    r = pg.execute("SELECT count(*) FROM items WHERE cat = 'a' "
                   "UNION ALL SELECT count(*) FROM items WHERE cat = 'b'")
    assert sorted(r.rows) == [(2,), (3,)]


# -- EXISTS / NOT EXISTS -----------------------------------------------------

def seed_orders(pg):
    pg.execute("CREATE TABLE orders (oid bigint PRIMARY KEY, item bigint, "
               "n int)")
    for oid, item, n in [(1, 1, 2), (2, 1, 1), (3, 3, 5)]:
        pg.execute(f"INSERT INTO orders (oid, item, n) VALUES "
                   f"({oid}, {item}, {n})")


def test_exists_correlated(pg):
    seed(pg)
    seed_orders(pg)
    r = pg.execute("SELECT id FROM items i WHERE EXISTS "
                   "(SELECT 1 FROM orders o WHERE o.item = i.id) "
                   "ORDER BY id")
    assert r.rows == [(1,), (3,)]
    r = pg.execute("SELECT id FROM items i WHERE NOT EXISTS "
                   "(SELECT 1 FROM orders o WHERE o.item = i.id) "
                   "ORDER BY id")
    assert r.rows == [(2,), (4,), (5,), (6,)]


def test_exists_uncorrelated(pg):
    seed(pg)
    seed_orders(pg)
    r = pg.execute("SELECT count(*) FROM items WHERE EXISTS "
                   "(SELECT 1 FROM orders WHERE n > 4)")
    assert r.rows == [(6,)]
    r = pg.execute("SELECT count(*) FROM items WHERE EXISTS "
                   "(SELECT 1 FROM orders WHERE n > 99)")
    assert r.rows == [(0,)]
    r = pg.execute("SELECT id FROM items WHERE NOT EXISTS "
                   "(SELECT 1 FROM orders WHERE n > 99) AND cat = 'c'")
    assert r.rows == [(6,)]


def test_exists_combined_with_predicates(pg):
    seed(pg)
    seed_orders(pg)
    r = pg.execute("SELECT id FROM items i WHERE price >= 100 AND "
                   "EXISTS (SELECT 1 FROM orders o WHERE o.item = i.id)"
                   " ORDER BY id")
    assert r.rows == [(1,)]


def test_exists_in_update_delete(pg):
    seed(pg)
    seed_orders(pg)
    pg.execute("UPDATE items SET qty = 0 WHERE id = 1 AND EXISTS "
               "(SELECT 1 FROM orders WHERE n > 4)")
    assert pg.execute("SELECT qty FROM items WHERE id = 1").rows == [(0,)]
    pg.execute("DELETE FROM items WHERE id = 6 AND EXISTS "
               "(SELECT 1 FROM orders WHERE n > 99)")
    assert pg.execute("SELECT count(*) FROM items").rows == [(6,)]
    pg.execute("DELETE FROM items WHERE id = 6 AND NOT EXISTS "
               "(SELECT 1 FROM orders WHERE n > 99)")
    assert pg.execute("SELECT count(*) FROM items").rows == [(5,)]


def test_exists_over_cte(pg):
    seed(pg)
    seed_orders(pg)
    r = pg.execute("WITH c AS (SELECT id, cat FROM items) "
                   "SELECT count(*) FROM c WHERE EXISTS "
                   "(SELECT 1 FROM orders WHERE n = 5)")
    assert r.rows == [(6,)]


# -- INTERSECT / EXCEPT ------------------------------------------------------

def test_except_and_intersect(pg):
    seed(pg)
    r = pg.execute("SELECT cat FROM items EXCEPT SELECT cat FROM items "
                   "WHERE cat = 'b' ORDER BY cat")
    assert r.rows == [("a",), ("c",)]
    r = pg.execute("SELECT cat FROM items WHERE price < 200 INTERSECT "
                   "SELECT cat FROM items WHERE qty >= 5 ORDER BY cat")
    assert r.rows == [("b",), ("c",)]


def test_intersect_binds_tighter_than_union(pg):
    seed(pg)
    # a UNION b INTERSECT c == a UNION (b INTERSECT c)
    r = pg.execute("SELECT cat FROM items WHERE cat = 'a' "
                   "UNION SELECT cat FROM items "
                   "INTERSECT SELECT cat FROM items WHERE qty > 8 "
                   "ORDER BY cat")
    assert r.rows == [("a",), ("c",)]


def test_except_all_per_occurrence(pg):
    seed(pg)
    # cats: a,a,b,b,b,c ; EXCEPT ALL one 'b' leaves b,b
    r = pg.execute("SELECT cat FROM items EXCEPT ALL "
                   "SELECT cat FROM items WHERE id = 3 ORDER BY cat")
    assert r.rows == [("a",), ("a",), ("b",), ("b",), ("c",)]


def test_intersect_all_multiset(pg):
    seed(pg)
    # lhs b,b,b ; rhs b,b -> min counts = 2
    r = pg.execute("SELECT cat FROM items WHERE cat = 'b' INTERSECT ALL "
                   "SELECT cat FROM items WHERE id >= 4 AND cat = 'b'")
    assert r.rows == [("b",), ("b",)]


def test_union_jsonb_rows(pg):
    pg.execute("CREATE TABLE j (id bigint PRIMARY KEY, data jsonb)")
    pg.execute("INSERT INTO j (id, data) VALUES (1, '{\"a\": 1}')")
    pg.execute("INSERT INTO j (id, data) VALUES (2, '{\"a\": 1}')")
    r = pg.execute("SELECT data FROM j UNION SELECT data FROM j")
    assert r.rows == [({"a": 1},)]
    r = pg.execute("SELECT data FROM j INTERSECT SELECT data FROM j "
                   "WHERE id = 2")
    assert r.rows == [({"a": 1},)]


def test_correlated_exists_clear_error_in_delete(pg):
    seed(pg)
    with pytest.raises(InvalidArgument) as ei:
        pg.execute("DELETE FROM items WHERE EXISTS "
                   "(SELECT 1 FROM items i2 WHERE i2.id = items.id)")
    assert "EXISTS" in str(ei.value)


def test_exists_subquery_typo_not_masked_as_correlated(pg):
    """A typo'd column inside an EXISTS subquery is the subquery's own
    error — it must NOT be rewrapped as 'correlated EXISTS
    unsupported' (only unresolvable outer-column references mean
    correlation)."""
    seed(pg)
    seed_orders(pg)
    with pytest.raises(InvalidArgument) as ei:
        pg.execute("SELECT count(*) FROM items WHERE EXISTS "
                   "(SELECT 1 FROM orders WHERE nosuch_col > 1)")
    assert "unknown column nosuch_col" in str(ei.value)
    assert "correlated" not in str(ei.value)
    # The genuinely-correlated case still gets the clear wrapper.
    with pytest.raises(InvalidArgument) as ei:
        pg.execute("SELECT count(*) FROM items WHERE EXISTS "
                   "(SELECT 1 FROM orders o WHERE o.item = items.id)")
    assert "correlated" in str(ei.value)


def test_false_exists_aggregate_is_empty_aggregate(pg):
    """A false folded EXISTS means 'aggregate over no rows': one row of
    count 0 / NULL sums without GROUP BY, zero rows with it."""
    seed(pg)
    seed_orders(pg)
    r = pg.execute("SELECT sum(price), count(*) FROM items WHERE "
                   "EXISTS (SELECT 1 FROM orders WHERE n > 99)")
    assert r.rows == [(None, 0)]
    r = pg.execute("SELECT cat, count(*) FROM items WHERE NOT EXISTS "
                   "(SELECT 1 FROM orders WHERE n > 0) GROUP BY cat")
    assert r.rows == []


# -- joins, DISTINCT, HAVING, subqueries (JAX tests/test_sql_relational.py) --

def setup_orders(pg):
    pg.execute("CREATE TABLE cust (ck INT PRIMARY KEY, name TEXT, "
               "seg TEXT)")
    pg.execute("CREATE TABLE ords (ok INT PRIMARY KEY, ck INT, "
               "total INT, day INT)")
    pg.execute("INSERT INTO cust (ck, name, seg) VALUES "
               "(1, 'alice', 'retail'), (2, 'bob', 'corp'), "
               "(3, 'carol', 'retail'), (4, 'dan', 'gov')")
    pg.execute("INSERT INTO ords (ok, ck, total, day) VALUES "
               "(10, 1, 100, 5), (11, 1, 250, 6), (12, 2, 70, 5), "
               "(13, 3, 300, 7), (14, 9, 40, 8)")  # ck=9: no customer


# -- joins -------------------------------------------------------------------

@THREE_TABLETS
def test_inner_join_basic(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT c.name, o.total FROM cust c JOIN ords o ON c.ck = o.ck "
        "ORDER BY total")
    assert res.rows == [("bob", 70), ("alice", 100), ("alice", 250),
                        ("carol", 300)]


@THREE_TABLETS
def test_inner_join_where_both_sides(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT c.name, o.total FROM cust c JOIN ords o ON c.ck = o.ck "
        "WHERE c.seg = 'retail' AND o.total > 150 ORDER BY o.total")
    assert res.rows == [("alice", 250), ("carol", 300)]


@THREE_TABLETS
def test_left_join_nulls(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT c.name, o.ok FROM cust c LEFT JOIN ords o ON c.ck = o.ck "
        "ORDER BY name, ok")
    # dan has no orders -> NULL-extended row survives a LEFT JOIN
    assert ("dan", None) in res.rows
    assert len(res.rows) == 5


@THREE_TABLETS
def test_left_join_where_on_right_filters_null_rows(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT c.name FROM cust c LEFT JOIN ords o ON c.ck = o.ck "
        "WHERE o.total > 0 ORDER BY name")
    # PG applies WHERE after the join: dan's NULL row is dropped.
    names = [r[0] for r in res.rows]
    assert "dan" not in names and len(res.rows) == 4


@THREE_TABLETS
def test_join_unqualified_unambiguous(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT name, total FROM cust JOIN ords ON cust.ck = ords.ck "
        "WHERE total >= 250 ORDER BY total")
    assert res.rows == [("alice", 250), ("carol", 300)]


@THREE_TABLETS
def test_join_ambiguous_bare_column_errors(pg):
    setup_orders(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT ck FROM cust JOIN ords ON cust.ck = ords.ck")


@THREE_TABLETS
def test_join_aggregate_group_having(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT c.name, sum(o.total) AS t, count(*) AS n "
        "FROM cust c JOIN ords o ON c.ck = o.ck "
        "GROUP BY c.name HAVING sum(o.total) > 100 ORDER BY t DESC")
    assert res.columns == ["name", "t", "n"]
    assert res.rows == [("alice", 350, 2), ("carol", 300, 1)]


@THREE_TABLETS
def test_three_way_join(pg):
    setup_orders(pg)
    pg.execute("CREATE TABLE items (ik INT PRIMARY KEY, ok INT, qty INT)")
    pg.execute("INSERT INTO items (ik, ok, qty) VALUES "
               "(100, 10, 2), (101, 10, 3), (102, 13, 1), (103, 12, 4)")
    res = pg.execute(
        "SELECT c.name, i.qty FROM cust c "
        "JOIN ords o ON c.ck = o.ck "
        "JOIN items i ON i.ok = o.ok "
        "ORDER BY c.name, i.qty")
    assert res.rows == [("alice", 2), ("alice", 3), ("bob", 4),
                        ("carol", 1)]


# -- DISTINCT ----------------------------------------------------------------

@THREE_TABLETS
def test_distinct_rows(pg):
    setup_orders(pg)
    res = pg.execute("SELECT DISTINCT seg FROM cust ORDER BY seg")
    assert res.rows == [("corp",), ("gov",), ("retail",)]


@THREE_TABLETS
def test_distinct_multi_column(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT DISTINCT ck, day FROM ords WHERE ck = 1 ORDER BY day")
    assert res.rows == [(1, 5), (1, 6)]


@THREE_TABLETS
def test_distinct_order_by_hidden_errors(pg):
    setup_orders(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT DISTINCT seg FROM cust ORDER BY name")


# -- HAVING (single table, pushed-down partials) -----------------------------

@THREE_TABLETS
def test_having_single_table(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT ck, sum(total) AS t FROM ords GROUP BY ck "
        "HAVING sum(total) >= 300 ORDER BY ck")
    assert res.rows == [(1, 350), (3, 300)]


@THREE_TABLETS
def test_having_agg_not_in_select(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT ck FROM ords GROUP BY ck HAVING count(*) > 1")
    assert res.rows == [(1,)]


@THREE_TABLETS
def test_having_avg_and_group_col(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT ck, count(*) AS n FROM ords GROUP BY ck "
        "HAVING avg(total) > 100 AND ck < 5 ORDER BY ck")
    assert res.rows == [(1, 2), (3, 1)]


# -- subqueries --------------------------------------------------------------

@THREE_TABLETS
def test_scalar_subquery(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT ok FROM ords WHERE total = "
        "(SELECT max(total) FROM ords)")
    assert res.rows == [(13,)]


@THREE_TABLETS
def test_in_subquery(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT ok FROM ords WHERE ck IN "
        "(SELECT ck FROM cust WHERE seg = 'retail') ORDER BY ok")
    assert res.rows == [(10,), (11,), (13,)]


@THREE_TABLETS
def test_scalar_subquery_null_matches_nothing(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT ok FROM ords WHERE total < "
        "(SELECT min(total) FROM ords WHERE ck = 42)")
    assert res.rows == []


@THREE_TABLETS
def test_scalar_subquery_multi_row_errors(pg):
    setup_orders(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT ok FROM ords WHERE total = "
                   "(SELECT total FROM ords)")


# -- TPC-H Q3 ----------------------------------------------------------------

@THREE_TABLETS
def test_tpch_q3(pg):
    """Q3: 3-way join + predicate on each table + grouped revenue +
    ORDER BY revenue DESC, date + LIMIT. Expected result computed
    independently over the generated rows."""
    rnd = random.Random(42)
    pg.execute("CREATE TABLE customer (c_custkey INT PRIMARY KEY, "
               "c_mktsegment TEXT)")
    pg.execute("CREATE TABLE orders (o_orderkey INT PRIMARY KEY, "
               "o_custkey INT, o_orderdate INT, o_shippriority INT)")
    pg.execute("CREATE TABLE lineitem (l_linekey INT PRIMARY KEY, "
               "l_orderkey INT, l_extendedprice INT, l_discount INT, "
               "l_shipdate INT)")
    segs = ["BUILDING", "AUTOMOBILE", "MACHINERY"]
    customers = [(ck, rnd.choice(segs)) for ck in range(1, 31)]
    orders = [(ok, rnd.randrange(1, 31), rnd.randrange(9000, 9200),
               rnd.randrange(3)) for ok in range(1, 81)]
    lineitems = [(lk, rnd.randrange(1, 81), rnd.randrange(1000, 90000),
                  rnd.randrange(0, 11), rnd.randrange(9000, 9200))
                 for lk in range(1, 241)]
    for ck, seg in customers:
        pg.execute(f"INSERT INTO customer (c_custkey, c_mktsegment) "
                   f"VALUES ({ck}, '{seg}')")
    for ok, ck, d, pr in orders:
        pg.execute(f"INSERT INTO orders (o_orderkey, o_custkey, "
                   f"o_orderdate, o_shippriority) "
                   f"VALUES ({ok}, {ck}, {d}, {pr})")
    for lk, ok, price, disc, sd in lineitems:
        pg.execute(f"INSERT INTO lineitem (l_linekey, l_orderkey, "
                   f"l_extendedprice, l_discount, l_shipdate) "
                   f"VALUES ({lk}, {ok}, {price}, {disc}, {sd})")

    CUT = 9100
    res = pg.execute(
        "SELECT l.l_orderkey, "
        "sum(l.l_extendedprice * (100 - l.l_discount)) AS revenue, "
        "o.o_orderdate, o.o_shippriority "
        "FROM customer c "
        "JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        f"WHERE c.c_mktsegment = 'BUILDING' AND o.o_orderdate < {CUT} "
        f"AND l.l_shipdate > {CUT} "
        "GROUP BY l.l_orderkey, o.o_orderdate, o.o_shippriority "
        "ORDER BY revenue DESC, o_orderdate LIMIT 10")
    assert res.columns == ["l_orderkey", "revenue", "o_orderdate",
                           "o_shippriority"]

    # Independent oracle (plain Python over the same tuples).
    seg_of = dict(customers)
    odict = {ok: (ck, d, pr) for ok, ck, d, pr in orders}
    agg: dict = {}
    for lk, ok, price, disc, sd in lineitems:
        o = odict.get(ok)
        if o is None or sd <= CUT:
            continue
        ck, d, pr = o
        if seg_of.get(ck) != "BUILDING" or d >= CUT:
            continue
        key = (ok, d, pr)
        agg[key] = agg.get(key, 0) + price * (100 - disc)
    expect = sorted(((ok, rev, d, pr) for (ok, d, pr), rev in agg.items()),
                    key=lambda r: (-r[1], r[2]))[:10]
    assert res.rows == expect


@THREE_TABLETS
def test_qualified_single_table(pg):
    setup_orders(pg)
    res = pg.execute(
        "SELECT o.ok FROM ords o WHERE o.total > 200 ORDER BY o.ok")
    assert res.rows == [(11,), (13,)]


# -- window functions (JAX tests/test_window.py) ------------------------------

def seed_sales(pg):
    pg.execute("CREATE TABLE sales (id bigint PRIMARY KEY, rgn text, "
               "amt bigint)")
    for i, (rgn, amt) in enumerate([("e", 100), ("e", 300), ("e", 300),
                                    ("w", 50), ("w", 200)], start=1):
        pg.execute(f"INSERT INTO sales (id, rgn, amt) VALUES "
                   f"({i}, '{rgn}', {amt})")


def test_row_number_global(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, row_number() OVER (ORDER BY amt DESC, id) "
                   "AS rn FROM sales ORDER BY rn")
    assert r.rows == [(2, 1), (3, 2), (5, 3), (1, 4), (4, 5)]


def test_row_number_partitioned(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, row_number() OVER (PARTITION BY rgn "
                   "ORDER BY amt) AS rn FROM sales ORDER BY id")
    assert r.rows == [(1, 1), (2, 2), (3, 3), (4, 1), (5, 2)]


def test_rank_and_dense_rank_ties(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, rank() OVER (ORDER BY amt DESC) AS rk, "
                   "dense_rank() OVER (ORDER BY amt DESC) AS dr "
                   "FROM sales ORDER BY id")
    # amts: 100,300,300,50,200 -> desc order 300,300,200,100,50
    assert r.rows == [(1, 4, 3), (2, 1, 1), (3, 1, 1), (4, 5, 4),
                      (5, 3, 2)]


def test_lag_lead(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, lag(amt) OVER (PARTITION BY rgn "
                   "ORDER BY id) AS prev, lead(amt) OVER (PARTITION BY "
                   "rgn ORDER BY id) AS nxt FROM sales ORDER BY id")
    assert r.rows == [(1, None, 300), (2, 100, 300), (3, 300, None),
                      (4, None, 200), (5, 50, None)]


def test_lag_offset_and_default(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, lag(amt, 2, 0) OVER (ORDER BY id) AS p2 "
                   "FROM sales ORDER BY id")
    assert r.rows == [(1, 0), (2, 0), (3, 100), (4, 300), (5, 300)]


def test_lag_bound_param_offset_and_default(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, lag(amt, $1, $2) OVER (ORDER BY id) AS p "
                   "FROM sales ORDER BY id", [2, -1])
    assert r.rows == [(1, -1), (2, -1), (3, 100), (4, 300), (5, 300)]


def test_running_sum_default_frame(pg):
    seed_sales(pg)
    # PG default frame with ORDER BY: peers (equal order keys) share the
    # running value — ids 2 and 3 are both amt=300 but distinct order
    # keys here (ORDER BY id), so a plain prefix sum.
    r = pg.execute("SELECT id, sum(amt) OVER (PARTITION BY rgn "
                   "ORDER BY id) AS run FROM sales ORDER BY id")
    assert r.rows == [(1, 100), (2, 400), (3, 700), (4, 50), (5, 250)]


def test_running_sum_peer_rows_share(pg):
    seed_sales(pg)
    # ORDER BY amt: ids 2,3 are peers (amt=300) -> both see the full
    # 700 running total, exactly PG's RANGE-frame semantics.
    r = pg.execute("SELECT id, sum(amt) OVER (PARTITION BY rgn "
                   "ORDER BY amt) AS run FROM sales ORDER BY id")
    assert r.rows == [(1, 100), (2, 700), (3, 700), (4, 50), (5, 250)]


def test_whole_partition_aggregates(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, sum(amt) OVER (PARTITION BY rgn) AS tot, "
                   "count(*) OVER (PARTITION BY rgn) AS n, "
                   "avg(amt) OVER (PARTITION BY rgn) AS mean "
                   "FROM sales ORDER BY id")
    assert r.rows == [(1, 700, 3, 700 / 3), (2, 700, 3, 700 / 3),
                      (3, 700, 3, 700 / 3), (4, 250, 2, 125.0),
                      (5, 250, 2, 125.0)]


def test_min_max_over(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, min(amt) OVER (PARTITION BY rgn) AS lo, "
                   "max(amt) OVER (PARTITION BY rgn) AS hi "
                   "FROM sales WHERE rgn = 'e' ORDER BY id")
    assert r.rows == [(1, 100, 300), (2, 100, 300), (3, 100, 300)]


def test_window_over_cte(pg):
    seed_sales(pg)
    r = pg.execute("WITH big AS (SELECT id, rgn, amt FROM sales "
                   "WHERE amt >= 100) "
                   "SELECT id, rank() OVER (ORDER BY amt DESC) AS rk "
                   "FROM big ORDER BY id")
    assert r.rows == [(1, 4), (2, 1), (3, 1), (5, 3)]


def test_window_over_view(pg):
    seed_sales(pg)
    pg.execute("CREATE VIEW east AS SELECT id, amt FROM sales "
               "WHERE rgn = 'e'")
    r = pg.execute("SELECT id, row_number() OVER (ORDER BY amt DESC, id)"
                   " AS rn FROM east ORDER BY rn")
    assert r.rows == [(2, 1), (3, 2), (1, 3)]


def test_window_over_join(pg):
    seed_sales(pg)
    pg.execute("CREATE TABLE rgns (rgn text PRIMARY KEY, nm text)")
    pg.execute("INSERT INTO rgns (rgn, nm) VALUES ('e', 'east')")
    pg.execute("INSERT INTO rgns (rgn, nm) VALUES ('w', 'west')")
    r = pg.execute("SELECT s.id, row_number() OVER (PARTITION BY r.nm "
                   "ORDER BY s.amt DESC) AS rn FROM sales s "
                   "JOIN rgns r ON s.rgn = r.rgn ORDER BY s.id")
    assert r.rows == [(1, 3), (2, 1), (3, 2), (4, 2), (5, 1)]


def test_window_star_projection(pg):
    seed_sales(pg)
    r = pg.execute("SELECT *, row_number() OVER (ORDER BY id) AS rn "
                   "FROM sales WHERE rgn = 'w' ORDER BY id")
    assert [row[-1] for row in r.rows] == [1, 2]
    assert len(r.columns) == 4


def test_window_with_limit_offset(pg):
    seed_sales(pg)
    r = pg.execute("SELECT id, row_number() OVER (ORDER BY amt DESC, id)"
                   " AS rn FROM sales ORDER BY rn LIMIT 2 OFFSET 1")
    assert r.rows == [(3, 2), (5, 3)]


def test_fromless_window(pg):
    r = pg.execute("SELECT row_number() OVER () AS rn")
    assert r.rows == [(1,)]
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT row_number() OVER (ORDER BY x)")


def test_window_rejects_group_by(pg):
    seed_sales(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT rgn, row_number() OVER (ORDER BY rgn) "
                   "FROM sales GROUP BY rgn")


def test_window_requires_over(pg):
    seed_sales(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT row_number() FROM sales")


def test_window_unknown_column(pg):
    seed_sales(pg)
    with pytest.raises(InvalidArgument):
        pg.execute("SELECT row_number() OVER (ORDER BY nope) FROM sales")


# -- the false uncorrelated EXISTS under an aggregate (PG semantics) ----------

@pytest.mark.parametrize("table", ["items", "pg_catalog.pg_tables",
                                   "information_schema.columns"])
def test_false_exists_aggregate_is_one_zero_row_aggregate(pg, table):
    """PostgreSQL: an aggregate without GROUP BY over no rows is one row
    (count 0, NULL min / max / sum); with GROUP BY it is no row. A false
    uncorrelated EXISTS leaves no rows, on a table with a primary key and
    on a keyless catalog table alike."""
    seed(pg)
    seed_orders(pg)
    col = {"items": "cat", "pg_catalog.pg_tables": "tablename",
           "information_schema.columns": "column_name"}[table]
    false_exists = "EXISTS (SELECT 1 FROM orders WHERE n > 99)"
    r = pg.execute(f"SELECT count(*), min({col}), max({col}) FROM {table} "
                   f"WHERE {false_exists}")
    assert r.rows == [(0, None, None)]
    r = pg.execute(f"SELECT count(*) FROM {table} WHERE NOT EXISTS "
                   "(SELECT 1 FROM orders WHERE n > 0)")
    assert r.rows == [(0,)]
    r = pg.execute(f"SELECT {col}, count(*) FROM {table} WHERE "
                   f"{false_exists} GROUP BY {col}")
    assert r.rows == []
    r = pg.execute(f"SELECT {col} FROM {table} WHERE {false_exists}")
    assert r.rows == []
    # A true EXISTS keeps every row.
    every = pg.execute(f"SELECT count(*) FROM {table}").rows
    assert every[0][0] > 0
    r = pg.execute(f"SELECT count(*) FROM {table} WHERE EXISTS "
                   "(SELECT 1 FROM orders WHERE n > 4)")
    assert r.rows == every
