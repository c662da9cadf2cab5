"""TPC-H lineitem: schema, data generation, and Q1/Q6 (BASELINE config 3).

Money columns are SCALED INTEGERS (cents; discount/tax as integer
percents), the classic exact-decimal representation — which also makes
every Q1/Q6 aggregate an exact integer computation the device evaluates
with exact integer sums (ops.group_agg). Final results rescale to
decimals on output.

    Q1: select l_returnflag, l_linestatus, sum(qty), sum(price),
               sum(price*(100-disc)), sum(price*(100-disc)*(100+tax)),
               avg(qty), avg(price), avg(disc), count(*)
        from lineitem where l_shipdate <= DATE - DELTA
        group by l_returnflag, l_linestatus order by 1, 2
    Q6: select sum(price * disc) from lineitem
        where l_shipdate in [DATE, DATE+1y) and disc in DISC±1 and qty < QTY
"""

from __future__ import annotations

import random

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema, Schema
from yugabyte_db_tpu_torch.storage.expr import BinOp, Col, Const
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import AggSpec, Predicate, ScanSpec

LINEITEM_COLUMNS = [
    ColumnSchema("l_orderkey", DataType.INT64, ColumnKind.HASH),
    ColumnSchema("l_linenumber", DataType.INT32, ColumnKind.RANGE),
    ColumnSchema("l_quantity", DataType.INT32),       # whole units
    ColumnSchema("l_extendedprice", DataType.INT64),  # cents
    ColumnSchema("l_discount", DataType.INT8),        # percent 0..10
    ColumnSchema("l_tax", DataType.INT8),             # percent 0..8
    ColumnSchema("l_returnflag", DataType.STRING),    # 'A'|'N'|'R'
    ColumnSchema("l_linestatus", DataType.STRING),    # 'F'|'O'
    ColumnSchema("l_shipdate", DataType.INT32),       # days since epoch
]

SHIPDATE_LO = 8766    # ~1994-01-01 in days
SHIPDATE_HI = 10957   # ~1998-12-31


def lineitem_schema(table_id: str = "lineitem") -> Schema:
    return Schema(list(LINEITEM_COLUMNS), table_id=table_id)


def generate_lineitem(num_rows: int, seed: int = 42):
    """Yield (key_values, value dict) rows in the published generator's
    value distributions (scaled-integer money)."""
    rng = random.Random(seed)
    for i in range(num_rows):
        orderkey = i // 4 + 1
        line = i % 4 + 1
        qty = rng.randrange(1, 51)
        price = qty * rng.randrange(900_00, 11_000_00) // 10
        shipdate = rng.randrange(SHIPDATE_LO, SHIPDATE_HI)
        # returnflag correlates with date like the spec's generator
        if shipdate < 9496:
            flag = rng.choice("AR")
            status = "F"
        else:
            flag = "N"
            status = "O" if shipdate > 9600 else "F"
        yield {
            "l_orderkey": orderkey, "l_linenumber": line,
            "l_quantity": qty, "l_extendedprice": price,
            "l_discount": rng.randrange(0, 11),
            "l_tax": rng.randrange(0, 9),
            "l_returnflag": flag, "l_linestatus": status,
            "l_shipdate": shipdate,
        }


def load_engine(engine, schema: Schema, num_rows: int, seed: int = 42,
                batch: int = 4096) -> int:
    """Load generated rows straight into a storage engine (bench path)."""
    cid = {c.name: c.col_id for c in schema.columns}
    key_names = {c.name for c in schema.key_columns}
    ht = 100
    buf = []
    for row in generate_lineitem(num_rows, seed):
        kv = {k: row[k] for k in key_names}
        key = schema.encode_primary_key(kv, compute_hash_code(schema, kv))
        ht += 1
        buf.append(RowVersion(key, ht=ht, liveness=True, columns={
            cid[name]: v for name, v in row.items()
            if name not in key_names}))
        if len(buf) >= batch:
            engine.apply(buf)
            buf = []
    if buf:
        engine.apply(buf)
    engine.flush()
    return ht


DISC_PRICE = BinOp("*", Col("l_extendedprice"),
                   BinOp("-", Const(100), Col("l_discount")))
CHARGE = BinOp("*", DISC_PRICE, BinOp("+", Const(100), Col("l_tax")))


def q1_spec(read_ht: int, ship_cutoff: int = 10471) -> ScanSpec:
    """Q1 as one pushed-down grouped scan. avg columns lower to
    sum+count; the runner derives the averages (the reference's FDW does
    the same above the scan)."""
    return ScanSpec(
        read_ht=read_ht,
        predicates=[Predicate("l_shipdate", "<=", ship_cutoff)],
        group_by=["l_returnflag", "l_linestatus"],
        aggregates=[
            AggSpec("sum", "l_quantity", label="sum_qty"),
            AggSpec("sum", "l_extendedprice", label="sum_base_price"),
            AggSpec("sum", None, expr=DISC_PRICE, label="sum_disc_price"),
            AggSpec("sum", None, expr=CHARGE, label="sum_charge"),
            AggSpec("count", None, label="count_order"),
        ])


def q1_result(scan_result) -> list[dict]:
    """Rescale the integer partials into the Q1 output row shape."""
    out = []
    for row in scan_result.rows:
        flag, status, sum_qty, sum_price, sum_disc, sum_charge, n = row
        out.append({
            "l_returnflag": flag, "l_linestatus": status,
            "sum_qty": sum_qty,
            "sum_base_price": (sum_price or 0) / 100,
            "sum_disc_price": (sum_disc or 0) / 100 / 100,
            "sum_charge": (sum_charge or 0) / 100 / 100 / 100,
            "avg_qty": sum_qty / n if n else None,
            "avg_price": (sum_price or 0) / 100 / n if n else None,
            "count_order": n,
        })
    return out


def q6_spec(read_ht: int, date_lo: int = 9131, discount: int = 6,
            quantity: int = 24) -> ScanSpec:
    """Q6: sum(l_extendedprice * l_discount) under date/disc/qty bands."""
    return ScanSpec(
        read_ht=read_ht,
        predicates=[
            Predicate("l_shipdate", ">=", date_lo),
            Predicate("l_shipdate", "<", date_lo + 365),
            Predicate("l_discount", ">=", discount - 1),
            Predicate("l_discount", "<=", discount + 1),
            Predicate("l_quantity", "<", quantity),
        ],
        aggregates=[AggSpec(
            "sum", None, label="revenue",
            expr=BinOp("*", Col("l_extendedprice"), Col("l_discount")))])


def q6_result(scan_result) -> float:
    v = scan_result.rows[0][0]
    return (v or 0) / 100 / 100   # cents x percent -> currency


Q1_SQL = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (100 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (100 - l_discount) * (100 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= {cutoff}
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

Q6_SQL = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= {lo} AND l_shipdate < {hi}
  AND l_discount >= {dlo} AND l_discount <= {dhi}
  AND l_quantity < {qty}
"""


def q1_sql(ship_cutoff: int = 10471) -> str:
    return Q1_SQL.format(cutoff=ship_cutoff)


def q6_sql(date_lo: int = 9131, discount: int = 6,
           quantity: int = 24) -> str:
    return Q6_SQL.format(lo=date_lo, hi=date_lo + 365,
                         dlo=discount - 1, dhi=discount + 1, qty=quantity)
