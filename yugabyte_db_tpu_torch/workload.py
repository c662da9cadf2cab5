"""The headline aggregate workload: the bench table, its rows, its spec.

The same schema and row generator as the repository's entry module
(``__graft_entry__._make_schema`` / ``_make_rows``), built from the port's
own data model: one version per key (a flat run), ~5% tombstones, an
INT64, a DOUBLE and an INT32 value column. The headline spec is
``bench.py``'s ``bench_aggregate`` scan: count(*), sum(a), min(a),
max(a), sum(d) under ``d >= lo``.
"""

from __future__ import annotations

import random

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import (ColumnKind, ColumnSchema,
                                                 Schema)
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import (AggSpec, Predicate,
                                                     ScanSpec)


def make_schema() -> Schema:
    return Schema([
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("r", DataType.INT64, ColumnKind.RANGE),
        ColumnSchema("a", DataType.INT64),
        ColumnSchema("c", DataType.DOUBLE),
        ColumnSchema("d", DataType.INT32),
    ], table_id="bench")


def make_rows(schema: Schema, num_keys: int, seed: int = 3):
    """(rows, max_ht): one RowVersion per key, in key-generation order."""
    rng = random.Random(seed)
    cid = {c.name: c.col_id for c in schema.columns}
    ht = 100
    rows = []
    for i in range(num_keys):
        key = schema.encode_primary_key(
            {"k": f"user{i:06d}", "r": i % 7},
            compute_hash_code(schema, {"k": f"user{i:06d}"}))
        ht += rng.randrange(1, 4)
        if rng.random() < 0.05:
            rows.append(RowVersion(key, ht=ht, tombstone=True))
        else:
            rows.append(RowVersion(key, ht=ht, liveness=True, columns={
                cid["a"]: rng.randrange(-10**12, 10**12),
                cid["c"]: rng.uniform(-1e6, 1e6),
                cid["d"]: rng.randrange(-10**6, 10**6),
            }))
    return rows, ht


def headline_spec(read_ht: int, lo: int = -500_000) -> ScanSpec:
    return ScanSpec(
        read_ht=read_ht,
        predicates=[Predicate("d", ">=", lo)],
        aggregates=[AggSpec("count", None), AggSpec("sum", "a"),
                    AggSpec("min", "a"), AggSpec("max", "a"),
                    AggSpec("sum", "d")])
