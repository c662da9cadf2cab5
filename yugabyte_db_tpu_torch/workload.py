"""The headline aggregate workload: the bench table, its rows, its spec.

The same schema and row generator as the repository's entry module
(``__graft_entry__._make_schema`` / ``_make_rows``), built from the port's
own data model: one version per key (a flat run), ~5% tombstones, an
INT64, a DOUBLE and an INT32 value column. The headline spec is
``bench.py``'s ``bench_aggregate`` scan: count(*), sum(a), min(a),
max(a), sum(d) under ``d >= lo``. ``make_update_rows`` adds updates
whose keys and single fields follow YCSB workload A's, which turn the
flat run into a multi-version one.
"""

from __future__ import annotations

import random

import numpy as np

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import (ColumnKind, ColumnSchema,
                                                 Schema)
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
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


# YCSB's zipfian constant (ZipfianGenerator.ZIPFIAN_CONSTANT).
ZIPFIAN_THETA = 0.99
MAX_VERSIONS = 256  # versions a key may reach; a draw of a key at it re-draws


def make_update_rows(schema: Schema, rows: list, max_ht: int,
                     n_updates: int, seed: int = 5):
    """(updates, max_ht): a multi-version history over the keys of
    ``rows``, with hybrid times after ``max_ht``. Three things follow
    YCSB workload A's update operations (``workloads/workloada``): keys
    are drawn zipfian (``requestdistribution=zipfian``, constant 0.99),
    every operation is an update, and an update sets one field
    (``writeallfields=false``): one of a, c, d. The zipfian ranks are
    scrambled across the key space by a seeded permutation of the keys,
    where YCSB hashes over a larger item space. A key at ``MAX_VERSIONS``
    versions re-draws.

    The rest is coverage of the resolve's traps, not measured traffic:
    about 1% of updates write NULL, about 3% carry a TTL that may expire
    inside the history, and about 2% are DELETEs instead, a third of them
    followed by a full-row write at the same hybrid time (the next
    statement of the same batch)."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    cid = {c.name: c.col_id for c in schema.columns}
    keys = [r.key for r in rows]
    n = len(keys)
    cdf = np.cumsum(1.0 / np.arange(1, n + 1) ** ZIPFIAN_THETA)
    cdf /= cdf[-1]
    rank_to_key = nprng.permutation(n)
    versions = np.ones(n, np.int64)  # rows: one version per key
    draws: list = []

    def draw(room: int) -> int:
        """A zipfian key with room for ``room`` more versions."""
        while True:
            if not draws:
                ranks = np.searchsorted(cdf, nprng.random(1 << 16),
                                        side="right")
                draws.extend(rank_to_key[np.minimum(ranks, n - 1)].tolist())
            k = draws.pop()
            if versions[k] + room <= MAX_VERSIONS:
                return k

    ht = max_ht
    history = 2 * n_updates  # hybrid-time span of the update phase
    out = []
    while len(out) < n_updates:
        ht += rng.randrange(1, 4)
        roll = rng.random()
        if roll < 0.02:
            tie = rng.random() < 1 / 3
            k = draw(2 if tie else 1)
            out.append(RowVersion(keys[k], ht=ht, tombstone=True))
            versions[k] += 1
            if tie:
                out.append(RowVersion(keys[k], ht=ht, liveness=True,
                                      write_id=1, columns={
                                          cid["a"]: rng.randrange(-10**12,
                                                                  10**12),
                                          cid["c"]: rng.uniform(-1e6, 1e6),
                                          cid["d"]: rng.randrange(-10**6,
                                                                  10**6)}))
                versions[k] += 1
            continue
        k = draw(1)
        col = rng.choice("acd")
        if rng.random() < 0.01:
            value = None
        elif col == "a":
            value = rng.randrange(-10**12, 10**12)
        elif col == "c":
            value = rng.uniform(-1e6, 1e6)
        else:
            value = rng.randrange(-10**6, 10**6)
        expire = (ht + rng.randrange(1, history) if rng.random() < 0.03
                  else MAX_HT)
        out.append(RowVersion(keys[k], ht=ht, columns={cid[col]: value},
                              expire_ht=expire))
        versions[k] += 1
    return out, ht


def headline_spec(read_ht: int, lo: int = -500_000) -> ScanSpec:
    return ScanSpec(
        read_ht=read_ht,
        predicates=[Predicate("d", ">=", lo)],
        aggregates=[AggSpec("count", None), AggSpec("sum", "a"),
                    AggSpec("min", "a"), AggSpec("max", "a"),
                    AggSpec("sum", "d")])
