"""The headline aggregate workload: the bench table, its rows, its spec.

The same schema and row generator as the repository's entry module
(``__graft_entry__._make_schema`` / ``_make_rows``), built from the port's
own data model: one version per key (a flat run), ~5% tombstones, an
INT64, a DOUBLE and an INT32 value column. The headline spec is
``bench.py``'s ``bench_aggregate`` scan: count(*), sum(a), min(a),
max(a), sum(d) under ``d >= lo``. ``make_update_rows`` adds updates
whose keys and single fields follow YCSB workload A's, which turn the
flat run into a multi-version one; ``make_wave_rows`` adds the uniform
update waves of ``bench.py``'s post-write scan bench, which leave several
runs and a live memtable.
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
from yugabyte_db_tpu_torch.utils import planes as P


def make_schema() -> Schema:
    return Schema([
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("r", DataType.INT64, ColumnKind.RANGE),
        ColumnSchema("a", DataType.INT64),
        ColumnSchema("c", DataType.DOUBLE),
        ColumnSchema("d", DataType.INT32),
    ], table_id="bench")


def bench_key(schema: Schema, i: int) -> bytes:
    """The encoded key of the bench table's key number ``i``."""
    return schema.encode_primary_key(
        {"k": f"user{i:06d}", "r": i % 7},
        compute_hash_code(schema, {"k": f"user{i:06d}"}))


def make_rows(schema: Schema, num_keys: int, seed: int = 3):
    """(rows, max_ht): one RowVersion per key, in key-generation order."""
    rng = random.Random(seed)
    cid = {c.name: c.col_id for c in schema.columns}
    ht = 100
    rows = []
    for i in range(num_keys):
        key = bench_key(schema, i)
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


def make_wave_rows(schema: Schema, num_keys: int, count: int, ht: int,
                   seed: int = 5):
    """(rows, max_ht): one update wave of ``bench.py:740``
    ``bench_multisource`` over the keys of ``make_rows(schema,
    num_keys)``: ``count`` operations (that bench takes 2% of the keys a
    wave) on keys drawn uniformly, each at the next hybrid time after
    ``ht`` and each a one-field update of d to a value in [-10^6, 10^6).
    The rest is coverage of the merge's traps, not measured traffic:
    about 2% of the operations are DELETEs and about 2% write d NULL."""
    rng = random.Random(seed)
    d = next(c.col_id for c in schema.columns if c.name == "d")
    rows = []
    for _ in range(count):
        key = bench_key(schema, rng.randrange(num_keys))
        ht += 1
        roll = rng.random()
        if roll < 0.02:
            rows.append(RowVersion(key, ht=ht, tombstone=True))
        else:
            rows.append(RowVersion(key, ht=ht, columns={
                d: None if roll < 0.04 else rng.randrange(-10**6, 10**6)}))
    return rows, ht


LONG_GROUP_LENGTHS = (1, 2, 31, 32, 33, 256)  # and R: a key filling a block
LONG_GROUP_HT0 = 1 << 40  # hybrid times of long_group_planes start here


def long_group_planes(n_rows: int, R: int, seed: int = 7) -> dict:
    """Multi-version planes of the bench table's value columns in the
    ``DeviceRun.arrays`` layout (numpy, [n_rows // R, R]), laid out for
    the resolve's hard cases rather than drawn from traffic: group lengths
    drawn evenly from ``LONG_GROUP_LENGTHS`` and R (those up to R), so that
    groups straddle 32-row warp steps and fill whole blocks. Groups are
    packed into blocks as ``storage/columnar.py`` packs them: a group that
    does not fit in the rest of a block starts the next one, and the rest
    is padding (valid False, its own group, hybrid time 0, expiry MAX_HT,
    no flags). Hybrid times do not increase within a group (newest first,
    from ``LONG_GROUP_HT0`` up); about 2% of the versions are tombstones,
    a third of those (where the group has a row before them) with a write
    at the same hybrid time sorted before them: a full-row write with the
    liveness marker (the same-batch DELETE + INSERT). Of the other writes
    about 30% carry the liveness marker, 3% a TTL that may expire inside
    the history, and each column is set on 40% of them; 2% of the set
    values are NULL."""
    if R < 1 or n_rows % R:
        raise ValueError(f"{n_rows} rows are not whole blocks of {R}")
    rng = np.random.default_rng(seed)
    choices = np.array(sorted({n for n in LONG_GROUP_LENGTHS + (R,)
                               if n <= R}))
    draws = rng.choice(choices, size=max(n_rows, 1)).tolist()
    starts, lens = [], []
    row, end = 0, R
    for n in draws:
        if row + n > end:  # pad the block's rest; the group opens the next
            row, end = end, end + R
        if row >= n_rows:
            break
        starts.append(row)
        lens.append(n)
        row += n
        if row == end:
            end += R
    starts, lens = np.array(starts, np.int64), np.array(lens, np.int64)
    total = int(lens.sum())
    first = np.repeat(np.cumsum(lens) - lens, lens)  # group's first version
    pos = np.arange(total) - first  # version's place in its group
    idx = np.repeat(starts, lens) + pos  # its row

    history = 4 * n_rows  # hybrid-time span of the tops of the groups
    top = LONG_GROUP_HT0 + rng.integers(0, history, len(lens))
    steps = rng.integers(1, 4, total)
    tomb = rng.random(total) < 0.02
    tie = tomb & (pos > 0) & (rng.random(total) < 1 / 3)
    steps[pos == 0] = 0
    steps[tie] = 0  # the write before it shares its hybrid time
    tied = np.zeros(total, bool)  # the write before a tied tombstone
    tied[np.flatnonzero(tie) - 1] = True
    tomb &= ~tied
    cs = np.cumsum(steps)
    ht = np.repeat(top, lens) - (cs - cs[first])
    live = tied | (~tomb & (rng.random(total) < 0.3))
    exp = np.full(total, MAX_HT, np.int64)
    ttl = ~tomb & (rng.random(total) < 0.03)
    exp[ttl] = ht[ttl] + rng.integers(1, history // 2 + 2, int(ttl.sum()))

    def plane(values, fill, dtype):
        out = np.full(n_rows, fill, dtype)
        out[idx] = values
        return out.reshape(n_rows // R, R)

    ht_hi, ht_lo = P.ht_to_planes(ht)
    exp_hi, exp_lo = P.ht_to_planes(exp)
    pad_exp_hi, pad_exp_lo = P.scalar_ht_planes(MAX_HT)
    planes = {"valid": plane(True, False, bool),
              "group_start": plane(pos == 0, True, bool),
              "tomb": plane(tomb, False, bool),
              "live": plane(live, False, bool),
              "ht_hi": plane(ht_hi, 0, np.int32),
              "ht_lo": plane(ht_lo, 0, np.int32),
              "exp_hi": plane(exp_hi, pad_exp_hi, np.int32),
              "exp_lo": plane(exp_lo, pad_exp_lo, np.int32), "cols": {}}
    for col in make_schema().value_columns:
        set_ = tied | (~tomb & (rng.random(total) < 0.4))
        keep = set_ & (rng.random(total) >= 0.02)  # set and not NULL
        if col.dtype == DataType.INT64:
            values = rng.integers(-10**12, 10**12, total)
            hi, lo = P.i64_to_ordered_planes(values)
            cmp = np.stack([hi, lo], axis=-1)
        elif col.dtype == DataType.DOUBLE:
            values = rng.uniform(-1e6, 1e6, total)
            hi, lo = P.f64_to_ordered_planes(values)
            cmp = np.stack([hi, lo], axis=-1)
        else:
            values = rng.integers(-10**6, 10**6, total)
            cmp = values[:, None]
        cmp = np.where(keep[:, None], cmp, 0).astype(np.int32)
        full = np.zeros((n_rows, cmp.shape[1]), np.int32)
        full[idx] = cmp
        planes["cols"][col.col_id] = {
            "set": plane(set_, False, bool),
            "isnull": plane(set_ & ~keep, False, bool),
            "cmp": full.reshape(n_rows // R, R, cmp.shape[1]),
            "arith": plane(np.where(keep, values, 0).astype(np.float32), 0,
                           np.float32)}
    return planes


def headline_spec(read_ht: int, lo: int = -500_000) -> ScanSpec:
    return ScanSpec(
        read_ht=read_ht,
        predicates=[Predicate("d", ">=", lo)],
        aggregates=[AggSpec("count", None), AggSpec("sum", "a"),
                    AggSpec("min", "a"), AggSpec("max", "a"),
                    AggSpec("sum", "d")])
