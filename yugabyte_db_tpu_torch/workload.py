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
runs and a live memtable. ``ycsb_e_batch`` is a batch of YCSB workload
E's LIMIT pages, as ``bench.py``'s ``bench_ycsb_e`` makes them.

TPC-H's lineitem (BASELINE config 3) takes its schema (scaled-integer
money) from the port's ``yql/pgsql/tpch.py``; here are a seeded numpy
generator with the same value distributions as ``tpch.generate_lineitem``
(much faster at the smoke's row counts), and the Q1/Q6 specs.
``make_lineitem_updates`` rewrites single fields of zipfian keys, which
makes the run multi-version.

``flat_planes`` draws a flat run's planes with integer and float
columns (NULLs, unset values, tombstones, TTLs, invalid rows, values at
the extremes) for the folds' kernels, at sizes past the flat fold's
bounds.

The write side's kernels get inputs laid out for their hard cases:
``replay_inputs`` (the flush's staged planes, order and packing at any R
and column mix) and ``gc_union`` / ``scatter_union`` (a sorted union with
long key groups and spans of equal hybrid time, spread over several
runs' resident planes).
"""

from __future__ import annotations

import random

import numpy as np

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.encoding import (GROUP_END,
                                                   encode_doc_key_prefix,
                                                   encode_key_component)
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import (ColumnKind, ColumnSchema,
                                                 Schema)
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.storage.expr import BinOp, Col, Const
from yugabyte_db_tpu_torch.storage.scan_spec import (AggSpec, Predicate,
                                                     ScanSpec)
from yugabyte_db_tpu_torch.utils import planes as P
from yugabyte_db_tpu_torch.yql.pgsql.tpch import (LINEITEM_COLUMNS,
                                                  SHIPDATE_HI, SHIPDATE_LO,
                                                  lineitem_schema)


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


def make_rows(schema: Schema, num_keys: int, seed: int = 3,
              first: int = 0, ht: int = 100):
    """(rows, max_ht): one RowVersion per key of key numbers [first,
    first + num_keys), in key-generation order, at hybrid times after
    ``ht``."""
    rng = random.Random(seed)
    cid = {c.name: c.col_id for c in schema.columns}
    rows = []
    for i in range(first, first + num_keys):
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


def make_compact_waves(keys: list, schema: Schema, ht: int,
                       waves: int = 3, share: float = 0.35,
                       seed: int = 9) -> tuple:
    """([rows of each wave], max_ht): ``bench.py:1458`` ``bench_compact``'s
    update waves over ``keys`` (those of ``make_rows``): each wave
    ``share`` of the key count in operations, on keys drawn uniformly,
    each at the next hybrid time after ``ht``; 10% are DELETEs, the rest
    one-field updates of d to a value in [-10^6, 10^6)."""
    rng = random.Random(seed)
    d = next(c.col_id for c in schema.columns if c.name == "d")
    per_wave = max(1, int(len(keys) * share))
    out = []
    for _ in range(waves):
        rows = []
        for _ in range(per_wave):
            key = keys[rng.randrange(len(keys))]
            ht += 1
            if rng.random() < 0.1:
                rows.append(RowVersion(key, ht=ht, tombstone=True))
            else:
                rows.append(RowVersion(key, ht=ht, columns={
                    d: rng.randrange(-10**6, 10**6)}))
        out.append(rows)
    return out, ht


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


# A float column's values (well conditioned for sums: all positive).
FLOAT_RANGE = {"f32": (0.5, 100.0), "f64": (0.5, 1000.0)}
# Values at a kind's extremes (for the columns that take them).
EXTREMES = {"i32": (-(1 << 31), (1 << 31) - 1),
            "i64": (-(1 << 63), (1 << 63) - 1),
            "f32": (-3.4028234663852886e38, 3.4028234663852886e38),
            "f64": (-1.7976931348623157e308, 1.7976931348623157e308)}


def flat_planes(n_blocks: int, R: int, columns, seed: int = 17) -> tuple:
    """Flat-run planes (one version a key) in the ``DeviceRun.arrays``
    layout, as numpy [n_blocks, R] (cmp [n_blocks, R, P]), drawn rather
    than flushed, and read points: ``(planes, reads)``. ``columns`` lists
    ``(col_id, kind, p_set, p_null, p_extreme)`` with kind ``i32``,
    ``i64``, ``f32`` or ``f64``; each column has its order planes as the
    columnar build writes them (i32 one word; i64 and f64 the two ordered
    words; f32 the float's bits) and its ``arith`` plane (the value as
    float32; 0 where unset or NULL). Integers are uniform in +-10^6
    (i32) or +-10^12 (i64); floats uniform in ``FLOAT_RANGE`` (all
    positive, so that sums are well conditioned); a share ``p_extreme``
    of the set values sits at the kind's ``EXTREMES`` (a float's arith
    plane then holds +-inf or +-FLT_MAX). A column of ``p_set`` 0 is never
    set. About 0.2% of the rows are invalid, 5% of the valid ones
    tombstones, 95% of the others carry the liveness marker (the rest
    exist only through a set, non-NULL column), 3% have a TTL (expiring
    inside the history). ``reads``: ``all`` (past every hybrid time),
    ``mid`` (the median) and ``early`` (the 5th percentile)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * R
    ht = (10**15 + rng.integers(0, 10**7, n)) << 12
    valid = rng.random(n, np.float32) > 0.002
    tomb = valid & (rng.random(n, np.float32) < 0.05)
    live = valid & ~tomb & (rng.random(n, np.float32) < 0.95)
    has_ttl = ~tomb & (rng.random(n, np.float32) < 0.03)
    exp = np.full(n, MAX_HT, np.int64)
    exp[has_ttl] = ht[has_ttl] + (
        rng.integers(1, 10**7, int(has_ttl.sum())) << 12)

    def shaped(x, *extra):
        return np.ascontiguousarray(x.reshape((n_blocks, R) + extra))

    def column(kind, p_set, p_null, p_ext):
        set_ = valid & ~tomb & (rng.random(n, np.float32) < p_set)
        keep = set_ & (rng.random(n, np.float32) >= p_null)
        ext = keep & (rng.random(n, np.float32) < p_ext)
        lo, hi = EXTREMES[kind]
        sign = rng.random(int(ext.sum()), np.float32) < 0.5
        if kind in ("i32", "i64"):
            bound = 10**6 if kind == "i32" else 10**12
            values = rng.integers(-bound, bound, n, dtype=np.int64)
            values[ext] = np.where(sign, lo, hi)
        else:
            values = rng.uniform(*FLOAT_RANGE[kind], n)
            if kind == "f32":
                values = values.astype(np.float32)
            values[ext] = np.where(sign, lo, hi)
        with np.errstate(over="ignore"):
            arith = np.where(keep, values, 0).astype(np.float32)
        if kind == "i32":
            cmp = values.astype(np.int32)[:, None]
        elif kind == "f32":
            cmp = values.view(np.int32)[:, None]
        else:
            hi_p, lo_p = (P.i64_to_ordered_planes(values) if kind == "i64"
                          else P.f64_to_ordered_planes(values))
            cmp = np.stack([hi_p, lo_p], axis=-1)
        cmp = np.where(keep[:, None], cmp, 0).astype(np.int32)
        return {"set": shaped(set_), "isnull": shaped(set_ & ~keep),
                "cmp": shaped(cmp, cmp.shape[1]), "arith": shaped(arith)}

    ht_hi, ht_lo = P.ht_to_planes(ht)
    exp_hi, exp_lo = P.ht_to_planes(exp)
    planes = {
        "valid": shaped(valid), "group_start": shaped(np.ones(n, bool)),
        "tomb": shaped(tomb), "live": shaped(live),
        "ht_hi": shaped(ht_hi), "ht_lo": shaped(ht_lo),
        "exp_hi": shaped(exp_hi), "exp_lo": shaped(exp_lo),
        "cols": {cid: column(kind, p_set, p_null, p_ext)
                 for cid, kind, p_set, p_null, p_ext in columns}}
    reads = {"all": int(ht.max()) + 1, "mid": int(np.median(ht)),
             "early": int(np.percentile(ht, 5))}
    return planes, reads


def replay_inputs(n: int, R: int, num_cols: int, pads: int = 0,
                  seed: int = 5, two_word_last: bool = False,
                  odd_blocks: bool = False) -> tuple:
    """Inputs of ``ops.flush.replay_flush`` as numpy, drawn rather than
    flushed: ``(staged, perm, dst, gs, is_real)``. ``n`` staged rows in
    apply order (random planes, ~30% tombstones, half with liveness;
    each of ``num_cols`` columns of 1 or 2 order words, 60% with an
    arithmetic plane, and the last of 2 words if ``two_word_last``), a
    random flush order ``perm`` of them, then ``pads`` pad entries (perm
    0, dst past the last slot) as the JAX engine pads to a power of two;
    ``dst`` packs the sorted positions into blocks of at most R rows (a
    block closed early now and then), ascending; Bp blocks: a multiple of
    8 with padding blocks after the real ones, or the real ones rounded
    up to an odd count (``odd_blocks``: a slot count that need not be a
    multiple of 4)."""
    rng = np.random.default_rng(seed)
    perm = np.concatenate([rng.permutation(n), np.zeros(pads, np.int64)])
    block = np.cumsum((rng.random(n) < 0.15) & (np.arange(n) > 0))
    dst, b, off = np.empty(n, np.int64), 0, 0
    for j in range(n):  # a new block when this one is full or closes early
        if j and (off == R or block[j] != block[j - 1]):
            b, off = b + 1, 0
        dst[j] = b * R + off
        off += 1
    B = b + 1 if n else 0
    Bp = (B | 1) if odd_blocks else (B + 7) // 8 * 8 + 8 * int(
        rng.random() < 0.5)
    dst = np.concatenate([dst, np.full(pads, Bp * R, np.int64)])
    gs = rng.random(n + pads) < 0.4
    is_real = np.arange(Bp) < B

    def words(k):
        return rng.integers(-2**31, 2**31, k, dtype=np.int64).astype(
            np.int32)

    staged = {"ht_hi": words(n), "ht_lo": words(n), "exp_hi": words(n),
              "exp_lo": words(n), "tomb": rng.random(n) < 0.3,
              "live": rng.random(n) < 0.5, "cols": {}}
    for c in range(num_cols):
        w = 2 if two_word_last and c == num_cols - 1 else int(
            rng.integers(1, 3))
        col = {"set": rng.random(n) < 0.6, "isnull": rng.random(n) < 0.2,
               "cmp": words(n * w).reshape(n, w)}
        if rng.random() < 0.6:
            col["arith"] = rng.standard_normal(n).astype(np.float32)
        staged["cols"][100 + c] = col
    return (staged, perm.astype(np.int32), dst.astype(np.int32), gs,
            is_real)


GC_GROUP_LENGTHS = (1, 1, 2, 3, 5, 9, 40)


def gc_union(n_groups: int, num_cols: int, long_groups=(), pads: int = 0,
             seed: int = 1, span: int = 70) -> tuple:
    """A sorted union (key groups, hybrid time not increasing inside
    each) for the retention mask's hard cases, as numpy planes in the
    form ``ops.compact.gc_mask_plain`` takes (``set_`` a list of
    columns). ``n_groups`` groups of lengths drawn from
    ``GC_GROUP_LENGTHS`` (about half of those past 2 rows with two equal
    hybrid times side by side), and ``long_groups``, (position, length)
    pairs, inserted at those positions: their hybrid times run in spans
    of ``span`` equal ones, and each column is set on 2% of their rows.
    ~12% tombstones; of the other rows ~30% carry the liveness marker and
    each column is set on half (short groups); 15% of the rows expire.
    Then ``pads`` pad rows in a group of their own (hybrid time and
    expiry 0, no flag). Returns (planes, the newest hybrid time)."""
    rng = np.random.default_rng(seed)
    plan = [int(x) for x in rng.choice(GC_GROUP_LENGTHS, n_groups)]
    for pos, length in sorted(long_groups, reverse=True):
        plan.insert(pos, length)
    hts, new_group = [], []
    for n in plan:
        if n > 100:
            h = np.repeat(np.sort(rng.integers(1, 3000, -(-n // span)))[::-1],
                          span)[:n]
        else:
            h = np.sort(rng.integers(1, 3000, n))[::-1]
            if n > 2 and rng.random() < 0.5:
                j = int(rng.integers(0, n - 1))
                h[j + 1] = h[j]
        hts.append(h)
        new_group.append(np.arange(n) == 0)
    sizes = np.array(plan, np.int64)
    ht = np.concatenate(hts) if plan else np.zeros(0, np.int64)
    N = ht.size
    long_row = np.repeat(sizes > 100, sizes)
    tomb = rng.random(N) < 0.12
    live = ~tomb & (rng.random(N) < 0.3)
    exp = np.where(rng.random(N) < 0.15, ht + rng.integers(1, 400, N),
                   MAX_HT)
    share = np.where(long_row, 0.02, 0.5)
    sets = [~tomb & (rng.random(N) < share) for _ in range(num_cols)]
    ht_hi, ht_lo = P.ht_to_planes(ht.astype(np.int64))
    exp_hi, exp_lo = P.ht_to_planes(exp.astype(np.int64))
    zlo = np.int32(-(1 << 31))

    def padded(arr, fill):
        return np.concatenate([arr, np.full(pads, fill, arr.dtype)])

    s = {"ht_hi": padded(ht_hi, np.int32(0)), "ht_lo": padded(ht_lo, zlo),
         "exp_hi": padded(exp_hi, np.int32(0)),
         "exp_lo": padded(exp_lo, zlo), "tomb": padded(tomb, False),
         "live": padded(live, False),
         "new_group": np.concatenate(
             new_group + [np.arange(pads) == 0]).astype(bool),
         "set_": [padded(c, False) for c in sets]}
    return s, int(ht.max()) if N else 0


def scatter_union(s: dict, n_runs: int, R: int, pads: int = 0,
                  seed: int = 3) -> tuple:
    """The union ``s`` (``gc_union``'s planes, its last ``pads`` rows pad
    rows) spread over ``n_runs`` runs of [B, R] resident planes, as a
    compaction's merge order reads them: each row goes to a random run,
    after that run's earlier rows with a gap now and then; a pad row goes
    to none. Returns (runs: a dict of numpy planes a run, with ``sets`` a
    list of columns; idx: int32 flat rows into the runs' concatenated
    planes, -1 for a pad row)."""
    rng = np.random.default_rng(seed)
    real = np.arange(s["ht_hi"].size - pads)
    run_of = rng.integers(0, n_runs, real.size)
    pos = np.zeros(real.size, np.int64)
    counts = []
    for r in range(n_runs):
        sel = run_of == r
        steps = 1 + (rng.random(int(sel.sum())) < 0.1)
        pos[sel] = np.cumsum(steps) - 1
        counts.append(int(pos[sel].max()) + 1 if sel.any() else 0)
    blocks = [max(1, -(-c // R)) for c in counts]
    offsets = np.concatenate([[0], np.cumsum(blocks) * R])
    idx = np.full(s["ht_hi"].size, -1, np.int64)
    idx[real] = offsets[run_of] + pos
    num_cols = len(s["set_"])
    runs = []
    for r, B in enumerate(blocks):
        sel = real[run_of == r]
        flat = pos[run_of == r]
        run = {}
        for k in ("ht_hi", "ht_lo", "exp_hi", "exp_lo", "tomb", "live"):
            plane = np.zeros(B * R, s[k].dtype)
            plane[flat] = s[k][sel]
            run[k] = plane.reshape(B, R)
        run["sets"] = []
        for c in range(num_cols):
            plane = np.zeros(B * R, bool)
            plane[flat] = s["set_"][c][sel]
            run["sets"].append(plane.reshape(B, R))
        runs.append(run)
    return runs, idx.astype(np.int32)


def row_edge_planes(n_rows: int, R: int, K: int, seed: int = 7,
                    flat: bool = False) -> dict:
    """``long_group_planes`` laid out to break a window resolve that is
    split across the blocks of a cluster (the row path's K7 and K9, K
    blocks a window): about 10% of the key groups cleared (every version's
    valid flag, as the delta overlay clears a dirty key); column ``d``
    never set in the last block of each window, so that its groups there
    read the stand-in row (the window's last row); and random order and
    arithmetic planes on every row that is not valid (padding and cleared
    rows), so that a wrong stand-in row shows. ``flat``: every row its own
    group (a flat run's layout)."""
    if n_rows % (R * K):
        raise ValueError(f"{n_rows} rows are not whole windows of {K} x {R}")
    planes = long_group_planes(n_rows, R, seed)
    rng = np.random.default_rng(seed + 1)
    valid = planes["valid"].reshape(-1).copy()
    starts = planes["group_start"].reshape(-1)
    gid = np.cumsum(starts) - 1
    cleared = rng.random(int(gid[-1]) + 1) < 0.1
    valid &= ~cleared[gid]
    planes["valid"] = valid.reshape(planes["valid"].shape)
    if flat:
        planes["group_start"] = np.ones_like(planes["group_start"])
    blocks = planes["valid"].shape[0]
    last = np.arange(blocks) % K == K - 1
    d = next(c.col_id for c in make_schema().value_columns if c.name == "d")
    planes["cols"][d]["set"][last] = False
    planes["cols"][d]["isnull"][last] = False
    off = ~planes["valid"]
    for col in planes["cols"].values():
        col["cmp"][off] = rng.integers(-10**6, 10**6, col["cmp"][off].shape,
                                       dtype=np.int32)
        col["arith"][off] = rng.uniform(-1e6, 1e6, int(off.sum()))
    return planes


def row_edge_reads(planes: dict) -> tuple:
    """(newest, mid): the read points of ``row_edge_planes``' launches,
    past every version and at the median version's hybrid time."""
    valid = planes["valid"]
    ht = P.planes_to_u64(planes["ht_hi"][valid],
                         planes["ht_lo"][valid]).astype(np.int64)
    return int(ht.max()) + 1, int(np.median(ht))


def row_edge_pages(R: int, K: int, windows: int, reads: tuple) -> dict:
    """The launches' parameters over ``row_edge_planes`` of ``windows``
    windows of K blocks of R rows at ``reads`` (``row_edge_reads``), as
    (w_first, w_last, row_lo, row_hi, read point, scan_from) pages.
    ``paged``: K7's pages: the whole run at both read points, a page that
    starts inside a window and counts from a later ``scan_from`` inside
    the next, a bounded range from the second window, and the last window
    alone. ``chunks``: K7's chunks mode, one page a window at alternating
    read points. ``candidates``: K9's (row_lo, row_hi, read point), a
    bounded row range over the windows it walks."""
    N, n_rows, last = K * R, windows * K * R, windows - 1
    newest, mid = reads
    return {"paged": [(0, last, 0, n_rows, newest, None),
                      (0, last, 0, n_rows, mid, None),
                      (0, last, R + 5, n_rows - 3, newest, N + R // 2 + 1),
                      (min(1, last), last, N + 3, n_rows - R, mid, None),
                      (last, last, last * N, n_rows, newest, None)],
            "chunks": [(w, w, 3, n_rows - 70, reads[w % 2], None)
                       for w in range(windows)],
            "candidates": (R + 9, n_rows - 17, mid)}


def row_edge_sigs(S, G, B: int, R: int, K: int, flat: bool, preds, M: int,
                  packed: bool = True, apply_preds: bool = True) -> tuple:
    """(GatherSig, row-scan ScanSig, int literals) of a launch over
    ``row_edge_planes``: the bench table's value columns, every one an
    output (setter rows on two of them), under ``preds`` ((column, op,
    value) triples). ``S`` holds ``ScanSig``, ``ColSig`` and ``PredSig``
    and ``G`` holds ``GatherSig`` and ``OutCol``: the port's ``ops.scan``
    and ``ops.row_gather``, or modules with the same signatures."""
    from yugabyte_db_tpu_torch.ops.agg_fold import pred_literal_host
    from yugabyte_db_tpu_torch.ops.device_run import dtype_kind

    schema = make_schema()
    cid = {c.name: c.col_id for c in schema.value_columns}
    kinds = {c.col_id: dtype_kind(c.dtype) for c in schema.value_columns}
    cols = tuple(S.ColSig(c, k) for c, k in kinds.items())
    ps = tuple(S.PredSig(cid[c], kinds[cid[c]], op) for c, op, _v in preds)
    outs = tuple(G.OutCol(c, 2 if k in ("i64", "f64") else 1, i != 1)
                 for i, (c, k) in enumerate(kinds.items()))
    ints = [int(x) for c, _op, v in preds
            for x in np.atleast_1d(pred_literal_host(kinds[cid[c]], v))]
    return (G.GatherSig(B=B, R=R, K=K, M=M, cols=cols, preds=ps,
                        apply_preds=True, out_cols=outs, flat=flat,
                        packed=packed),
            S.ScanSig(B=B, R=R, K=K, cols=cols, preds=ps, aggs=(),
                      apply_preds=apply_preds, flat=flat), ints)


YCSB_E_LIMIT = 100    # bench.py:179 bench_ycsb_e: rows a page
YCSB_E_PAGES = 256    # pages a batch


def ycsb_e_batch(schema: Schema, num_keys: int, read_ht: int,
                 rng: random.Random, n_pages: int = YCSB_E_PAGES) -> list:
    """One batch of ``bench.py:179`` ``bench_ycsb_e``'s ``make_batch``
    over the keys of ``make_rows(schema, num_keys)``: ``n_pages`` LIMIT
    pages of YCSB_E_LIMIT rows, each from a key drawn uniformly by
    ``rng`` (``user%06d``, range component 0), under ``d >= -500000``,
    projecting k, r, a, d."""
    out = []
    for _ in range(n_pages):
        i = rng.randrange(num_keys)
        lo = schema.encode_primary_key(
            {"k": f"user{i:06d}", "r": 0},
            compute_hash_code(schema, {"k": f"user{i:06d}"}))
        out.append(ScanSpec(lower=lo, read_ht=read_ht,
                            predicates=[Predicate("d", ">=", -500_000)],
                            projection=["k", "r", "a", "d"],
                            limit=YCSB_E_LIMIT))
    return out


def headline_spec(read_ht: int, lo: int = -500_000) -> ScanSpec:
    return ScanSpec(
        read_ht=read_ht,
        predicates=[Predicate("d", ">=", lo)],
        aggregates=[AggSpec("count", None), AggSpec("sum", "a"),
                    AggSpec("min", "a"), AggSpec("max", "a"),
                    AggSpec("sum", "d")])


# -- TPC-H lineitem ------------------------------------------------------------

LINEITEM_VALUES = tuple(c.name for c in LINEITEM_COLUMNS[2:])
SF1_ROWS = 6_001_215  # lineitem rows at TPC-H scale factor 1
LINEITEM_HT0 = 100    # the first row is written at LINEITEM_HT0 + 1


def generate_lineitem(num_rows: int, seed: int = 42) -> dict:
    """Column arrays of ``num_rows`` lineitem rows (int64, and str for
    the flags), drawn with numpy in the value distributions of the JAX
    package's ``generate_lineitem``: four lines an order; quantity
    uniform in 1..50; price quantity x uniform 900.00..10999.99 / 10, in
    cents; ship date uniform over five years; the return flag A or R
    (even odds) and status F before day 9496, else flag N and status O
    after day 9600 (F until then); discount 0..10 and tax 0..8 percent,
    uniform."""
    rng = np.random.default_rng(seed)
    i = np.arange(num_rows, dtype=np.int64)
    qty = rng.integers(1, 51, num_rows)
    price = qty * rng.integers(900_00, 11_000_00, num_rows) // 10
    ship = rng.integers(SHIPDATE_LO, SHIPDATE_HI, num_rows)
    early = ship < 9496
    flag = np.where(early, np.where(rng.random(num_rows) < 0.5, "A", "R"),
                    "N")
    return {"l_orderkey": i // 4 + 1, "l_linenumber": i % 4 + 1,
            "l_quantity": qty, "l_extendedprice": price,
            "l_discount": rng.integers(0, 11, num_rows),
            "l_tax": rng.integers(0, 9, num_rows),
            "l_returnflag": flag,
            "l_linestatus": np.where(early | (ship <= 9600), "F", "O"),
            "l_shipdate": ship}


def lineitem_keys(schema: Schema, cols: dict) -> list[bytes]:
    """The encoded keys of the rows of ``cols``: ``encode_primary_key``'s
    bytes (hash prelude and order key, then the line number), each order
    key encoded once."""
    okey, oline = schema.hash_columns[0], schema.range_columns[0]
    prefix = {}
    for ok in np.unique(cols[okey.name]).tolist():
        kv = {okey.name: ok}
        prefix[ok] = encode_doc_key_prefix(
            compute_hash_code(schema, kv), [(ok, okey.dtype)], [])
    suffix = {ln: encode_key_component(ln, oline.dtype) + bytes([GROUP_END])
              for ln in np.unique(cols[oline.name]).tolist()}
    return [prefix[ok] + suffix[ln] for ok, ln in
            zip(cols[okey.name].tolist(), cols[oline.name].tolist())]


def lineitem_rows(schema: Schema, cols: dict) -> tuple[list, int]:
    """(rows, max_ht): one INSERT (liveness and every value column) per
    row of ``cols``, row i at hybrid time LINEITEM_HT0 + 1 + i, as the
    JAX package's ``tpch.load_engine`` writes them."""
    cid = [schema.column(name).col_id for name in LINEITEM_VALUES]
    values = zip(*(cols[name].tolist() for name in LINEITEM_VALUES))
    ht0 = LINEITEM_HT0 + 1
    rows = [RowVersion(key, ht=ht0 + i, liveness=True,
                       columns=dict(zip(cid, vals)))
            for i, (key, vals) in enumerate(zip(lineitem_keys(schema, cols),
                                                values))]
    return rows, LINEITEM_HT0 + len(rows)


# The fields a lineitem update rewrites, one an update.
LINEITEM_UPDATED = ("l_quantity", "l_extendedprice", "l_discount",
                    "l_shipdate", "l_returnflag")


def zipfian_draws(n_keys: int, count: int, cap: int, nprng) -> np.ndarray:
    """``count`` key indexes drawn zipfian (constant ZIPFIAN_THETA, ranks
    scrambled across the keys by a permutation) with no key drawn more
    than ``cap`` times: draws past the cap are drawn again."""
    cdf = np.cumsum(1.0 / np.arange(1, n_keys + 1) ** ZIPFIAN_THETA)
    cdf /= cdf[-1]
    rank_to_key = nprng.permutation(n_keys)
    out = np.zeros(0, np.int64)
    while out.size < count:
        ranks = np.searchsorted(cdf, nprng.random(count - out.size),
                                side="right")
        out = np.concatenate([out, rank_to_key[np.minimum(ranks,
                                                          n_keys - 1)]])
        order = np.argsort(out, kind="stable")
        srt = out[order]
        first = np.searchsorted(srt, srt, side="left")
        seen = np.empty_like(out)
        seen[order] = np.arange(out.size) - first  # earlier draws of the key
        out = out[seen < cap]
    return out


def make_lineitem_updates(schema: Schema, keys: list[bytes], max_ht: int,
                          count: int, seed: int = 5) -> tuple[list, dict]:
    """(updates, their arrays) over the rows whose keys are ``keys``:
    ``count`` one-field updates, in order at hybrid times max_ht + 1, +2,
    ... Keys are drawn zipfian (constant 0.99, as ``make_update_rows``),
    a key at MAX_VERSIONS versions drawing again; the field is one of
    LINEITEM_UPDATED, evenly; its value is drawn from the generator's
    distribution of that field. The arrays: ``row`` (index into
    ``keys``), ``ht``, ``field`` (index into LINEITEM_UPDATED) and
    ``value`` (object)."""
    nprng = np.random.default_rng(seed)
    row = zipfian_draws(len(keys), count, MAX_VERSIONS - 1, nprng)
    field = nprng.integers(0, len(LINEITEM_UPDATED), count)
    pool = generate_lineitem(count, seed + 1)
    value = np.empty(count, object)
    for f, name in enumerate(LINEITEM_UPDATED):
        at = field == f
        value[at] = pool[name][at]
    value = value.tolist()
    cids = [schema.column(name).col_id for name in LINEITEM_UPDATED]
    ht = max_ht + 1 + np.arange(count, dtype=np.int64)
    updates = [RowVersion(keys[k], ht=h, columns={cids[f]: v})
               for k, h, f, v in zip(row.tolist(), ht.tolist(),
                                     field.tolist(), value)]
    return updates, {"row": row, "ht": ht, "field": field, "value": value}


DISC_PRICE = BinOp("*", Col("l_extendedprice"),
                   BinOp("-", Const(100), Col("l_discount")))
CHARGE = BinOp("*", DISC_PRICE, BinOp("+", Const(100), Col("l_tax")))


def q1_spec(read_ht: int, ship_cutoff: int = 10471) -> ScanSpec:
    """TPC-H Q1 as one pushed-down grouped scan (avg lowers to sum and
    count above the scan)."""
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


def q6_spec(read_ht: int, date_lo: int = 9131, discount: int = 6,
            quantity: int = 24) -> ScanSpec:
    """TPC-H Q6: sum(l_extendedprice * l_discount) under date, discount
    and quantity bands."""
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
