"""Shared inputs of the PyTorch-port differential tests, and their checks.

The other ``test_torch_*.py`` files import their tables, rows and plane
trees from here. Every table and row set is built twice from one seed:
once with the JAX package's data model and once with the port's, so that
a test feeds both sides the same bytes. ``flat_rows`` gives flat runs
(one version per key) with tombstones, NULLs, unset columns, UPDATE-only
rows (no liveness) and TTLs that expire inside the history;
``multiversion_rows`` gives multi-version histories, ``layered_rows``
layers of ``flat_rows`` over the same keys (the row path's multi-version
runs, on the ``rows`` table with a FLOAT and a STRING value column).
"""

from __future__ import annotations

import contextlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

import yugabyte_db_tpu.models.partition as j_partition
import yugabyte_db_tpu.models.schema as j_schema
import yugabyte_db_tpu.storage.columnar as j_columnar
import yugabyte_db_tpu.storage.memtable as j_memtable
import yugabyte_db_tpu.storage.row_version as j_row_version
import yugabyte_db_tpu_torch.models.partition as t_partition
import yugabyte_db_tpu_torch.models.schema as t_schema
import yugabyte_db_tpu_torch.storage.columnar as t_columnar
import yugabyte_db_tpu_torch.storage.memtable as t_memtable
import yugabyte_db_tpu_torch.storage.row_version as t_row_version

JAX = SimpleNamespace(schema=j_schema, partition=j_partition,
                      columnar=j_columnar, memtable=j_memtable,
                      row_version=j_row_version)
PORT = SimpleNamespace(schema=t_schema, partition=t_partition,
                       columnar=t_columnar, memtable=t_memtable,
                       row_version=t_row_version)

MAX_HT = t_row_version.MAX_HT

# (name, DataType name, ColumnKind name).
TABLES = {
    "pallas": [("k", "STRING", "HASH"), ("a", "INT64", "REGULAR"),
               ("d", "INT32", "REGULAR")],
    "bench": [("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
              ("a", "INT64", "REGULAR"), ("c", "DOUBLE", "REGULAR"),
              ("d", "INT32", "REGULAR")],
    "mixed": [("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
              ("a", "INT64", "REGULAR"), ("b", "STRING", "REGULAR"),
              ("c", "DOUBLE", "REGULAR"), ("d", "INT32", "REGULAR")],
    # The row path's table: every predicate kind (i32, i64, f64, and the
    # superset kinds str and f32).
    "rows": [("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
             ("a", "INT64", "REGULAR"), ("b", "STRING", "REGULAR"),
             ("c", "DOUBLE", "REGULAR"), ("d", "INT32", "REGULAR"),
             ("f", "FLOAT", "REGULAR")],
    # tests/test_breaker.py's and tests/test_residency.py's tables.
    "breaker": [("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
                ("a", "INT64", "REGULAR"), ("b", "STRING", "REGULAR")],
    "residency": [("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
                  ("a", "INT64", "REGULAR"), ("b", "STRING", "REGULAR"),
                  ("c", "DOUBLE", "REGULAR")],
}

# FLOAT values: signed zeros, and pairs that are equal once rounded to
# float32 (16777217 and 16777216; 0.1 and its float32) but not as stored.
FLOATS = [0.0, -0.0, 0.5, 1.25, -3.0, 7.75, 0.1, float(np.float32(0.1)),
          16777216.0, 16777217.0, -16777217.0]


def make_schema(side, table: str):
    S = side.schema
    DataType = S.DataType
    return S.Schema([S.ColumnSchema(name, getattr(DataType, dt),
                                    getattr(S.ColumnKind, kind))
                     for name, dt, kind in TABLES[table]],
                    table_id=f"torch_{table}")


def encode_key(side, schema, i: int) -> bytes:
    kv = {}
    for c in schema.key_columns:
        kv[c.name] = f"u{i:05d}" if c.dtype.name == "STRING" else i % 7
    hashed = {c.name: kv[c.name] for c in schema.hash_columns}
    return schema.encode_primary_key(
        kv, side.partition.compute_hash_code(schema, hashed))


def _value(rng: random.Random, dtype_name: str):
    if dtype_name == "INT64":
        return rng.randrange(-10**14, 10**14)
    if dtype_name == "INT32":
        return rng.randrange(-10**6, 10**6)
    if dtype_name == "DOUBLE":
        return rng.uniform(0.0, 100.0)
    if dtype_name == "FLOAT":
        return rng.choice(FLOATS)
    return rng.choice(["xy", "xyz", "zz", "commonprefix-aa",
                       "commonprefix-ab"])


def flat_rows(side, schema, n: int, seed: int):
    """(rows, max_ht): one RowVersion per key in ``side``'s classes."""
    RowVersion = side.row_version.RowVersion
    rng = random.Random(seed)
    ht = 100
    rows = []
    for i in range(n):
        key = encode_key(side, schema, i)
        ht += rng.randrange(1, 4)
        roll = rng.random()
        if roll < 0.06:
            rows.append(RowVersion(key, ht=ht, tombstone=True))
            continue
        cols = {}
        for c in schema.value_columns:
            r = rng.random()
            if r < 0.07:
                cols[c.col_id] = None
            elif r >= 0.15:
                cols[c.col_id] = _value(rng, c.dtype.name)
        expire = ht + rng.randrange(1, 400) if rng.random() < 0.08 \
            else MAX_HT
        rows.append(RowVersion(key, ht=ht, liveness=roll < 0.85,
                               columns=cols, expire_ht=expire))
    return rows, ht


def multiversion_rows(side, schema, n: int = 900, nkeys: int = 120,
                      seed: int = 3, hot: float = 0.0):
    """(rows, max_ht): a history of ``n`` writes to ``nkeys`` keys of the
    bench table in ``side``'s classes, in the style of
    ``tests/test_seg_fold.py``: full-row INSERTs (some with a TTL that
    expires inside the history, some d NULL), one-column UPDATEs (some
    NULL) and DELETEs, a third of them followed by a write at the same
    hybrid time that lands before or after the tombstone in the layout.
    ``hot`` is the share of writes that go to key 0."""
    RowVersion = side.row_version.RowVersion
    rng = random.Random(seed)
    cid = {c.name: c.col_id for c in schema.value_columns}
    keys = [encode_key(side, schema, i) for i in range(nkeys)]
    ht = 0
    rows = []
    for _ in range(n):
        ht += rng.randrange(1, 3)
        key = keys[0] if rng.random() < hot else keys[rng.randrange(nkeys)]
        roll = rng.random()
        if roll < 0.12:
            rows.append(RowVersion(key, ht=ht, tombstone=True))
            if rng.random() < 0.33:
                rows.append(RowVersion(
                    key, ht=ht, liveness=True, write_id=rng.randrange(2),
                    columns={cid["a"]: rng.randrange(-10**9, 10**9)}))
        elif roll < 0.7:
            rows.append(RowVersion(
                key, ht=ht, liveness=True,
                columns={cid["a"]: rng.randrange(-10**12, 10**12),
                         cid["c"]: rng.uniform(-1e6, 1e6),
                         cid["d"]: rng.choice(
                             [None, rng.randrange(-10**6, 10**6)])},
                expire_ht=(ht + rng.randrange(5, 500)
                           if rng.random() < 0.1 else MAX_HT)))
        else:
            col = rng.choice(["a", "c", "d"])
            val = {"a": rng.randrange(-10**10, 10**10),
                   "c": rng.uniform(-100, 100),
                   "d": rng.randrange(-1000, 1000)}[col]
            rows.append(RowVersion(key, ht=ht, columns={
                cid[col]: None if rng.random() < 0.1 else val}))
    return rows, ht


def layered_rows(side, schema, layers=(500, 300, 150), seed: int = 5):
    """(rows, max_ht): ``flat_rows`` layers over the same keys (layer i
    writes keys 0 .. layers[i] - 1), each layer's hybrid times (and TTLs)
    after the previous layer's: a multi-version history of up to
    len(layers) versions a key, with tombstones, NULLs, UPDATE-only rows
    and TTLs in every layer."""
    RowVersion = side.row_version.RowVersion
    out, top = [], 0
    for i, n in enumerate(layers):
        rows, ht = flat_rows(side, schema, n, seed=seed + i)
        out += [RowVersion(r.key, ht=r.ht + top, tombstone=r.tombstone,
                           liveness=r.liveness, columns=r.columns,
                           expire_ht=(r.expire_ht if r.expire_ht == MAX_HT
                                      else r.expire_ht + top))
                for r in rows]
        top += ht
    return out, top


def overlay_history(side, schema, flat: bool, seed: int = 7,
                    nbase: int = 1500, nkeys: int = 250, waves: int = 3,
                    per_wave: int = 120, hot: int = 0):
    """(base rows, [rows of each wave], max_ht) of the bench table in
    ``side``'s classes, in ``tests/test_overlay.py``'s ``_setup`` shape:
    keys (k in ``nkeys`` names) x (r in 0..5). The base is the primary
    run: on a flat one (``flat``) one full-row write to each of ``nbase``
    keys; on a multi-version one ``nbase`` full-row writes to
    (k_{i % nkeys}, i % 6), plus ``hot`` one-column updates of key
    (k0000, 0), a group past 32 versions when ``hot`` > 31. Each wave
    writes ``per_wave`` keys drawn from the whole key space (the first
    write of the first wave goes to the hot key): 15% DELETEs, 15% NULL
    writes of d, the rest a new d."""
    RowVersion = side.row_version.RowVersion
    cid = {c.name: c.col_id for c in schema.value_columns}

    def enc(k, r):
        return schema.encode_primary_key(
            {"k": k, "r": r},
            side.partition.compute_hash_code(schema, {"k": k}))

    rnd = random.Random(seed)
    ht = 0
    base = []
    for i in range(nbase):
        ht += 1
        r = (i // nkeys) % 6 if flat else i % 6
        base.append(RowVersion(
            enc(f"k{i % nkeys:04d}", r), ht=ht, liveness=True,
            columns={cid["a"]: rnd.randrange(-10**12, 10**12),
                     cid["c"]: rnd.uniform(-1e6, 1e6),
                     cid["d"]: rnd.randrange(-10**6, 10**6)}))
    for _ in range(hot):
        ht += 1
        base.append(RowVersion(enc("k0000", 0), ht=ht, columns={
            cid["a"]: rnd.randrange(-10**12, 10**12)}))
    out = []
    for w in range(waves):
        batch = []
        for j in range(per_wave):
            ht += 1
            k = enc(f"k{rnd.randrange(nkeys):04d}", rnd.randrange(6))
            if hot and w == j == 0:
                k = enc("k0000", 0)
            roll = rnd.random()
            if roll < 0.15:
                batch.append(RowVersion(k, ht=ht, tombstone=True))
            elif roll < 0.3:
                batch.append(RowVersion(k, ht=ht, columns={cid["d"]: None}))
            else:
                batch.append(RowVersion(k, ht=ht, columns={
                    cid["d"]: rnd.randrange(-10**6, 10**6)}))
        out.append(batch)
    return base, out, ht


def build_run(side, schema, rows, rows_per_block: int):
    mem = side.memtable.MemTable()
    mem.apply(rows)
    return side.columnar.ColumnarRun.build(schema, mem.drain_sorted(),
                                           rows_per_block)


@contextlib.contextmanager
def plane_encoding(setting: str):
    """The JAX package's runs upload under ``tpu_plane_encoding``
    ``setting`` inside, and the port's engines made inside default to
    ``plane_encoding`` ``setting``: both packages run one deployment
    ("off": plain planes; "auto": each package's default, encoded)."""
    from yugabyte_db_tpu.utils.flags import FLAGS
    from yugabyte_db_tpu_torch.storage import gpu_engine

    old = FLAGS.get("tpu_plane_encoding")
    old_port = gpu_engine.DEFAULT_PLANE_ENCODING
    FLAGS.set("tpu_plane_encoding", setting)
    gpu_engine.DEFAULT_PLANE_ENCODING = setting
    try:
        yield
    finally:
        FLAGS.set("tpu_plane_encoding", old)
        gpu_engine.DEFAULT_PLANE_ENCODING = old_port


def plain_planes():
    """Both packages run the plain deployment (``plane_encoding("off")``)."""
    return plane_encoding("off")


def reference_planes(jax_crun, window_blocks: int) -> dict:
    """The JAX package's DeviceRun.arrays of ``jax_crun``, as numpy."""
    import jax

    from yugabyte_db_tpu.ops.device_run import DeviceRun

    with plain_planes():
        dev = DeviceRun(jax_crun, window_blocks)
    return jax.tree.map(np.asarray, jax.device_get(dev.arrays))


def read_planes(P, read_ht: int) -> tuple:
    """(read hi, read lo, expiry hi, expiry lo) of a read point."""
    r = P.scalar_ht_planes(min(read_ht, MAX_HT))
    e = P.scalar_ht_planes(min(read_ht, MAX_HT - 1))
    return (*r, *e)


def build_spec(S, kwargs):
    """``S.ScanSpec`` of keyword arguments with (fn, column) aggregates and
    (column, op, value) predicates (``S``: either package's storage)."""
    kw = dict(kwargs)
    kw["aggregates"] = [S.AggSpec(fn, col) for fn, col in kw["aggregates"]]
    kw["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
    return S.ScanSpec(**kw)


APPROX = ("sum(c)", "avg(c)", "avg(a)", "avg(d)")


def assert_same(want, got, label, scanned=True):
    """The same columns and rows (float sums and averages within rel 1e-4
    / abs 1e-4, the tolerance of ``tests/test_engine_diff.py``), and the
    same ``rows_scanned`` unless ``scanned`` is False."""
    assert got.columns == want.columns, label
    assert len(got.rows) == len(want.rows) == 1, label
    for name, w, g in zip(want.columns, want.rows[0], got.rows[0]):
        if name in APPROX and w is not None:
            assert g == pytest.approx(w, rel=1e-4, abs=1e-4), (label, name)
        else:
            assert g == w, (label, name)
    if scanned:
        assert got.rows_scanned == want.rows_scanned, label


@pytest.mark.parametrize("table", sorted(TABLES))
def test_both_sides_get_the_same_rows_in_every_state(table):
    js, ps = make_schema(JAX, table), make_schema(PORT, table)
    jrows, jht = flat_rows(JAX, js, 600, seed=9)
    prows, pht = flat_rows(PORT, ps, 600, seed=9)

    def fields(r):
        return (r.key, r.ht, r.tombstone, r.liveness, r.columns,
                r.expire_ht)

    assert jht == pht
    assert [fields(r) for r in jrows] == [fields(r) for r in prows]
    run = build_run(JAX, js, jrows, 64)
    assert run.max_group_versions == 1  # flat
    assert run.tomb.any()
    assert (run.valid & ~run.live & ~run.tomb).any()  # UPDATE-only rows
    assert any(c.isnull.any() for c in run.cols.values())
    assert any((run.valid & ~c.set_).any() for c in run.cols.values())
    assert (run.exp_hi != run.exp_hi.max()).any()  # TTLs


@pytest.mark.parametrize("hot", [0.0, 0.045])
def test_both_sides_get_the_same_multiversion_history(hot):
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jrows, jht = multiversion_rows(JAX, js, seed=4, hot=hot)
    prows, pht = multiversion_rows(PORT, ps, seed=4, hot=hot)

    def fields(r):
        return (r.key, r.ht, r.tombstone, r.liveness, r.columns,
                r.expire_ht, r.write_id)

    assert jht == pht
    assert [fields(r) for r in jrows] == [fields(r) for r in prows]
    run = build_run(PORT, ps, prows, 64)
    assert 1 < run.max_group_versions <= 64
    assert (run.max_group_versions > 32) == (hot > 0)
    # Same-hybrid-time DELETE + write pairs on both sides of the tombstone.
    ties = {(r.key, r.ht): r for r in prows if r.tombstone}
    writes = [r for r in prows if not r.tombstone and (r.key, r.ht) in ties]
    assert {w.write_id for w in writes} == {0, 1}
    assert any(v is None for r in prows for v in r.columns.values())
    assert (run.exp_hi != run.exp_hi.max()).any()  # TTLs


# -- GROUP BY and expression aggregates ----------------------------------------

# The table of tests/test_group_agg.py (a Q1-like lineitem slice) with a
# DOUBLE column beside it.
GROUP_TABLE = [("k", "STRING", "HASH"), ("flag", "STRING", "REGULAR"),
               ("status", "STRING", "REGULAR"), ("qty", "INT64", "REGULAR"),
               ("price", "INT64", "REGULAR"), ("disc", "INT8", "REGULAR"),
               ("tax", "INT8", "REGULAR"), ("d", "INT32", "REGULAR"),
               ("x", "DOUBLE", "REGULAR")]


def group_schema(side):
    S = side.schema
    return S.Schema([S.ColumnSchema(name, getattr(S.DataType, dt),
                                    getattr(S.ColumnKind, kind))
                     for name, dt, kind in GROUP_TABLE], table_id="li")


def group_rows(side, schema, num: int = 3000, seed: int = 7,
               with_nulls: bool = True, negatives: bool = False,
               versions: int = 1):
    """(rows, max_ht) in ``tests/test_group_agg.py``'s ``_load`` shape:
    ``versions`` full-row writes to each of ``num`` keys, flags A/N/R,
    statuses F/O, money in cents, discounts and taxes in percent; about
    5% of quantities NULL (``with_nulls``) and 1% of prices negative
    (``negatives``); x a double in [0, 100) with ~3% NULL."""
    RowVersion = side.row_version.RowVersion
    rng = random.Random(seed)
    cid = {c.name: c.col_id for c in schema.columns}
    ht = 10
    rows = []
    for i in range(num):
        key = schema.encode_primary_key(
            {"k": f"r{i:06d}"},
            side.partition.compute_hash_code(schema, {"k": f"r{i:06d}"}))
        for _v in range(versions):
            ht += 1
            price = rng.randrange(100, 10_000_00)
            if negatives and rng.random() < 0.01:
                price = -price
            cols = {
                cid["flag"]: rng.choice(["A", "N", "R"]),
                cid["status"]: rng.choice(["F", "O"]),
                cid["qty"]: rng.randrange(1, 51),
                cid["price"]: price,
                cid["disc"]: rng.randrange(0, 11),
                cid["tax"]: rng.randrange(0, 9),
                cid["d"]: rng.randrange(0, 1000),
                cid["x"]: (None if rng.random() < 0.03
                           else rng.uniform(0.0, 100.0)),
            }
            if with_nulls and rng.random() < 0.05:
                cols[cid["qty"]] = None
            rows.append(RowVersion(key, ht=ht, liveness=True, columns=cols))
    return rows, ht


def jax_rows(rows):
    """The JAX package's RowVersions of the port's ``rows`` (the same
    fields)."""
    RowVersion = j_row_version.RowVersion
    return [RowVersion(r.key, ht=r.ht, tombstone=r.tombstone,
                       liveness=r.liveness, columns=dict(r.columns),
                       expire_ht=r.expire_ht, write_id=r.write_id)
            for r in rows]


def assert_same_rows(want, got, label, scanned=True):
    """The same columns and rows, every value exact (grouped results),
    and the same ``rows_scanned`` unless ``scanned`` is False."""
    assert got.columns == want.columns, label
    assert got.rows == want.rows, label
    if scanned:
        assert got.rows_scanned == want.rows_scanned, label


def cpu_mini_cluster(data_root: str, **kwargs):
    """The port's ``MiniCluster``, its ``gpu`` tablets on CPU tensors:
    what the JAX cluster tests' ``MiniCluster(...)`` becomes in their
    port mirrors (``tests/test_torch_cluster*.py``)."""
    from yugabyte_db_tpu_torch.integration import MiniCluster

    kwargs.setdefault("engine_options", {"device": "cpu"})
    return MiniCluster(data_root, **kwargs)


def cpu_local_cluster(data_root: str | None = None, **kwargs):
    """The port's ``LocalCluster`` (the CQL processor's in-process
    cluster), its ``gpu`` tablets on CPU tensors: what the JAX CQL tests'
    ``LocalCluster(...)`` becomes in their port mirrors
    (``tests/test_torch_cql*.py``). Options the caller gives are kept;
    ``device`` is added to them."""
    from yugabyte_db_tpu_torch.yql.cql.processor import LocalCluster

    kwargs["engine_options"] = dict(kwargs.get("engine_options") or {},
                                    device="cpu")
    return LocalCluster(data_root, **kwargs)


class CqlWireClient:
    """A tiny CQL v4 client speaking raw frames through the port's
    ``wire_protocol`` (the JAX ``tests/test_cql_wire.py`` ``WireClient``):
    STARTUP, QUERY, PREPARE/EXECUTE with raw bound values, paging, and
    pipelined EXECUTEs in one write (``tests/test_serving_path.py``'s
    ``_CqlWire``)."""

    def __init__(self, host, port):
        import socket

        from yugabyte_db_tpu_torch.yql.cql import wire_protocol as W

        self.W = W
        self.sock = socket.create_connection((host, port), timeout=10)
        self.stream = 0

    def close(self):
        self.sock.close()

    def _send(self, opcode, body: bytes, stream=None):
        W = self.W
        s = self.stream if stream is None else stream
        self.sock.sendall(
            W.HEADER.pack(W.VERSION_REQ, 0, s, opcode, len(body)) + body)

    def _recv_frame(self):
        W = self.W
        hdr = self._recvn(W.HEADER.size)
        _version, _flags, stream, opcode, length = W.HEADER.unpack(hdr)
        return stream, opcode, self._recvn(length)

    def _recvn(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "connection closed"
            buf += chunk
        return buf

    def startup(self):
        W = self.W
        w = W.Writer()
        w.short(1)
        w.string("CQL_VERSION").string("3.4.4")
        self._send(W.OP_STARTUP, w.getvalue())
        _s, opcode, _b = self._recv_frame()
        assert opcode == W.OP_READY

    def query(self, cql, page_size=None, paging_state=None, values=None):
        W = self.W
        self.stream = (self.stream + 1) % 32000
        w = W.Writer().long_string(cql)
        self._query_params(w, values, page_size, paging_state)
        self._send(W.OP_QUERY, w.getvalue())
        return self._result()

    def prepare(self, cql):
        W = self.W
        self.stream = (self.stream + 1) % 32000
        self._send(W.OP_PREPARE, W.Writer().long_string(cql).getvalue())
        _stream, opcode, body = self._recv_frame()
        assert opcode == W.OP_RESULT, body
        r = W.Reader(body)
        assert r.int32() == W.RESULT_PREPARED
        stmt_id = r.short_bytes()
        flags = r.int32()
        ncols = r.int32()
        r.int32()  # pk count
        if flags & 0x0001:
            r.string()
            r.string()
        bind_types = []
        for _ in range(ncols):
            r.string()
            bind_types.append(r.short())
        return stmt_id, bind_types

    def execute(self, stmt_id, raw_values, page_size=None):
        W = self.W
        self.stream = (self.stream + 1) % 32000
        w = W.Writer().short_bytes(stmt_id)
        self._query_params(w, raw_values, page_size, None)
        self._send(W.OP_EXECUTE, w.getvalue())
        return self._result()

    def execute_many(self, frames):
        """frames: [(stream, stmt_id, [raw value bytes])], all sent in
        ONE write (the pipelined shape the server's batch path
        coalesces); returns {stream: (opcode, body)}, each reply frame
        verbatim."""
        W = self.W
        out = []
        for stream, stmt_id, values in frames:
            w = W.Writer().short_bytes(stmt_id)
            self._query_params(w, values, None, None)
            body = w.getvalue()
            out.append(W.HEADER.pack(W.VERSION_REQ, 0, stream,
                                     W.OP_EXECUTE, len(body)) + body)
        self.sock.sendall(b"".join(out))
        replies = {}
        for _ in range(len(frames)):
            stream, opcode, body = self._recv_frame()
            assert stream not in replies
            replies[stream] = (opcode, body)
        assert set(replies) == {f[0] for f in frames}
        return replies

    @staticmethod
    def _query_params(w, values, page_size, paging_state):
        flags = 0
        if values:
            flags |= 0x01
        if page_size is not None:
            flags |= 0x04
        if paging_state is not None:
            flags |= 0x08
        w.short(1).byte(flags)  # consistency ONE
        if values:
            w.short(len(values))
            for v in values:
                w.bytes_(v)
        if page_size is not None:
            w.int32(page_size)
        if paging_state is not None:
            w.bytes_(paging_state)

    def _result(self):
        W = self.W
        _stream, opcode, body = self._recv_frame()
        if opcode == W.OP_ERROR:
            r = W.Reader(body)
            code = r.int32()
            raise CqlWireError(code, r.string())
        assert opcode == W.OP_RESULT
        r = W.Reader(body)
        kind = r.int32()
        if kind in (W.RESULT_VOID, W.RESULT_SET_KEYSPACE,
                    W.RESULT_SCHEMA_CHANGE):
            return kind, None, None
        assert kind == W.RESULT_ROWS
        flags = r.int32()
        ncols = r.int32()
        paging = r.bytes_() if flags & 0x0002 else None
        if flags & 0x0001:
            r.string()
            r.string()
        cols = []
        for _ in range(ncols):
            name = r.string()
            cols.append((name, r.short()))
        nrows = r.int32()
        rows = [tuple(r.bytes_() for _ in range(ncols))
                for _ in range(nrows)]
        return cols, rows, paging


class CqlWireError(Exception):
    def __init__(self, code, message):
        super().__init__(message)
        self.code = code
