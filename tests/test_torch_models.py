"""The port's data model and columnar build against the JAX package's.

Doc keys and partition hash codes must be byte-identical, and the port's
``ColumnarRun.build`` must give planes ``np.array_equal`` to the JAX
package's on the same entries (NULLs, unset columns, tombstones, TTLs),
which is what lets the differential tests feed both sides one plane set.
"""

import numpy as np
import pytest

import __graft_entry__
from test_torch_data import (JAX, PORT, build_run, encode_key, flat_rows,
                             make_schema)
from yugabyte_db_tpu_torch import workload

TABLES = ["pallas", "bench", "mixed"]
PLANES = ("key_planes", "ht_hi", "ht_lo", "exp_hi", "exp_lo", "tomb",
          "live", "valid", "group_start")


@pytest.mark.parametrize("table", TABLES)
def test_keys_and_hash_codes_byte_identical(table):
    js, ps = make_schema(JAX, table), make_schema(PORT, table)
    for i in range(0, 3000, 7):
        assert encode_key(JAX, js, i) == encode_key(PORT, ps, i)
        hashed = {c.name: f"u{i:05d}" for c in js.hash_columns}
        assert JAX.partition.compute_hash_code(js, hashed) == \
            PORT.partition.compute_hash_code(ps, hashed)


def test_bench_workload_matches_graft_entry():
    js = __graft_entry__._make_schema()
    ps = workload.make_schema()
    assert [(c.name, int(c.dtype), c.col_id) for c in js.columns] == \
        [(c.name, int(c.dtype), c.col_id) for c in ps.columns]
    jrows, jht = __graft_entry__._make_rows(js, 500)
    prows, pht = workload.make_rows(ps, 500)
    assert jht == pht
    assert [(r.key, r.ht, r.tombstone, r.liveness, r.columns)
            for r in jrows] == [(r.key, r.ht, r.tombstone, r.liveness,
                                 r.columns) for r in prows]


@pytest.mark.parametrize("table,n,R", [("pallas", 700, 128),
                                       ("bench", 1000, 128),
                                       ("mixed", 900, 64)])
def test_columnar_build_planes_equal(table, n, R):
    js, ps = make_schema(JAX, table), make_schema(PORT, table)
    jrows, _ = flat_rows(JAX, js, n, seed=n)
    prows, _ = flat_rows(PORT, ps, n, seed=n)
    jrun = build_run(JAX, js, jrows, R)
    prun = build_run(PORT, ps, prows, R)
    assert (jrun.B, jrun.R, jrun.num_versions, jrun.max_group_versions,
            jrun.max_key_len, jrun.max_ht) == \
        (prun.B, prun.R, prun.num_versions, prun.max_group_versions,
         prun.max_key_len, prun.max_ht)
    assert prun.max_group_versions == 1
    for name in PLANES:
        assert np.array_equal(getattr(jrun, name), getattr(prun, name)), name
    assert jrun.cols.keys() == prun.cols.keys()
    for cid, jc in jrun.cols.items():
        pc = prun.cols[cid]
        assert np.array_equal(jc.set_, pc.set_)
        assert np.array_equal(jc.isnull, pc.isnull)
        assert np.array_equal(jc.cmp_planes, pc.cmp_planes)
        assert (jc.arith is None) == (pc.arith is None)
        if jc.arith is not None:
            assert np.array_equal(jc.arith, pc.arith)
    # Exact key location agrees.
    for row in range(0, jrun.total_rows(), 37):
        key = jrun.key_at(row)
        assert prun.key_at(row) == key
        assert prun.lower_row(key) == jrun.lower_row(key)
        assert prun.upper_row(key + b"\x00") == jrun.upper_row(key + b"\x00")
