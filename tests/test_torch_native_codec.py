"""The port's native codec (``yugabyte_db_tpu_torch/native``) against the
JAX package's codecs.

The port builds its own ``yb_codec`` from its own copy of
``native/codec.cc`` / ``tagcodec.h``; ``utils/codec.py`` dispatches to it
and keeps the pure-Python codec as its plain version. For every value
(hypothesis: integers past 2^64, which take the ``OverflowError`` route,
floats with NaN and -0.0, strings, bytes, nested lists and maps, rich
scalars as ``X`` extension values) the port's native bytes must equal the
JAX native ``yb_codec``'s, the JAX pure-Python codec's and the port's
pure-Python codec's, and decode back. A WAL segment and a run file
written through the native path read back in the JAX package, and the
other way round. Tolerance: none, every byte exact.
"""

from __future__ import annotations

import datetime
import decimal
import os
import re
import subprocess
import sys
import uuid

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import test_torch_data as D
from yugabyte_db_tpu.native import yb_codec as j_native
from yugabyte_db_tpu.storage import run_io as j_run_io
from yugabyte_db_tpu.storage import wire as j_wire
from yugabyte_db_tpu.storage.row_version import RowVersion as JRow
from yugabyte_db_tpu.tablet import wal as j_wal
from yugabyte_db_tpu.utils import codec as j_codec
from yugabyte_db_tpu_torch import native
from yugabyte_db_tpu_torch.storage import run_io as t_run_io
from yugabyte_db_tpu_torch.storage import wire as t_wire
from yugabyte_db_tpu_torch.storage.row_version import RowVersion as TRow
from yugabyte_db_tpu_torch.tablet import Log, LogEntry, OpId
from yugabyte_db_tpu_torch.utils import codec as t_codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def t_native():
    mod = native.yb_codec()
    assert mod is not None, native.build_error
    assert t_codec.native_loaded()
    return mod


def scalars():
    return st.one_of(
        st.none(), st.booleans(),
        st.integers(min_value=-(2 ** 70), max_value=2 ** 70),
        st.integers(min_value=-(2 ** 63), max_value=2 ** 64),
        st.floats(allow_nan=True, allow_infinity=True),
        st.sampled_from([0.0, -0.0, float("nan"), float("inf")]),
        st.text(), st.binary(),
        st.decimals(allow_nan=False, allow_infinity=False, places=3),
        st.uuids(), st.dates(), st.times())


def keys():
    return st.one_of(st.integers(min_value=-(2 ** 66), max_value=2 ** 66),
                     st.text(max_size=8), st.binary(max_size=8), st.none(),
                     st.booleans())


VALUES = st.recursive(
    scalars(),
    lambda inner: st.one_of(st.lists(inner, max_size=6),
                            st.tuples(inner, inner),
                            st.dictionaries(keys(), inner, max_size=5)),
    max_leaves=30)


@settings(max_examples=300, deadline=None)
@given(VALUES)
def test_native_encode_equals_every_codec(t_native, v):
    got = t_codec.encode(v)
    assert got == j_codec._py_encode(v) == t_codec._py_encode(v)
    if not _wide(v):
        assert got == j_native.encode(v)
    assert got == j_codec.encode(v)
    # decode round-trips: the same value as the JAX decoders give, and the
    # same bytes again (NaN is not equal to itself).
    back = t_codec.decode(got)
    assert t_codec.encode(back) == got
    assert t_codec._py_encode(t_codec._py_decode(got)) == got
    assert j_codec._py_encode(j_codec.decode(got)) == got


def _wide(v) -> bool:
    """Whether an int past the 64-bit varint sits somewhere in ``v`` (the
    JAX native codec raises OverflowError there, as the port's does)."""
    if type(v) is int:
        z = (v << 1) if v >= 0 else ((-v - 1) << 1) | 1
        return z >= 1 << 64
    if isinstance(v, (list, tuple)):
        return any(_wide(x) for x in v)
    if isinstance(v, dict):
        return any(_wide(k) or _wide(x) for k, x in v.items())
    return False


@pytest.mark.parametrize("v", [2 ** 64, -(2 ** 64) - 1, 2 ** 80,
                               [1, {"x": -(2 ** 90)}]])
def test_wide_integers_take_the_python_route(t_native, v):
    with pytest.raises(OverflowError):
        t_native.encode(v)
    got = t_codec.encode(v)
    assert got == j_codec.encode(v) == t_codec._py_encode(v)
    assert t_codec.decode(got) == v
    with pytest.raises(OverflowError):
        t_native.decode(got)


@pytest.mark.parametrize("v", [None, 7, "s", [1, 2], {"a": b"b"},
                               decimal.Decimal("1.5"), uuid.UUID(int=9),
                               datetime.date(2020, 1, 2)])
def test_trailing_bytes_raise(t_native, v):
    buf = t_codec.encode(v) + b"\x00"
    for dec in (t_native.decode, t_codec._py_decode, t_codec.decode):
        with pytest.raises(ValueError, match="trailing"):
            dec(buf)


def test_bad_tag_and_truncation_raise(t_native):
    with pytest.raises(ValueError):
        t_native.decode(b"\x0f")
    with pytest.raises(ValueError):
        t_native.decode(t_codec.encode("abcdef")[:-2])
    with pytest.raises(TypeError):
        t_native.encode(object())


def port_rows(n: int = 120, seed: int = 5) -> list:
    schema = D.make_schema(D.PORT, "rows")
    rows, _ = D.flat_rows(D.PORT, schema, n, seed)
    return [TRow(r.key, ht=r.ht, tombstone=r.tombstone, liveness=r.liveness,
                 columns=dict(r.columns), expire_ht=r.expire_ht,
                 write_id=i % 3) for i, r in enumerate(rows)]


def as_jax(rows):
    return [JRow(r.key, ht=r.ht, tombstone=r.tombstone, liveness=r.liveness,
                 columns=dict(r.columns), expire_ht=r.expire_ht,
                 ttl_us=r.ttl_us, write_id=r.write_id) for r in rows]


def fields(r) -> tuple:
    return (r.key, r.ht, r.tombstone, r.liveness, r.columns, r.expire_ht,
            r.write_id)


def test_wal_segments_cross_packages(tmp_path, t_native):
    """A WAL written by the port (native codec) reads in the JAX package,
    and one the JAX package wrote reads in the port; the segments are
    equal byte for byte."""
    rows = port_rows()
    jrows = as_jax(rows)
    port = Log(str(tmp_path / "port"), 2048, fsync=False)
    jax = j_wal.Log(str(tmp_path / "jax"), 2048, fsync=False)
    for i in range(0, len(rows), 8):
        port.append(LogEntry(OpId(2, i + 1), 500 + i, "write",
                             t_wire.encode_rows(rows[i:i + 8]), committed=i))
        jax.append(j_wal.LogEntry(j_wal.OpId(2, i + 1), 500 + i, "write",
                                  j_wire.encode_rows(jrows[i:i + 8]),
                                  committed=i))
    port.close()
    jax.close()
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(names) > 1 and names == sorted(os.listdir(tmp_path / "jax"))
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    theirs = list(j_wal.Log(str(tmp_path / "port"), fsync=False).read_all())
    mine = list(Log(str(tmp_path / "jax"), fsync=False).read_all())
    assert [fields(r) for e in theirs for r in j_wire.decode_rows(e.body)] \
        == [fields(r) for e in mine for r in t_wire.decode_rows(e.body)] \
        == [fields(r) for r in rows]


def test_run_files_cross_packages(tmp_path, t_native):
    """A run file saved through the native route (``encode_run``) reads in
    the JAX package and equals its file and the pure-Python codec's bytes
    of the record lists; the JAX file loads in the port as the
    pure-Python decoder reads it."""
    rows = port_rows(200, seed=8)
    entries = sorted(((r.key, [r]) for r in rows), key=lambda e: e[0])
    t_run_io.save_run(str(tmp_path / "port.dat"), entries)
    j_run_io.save_run(str(tmp_path / "jax.dat"),
                      [(k, as_jax(vs)) for k, vs in entries])
    buf = (tmp_path / "port.dat").read_bytes()
    assert buf == (tmp_path / "jax.dat").read_bytes()
    payload = [[k, [[v.ht, v.tombstone, v.liveness,
                     {str(c): x for c, x in v.columns.items()},
                     v.expire_ht, v.write_id] for v in vs]]
               for k, vs in entries]
    assert buf == t_codec._py_encode(["run1", payload])
    theirs = j_run_io.load_run(str(tmp_path / "port.dat"))
    mine = t_run_io.load_run(str(tmp_path / "jax.dat"))
    magic, recs = t_codec._py_decode(buf)
    assert magic == "run1"
    py = [(k, [TRow.stored(k, r[0], r[1], r[2],
                           {int(c): x for c, x in r[3].items()}, r[4], r[5])
               for r in rs]) for k, rs in recs]
    assert [(k, [fields(v) for v in vs]) for k, vs in theirs] == \
        [(k, [fields(v) for v in vs]) for k, vs in mine] == \
        [(k, [fields(v) for v in vs]) for k, vs in py] == \
        [(k, [fields(v) for v in vs]) for k, vs in entries]
    # Another magic or an older record layout is left to ``decode``.
    assert t_codec.decode_run(buf, "run2", TRow.stored) is None
    old = t_codec.encode(["run1", [[rows[0].key, [[1, False, True, {}, 0]]]]])
    assert t_codec.decode_run(old, "run1", TRow.stored) is None


def test_run_file_past_64_bits_takes_the_python_codec(tmp_path, t_native):
    """A column value past 64 bits makes the native codec overflow:
    ``encode_run`` / ``decode_run`` then take the pure-Python codec, give
    the JAX file's bytes and read back the same versions."""
    rows = port_rows(40, seed=9)
    col = next(iter(rows[0].columns))
    rows[0].columns[col] = 2 ** 70 + 3
    rows[1].columns[col] = -(2 ** 66)
    entries = sorted(((r.key, [r]) for r in rows), key=lambda e: e[0])
    with pytest.raises(OverflowError):
        t_native.encode(rows[0].columns[col])
    t_run_io.save_run(str(tmp_path / "port.dat"), entries)
    j_run_io.save_run(str(tmp_path / "jax.dat"),
                      [(k, as_jax(vs)) for k, vs in entries])
    buf = (tmp_path / "port.dat").read_bytes()
    assert buf == (tmp_path / "jax.dat").read_bytes()
    got = t_codec.decode_run(buf, "run1", TRow.stored)
    assert [(k, [fields(v) for v in vs]) for k, vs in got] == \
        [(k, [fields(v) for v in vs]) for k, vs in entries]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_native_codec_keeps_its_own_rich_scalars(first):
    """Both native codecs in one process, either loaded and used first:
    each encodes its own package's rich scalars and decodes them into
    its own package's classes (the two extensions share no symbol)."""
    code = f"""
import yugabyte_db_tpu.models.datatypes as jd
import yugabyte_db_tpu_torch.models.datatypes as td
from yugabyte_db_tpu.native import yb_codec as jn
from yugabyte_db_tpu_torch import native
tn = native.yb_codec()
sides = [(jn, jd), (tn, td)]
if {first!r} == "port":
    sides.reverse()
import uuid
for mod, dt in sides:
    vals = [dt.Inet("10.1.2.3"),
            dt.TimeUuid(uuid.UUID("6ba7b810-9dad-11d1-80b4-00c04fd430c8"))]
    for v in vals:
        back = mod.decode(mod.encode([v]))[0]
        assert type(back) is type(v), (mod, type(back), type(v))
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_name_no_path_of_the_jax_package():
    src = os.path.join(ROOT, "yugabyte_db_tpu_torch", "native")
    names = sorted(n for n in os.listdir(src) if n.endswith((".cc", ".h")))
    assert names == ["codec.cc", "tagcodec.h"]
    for n in names:
        text = open(os.path.join(src, n)).read()
        assert not re.search(r"yugabyte_db_tpu(?!_torch)", text), n


def test_importing_builds_nothing():
    """The loader builds at the first encode or decode, never at import
    (the import guard imports every module on hosts with no compiler)."""
    code = ("import yugabyte_db_tpu_torch.native as n, "
            "yugabyte_db_tpu_torch.utils.codec as c; "
            "print(n._module is n._UNBUILT and c._native is c._UNRESOLVED)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "True"


def test_build_name_carries_the_sources_hash(t_native):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert re.fullmatch(r"yb_codec-[0-9a-f]{16}\..*\.so", path.name)
