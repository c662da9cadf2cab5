"""The port's plane encodings (``ops.encodings``, ``ops.decode``) against
the JAX package's ``ops/encodings.py``, under its default
``tpu_plane_encoding`` "auto".

- The encoders and ``ColumnarRun.encoded_arrays`` give the JAX package's
  tree leaf for leaf and byte for byte, with ``enc_dicts`` and
  ``enc_stats``: every kind and every fallback (a span past 65535, more
  runs than R/8, R = 33, NaN and -0.0, a dictionary past
  ``DICT_MAX_VALUES``, patched small in both packages).
- The plain decode (``wplane`` / ``decode_leaf`` / ``decode_run``) equals
  the JAX one at several first blocks, on padded leaves; K10's plain
  version is ``decode_run`` with a dictionary's code plane split off, and
  equals the plain upload on the planes both have.
- ``DeviceRun``'s encoded upload equals the JAX ``DeviceRun``'s.
- The flush's codes route (``replay_flush_plain``) equals the JAX
  ``replay_flush`` with codes; ``_promote_code_preds`` equals the JAX
  engine's on every operator, absent literals included; K8's plain
  version on an encoded tree equals the JAX ``compiled_grouped`` on the
  same tree, code predicates included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yugabyte_db_tpu.ops.encodings as j_enc
import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.ops.encodings as t_enc
import yugabyte_db_tpu_torch.storage as T
from test_torch_data import (JAX, PORT, build_run, flat_rows, group_rows,
                             group_schema, jax_rows, make_schema,
                             multiversion_rows)
from test_torch_group_agg import Q1_AGGS, assert_same_buckets, build
from yugabyte_db_tpu.ops import flush as j_flush
from yugabyte_db_tpu.ops import group_agg as j_group_agg
from yugabyte_db_tpu.ops.device_run import DeviceRun as JDeviceRun
from yugabyte_db_tpu.storage import expr as JX
from yugabyte_db_tpu_torch.ops import decode, group_agg
from yugabyte_db_tpu_torch.ops import flush as t_flush
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
from yugabyte_db_tpu_torch.storage import expr as TX

PAD_BLOCKS = 64


def to_torch(leaf):
    """A numpy leaf (or tree) as torch tensors, u16 arrays as int16."""
    if isinstance(leaf, dict):
        return {k: to_torch(v) for k, v in leaf.items()}
    a = np.ascontiguousarray(np.asarray(leaf))
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a.copy())


def to_jax(leaf):
    if isinstance(leaf, dict):
        return {k: to_jax(v) for k, v in leaf.items()}
    return jnp.asarray(leaf)


def same_bytes(got, want, path=""):
    """Two trees (numpy, torch or JAX leaves) equal in names, shapes and
    bytes; a torch int16 array stands for a u16 one."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            same_bytes(got[k], want[k], f"{path}/{k}")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == np.uint16 and g.dtype == np.int16:
        g = g.view(np.uint16)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                        w.dtype)
    assert g.tobytes() == w.tobytes(), path


def planes(rng, B: int, R: int) -> dict:
    """Planes that select each encoding and each fallback."""
    nan_neg = np.array([np.nan, -0.0, 0.0, 1.5], np.float32)
    row = np.arange(B * R).reshape(B, R)
    steps = row // 16 * 1_000_000
    return {
        "bits": rng.random((B, R)) < 0.4,
        "bool_plain": np.zeros((B, R), bool),
        "const": np.full((B, R), -7, np.int32),
        "const2": np.full((B, R, 2), 3, np.int32),
        "delta16": (rng.integers(-(1 << 30), 1 << 30, (B, 1))
                    + rng.integers(0, 60_000, (B, R))).astype(np.int32),
        "span_rle": steps.astype(np.int32),  # span > 65535: rle
        "span_plain": rng.integers(-(1 << 31), (1 << 31) - 1, (B, R),
                                   dtype=np.int64).astype(np.int32),
        "rle2": rng.integers(-9, 9, (B * R, 2))[
            (row // 8).reshape(-1)].reshape(B, R, 2).astype(np.int32),
        "many_runs": (row % 2 * 70_000).astype(np.int32),
        "float_const": np.full((B, R), np.nan, np.float32),
        "float_negzero": np.full((B, R), -0.0, np.float32),
        "float_rle": nan_neg[row // 16 % 4],
        "float_plain": rng.random((B, R)).astype(np.float32),
    }


def encode(E, name, p):
    if p.dtype == bool:
        return E.encode_bool_plane(p)
    if p.dtype == np.float32:
        return E.encode_float_plane(p)
    return E.encode_int_plane(p)


@pytest.mark.parametrize("R", [64, 33])
def test_encoders_match_jax_leaf_for_leaf(R):
    rng = np.random.default_rng(3)
    for name, p in planes(rng, 5, R).items():
        got, want = encode(t_enc, name, p), encode(j_enc, name, p)
        assert t_enc.leaf_kind(got) == j_enc.leaf_kind(want), name
        same_bytes(got, want, name)
        assert t_enc.leaf_nbytes(got) == j_enc.leaf_nbytes(want)
        for pad_b in (5, 8):
            for ones in (False, True):
                if name.startswith("bool") or name == "bits" or not ones:
                    same_bytes(t_enc.pad_leaf(got, pad_b, ones),
                               j_enc.pad_leaf(want, pad_b, ones), name)
    if R == 64:
        kinds = {name: t_enc.leaf_kind(encode(t_enc, name, p))
                 for name, p in planes(rng, 5, R).items()}
        assert kinds["bits"] == "bits" and kinds["const"] == "const"
        assert kinds["delta16"] == "delta16" and kinds["rle2"] == "rle"
        assert kinds["span_rle"] == "rle" and kinds["span_plain"] is None
        assert kinds["many_runs"] is None and kinds["float_rle"] == "rle"
        assert kinds["float_const"] == kinds["float_negzero"] == "const"
    else:
        assert t_enc.encode_bits(planes(rng, 5, 33)["bits"]) is None


@pytest.mark.parametrize("b0,K", [(0, 8), (3, 2), (7, 1), (0, 1)])
def test_decode_matches_jax_on_padded_leaves(b0, K):
    rng = np.random.default_rng(4)
    for name, p in planes(rng, 5, 64).items():
        leaf = j_enc.pad_leaf(encode(j_enc, name, p), 8,
                              ones=name == "bits")
        want = np.asarray(j_enc.wplane(to_jax(leaf), b0, K, 64))
        got = t_enc.wplane(to_torch(leaf), b0, K, 64)
        same_bytes(got, want, name)
        same_bytes(t_enc.decode_leaf(to_torch(leaf), 8, 64),
                   np.asarray(j_enc.decode_leaf(to_jax(leaf), 8, 64)), name)
    codes = rng.integers(0, 3, (8, 64)).astype(np.uint16)
    codes[2, 5:9] = 3  # the absent slot
    leaf = j_enc.dict_leaf(codes, np.array([5, 6, 7, 0], np.int32),
                           np.array([-1, -2, -3, 0], np.int32))
    same_bytes(t_enc.wplane(to_torch(leaf), b0, K, 64),
               np.asarray(j_enc.wplane(to_jax(leaf), b0, K, 64)), "dict")


def table_runs(rows_per_block: int):
    """(port run, JAX run) pairs of the tables the checks below use: flat
    rows with tombstones, NULLs and TTLs, a multi-version history, and
    the grouped table (string flags, small integers)."""
    out = []
    for table, rows in (
            ("mixed", flat_rows(PORT, make_schema(PORT, "mixed"), 700, 5)[0]),
            ("rows", multiversion_rows(PORT, make_schema(PORT, "rows"))[0])):
        out.append((build_run(PORT, make_schema(PORT, table), rows,
                              rows_per_block),
                    build_run(JAX, make_schema(JAX, table), jax_rows(rows),
                              rows_per_block)))
    rows, _ht = group_rows(PORT, group_schema(PORT), 900)
    out.append((build_run(PORT, group_schema(PORT), rows, rows_per_block),
                build_run(JAX, group_schema(JAX), jax_rows(rows),
                          rows_per_block)))
    return out


@pytest.mark.parametrize("R", [64, 33])
def test_encoded_arrays_match_jax(R):
    for prun, jrun in table_runs(R):
        want = jrun.encoded_arrays()
        got = prun.encoded_arrays("auto")
        assert want is not None
        same_bytes(got, want)
        assert prun.enc_dicts == jrun.enc_dicts
        assert prun.enc_stats == jrun.enc_stats
        assert prun.encoded_arrays("auto") is got  # cached
        assert prun.encoded_arrays("off") is None
    kinds = {t_enc.leaf_kind(c["cmp"]) for prun, _j in table_runs(64)
             for c in prun.encoded_arrays("auto")["cols"].values()}
    assert "dict" in kinds


def test_dictionary_overflow_falls_back_in_both(monkeypatch):
    monkeypatch.setattr(t_enc, "DICT_MAX_VALUES", 2)
    monkeypatch.setattr(j_enc, "DICT_MAX_VALUES", 2)
    for prun, jrun in table_runs(64):
        same_bytes(prun.encoded_arrays("auto"), jrun.encoded_arrays())
        assert prun.enc_dicts == jrun.enc_dicts
        assert all(len(d) <= 2 for d in prun.enc_dicts.values())
        assert prun.enc_stats == jrun.enc_stats


def test_device_run_upload_matches_jax():
    for prun, jrun in table_runs(64):
        got = DeviceRun(prun, PAD_BLOCKS, device="cpu", setting="auto")
        want = JDeviceRun(jrun, PAD_BLOCKS)
        assert got.encoded and want.encoded
        same_bytes(got.arrays, jax.device_get(want.arrays))
        ref = DeviceRun.from_reference_planes(
            jax.device_get(want.arrays), 64, "cpu")
        same_bytes(ref.arrays, jax.device_get(want.arrays))
        assert ref.encoded and got.nbytes == ref.nbytes


def test_k10_plain_version_is_decode_run_and_the_plain_upload():
    for prun, jrun in table_runs(64):
        enc_arrays = DeviceRun(prun, PAD_BLOCKS, device="cpu",
                               setting="auto").arrays
        side = decode.decode_tree_plain(enc_arrays)
        assert decode.decode_tree(enc_arrays).keys() == side.keys()
        same_bytes(decode.decode_tree(enc_arrays), side)
        want = jax.device_get(j_enc.decode_run(
            jax.device_get(JDeviceRun(jrun, PAD_BLOCKS).arrays)))
        plain = DeviceRun(prun, PAD_BLOCKS, device="cpu", setting="off")
        B = prun.B  # a const leaf decodes its value into the pad blocks too

        def real(t):
            return t[:B]

        for name in ("valid", "group_start", "tomb", "live", "ht_hi",
                     "ht_lo", "exp_hi", "exp_lo"):
            same_bytes(side[name], want[name], name)
            same_bytes(real(side[name]), real(plain.arrays[name]), name)
        for cid, col in side["cols"].items():
            w = want["cols"][cid]
            if "code" in col:  # a dictionary column: three planes in JAX
                same_bytes(col["cmp"], np.ascontiguousarray(w["cmp"][..., :2]))
                same_bytes(col["code"], np.ascontiguousarray(w["cmp"][..., 2]))
            else:
                same_bytes(col["cmp"], w["cmp"])
            for n in col:
                if n != "code":
                    same_bytes(real(col[n]),
                               real(plain.arrays["cols"][cid][n]), (cid, n))
        assert decode.decode_bytes(enc_arrays) > 0


def k10_leaves(rng, B: int, R: int) -> dict:
    """Numpy leaves of a [B, R] run for K10's partition: every kind at
    [B, R] and [B, R, 2] (bits where R is a multiple of 32), floats, a
    dictionary with absent rows and one past K10's shared cap."""
    row = np.arange(B * R).reshape(B, R)
    run = R if R < 32 else 16
    leaves = {
        "const": j_enc.encode_int_plane(np.full((B, R), -7, np.int32)),
        "const2": j_enc.encode_int_plane(np.full((B, R, 2), 3, np.int32)),
        "delta16": j_enc.encode_delta16(
            (rng.integers(-(1 << 30), 1 << 30, (B, 1))
             + rng.integers(0, 60_000, (B, R))).astype(np.int32)),
        "delta16_2": j_enc.encode_delta16(
            (rng.integers(-(1 << 30), 1 << 30, (B, 1, 2))
             + rng.integers(0, 60_000, (B, R, 2))).astype(np.int32)),
        "rle": j_enc.encode_rle((row // run * 1_000_000).astype(np.int32)),
        "rle2": j_enc.encode_rle(rng.integers(-9, 9, (B * R, 2))[
            (row // run).reshape(-1)].reshape(B, R, 2).astype(np.int32)),
        "float_rle": j_enc.encode_rle(
            np.array([np.nan, -0.0, 0.0, 1.5], np.float32)[row // run % 4]),
        "dict": j_enc.dict_leaf(rng.integers(0, 4, (B, R)),
                                np.array([5, 6, 7, 0], np.int32),
                                np.array([-1, -2, -3, 0], np.int32)),
        "dict_big": j_enc.dict_leaf(
            rng.integers(0, 2048, (B, R)),
            rng.integers(-9, 9, 2048).astype(np.int32),
            rng.integers(-9, 9, 2048).astype(np.int32)),
    }
    if R % 32 == 0:
        leaves["bits"] = j_enc.encode_bool_plane(rng.random((B, R)) < 0.4)
    for name, leaf in leaves.items():
        assert j_enc.leaf_kind(leaf) == name.split("_")[0].rstrip("2") or \
            name == "float_rle", name
    return leaves


def item_units(first: list, units, item: int) -> tuple:
    """The part and the units [lo, hi) that work item ``item`` decodes,
    as csrc/decode.cu finds them (the last part whose first item is at or
    before it)."""
    part = max(p for p in range(len(units)) if first[p] <= item)
    lo = (item - first[part]) * decode.ITEM_UNITS
    return part, lo, min(lo + decode.ITEM_UNITS, int(units[part]))


# (blocks, R, padded blocks): a part of one unit; parts that end inside a
# 16-byte unit (tails) with a unit's words in two blocks of R rows; pad
# blocks; several work items a block of R rows.
K10_GEOMETRIES = ((1, 1, 1), (3, 7, 3), (5, 9, 5), (6, 64, 8), (2, 2048, 2))


@pytest.mark.parametrize("B,R,pad_b", K10_GEOMETRIES)
def test_k10_work_items_cover_each_unit_once(B, R, pad_b):
    """K10's partition: each part's 16-byte output units (a dictionary is
    two parts, its prefix pairs and its codes) are covered by exactly one
    work item, no item is empty, the outputs are 16-byte aligned and
    disjoint in one allocation, and only the dictionary within the cap
    goes to shared memory."""
    rng = np.random.default_rng(B * 1000 + R)
    leaves = [to_torch(j_enc.pad_leaf(leaf, pad_b, ones=name == "bits"))
              for name, leaf in k10_leaves(rng, B, R).items()]
    rows, outs, out_bytes, dict_bytes = decode.part_rows(leaves, pad_b, R)
    assert rows.shape == (len(leaves) + 2, decode.PART_WORDS)
    n = pad_b * R
    units = []
    for leaf in leaves:
        kind = t_enc.leaf_kind(leaf)
        if kind == "bits":
            units.append(n // 16)
        elif kind == "dict":
            units += [-(-2 * n // 4), -(-n // 4)]
        else:
            P = 2 if leaf[kind][{"const": "cval", "delta16": "doff",
                                  "rle": "rvals"}[kind]].dim() == 3 else 1
            units.append(-(-n * P // 4))
    assert list(rows[:, 1]) == units
    first = decode.work_items(rows[:, 1])
    assert list(rows[:, 5]) == first[:-1]
    seen = [np.zeros(u, np.int64) for u in units]
    for item in range(first[-1]):
        part, lo, hi = item_units(first, rows[:, 1], item)
        assert lo < hi <= units[part] and hi - lo <= decode.ITEM_UNITS
        seen[part][lo:hi] += 1
    assert all((s == 1).all() for s in seen)
    spans = sorted((o, o + int(np.prod(shape)) * torch.empty(
        0, dtype=dtype).element_size()) for planes in outs
        for o, shape, dtype in planes)
    assert all(a % 16 == 0 for a, _b in spans)
    assert all(b <= c for (_a, b), (c, _d) in zip(spans, spans[1:]))
    assert spans[-1][1] <= out_bytes
    pairs = rows[rows[:, 0] == 4]
    assert [int(r[6]) for r in pairs] == [0, -1]  # small: shared; big: not
    assert dict_bytes == 32
    # The allocation's views carry each leaf's plain planes.
    out = torch.zeros(out_bytes, dtype=torch.uint8)
    plan = decode.DecodePlan(pad_b, R, rows, None, first[-1], outs,
                             out_bytes, dict_bytes)
    for got, want in zip(decode.planes_of(plan, out),
                         decode.decode_leaves(leaves, pad_b, R)):
        assert [(g.shape, g.dtype) for g in got] == \
            [(w.shape, w.dtype) for w in want]


@pytest.mark.parametrize("kind", ["bits", "const", "const2", "delta16",
                                  "delta16_2", "rle", "rle2", "float_rle",
                                  "dict", "dict_big"])
def test_decode_tree_matches_jax_decode_run(kind):
    """``decode_tree`` on CPU tensors (K10's plain version) against the
    JAX ``decode_run`` on a run tree whose column holds a ``kind`` leaf,
    padded past its blocks: the same planes byte for byte (a dictionary's
    three JAX planes as the prefix pair and the code plane)."""
    rng = np.random.default_rng(11)
    B, R, pad_b = 6, 64, 8
    leaves = k10_leaves(rng, B, R)
    flags = {n: j_enc.pad_leaf(j_enc.encode_bool_plane(
        rng.random((B, R)) < 0.5), pad_b, ones=n == "group_start")
        for n in ("valid", "group_start", "tomb", "live")}
    tree = {**flags, "ht_hi": j_enc.encode_int_plane(
        np.zeros((B, R), np.int32)),
        "ht_lo": j_enc.pad_leaf(j_enc.encode_delta16(
            np.arange(B * R, dtype=np.int32).reshape(B, R)), pad_b),
        "exp_hi": np.zeros((pad_b, R), np.int32),
        "exp_lo": np.zeros((pad_b, R), np.int32),
        "cols": {3: {"set": flags["valid"], "isnull": flags["tomb"],
                     "cmp": j_enc.pad_leaf(leaves[kind], pad_b)}}}
    got = decode.decode_tree(to_torch(tree))
    want = jax.device_get(j_enc.decode_run(to_jax(tree)))
    for name in ("valid", "group_start", "tomb", "live", "ht_hi", "ht_lo",
                 "exp_hi", "exp_lo"):
        same_bytes(got[name], want[name], name)
    col, w = got["cols"][3], want["cols"][3]
    if kind.startswith("dict"):
        same_bytes(col["cmp"], np.ascontiguousarray(w["cmp"][..., :2]))
        same_bytes(col["code"], np.ascontiguousarray(w["cmp"][..., 2]))
    else:
        same_bytes(col["cmp"], w["cmp"])
    same_bytes(col["set"], w["set"])
    assert decode.decode_bytes(to_torch(tree)) > 0


def test_flush_codes_route_matches_jax():
    rng = np.random.default_rng(8)
    m, n, R, Bp = 256, 200, 32, 16
    perm = rng.permutation(n).astype(np.int32)
    perm = np.concatenate([perm, np.zeros(m - n, np.int32)])
    dst = np.sort(rng.choice(Bp * R - 64, n, replace=False)).astype(np.int32)
    dst = np.concatenate([dst, np.full(m - n, Bp * R, np.int32)])
    gs = rng.random(m) < 0.7
    is_real = np.arange(Bp) < 12
    staged = {"ht_hi": rng.integers(0, 9, m).astype(np.int32),
              "ht_lo": rng.integers(0, 9, m).astype(np.int32),
              "exp_hi": rng.integers(0, 9, m).astype(np.int32),
              "exp_lo": rng.integers(0, 9, m).astype(np.int32),
              "tomb": rng.random(m) < 0.1, "live": rng.random(m) < 0.9,
              "cols": {1: {"set": rng.random(m) < 0.8,
                           "isnull": rng.random(m) < 0.1,
                           "codes": rng.integers(0, 5, m).astype(np.uint16),
                           "dhi": np.arange(8, dtype=np.int32) * 3,
                           "dlo": np.arange(8, dtype=np.int32) - 4},
                       2: {"set": rng.random(m) < 0.8,
                           "isnull": rng.random(m) < 0.1,
                           "cmp": rng.integers(-9, 9, (m, 2)).astype(
                               np.int32),
                           "arith": rng.random(m).astype(np.float32)}}}
    want = jax.device_get(j_flush.replay_flush(
        to_jax(staged), jnp.asarray(perm), jnp.asarray(dst),
        jnp.asarray(gs), jnp.asarray(is_real), 11, 12, R=R))
    # The port stages only the n rows the sorted positions gather.
    pstaged = to_torch({k: (v[:n] if k != "cols" else {
        cid: {f: (a if f in ("dhi", "dlo") else a[:n])
              for f, a in col.items()} for cid, col in v.items()})
        for k, v in staged.items()})
    got = t_flush.replay_flush(pstaged, torch.from_numpy(perm[:n]),
                               torch.from_numpy(dst[:n]),
                               torch.from_numpy(gs[:n]),
                               torch.from_numpy(is_real), 11, 12, R)
    same_bytes(got, want)
    assert t_enc.leaf_kind(got["cols"][1]["cmp"]) == "dict"
    assert t_flush.record_layout([0, 2], [False, True], True)["stride"] == 12


OPS = ("=", "!=", "<", "<=", ">", ">=")
LITERALS = ("A", "N", "R", "B", "", "Z", "AA")  # present and absent


@pytest.fixture(scope="module")
def grouped_engines():
    """The JAX ``tpu`` engine and the port's ``gpu`` engine (CPU
    tensors), both encoding, on one flushed grouped table."""
    rows, ht = group_rows(PORT, group_schema(PORT), 900, seed=3)
    tpu = J.make_engine("tpu", group_schema(JAX), {"rows_per_block": 64})
    gpu = T.make_engine("gpu", group_schema(PORT), {"rows_per_block": 64,
                                                     "device": "cpu"})
    tpu.apply(jax_rows(rows))
    gpu.apply(rows)
    tpu.flush()
    gpu.flush()
    tpu.runs[0].dev  # the JAX run builds its dictionaries on first access
    return tpu, gpu, ht


@pytest.mark.parametrize("op", OPS)
def test_promote_code_preds_matches_jax(grouped_engines, op):
    tpu, gpu, _ht = grouped_engines
    for lit in LITERALS:
        want = tpu._promote_code_preds(tpu.runs[0],
                                       [J.Predicate("flag", op, lit)])
        got = gpu._promote_code_preds(gpu.runs[0],
                                      [T.Predicate("flag", op, lit)])
        assert want is not None and got is not None, lit
        assert [(p.column, p.op, p.value) for p in got] == \
            [(p.column, p.op, p.value) for p in want], (op, lit)
    assert gpu._promote_code_preds(gpu.runs[0],
                                   [T.Predicate("flag", "IN", "A")]) is None


@pytest.mark.parametrize("label", ["q1", "q1_code", "q6_code"])
def test_k8_plain_version_on_encoded_tree_matches_jax(grouped_engines,
                                                       label):
    tpu, gpu, ht = grouped_engines
    kw = {"q1": dict(read_ht=ht + 1, aggregates=Q1_AGGS,
                     group_by=["flag", "status"],
                     predicates=[("d", "<", 900)]),
          "q1_code": dict(read_ht=ht + 1, aggregates=Q1_AGGS,
                          group_by=["flag", "status"],
                          predicates=[("flag", ">=", "N"),
                                      ("status", "=", "O")]),
          "q6_code": dict(read_ht=ht + 1, aggregates=[
              ("sum", None, ("*", "price", "disc"), "revenue")],
              predicates=[("qty", "<", 25), ("flag", "!=", "Q")])}[label]
    jspec, pspec = build(J, JX, kw), build(T, TX, kw)
    jrun = tpu.runs[0]
    exact, superset, _host = tpu._split_predicates(jspec)
    if superset:
        exact = exact + tpu._promote_code_preds(jrun, superset)
    kind, (jsig, ip, fp) = tpu._grouped_prep(jrun, jspec, exact)
    assert kind == "params" and jrun.dev.encoded
    want = jax.device_get(j_group_agg.compiled_grouped(jsig)(
        jrun.dev.arrays, ip, fp))
    prep = gpu._plan_scan(pspec)
    assert prep.route == "grouped"
    assert ("code" in {p.kind for p in prep.sig.preds}) == \
        label.endswith("code")
    plan = group_agg.make_plan(prep.sig)
    arrays = DeviceRun.from_reference_planes(
        jax.device_get(jrun.dev.arrays), 64, "cpu").arrays
    table = plan.plane_table(arrays)
    assert any(t_enc.leaf_kind(t) == "dict" for t in table if t is not None)
    params = torch.tensor([plan.param_row(prep.row_lo, prep.row_hi,
                                          prep.read_planes, prep.lits)],
                          dtype=torch.int32)
    got = group_agg.grouped_aggregate(plan, table, params).numpy()
    assert_same_buckets(plan, got[0], want)
    # The same spec over the side-car (a plain tree with code planes).
    side = decode.decode_tree_plain(arrays)
    again = group_agg.grouped_aggregate(plan, plan.plane_table(side),
                                        params).numpy()
    np.testing.assert_array_equal(again, got)
    assert group_agg.group_bytes(plan, table, params) < \
        group_agg.group_bytes(plan, plan.plane_table(side), params)
