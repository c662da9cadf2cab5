"""The mesh scans' kernels (``ops.mesh``) against the JAX package's.

- ``combine_plain`` (K14's combine) against the JAX ``_combine_across_mesh``
  run under ``shard_map`` on the 4x2 mesh of 8 CPU devices, one hand-made
  packed row a device: the finalized answers and every count, ``n`` and
  extreme equal; high-plane ties, empty pieces (``n`` 0), i64 and f64
  extremes at the limits, and float sums. Digit vectors whose sums carry
  past 2^31 (more rows than a mesh has devices) against Python integers.
- ``stack_update_plain`` byte for byte against the JAX
  ``_compiled_stack_update`` on the same numpy trees, sources cast to
  the destination's type as ``astype`` does.
- The item table of the combine against K5's packed layout, the update's
  entry table and launch shape, the bytes bounds, and the wrappers'
  refusals.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from yugabyte_db_tpu.ops import agg_fold as j_agg_fold
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu.parallel import meshcompat
from yugabyte_db_tpu.parallel import sharded as j_sharded
from yugabyte_db_tpu_torch.ops import agg_fold, full_agg
from yugabyte_db_tpu_torch.ops import mesh as M
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.scan import I32_MAX, I32_MIN
from yugabyte_db_tpu_torch.utils import planes as PL

# (fn, kind) of the aggregates every case packs: one of each layout.
AGGS = (("count", None), ("sum", "i64"), ("sum", "i32"), ("sum", "f64"),
        ("sum", "f32"), ("min", "i32"), ("max", "i32"), ("min", "i64"),
        ("max", "i64"), ("min", "f64"), ("max", "f64"), ("min", "f32"),
        ("max", "f32"))
S = 8  # pieces of the 4x2 mesh


def sigs(side):
    return tuple(side.AggSig(fn, None if kind is None else i, kind)
                 for i, (fn, kind) in enumerate(AGGS))


def ordered(kind: str, v):
    """(hi, lo) ordered planes of an i64 or f64 value."""
    if kind == "i64":
        hi, lo = PL.i64_to_ordered_planes(np.array([v], np.int64))
    else:
        hi, lo = PL.f64_to_ordered_planes(np.array([v], np.float64))
    return int(hi[0]), int(lo[0])


def random_acc(rng: random.Random, case: str, s: int) -> list:
    """One piece's accumulators (``agg_fold.unpack``'s form) of ``case``."""
    empty = case == "empty" and s % 3 == 0
    acc = []
    for fn, kind in AGGS:
        n = 0 if empty else rng.randrange(1, 500)
        if fn == "count":
            acc.append({"count": n})
        elif fn == "sum" and kind in ("f32", "f64"):
            acc.append({"fsum": float(np.float32(rng.uniform(-1e5, 1e5)))
                        if n else 0.0,
                        "fcomp": float(np.float32(rng.uniform(-1e-3, 1e-3)))
                        if n else 0.0, "n": n})
        elif fn == "sum":
            acc.append({"digits": [rng.randrange(0, 1 << 17) if n else 0
                                   for _ in range(agg_fold.DIGITS)], "n": n})
        else:
            is_max = fn == "max"
            fill = int(I32_MIN if is_max else I32_MAX)
            if kind == "f32":
                acc.append({"fext": float(np.float32(rng.uniform(-1e6, 1e6)))
                            if n else (-np.inf if is_max else np.inf),
                            "n": n})
            elif kind == "i32":
                acc.append({"ext": rng.randrange(-2**31, 2**31) if n
                            else fill, "n": n})
            else:
                if not n:
                    acc.append({"ext_hi": fill, "ext_lo": fill, "n": 0})
                    continue
                if case == "ties":
                    # every piece in one high plane: the low plane decides
                    v = (rng.randrange(-2**31, 2**31) if kind == "i64"
                         else 1.0 + rng.random() * 1e-9)
                elif case == "limits":
                    v = (rng.choice([-2**63, 2**63 - 1, -2**63 + 1,
                                     2**63 - 2, 0, -1]) if kind == "i64"
                         else rng.choice([-np.inf, np.inf, -1.7e308, 1.7e308,
                                          -0.0, 5e-324, -5e-324]))
                else:
                    v = (rng.randrange(-2**63, 2**63) if kind == "i64"
                         else rng.uniform(-1e300, 1e300))
                hi, lo = ordered(kind, v)
                acc.append({"ext_hi": hi, "ext_lo": lo, "n": n})
    return acc


def pack(acc: list, scanned: int) -> tuple:
    """(int32 row, float32 row) of one piece, ``agg_fold.pack``'s layout."""
    ints, floats = [scanned], []
    for (fn, kind), a in zip(AGGS, acc):
        if fn == "count":
            ints.append(a["count"])
        elif fn == "sum" and kind in ("f32", "f64"):
            floats += [a["fsum"], a["fcomp"]]
            ints.append(a["n"])
        elif fn == "sum":
            ints += a["digits"] + [a["n"]]
        elif kind == "f32":
            floats.append(a["fext"])
            ints.append(a["n"])
        elif kind == "i32":
            ints += [a["ext"], a["n"]]
        else:
            ints += [a["ext_hi"], a["ext_lo"], a["n"]]
    return ints, floats


def jax_combine(accs: list, scanned: list) -> tuple:
    """The JAX ``_combine_across_mesh`` over the 4x2 mesh of 8 CPU
    devices, piece s on device s: (combined accumulators, scanned), host
    values."""
    aggs = sigs(j_scan)
    mesh = Mesh(np.array(jax.devices()[:S]).reshape(4, 2), ("t", "b"))
    tb = P(("t", "b"))

    def stacked(i, name):
        vals = [a[i][name] for a in accs]
        if name == "digits":
            return jnp.asarray(np.array(vals, np.int32))
        if name in ("fsum", "fcomp", "fext"):
            return jnp.asarray(np.array(vals, np.float32))
        return jnp.asarray(np.array(vals, np.int32))

    tree = [{name: stacked(i, name) for name in accs[0][i]}
            for i in range(len(AGGS))]

    def body(acc, sc):
        local = [{k: v[0] for k, v in a.items()} for a in acc]
        return j_sharded._combine_across_mesh(aggs, local, sc[0])

    in_specs = ([{k: tb for k in a} for a in tree], tb)
    out_specs = ([{k: P() for k in j_agg_fold.agg_init(aggs)[i]}
                  for i in range(len(AGGS))], P())
    fn = jax.jit(meshcompat.shard_map(body, mesh, in_specs, out_specs))
    acc, sc = jax.device_get(fn(tree, jnp.asarray(np.array(scanned,
                                                             np.int32))))
    return acc, int(sc)


@pytest.mark.parametrize("case", ["random", "ties", "empty", "limits"])
def test_combine_plain_matches_the_jax_combine(case):
    rng = random.Random(f"combine-{case}")
    accs = [random_acc(rng, case, s) for s in range(S)]
    scanned = [rng.randrange(0, 10_000) for _ in range(S)]
    rows = [pack(a, sc) for a, sc in zip(accs, scanned)]
    ivec = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    fvec = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    aggs = sigs(t_scan)
    out_i, out_f = M.combine_plain(aggs, ivec, fvec)
    assert out_i.dtype == torch.int64 and out_f.dtype == torch.float32
    got, got_sc = agg_fold.unpack(aggs, out_i.tolist(), out_f.tolist())
    want, want_sc = jax_combine(accs, scanned)
    assert got_sc == want_sc == sum(scanned)
    for (fn, kind), ag, g, w in zip(AGGS, aggs, got, want):
        for name in w:
            if name == "digits":
                continue
            if name in ("fsum", "fcomp"):
                assert g[name] == pytest.approx(float(w[name]), rel=1e-5,
                                                abs=1e-3), (fn, kind)
            else:
                assert g[name] == w[name], (fn, kind, name)
        for user_fn in (fn, "avg") if fn == "sum" else (fn,):
            gv = agg_fold.finalize(ag, g, user_fn)
            wv = j_agg_fold.finalize(ag, {k: np.asarray(v)
                                          for k, v in w.items()}, user_fn)
            if isinstance(wv, float) and kind in ("f32", "f64") and \
                    fn == "sum":
                assert gv == pytest.approx(wv, rel=1e-5, abs=1e-3)
            elif isinstance(wv, float) and np.isnan(wv):
                assert np.isnan(gv)
            else:
                assert gv == wv, (fn, kind, user_fn)
    # The carry-normalised digits: 16 bits each below the last, the same
    # integer as the JAX psum's digits.
    for (fn, kind), g, w in zip(AGGS, got, want):
        if "digits" in w:
            assert all(0 <= d < 1 << 16 for d in g["digits"][:-1])
            assert sum(int(d) << (16 * j) for j, d in enumerate(
                g["digits"])) == sum(int(d) << (16 * j) for j, d in
                                     enumerate(w["digits"]))


def test_combine_digits_carry_past_int32():
    """70,000 rows of large digits: each digit's sum passes 2^31, which an
    int32 psum would wrap; the int64 sum and the carry give the exact
    integer."""
    rng = np.random.default_rng(5)
    aggs = (t_scan.AggSig("sum", 0, "i64"),)
    n = 70_000
    I, F = M.packed_widths(aggs)
    ivec = np.zeros((n, I), np.int32)
    ivec[:, 0] = 1
    ivec[:, 1:1 + agg_fold.DIGITS] = rng.integers(
        (1 << 16) - 64, (1 << 17), size=(n, agg_fold.DIGITS))
    ivec[:, 1 + agg_fold.DIGITS] = 3
    out_i, _ = M.combine_plain(aggs, torch.from_numpy(ivec),
                               torch.zeros((n, F), dtype=torch.float32))
    assert int(ivec[:, 1].astype(np.int64).sum()) > 2**31
    got = out_i.tolist()
    want = sum(int(ivec[:, 1 + j].astype(np.int64).sum()) << (16 * j)
               for j in range(agg_fold.DIGITS))
    digits = got[1:1 + agg_fold.DIGITS]
    assert sum(d << (16 * j) for j, d in enumerate(digits)) == want
    assert all(0 <= d < 1 << 16 for d in digits[:-1])
    assert got[0] == n and got[1 + agg_fold.DIGITS] == 3 * n
    assert M.carry([1 << 20, 0, 5]) == [0, 16, 5]


def test_combine_items_follow_k5s_packed_layout():
    cols = tuple(t_scan.ColSig(i, kind or "i32")
                 for i, (_fn, kind) in enumerate(AGGS))
    aggs = tuple(t_scan.AggSig(fn, i if kind else None, kind)
                 for i, (fn, kind) in enumerate(AGGS))
    plan = full_agg.make_plan(aggs, (), cols, 16, 2)
    assert M.packed_widths(aggs) == (plan.n_ints, plan.n_floats)
    items = M.combine_items(aggs)
    assert items[0] == (M.SUM, 0)
    by_off = {}
    for op, off in items[1:]:
        by_off.setdefault(op in (M.FSUM, M.FMAX, M.FMIN), []).append(off)
    for i, (fn, kind) in enumerate(AGGS):
        io, fo = plan.ioffs[i], plan.foffs[i]
        if fn == "count":
            assert (M.SUM, io) in items
        elif fn == "sum" and kind in ("f32", "f64"):
            assert {(M.FSUM, fo), (M.FSUM, fo + 1), (M.SUM, io)} <= set(items)
        elif fn == "sum":
            assert {(M.DIGITS, io), (M.SUM, io + agg_fold.DIGITS)} <= \
                set(items)
        elif kind == "f32":
            assert (M.FMAX if fn == "max" else M.FMIN, fo) in items
        elif kind == "i32":
            assert (M.MAX if fn == "max" else M.MIN, io) in items
        else:
            assert (M.LEX_MAX if fn == "max" else M.LEX_MIN, io) in items
    # Every int word and float word is some item's, once.
    ints = set()
    for op, off in items:
        if op in (M.FSUM, M.FMAX, M.FMIN):
            continue
        width = {M.DIGITS: agg_fold.DIGITS, M.LEX_MAX: 2,
                 M.LEX_MIN: 2}.get(op, 1)
        words = set(range(off, off + width))
        assert not words & ints
        ints |= words
    assert ints == set(range(plan.n_ints))
    assert sorted(by_off[True]) == list(range(plan.n_floats))
    assert M.combine_bytes(aggs, 8) == 8 * 4 * (plan.n_ints +
                                                plan.n_floats) + \
        8 * plan.n_ints + 4 * plan.n_floats + 8 * len(items)


def stack_trees(rng, T: int, B: int, R: int, cast: bool):
    """A stacked [T, B, ...] destination tree and a [1, B, ...] source of
    the stack's leaf layout; with ``cast`` the source's arith planes are
    int32 and its hybrid times float32, cast on the way in."""
    def plane(shape, dtype):
        if dtype == bool:
            return rng.random(shape) < 0.5
        if dtype == np.float32:
            return rng.standard_normal(shape).astype(np.float32) * 1e3
        return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64) \
            .astype(dtype)

    def tree(lead, src):
        out = {n: plane(lead + (B, R), bool)
               for n in ("valid", "group_start", "tomb", "live")}
        for n in ("ht_hi", "ht_lo", "exp_hi", "exp_lo"):
            out[n] = plane(lead + (B, R), np.float32 if src and cast and
                           n.startswith("ht") else np.int32)
            if src and cast and n.startswith("ht"):
                out[n] = np.round(out[n])
        out["cols"] = {}
        for cid, nplanes in ((1, 2), (2, 1)):
            out["cols"][cid] = {
                "set": plane(lead + (B, R), bool),
                "isnull": plane(lead + (B, R), bool),
                "cmp": plane(lead + (B, R, nplanes), np.int32),
                "arith": (plane(lead + (B, R), np.int32) % 1000
                          if src and cast else
                          plane(lead + (B, R), np.float32))}
        return out

    return tree((T,), False), tree((1,), True)


def flat_leaves(tree):
    out = [(n, tree[n]) for n in sorted(k for k in tree if k != "cols")]
    for cid in sorted(tree["cols"]):
        out += [((cid, n), tree["cols"][cid][n])
                for n in sorted(tree["cols"][cid])]
    return out


@pytest.mark.parametrize("cast", [False, True])
@pytest.mark.parametrize("t", [0, 3])
def test_stack_update_plain_matches_the_jax_update(t, cast):
    rng = np.random.default_rng(17 + t + cast)
    T, B, R = 4, 6, 16
    dst, src = stack_trees(rng, T, B, R, cast)
    cols_desc = tuple(sorted((cid, "arith" in c)
                             for cid, c in dst["cols"].items()))
    fn = j_sharded._compiled_stack_update(T, B, R, cols_desc)
    want = jax.device_get(fn(jax.tree.map(jnp.asarray, dst),
                             jax.tree.map(jnp.asarray, src), jnp.int32(t)))
    got = jax.tree.map(lambda a: torch.from_numpy(a.copy()), dst)
    entries = [(g[t], torch.from_numpy(np.ascontiguousarray(s[0])), None)
               for (_n, g), (_m, s) in zip(flat_leaves(got),
                                           flat_leaves(src))]
    M.stack_update_plain(entries)
    for (name, g), (_n, w) in zip(flat_leaves(got), flat_leaves(want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert g.numpy().tobytes() == w.tobytes(), name


def test_stack_update_fill_entries_and_the_wrapper():
    """Fill entries write the value (the slot's padding blocks); the
    wrapper runs the plain version on CPU tensors without counting a
    launch."""
    dst = torch.zeros((4, 8), dtype=torch.int32)
    flags = torch.zeros((4, 8), dtype=torch.bool)
    src = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    before = M.stack_update.launches
    M.stack_update([(dst[1:3], src, None), (dst[3:], None, 7),
                    (flags[2:], None, 1)])
    assert M.stack_update.launches == before
    assert dst[1:3].tolist() == src.tolist()
    assert dst[3].tolist() == [7] * 8 and dst[0].tolist() == [0] * 8
    assert flags.tolist() == [[False] * 8] * 2 + [[True] * 8] * 2
    table = M.update_entries([(dst[1:3], src, None), (flags[2:], None, 1)])
    assert table == [dst[1:3].data_ptr(), src.data_ptr(), 16, 1, 1, 0,
                     flags[2:].data_ptr(), 0, 16, 0, 0, 1]
    assert M.update_bytes([(dst[1:3], src, None), (flags[2:], None, 1)]) \
        == 2 * 8 * M.ENTRY_WORDS + 64 + 64 + 16
    geo = M.launch_geometry([(dst, src, None)] * 3)
    assert geo == {"kernel": 1, "blocks_x": 1, "blocks_y": 3,
                   "threads": M.UPDATE_THREADS}
    big = torch.empty(1 << 22, dtype=torch.int32)
    assert M.launch_geometry([(big, None, 0)])["blocks_x"] == \
        min(M.MAX_GRID_X, (4 << 22) // (16 * M.UPDATE_THREADS))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    aggs = (t_scan.AggSig("count", None, None),)
    with pytest.raises(ValueError, match="int32"):
        M.combine(aggs, torch.zeros((2, 2), dtype=torch.int64),
                  torch.zeros((2, 0)))
    with pytest.raises(ValueError, match="no packed row"):
        M.combine(aggs, torch.zeros((0, 2), dtype=torch.int32),
                  torch.zeros((0, 0)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        M.combine(aggs, torch.zeros((2, 2), dtype=torch.int32,
                                    device="meta"),
                  torch.zeros((2, 0), device="meta"))
    before = M.combine.launches
    out_i, out_f = M.combine(aggs, torch.tensor([[3, 4], [5, 6]],
                                                dtype=torch.int32),
                             torch.zeros((2, 0)))
    assert out_i.tolist() == [8, 10] and out_f.numel() == 0
    assert M.combine.launches == before
    dst = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="elements"):
        M.stack_update([(dst, torch.zeros(4, dtype=torch.int32), None)])
    with pytest.raises(ValueError, match="bool, int32"):
        M.stack_update([(torch.zeros(8, dtype=torch.float64), None, 0)])
    with pytest.raises(ValueError, match="no entry"):
        M.stack_update([])
    with pytest.raises(ValueError, match="cuda or cpu"):
        M.stack_update([(torch.zeros(8, dtype=torch.int32, device="meta"),
                         None, 0)])
