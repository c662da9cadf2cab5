"""K7 and K9 (``ops.row_gather``) against the JAX package's programs.

The port's plain versions and the JAX programs on the CPU backend read the
same planes (the JAX package's unencoded ``DeviceRun.arrays`` uploaded to
the port) and must give the same buffers exactly, every int of them:

- ``gather_rows_plain`` against ``compiled_gather_batch``: the whole
  ``[G, M + 1, W]`` buffer, on a flat run and a multi-version one
  (``layered_rows``), in paged mode (a LIMIT-sized M, and an M smaller
  than the matches: overflow) and chunks mode, with pages that start
  mid-window, end early, count from ``scan_from`` or walk nothing;
- ``scan_window`` / ``scan_candidates_plain`` against ``compiled_scan``:
  the match flags, first rows and group counts of windows, predicates
  applied or not;
- every predicate kind (i32, i64, f64, and the superset kinds str and
  f32) with every operator.

Also: the wrappers run the plain versions on CPU tensors without counting
a launch and refuse what the kernels do not take, and ``out_layout`` /
``pack_params`` keep the JAX package's layouts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import (JAX, PORT, build_run, flat_rows, layered_rows,
                             make_schema, read_planes, reference_planes)
from yugabyte_db_tpu.ops import row_gather as j_gather
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu_torch import workload
from yugabyte_db_tpu_torch.ops import agg_fold
from yugabyte_db_tpu_torch.ops import row_gather
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun, dtype_kind
from yugabyte_db_tpu_torch.utils import planes as P

R = 64
K = 8
N = K * R


_RUNS: dict = {}


def get_run(flat: bool) -> dict:
    """The ``rows`` table's run, built once a module: a flat run of 900
    keys, or three layers of writes over 700 keys; its JAX planes, the
    port's DeviceRun of them and the rows."""
    if flat not in _RUNS:
        js = make_schema(JAX, "rows")
        if flat:
            rows, ht = flat_rows(JAX, js, 900, seed=3)
        else:
            rows, ht = layered_rows(JAX, js, (700, 400, 250), seed=8)
        crun = build_run(JAX, js, rows, R)
        assert (crun.max_group_versions <= 1) == flat
        planes = reference_planes(crun, 64)
        _RUNS[flat] = {
            "flat": flat, "planes": planes, "rows": rows, "ht": ht,
            "dev": DeviceRun.from_reference_planes(planes, R, "cpu"),
            "cid": {c.name: c.col_id for c in js.value_columns},
            "kinds": {c.col_id: dtype_kind(c.dtype)
                      for c in js.value_columns},
            "B": planes["valid"].shape[0]}
    return _RUNS[flat]


@pytest.fixture(scope="module", params=[True, False], ids=["flat", "mv"])
def run(request):
    return get_run(request.param)


def sigs(run, preds, M, packed=True, apply_preds=True, outs=None):
    """(JAX GatherSig, port GatherSig, JAX ScanSig, port ScanSig)."""
    cols = [(cid, k) for cid, k in run["kinds"].items()]
    if outs is None:
        outs = [(cid, 2 if k in ("i64", "f64", "str") else 1,
                 k in ("str", "f32")) for cid, k in cols]
    ps = [(run["cid"][c], run["kinds"][run["cid"][c]], op)
          for c, op, _v in preds]

    def make(S, G):
        c = tuple(S.ColSig(*x) for x in cols)
        p = tuple(S.PredSig(*x) for x in ps)
        return (G.GatherSig(B=run["B"], R=R, K=K, M=M, cols=c, preds=p,
                            apply_preds=apply_preds,
                            out_cols=tuple(G.OutCol(*o) for o in outs),
                            flat=run["flat"], packed=packed),
                S.ScanSig(B=run["B"], R=R, K=K, cols=c, preds=p, aggs=(),
                          apply_preds=apply_preds, flat=run["flat"]))

    jg, js_ = make(j_scan, j_gather)
    tg, ts_ = make(t_scan, row_gather)
    return jg, tg, js_, ts_


def literals(run, preds):
    """(int literal planes, f32 literals) of (column, op, value) preds."""
    ints, floats = [], []
    for c, _op, v in preds:
        kind = run["kinds"][run["cid"][c]]
        if kind == "f32":
            floats.append(float(v))
        else:
            ints += np.atleast_1d(agg_fold.pred_literal_host(kind, v)) \
                .astype(np.int64).tolist()
    return ints, floats


def gather_both(run, preds, M, pages, packed=True):
    """Both buffers for ``pages``: (w_first, w_last, row_lo, row_hi,
    read_ht, scan_from) tuples."""
    jsig, tsig, _, _ = sigs(run, preds, M, packed)
    ints, floats = literals(run, preds)
    rows = [j_gather.pack_params(wf, wl, lo, hi, read_planes(P, rd), ints,
                                 floats, scan_from=sf)
            for wf, wl, lo, hi, rd, sf in pages]
    ip = np.stack([r[0] for r in rows])
    fp = np.stack([r[1] for r in rows])
    want = np.asarray(j_gather.compiled_gather_batch(jsig, len(pages))(
        run["planes"], ip, fp))
    got = row_gather.gather_rows(tsig, run["dev"].arrays, torch.from_numpy(ip),
                                 torch.from_numpy(fp))
    return want, got.numpy()


def pages(run):
    """A mix of pages: the whole run, mid-window bounds at an older read
    point, a later scan_from, a bounded window range, one empty window
    range and one past the last window."""
    B, ht = run["B"], run["ht"]
    last = B // K - 1
    return [(0, last, 0, B * R, ht + 1, None),
            (1, last, R + 7, (B - 9) * R + 3, ht // 2, None),
            (0, last, 5, B * R, ht + 1, 3 * N + 11),
            (2, 3, 2 * N - 1, 4 * N, ht // 3, None),
            (3, 2, 0, B * R, ht + 1, None),
            (last, last, last * N, B * R, ht + 1, None)]


PAGED_PREDS = [("d", ">=", -200_000), ("f", "<", 7.75), ("b", "!=", "zz")]


@pytest.mark.parametrize("M", [104, 8])
def test_paged_buffers_equal_the_jax_program(run, M):
    """A LIMIT-sized buffer, and one smaller than a window's matches
    (``count`` past M: overflow), under three predicate kinds."""
    want, got = gather_both(run, PAGED_PREDS, M, pages(run))
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    counts = got[:, M, 0]
    assert (counts > M).any() and counts.max() > 0


def test_chunks_buffers_equal_the_jax_program(run):
    """One whole window in place per page, each at its own window."""
    B, ht = run["B"], run["ht"]
    pg = [(w, w, 3, B * R - 70, ht + 1 if w % 2 else ht // 2, None)
          for w in range(B // K)]
    want, got = gather_both(run, [], N, pg, packed=False)
    np.testing.assert_array_equal(got, want)
    assert (got[:, :N, 0] == -1).any() and (got[:, :N, 0] >= 0).any()


def test_paged_without_predicates_or_outputs(run):
    """No predicate and no output column (only starts and the tail)."""
    jsig, tsig, _, _ = sigs(run, [], 104, outs=[])
    ht = run["ht"]
    rows = [j_gather.pack_params(0, run["B"] // K - 1, 0, 10**7,
                                 read_planes(P, ht + 1), [], [])]
    ip, fp = (np.stack([r[i] for r in rows]) for i in (0, 1))
    want = np.asarray(j_gather.compiled_gather_batch(jsig, 1)(
        run["planes"], ip, fp))
    got = row_gather.gather_rows(tsig, run["dev"].arrays, torch.from_numpy(ip),
                                 torch.from_numpy(fp)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.shape[2] == 3


OPS = ["=", "!=", "<", "<=", ">", ">="]
# (column, literal): a stored value (None: a value the first window
# holds), or one that ties with stored values (a string prefix shared
# past 8 bytes; a float that rounds onto stored ones).
KIND_CASES = {"i32": ("d", None), "i64": ("a", None), "f64": ("c", None),
              "str": ("b", "commonprefix-ab"), "f32": ("f", 16777217.0)}


@pytest.mark.parametrize("kind", sorted(KIND_CASES))
def test_every_predicate_kind_and_op(kind):
    """Each operator on each kind through ``scan_window`` (K9's plain
    version, one window) against ``compiled_scan`` on the flat run; the
    superset kinds ('str', 'f32') keep their superset masks."""
    run = get_run(True)
    col, value = KIND_CASES[kind]
    if value is None:  # a live row's value in the first window
        value = next(r.columns[run["cid"][col]]
                     for r in sorted(run["rows"], key=lambda r: r.key)[10:]
                     if r.columns.get(run["cid"][col]) is not None
                     and not r.has_ttl)
    rd = read_planes(P, run["ht"] + 1)
    for op in OPS:
        preds = [(col, op, value)]
        _, _, jsig, tsig = sigs(run, preds, 1)
        ints, floats = literals(run, preds)
        lits = (np.float32(floats[0]) if kind == "f32" else
                np.int32(ints[0]) if kind == "i32" else
                np.array(ints, np.int32))
        hits = 0
        for b0 in (0, K):
            want = j_scan.compiled_scan(jsig)(
                run["planes"], jnp.int32(b0), jnp.int32(3), jnp.int32(N - 5),
                *map(jnp.int32, rd), (jnp.asarray(lits),))
            got = t_scan.scan_window(tsig, run["dev"].arrays, b0, 3, N - 5,
                                     *rd, (lits,))
            for name in ("result", "start_idx", "num_groups"):
                np.testing.assert_array_equal(got[name].numpy(),
                                              np.asarray(want[name]),
                                              err_msg=f"{kind} {op} {name}")
            hits += int(got["result"].sum())
        assert hits, (kind, op)


@pytest.mark.parametrize("apply_preds", [True, False])
def test_candidates_over_a_window_range_equal_the_jax_program(run,
                                                              apply_preds):
    """``scan_candidates`` over every window of a bounded range, against
    ``compiled_scan`` window by window."""
    preds = [("d", "<", 300_000), ("c", ">=", 20.0)]
    _, _, jsig, tsig = sigs(run, preds, 1, apply_preds=apply_preds)
    ints, floats = literals(run, preds)
    B, ht = run["B"], run["ht"]
    row_lo, row_hi = R + 9, (B - 3) * R - 17
    w_first, w_last = row_lo // N, (row_hi - 1) // N
    rd = read_planes(P, ht // 2)
    ip, fp = row_gather.pack_params(w_first, w_last, row_lo, row_hi, rd,
                                    ints, floats)
    res, start, ng = row_gather.scan_candidates(
        tsig, run["dev"].arrays, torch.from_numpy(ip), torch.from_numpy(fp),
        w_last - w_first + 1)
    fn = j_scan.compiled_scan(jsig)
    lits = (jnp.int32(ints[0]), jnp.asarray(np.array(ints[1:], np.int32)))
    for i, w in enumerate(range(w_first, w_last + 1)):
        base = w * N
        want = fn(run["planes"], jnp.int32(w * K), jnp.int32(row_lo - base),
                  jnp.int32(row_hi - base), *map(jnp.int32, rd), lits)
        np.testing.assert_array_equal(res[i].numpy(), np.asarray(
            want["result"]))
        np.testing.assert_array_equal(start[i].numpy(), np.asarray(
            want["start_idx"]))
        assert int(ng[i]) == int(want["num_groups"])


def test_wrappers_on_cpu_tensors_run_the_plain_version(run):
    """No launch is counted on CPU tensors, and what the kernels do not
    take is refused before any launch."""
    row_gather.gather_rows.launches = 0
    row_gather.scan_candidates.launches = 0
    _, tsig, _, ssig = sigs(run, PAGED_PREDS, 104)
    ints, floats = literals(run, PAGED_PREDS)
    ip, fp = row_gather.pack_params(0, 1, 0, 10**6,
                                    read_planes(P, run["ht"]), ints, floats)
    ipt, fpt = torch.from_numpy(ip), torch.from_numpy(fp)
    arrays = run["dev"].arrays
    got = row_gather.gather_rows(tsig, arrays, ipt[None], fpt[None])
    assert torch.equal(got, row_gather.gather_rows_plain(tsig, arrays,
                                                         ipt[None], fpt[None]))
    row_gather.scan_candidates(ssig, arrays, ipt, fpt, 2)
    assert row_gather.gather_rows.launches == 0
    assert row_gather.scan_candidates.launches == 0
    with pytest.raises(ValueError, match="apply_preds"):
        row_gather.gather_rows(sigs(run, [], 104, apply_preds=False)[1],
                               arrays, ipt[None], fpt[None])
    with pytest.raises(ValueError, match="M = K"):
        chunks = sigs(run, [], 104, packed=False)[1]
        row_gather.gather_rows(chunks, arrays, ipt[None], fpt[None])
    with pytest.raises(ValueError, match="iparams"):
        row_gather.gather_rows(tsig, arrays, ipt[None].to(torch.int64),
                               fpt[None])
    with pytest.raises(ValueError, match="fparams"):
        row_gather.gather_rows(tsig, arrays, ipt[None], fpt[None].repeat(2, 1))
    with pytest.raises(ValueError, match="row-scan form"):
        row_gather.scan_candidates(
            t_scan.ScanSig(**{**ssig.__dict__, "aggs": (
                t_scan.AggSig("count", None, None),)}), arrays, ipt, fpt, 1)


def test_layouts_match_the_jax_package(run):
    jsig, tsig, _, _ = sigs(run, PAGED_PREDS, 104)
    assert row_gather.out_layout(tsig) == j_gather.out_layout(jsig)
    assert row_gather.PARAM_FIXED == j_gather.PARAM_FIXED
    for args in ((0, 3, 5, 900, (1, 2, 3, 4), [7, 8, 9], [0.5], None),
                 (2, 1, 0, 10, (5, 6, 7, 8), [], [], 40)):
        for a, b in zip(row_gather.pack_params(*args),
                        j_gather.pack_params(*args)):
            np.testing.assert_array_equal(a, b)
    # The bytes bound grows with the windows a page walked.
    ints, floats = literals(run, PAGED_PREDS)
    ip, fp = row_gather.pack_params(0, run["B"] // K - 1, 0, 10**7,
                                    read_planes(P, run["ht"] + 1), ints,
                                    floats)
    out = row_gather.gather_rows(tsig, run["dev"].arrays,
                                 torch.from_numpy(ip)[None],
                                 torch.from_numpy(fp)[None]).numpy()
    walked = int(out[0, 104, 2])
    one = row_gather.gather_bytes(tsig, run["dev"].arrays, ip[None], out)
    assert one > walked * N * 20


def test_gather_bytes_charge_output_planes_per_row_written(run):
    """The bound charges the resolve's planes (the predicates' included,
    a flat run's without group_start) for each row of the windows walked,
    and an output column that no predicate reads for each row written,
    min(count, M), not for each row walked."""
    ints, floats = literals(run, PAGED_PREDS)
    ip, fp = row_gather.pack_params(0, run["B"] // K - 1, 0, 10**7,
                                    read_planes(P, run["ht"] + 1), ints,
                                    floats)
    a, d = run["cid"]["a"], run["cid"]["d"]
    charged = {}
    for label, outs in (("none", []), ("a", [(a, 2, False)]),
                        ("d", [(d, 1, False)])):
        tsig = sigs(run, PAGED_PREDS, 8, outs=outs)[1]
        out = row_gather.gather_rows(tsig, run["dev"].arrays,
                                     torch.from_numpy(ip)[None],
                                     torch.from_numpy(fp)[None]).numpy()
        charged[label] = row_gather.gather_bytes(
            tsig, run["dev"].arrays, ip[None], out) - out.nbytes - ip.nbytes
        count, walked = int(out[0, 8, 0]), int(out[0, 8, 2])
    assert count > 8  # overflow: M rows written
    # valid, tomb, live, hybrid time, expiry, (group_start); set and
    # isnull of the 5 value columns; d (i32), f (f32), b (str) planes.
    per_row = 19 + (0 if run["flat"] else 1) + 2 * 5 + 4 * (1 + 1 + 2)
    assert charged["none"] == walked * N * per_row
    assert charged["a"] - charged["none"] == 8 * 2 * 4
    assert charged["d"] == charged["none"]


# -- the kernels' cluster geometry and the planes built to break it ---------

def bench_col_sigs(S):
    schema = workload.make_schema()
    return tuple(S.ColSig(c.col_id, dtype_kind(c.dtype))
                 for c in schema.value_columns)


def test_launch_geometry_fits_shared_memory():
    """The bench table's signature (the main path's) and a MAX_COLS /
    MAX_PREDS / MAX_OUT one both fit a block's shared memory, at R = 2048
    (one piece a run block) and past it (pieces of PIECE_MAX rows); the
    bench table's leaves room for 4 blocks an SM, the largest for 2."""
    bench = row_gather.GatherSig(
        B=64, R=2048, K=8, M=104, cols=bench_col_sigs(t_scan),
        preds=(t_scan.PredSig(3, "i32", ">="),), apply_preds=True,
        out_cols=(row_gather.OutCol(1, 2, False),
                  row_gather.OutCol(3, 1, False)))
    cols = tuple(t_scan.ColSig(i, "i64") for i in range(row_gather.MAX_COLS))
    big = row_gather.GatherSig(
        B=64, R=2048, K=8, M=4096, cols=cols,
        preds=tuple(t_scan.PredSig(i, "i64", "<")
                    for i in range(row_gather.MAX_PREDS)),
        apply_preds=True,
        out_cols=tuple(row_gather.OutCol(i, 2, True)
                       for i in range(row_gather.MAX_OUT)))
    sm_bytes = 233_472  # an SM's shared memory; each block reserves 1 KB
    for sig, per_sm in ((bench, 4), (big, 2)):
        for R in (64, 2048, 4096, 10_000):
            geo = row_gather.launch_geometry(
                dataclasses.replace(sig, R=R), 256)
            assert geo["piece_rows"] == min(R, row_gather.PIECE_MAX)
            assert geo["pieces_per_run_block"] * geo["piece_rows"] >= R
            assert geo["shared_bytes"] <= row_gather.SHARED_LIMIT
            assert geo["shared_bytes"] % 16 == 0
        geo = row_gather.launch_geometry(sig, 256)
        assert per_sm * (geo["shared_bytes"] + 1024) <= sm_bytes
        assert geo["blocks"] == 256 * 8 and geo["cluster"] == 8


@pytest.mark.parametrize("K", range(1, 17))
def test_launch_geometry_covers_every_K_by_whole_clusters(K):
    """Every K from 1 to 16: clusters of min(K, CLUSTER_MAX) blocks, each
    block a contiguous share of the window's run blocks in rank order,
    every run block taken exactly once."""
    sig = t_scan.ScanSig(B=2 * K, R=64, K=K, cols=bench_col_sigs(t_scan),
                         preds=(), aggs=(), apply_preds=True)
    geo = row_gather.launch_geometry(sig, 5)
    C, per = geo["cluster"], geo["run_blocks_per_block"]
    assert C == min(K, row_gather.CLUSTER_MAX) and geo["blocks"] == 5 * C
    taken = [b for r in range(C) for b in range(r * per, min(K, (r + 1) * per))]
    assert taken == list(range(K))


EDGE_R = 64
EDGE_WINDOWS = 3
EDGE_PREDS = {"none": [], "a": [("a", ">=", -10**11)],
              "dca": [("d", "<", 300_000), ("c", "!=", 5.0),
                      ("a", ">=", -10**11)]}
_EDGE_RUNS: dict = {}


def edge_run(K: int, flat: bool) -> dict:
    """``workload.row_edge_planes`` at R = EDGE_R, EDGE_WINDOWS windows of
    K blocks: the port's DeviceRun and the JAX program's planes."""
    if (K, flat) not in _EDGE_RUNS:
        n = EDGE_WINDOWS * K * EDGE_R
        planes = workload.row_edge_planes(n, EDGE_R, K, seed=K, flat=flat)
        reads = workload.row_edge_reads(planes)
        _EDGE_RUNS[K, flat] = {
            "K": K, "flat": flat, "B": n // EDGE_R,
            "port": DeviceRun.from_reference_planes(planes, EDGE_R,
                                                    "cpu").arrays,
            "jax": {k: ({c: {m: jnp.asarray(a) for m, a in e.items()}
                         for c, e in v.items()} if k == "cols"
                        else jnp.asarray(v)) for k, v in planes.items()},
            "reads": reads,
            "pages": workload.row_edge_pages(EDGE_R, K, EDGE_WINDOWS, reads)}
    return _EDGE_RUNS[K, flat]


def edge_sigs(er, preds, M, packed=True, apply_preds=True):
    """(JAX GatherSig, port GatherSig, JAX ScanSig, port ScanSig, int
    literals): ``workload.row_edge_sigs`` with each side's signatures."""
    args = (er["B"], EDGE_R, er["K"], er["flat"], preds, M)
    jg, js_, _ = workload.row_edge_sigs(j_scan, j_gather, *args,
                                        packed=packed, apply_preds=apply_preds)
    tg, ts_, ints = workload.row_edge_sigs(t_scan, row_gather, *args,
                                           packed=packed,
                                           apply_preds=apply_preds)
    return jg, tg, js_, ts_, ints


def edge_gather(er, preds, M, pages, packed=True):
    jsig, tsig, _, _, ints = edge_sigs(er, preds, M, packed)
    rows = [j_gather.pack_params(wf, wl, lo, hi, read_planes(P, rd), ints,
                                 [], scan_from=sf)
            for wf, wl, lo, hi, rd, sf in pages]
    ip, fp = (np.stack([r[i] for r in rows]) for i in (0, 1))
    want = np.asarray(j_gather.compiled_gather_batch(jsig, len(pages))(
        er["jax"], ip, fp))
    got = row_gather.gather_rows_plain(tsig, er["port"], torch.from_numpy(ip),
                                       torch.from_numpy(fp)).numpy()
    return want, got


@pytest.mark.parametrize("K,flat", [(1, False), (2, False), (8, False),
                                    (8, True)],
                         ids=["K1", "K2", "K8", "K8-flat"])
def test_edge_planes_paged_buffers_equal_the_jax_program(K, flat):
    """K7's paged buffers on ``row_edge_planes`` (cleared groups, groups of
    1 to R versions, tombstone ties, column d unset in each window's last
    block, stand-in rows with their own planes): M = 1, and an M whose
    M-th match is a window's last, which lies in its last run block."""
    er = edge_run(K, flat)
    N = K * EDGE_R
    preds = EDGE_PREDS["a"]
    # The matches of the first window: the M-th of a page that starts at
    # row 0 is the window's last match.
    _, first = edge_gather(er, preds, N, [(0, 0, 0, N, er["reads"][0], None)])
    M_last = int(first[0, N, 0])
    starts = first[0, :min(M_last, N), 0]
    assert M_last >= 1 and starts[-1] >= (K - 1) * EDGE_R
    for M in sorted({1, M_last}):
        want, got = edge_gather(er, preds, M, er["pages"]["paged"])
        np.testing.assert_array_equal(got, want)
    # The whole run's page at M_last stops after its first window, where
    # count reached M.
    assert got[0, M_last, 0] == M_last and got[0, M_last, 2] == 1


@pytest.mark.parametrize("K,flat", [(2, False), (8, False), (8, True)],
                         ids=["K2", "K8", "K8-flat"])
def test_edge_planes_chunks_buffers_equal_the_jax_program(K, flat):
    """K7's chunks mode on the edge planes under three predicates: every
    window in place, groups past the window's (the stand-in row's planes,
    NULL) included."""
    er = edge_run(K, flat)
    want, got = edge_gather(er, EDGE_PREDS["dca"], K * EDGE_R,
                            er["pages"]["chunks"], packed=False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K,flat", [(1, False), (8, False), (8, True)],
                         ids=["K1", "K8", "K8-flat"])
def test_edge_planes_candidates_equal_the_jax_program(K, flat):
    """K9 over every window of a bounded range of the edge planes, with
    and without its predicates, against ``compiled_scan`` window by
    window."""
    er = edge_run(K, flat)
    N = K * EDGE_R
    row_lo, row_hi, read = er["pages"]["candidates"]
    for apply_preds in (True, False):
        _, _, jsig, tsig, ints = edge_sigs(er, EDGE_PREDS["dca"], 1,
                                           apply_preds=apply_preds)
        rd = read_planes(P, read)
        ip, fp = row_gather.pack_params(0, EDGE_WINDOWS - 1, row_lo, row_hi,
                                        rd, ints, [])
        res, start, ng = row_gather.scan_candidates_plain(
            tsig, er["port"], torch.from_numpy(ip), torch.from_numpy(fp),
            EDGE_WINDOWS)
        fn = j_scan.compiled_scan(jsig)
        lits = (jnp.int32(ints[0]), jnp.asarray(np.array(ints[1:3], np.int32)),
                jnp.asarray(np.array(ints[3:5], np.int32)))
        for w in range(EDGE_WINDOWS):
            base = w * N
            want = fn(er["jax"], jnp.int32(w * K), jnp.int32(row_lo - base),
                      jnp.int32(row_hi - base), *map(jnp.int32, rd), lits)
            np.testing.assert_array_equal(res[w].numpy(),
                                          np.asarray(want["result"]))
            np.testing.assert_array_equal(start[w].numpy(),
                                          np.asarray(want["start_idx"]))
            assert int(ng[w]) == int(want["num_groups"])


def test_geometry_constants_mirror_the_kernel_source():
    """``launch_geometry``'s constants are the CUDA source's (the kernel
    cannot be built here, so its shape is held through its source)."""
    import re
    from pathlib import Path

    src = (Path(row_gather.__file__).resolve().parent.parent / "csrc"
           / "row_gather.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kMaxCluster") == row_gather.CLUSTER_MAX
    assert const("kPieceMax") == row_gather.PIECE_MAX
    assert const("kHeadBytes") == row_gather.HEAD_BYTES
    assert const("kMaxCols") == row_gather.MAX_COLS
    assert const("kMaxPreds") == row_gather.MAX_PREDS
    assert const("kMaxOut") == row_gather.MAX_OUT
    assert "(21 + 2 * s.n_cols)" in src  # bytes a staged row
