"""The windowed full-run aggregate K5: the CUDA kernel's plan and wrapper.

Counterpart of the JAX package's ``ops/agg_fold.py``
``compiled_full_aggregate`` (an XLA program: a ``fori_loop`` over the
run's windows of K blocks, each resolved by ``ops/scan.py``
``scan_window`` and folded by ``agg_fold.fold_window``). The engine takes
it for runs past the flat fold's bounds (``ops.flat_fold.MAX_B`` blocks)
on the signatures K1 (``ops.flat_agg``) does not take: float aggregates,
f64 predicates, and more aggregates, predicates or value columns than
K1's descriptor holds; this one has no such ceiling. Its kernel is
``csrc/full_agg.cu``; its plain version ``agg_fold.full_aggregate_plain``.

- ``supports``: which signatures it takes (a flat run or a resolved view;
  i32, i64 and f64 predicates; COUNT, SUM, MIN, MAX);
- ``make_plan``: a signature's plan (descriptor, parameter rows, window
  records, output layout);
- ``full_aggregate``: the wrapper. For N parameter rows (specs) it
  returns [N, I] int32 and [N, F] float32, each row in
  ``agg_fold.pack``'s layout. On a run whose planes are CUDA tensors it
  launches the kernel (or raises); on CPU tensors it runs the plain
  version, spec by spec. ``full_aggregate.launches`` counts launches;
- ``launch_geometry`` / ``last_launch``: the launch shape, computed here
  and reported by the library.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import agg_fold, native
from yugabyte_db_tpu_torch.ops import scan as dscan

THREADS = 256           # threads of a window block; csrc/full_agg.cu kThreads
MAX_WINDOW_ROWS = 32768  # K * R under the limb bound; kMaxWindowRows
MAX_SPECS = 65535       # grid.y
SLOTS = 5               # int64 words of a window record an aggregate
PARAM_HEAD = 8  # row_lo, row_hi, w_first, w_last, read hi/lo, expiry hi/lo
_HEAD = 12              # descriptor header words (csrc/full_agg.cu Head)
_TOP_PLANES = ("valid", "tomb", "live", "ht_hi", "ht_lo", "exp_hi",
               "exp_lo")
_COL_PLANES = ("set", "isnull", "cmp", "arith")

_FN = {"count": 0, "sum": 1, "min": 2, "max": 3}
_KIND = {"i32": 0, "i64": 1, "f32": 2, "f64": 3, "str": 4}
_OP = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}


def supports(sig: dscan.ScanSig) -> bool:
    """K5 takes a flat run (or a multi-version run's resolved view, which
    is flat) under exact predicates (i32, i64, f64), with COUNT of any
    column and SUM/MIN/MAX of numeric columns, within the limb bound."""
    if not sig.flat or sig.K * sig.R > MAX_WINDOW_ROWS:
        return False
    if 65535 * sig.R * sig.K > agg_fold._LIMB_BUDGET:
        return False
    if any(p.kind not in ("i32", "i64", "f64") or p.op not in _OP
           for p in sig.preds):
        return False
    for ag in sig.aggs:
        if ag.fn == "count":
            continue
        if ag.fn not in _FN or ag.kind not in ("i32", "i64", "f32", "f64"):
            return False
    return True


@functools.lru_cache(maxsize=256)
def make_plan(aggs: tuple, preds: tuple, cols: tuple, R: int,
              K: int) -> "FullAggPlan":
    """The kernel plan of one signature; ``cols`` (``ColSig``s) lists every
    value column of the run: their set/isnull planes decide existence."""
    return FullAggPlan(aggs, preds, cols, R, K)


class FullAggPlan:
    """Static layout of one signature: column slots, the parameter row,
    the window record (``1 + SLOTS * n_aggs`` int64 words: scanned, then
    per aggregate its count or limb sums or window sum or extreme, and
    n) and the packed output offsets."""

    def __init__(self, aggs: tuple, preds: tuple, cols: tuple, R: int,
                 K: int):
        self.aggs, self.preds, self.cols = tuple(aggs), tuple(preds), \
            tuple(cols)
        self.R, self.K = int(R), int(K)
        if not supports(self.scan_sig(1)):
            raise ValueError(f"K5 does not take {self.aggs} {self.preds} "
                             f"at R={R}, K={K}")
        self.slot = {cs.col_id: i for i, cs in enumerate(self.cols)}
        used = [p.col_id for p in self.preds] + [
            a.col_id for a in self.aggs if a.col_id is not None]
        if any(cid not in self.slot for cid in used):
            raise ValueError("a predicate or aggregate reads a column "
                             "missing from cols")
        self.lit_offsets = []
        off = PARAM_HEAD
        for p in self.preds:
            self.lit_offsets.append(off)
            off += 1 if p.kind == "i32" else 2
        self.n_params = off
        # agg_fold.pack's layout: ints = [scanned, ...], floats = [...].
        self.ioffs, self.foffs = [], []
        ni, nf = 1, 0
        for a in self.aggs:
            self.ioffs.append(ni)
            self.foffs.append(nf)
            if a.fn == "count":
                ni += 1
            elif a.fn == "sum":
                if a.kind in ("f32", "f64"):
                    nf, ni = nf + 2, ni + 1
                else:
                    ni += agg_fold.DIGITS + 1
            elif a.kind == "f32":
                nf, ni = nf + 1, ni + 1
            else:
                ni += 2 if a.kind == "i32" else 3
        self.n_ints, self.n_floats = ni, nf
        self.rec_words = 1 + SLOTS * len(self.aggs)

    def scan_sig(self, B: int) -> dscan.ScanSig:
        """The ``ScanSig`` of this plan over a run of ``B`` blocks."""
        return dscan.ScanSig(B=B, R=self.R, K=self.K, cols=self.cols,
                             preds=self.preds, aggs=self.aggs,
                             apply_preds=True, flat=True)

    # -- what the kernel is given ------------------------------------------
    def plane_table(self, arrays: dict) -> list:
        """The planes in the kernel's pointer order: valid, tomb, live,
        ht_hi, ht_lo, exp_hi, exp_lo, then per column slot set, isnull,
        cmp ([B, R, P] int32) and arith (float32, or None)."""
        out = [arrays[n] for n in _TOP_PLANES]
        for cs in self.cols:
            c = arrays["cols"][cs.col_id]
            out.extend(c.get(n) for n in _COL_PLANES)
        return out

    def descriptor(self, table: list) -> np.ndarray:
        """int64 words: the header [n_cols, n_preds, n_aggs, n_params,
        n_ints, n_floats, R, K * R, then the word offsets of the column,
        predicate, aggregate and pointer tables]; per column slot (order
        planes a row, has arith); per predicate (slot, kind, op, literal
        offset); per aggregate (fn, slot or -1, kind, ivec offset, fvec
        offset); then the planes' addresses (0 for a missing arith)."""
        n_cols, n_preds, n_aggs = (len(self.cols), len(self.preds),
                                   len(self.aggs))
        off_cols = _HEAD
        off_preds = off_cols + 2 * n_cols
        off_aggs = off_preds + 4 * n_preds
        off_ptrs = off_aggs + 5 * n_aggs
        w = np.zeros(off_ptrs + len(table), np.int64)
        w[:_HEAD] = (n_cols, n_preds, n_aggs, self.n_params, self.n_ints,
                     self.n_floats, self.R, self.K * self.R, off_cols,
                     off_preds, off_aggs, off_ptrs)
        for k in range(n_cols):
            cmp, arith = table[7 + 4 * k + 2], table[7 + 4 * k + 3]
            w[off_cols + 2 * k: off_cols + 2 * k + 2] = (
                cmp.shape[-1], arith is not None)
        for q, (p, lit) in enumerate(zip(self.preds, self.lit_offsets)):
            w[off_preds + 4 * q: off_preds + 4 * q + 4] = (
                self.slot[p.col_id], _KIND[p.kind], _OP[p.op], lit)
        for i, a in enumerate(self.aggs):
            w[off_aggs + 5 * i: off_aggs + 5 * i + 5] = (
                _FN[a.fn], -1 if a.col_id is None else self.slot[a.col_id],
                _KIND.get(a.kind, 0), self.ioffs[i], self.foffs[i])
        w[off_ptrs:] = [0 if t is None else t.data_ptr() for t in table]
        return w

    def param_row(self, row_lo: int, row_hi: int, w_first: int,
                  w_last: int, read_planes, lits) -> list:
        """One spec's parameter row: row range (clipped to int32), window
        range, read point planes (read hi/lo, expiry hi/lo), then one word
        per i32 literal and two (hi, lo) per i64/f64 literal."""
        top = (1 << 31) - 1
        row = [max(0, min(int(row_lo), top)), max(0, min(int(row_hi), top)),
               int(w_first), int(w_last), *(int(v) for v in read_planes)]
        for p, lit in zip(self.preds, lits):
            row.extend(int(v) for v in np.atleast_1d(lit)[
                :1 if p.kind == "i32" else 2])
        return row

    def literals(self, row) -> tuple:
        """A parameter row's literals back in ``pred_literal_host``'s
        form."""
        out = []
        for p, off in zip(self.preds, self.lit_offsets):
            if p.kind == "i32":
                out.append(np.int32(row[off]))
            else:
                out.append(np.array(row[off:off + 2], np.int32))
        return tuple(out)

    def bytes_per_row(self, table: list) -> int:
        """Plane bytes the fold needs per row in range: hybrid time and
        expiry, valid/tomb/live, set/isnull of every column, and each
        column's order planes (predicates, integer aggregates, f64
        MIN/MAX) and arith plane (float SUM, f32 MIN/MAX) once."""
        cmp_cols = {p.col_id for p in self.preds}
        arith_cols = set()
        for a in self.aggs:
            if a.fn == "count":
                continue
            if a.kind == "f32" or (a.fn == "sum" and a.kind == "f64"):
                arith_cols.add(a.col_id)
            else:
                cmp_cols.add(a.col_id)
        n = 16 + 3 + 2 * len(self.cols) + 4 * len(arith_cols)
        for k, cs in enumerate(self.cols):
            if cs.col_id in cmp_cols:
                n += 4 * table[7 + 4 * k + 2].shape[-1]
        return n


# -- the wrapper -----------------------------------------------------------

def launch_geometry(plan: FullAggPlan, params: np.ndarray, W: int) -> dict:
    """The two launches for the parameter rows ``params`` over a run of
    ``W`` windows, as ``csrc/full_agg.cu`` makes them: pass 1 a block of
    ``THREADS`` threads a (window, spec), over the windows from the
    smallest ``w_first`` to the largest ``w_last`` of the specs with a
    window (``w_base``, ``windows``; a block outside its spec's range
    returns at once), writing one record of ``rec_words`` int64 words;
    pass 2 a block a spec of ``fold_threads`` threads, a warp a statistic
    (scanned, then each aggregate) folding the spec's records in window
    order."""
    n = params.shape[0]
    spans = [(int(a), int(b)) for a, b in params[:, 2:4].tolist() if a < b]
    w_base = min((a for a, _b in spans), default=0)
    w_end = max((b for _a, b in spans), default=0)
    if spans and (w_base < 0 or w_end > W):
        raise ValueError(f"windows [{w_base}, {w_end}) outside the run's "
                         f"{W}")
    items = 1 + len(plan.aggs)
    return {"w_base": w_base, "windows": w_end - w_base, "specs": n,
            "threads": THREADS, "fold_threads": 32 * min(items, 32),
            "rec_words": plan.rec_words}


def _check(plan: FullAggPlan, arrays: dict, params: np.ndarray) -> tuple:
    table = plan.plane_table(arrays)
    B, R = table[0].shape
    if R != plan.R:
        raise ValueError(f"planes of R={R}, plan of R={plan.R}")
    if B * R >= (1 << 31):
        raise ValueError(f"{B * R} rows exceed the kernel's int32 row range")
    device = table[0].device
    for k, t in enumerate(table):
        if t is None:
            continue
        if t.device != device or not t.is_contiguous() or \
                tuple(t.shape[:2]) != (B, R):
            raise ValueError(f"plane {k} is not a contiguous [B, R] plane "
                             f"on {device}")
        col = (k - 7) % 4 if k >= 7 else None
        want = (torch.int32 if k in (3, 4, 5, 6) or col == 2
                else torch.float32 if col == 3 else torch.bool)
        if t.dtype != want:
            raise ValueError(f"plane {k} is {t.dtype}, want {want}")
    for a in plan.aggs:
        reads_arith = a.fn != "count" and (
            a.kind == "f32" or (a.fn == "sum" and a.kind == "f64"))
        if reads_arith and "arith" not in arrays["cols"][a.col_id]:
            raise ValueError(f"column {a.col_id} has no arith plane")
    if params.dtype != np.int32 or params.ndim != 2 or \
            params.shape[1] != plan.n_params:
        raise ValueError(f"params must be int32 [N, {plan.n_params}]")
    if not 1 <= params.shape[0] <= MAX_SPECS:
        raise ValueError(f"{params.shape[0]} specs; the kernel takes "
                         f"1..{MAX_SPECS}")
    return table, B


def full_aggregate(plan: FullAggPlan, arrays: dict,
                   params: np.ndarray) -> tuple:
    """(ivec [N, I] int32, fvec [N, F] float32) of the N specs whose
    parameter rows (``plan.param_row``; host int32) are ``params``, over
    the run ``arrays`` (``DeviceRun.arrays``). Launches the CUDA kernel
    for CUDA planes, runs the plain version for CPU planes, and raises
    for anything else."""
    table, B = _check(plan, arrays, params)
    device = table[0].device
    if device.type == "cpu":
        return full_aggregate_plain(plan, arrays, params)
    if device.type != "cuda":
        raise ValueError(f"full_aggregate runs on cuda or cpu, not {device}")
    geo = launch_geometry(plan, params, B // plan.K)
    n = params.shape[0]
    lib = _library()
    desc = torch.from_numpy(plan.descriptor(table)).to(device)
    dparams = torch.from_numpy(np.ascontiguousarray(params)).to(device)
    rec = torch.empty((n, max(geo["windows"], 1), plan.rec_words),
                      dtype=torch.int64, device=device)
    ivec = torch.empty((n, plan.n_ints), dtype=torch.int32, device=device)
    fvec = torch.empty((n, max(plan.n_floats, 1)), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.full_agg_launch(
            ctypes.c_void_p(desc.data_ptr()),
            ctypes.c_void_p(dparams.data_ptr()), n, plan.n_params,
            len(plan.aggs), plan.K * plan.R, plan.rec_words, geo["w_base"],
            geo["windows"], ctypes.c_void_p(rec.data_ptr()),
            ctypes.c_void_p(ivec.data_ptr()), plan.n_ints,
            ctypes.c_void_p(fvec.data_ptr()), plan.n_floats,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"full_agg kernel launch failed ({rc}): "
                           f"{lib.full_agg_error_string(rc).decode()}")
    full_aggregate.launches += 1
    return ivec, fvec[:, :plan.n_floats]


# Kernel launches since the count was last set to 0.
full_aggregate.launches = 0


def full_aggregate_plain(plan: FullAggPlan, arrays: dict,
                         params: np.ndarray) -> tuple:
    """The plain version on the run's device: ``agg_fold.
    full_aggregate_plain`` for each parameter row, stacked."""
    sig = plan.scan_sig(int(arrays["valid"].shape[0]))
    ivecs, fvecs = [], []
    for row in params.tolist():
        iv, fv = agg_fold.full_aggregate_plain(
            sig, arrays, row[0], row[1], row[2], row[3], *row[4:8],
            plan.literals(row))
        ivecs.append(iv)
        fvecs.append(fv)
    return torch.stack(ivecs), torch.stack(fvecs)


def last_launch() -> dict:
    """The shape of this process's last K5 launch as the library reports
    it (``launch_geometry``'s keys)."""
    lib = _library()
    out = (ctypes.c_int32 * 6)()
    lib.full_agg_last_launch(out)
    return dict(zip(("w_base", "windows", "specs", "threads",
                     "fold_threads", "rec_words"), out))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = native.load_library("full_agg")
    lib.full_agg_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.full_agg_launch.restype = ctypes.c_int
    lib.full_agg_error_string.argtypes = [ctypes.c_int]
    lib.full_agg_error_string.restype = ctypes.c_char_p
    lib.full_agg_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.full_agg_last_launch.restype = None
    return lib
