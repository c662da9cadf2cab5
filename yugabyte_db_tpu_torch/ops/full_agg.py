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
  records, output layout, column passes, the planes a tile holds);
- ``full_aggregate``: the wrapper. For N parameter rows (specs) it
  returns [N, I] int32 and [N, F] float32, each row in
  ``agg_fold.pack``'s layout. On a run whose planes are CUDA tensors it
  launches the kernel (or raises); on CPU tensors it runs the plain
  version, spec by spec. ``full_aggregate.launches`` counts launches;
- ``launch_geometry`` / ``last_launch``: the launch's partition (windows
  to blocks, specs to chunks, aggregates to passes, tile rows and shared
  bytes), computed here and reported by the library; ``read_classes``
  the read points each chunk stages visibility for;
- ``fold_digits``: the kernel's closed form of one carry step a window,
  in Python, for the tests to hold against ``agg_fold.carry_step``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import agg_fold, native
from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.ops.encodings import require_plain

THREADS = 256           # threads of a window block; csrc/full_agg.cu kThreads
WARPS = THREADS // 32
MAX_WINDOW_ROWS = 32768  # K * R under the limb bound; kMaxWindowRows
MAX_SPECS = 65535       # fold grid
SLOTS = 5               # int32 words of a window record an aggregate
PARAM_HEAD = 8  # row_lo, row_hi, w_first, w_last, read hi/lo, expiry hi/lo
MAX_SPEC_CHUNK = 64     # specs a block serves; kMaxSpecChunk
READ_CLASSES = 8        # read points a chunk stages visibility for
CLASS_WORDS = 1 + 4 * READ_CLASSES
MAX_TILE_ROWS = 1024    # rows a block stages at once (32 a lane at most)
MIN_TILE_ROWS = 32
SMEM_LIMIT = 232448     # shared bytes a block may use on Hopper
FOLD_WARPS = 8          # warps of a fold block; kFoldWarps
SPEC_HEAD = 6           # a staged spec: row_lo, row_hi, w_first, w_last, class
SLOT_HEAD = 2           # a spec's accumulators: scanned, then 12 a pass
PASS_WORDS = 12
# Resident blocks an SM the tile's shared bytes aim for (csrc/full_agg.cu
# kMinBlocks), and fewer for a chunk of fewer than 8 specs, whose warps
# share a tile's rows: larger tiles, fewer barriers and reductions.
BLOCKS_PER_SM = 3
FEW_BLOCKS_PER_SM = 2
# Blocks the grid aims for (one round of BLOCKS_PER_SM on each of the
# H100's 132 SMs) and the rows a block takes at most when windows are
# small.
TARGET_BLOCKS = BLOCKS_PER_SM * 132
BLOCK_ROWS = 8192
_HEAD = 17              # descriptor header words (csrc/full_agg.cu Head)
_TOP_PLANES = ("valid", "tomb", "live", "ht_hi", "ht_lo", "exp_hi",
               "exp_lo")
_COL_PLANES = ("set", "isnull", "cmp", "arith")
_SUM, _MIN, _MAX = 1, 2, 4  # a pass's flags
# The launch's partition as launch_geometry gives it and the library
# reports it (csrc/full_agg.cu g_last_launch).
GEOMETRY = ("w_base", "windows", "specs", "chunk", "chunks", "tile_rows",
            "windows_per_block", "blocks", "warps_per_spec",
            "rows_per_load", "async_copy", "read_classes", "passes",
            "staged",
            "shared_bytes", "threads", "fold_threads", "rec_words")

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
    the window record (``1 + SLOTS * n_aggs`` int32 words: scanned, then
    per aggregate its n and its limb sums, window sum or extreme), the
    packed output offsets, the passes (one a column that a SUM, MIN, MAX
    or COUNT reads: which of them it holds) and the planes a tile stages
    (order words and arith planes that a predicate or pass reads)."""

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
        self._plan_passes()

    def _plan_passes(self) -> None:
        """``passes``: (slot, kind, flags, order word 0, order word 1,
        arith), staged indices or -1, one a column an aggregate reads, in
        order of first use; ``agg_pass``: each aggregate's pass (-1 for
        COUNT(*)); ``staged``: the (slot, word or -1 for arith) planes a
        tile holds; ``pred_staged``: each predicate's (word 0, word 1);
        ``raw``: the planes a tile buffer holds as they lie, (slot, is
        arith, words a row, word offset a row), ``val_words`` words a row
        in all; ``staged_at``: each staged plane's (raw offset, words a
        row, word)."""
        self.staged = []
        index = {}

        def stage(slot, plane):
            if (slot, plane) not in index:
                index[slot, plane] = len(self.staged)
                self.staged.append((slot, plane))
            return index[slot, plane]

        self.pred_staged = []
        for p in self.preds:
            slot = self.slot[p.col_id]
            self.pred_staged.append(
                (stage(slot, 0), -1 if p.kind == "i32" else stage(slot, 1)))
        by_slot = {}
        self.agg_pass = []
        for a in self.aggs:
            if a.col_id is None:
                self.agg_pass.append(-1)
                continue
            slot = self.slot[a.col_id]
            entry = by_slot.setdefault(slot, [len(by_slot), None, 0])
            if a.fn != "count":
                entry[1] = a.kind
                entry[2] |= {"sum": _SUM, "min": _MIN, "max": _MAX}[a.fn]
            self.agg_pass.append(entry[0])
        self.passes = []
        for slot, (_i, kind, flags) in by_slot.items():
            vc0 = vc1 = va = -1
            wide = kind in ("i64", "f64")
            if flags & _SUM and kind in ("f32", "f64"):
                va = stage(slot, -1)
            elif flags & _SUM:
                vc0 = stage(slot, 0)
                vc1 = stage(slot, 1) if wide else -1
            if flags & (_MIN | _MAX) and kind == "f32":
                va = stage(slot, -1)
            elif flags & (_MIN | _MAX):
                vc0 = stage(slot, 0)
                vc1 = stage(slot, 1) if wide else -1
            self.passes.append((slot, _KIND[kind] if flags else 0, flags,
                                vc0, vc1, va))
        self.raw, raw_at = [], {}
        self.val_words = 0
        self.staged_at = []
        for slot, plane in self.staged:
            key = (slot, plane < 0)
            if key not in raw_at:
                width = 2 if plane >= 0 and self.cols[slot].kind in (
                    "i64", "f64") else 1
                raw_at[key] = len(self.raw)
                self.raw.append((slot, int(plane < 0), width,
                                 self.val_words))
                self.val_words += width
            _slot, _arith, width, off = self.raw[raw_at[key]]
            self.staged_at.append((off, width, max(plane, 0)))
        self.desc_words = (_HEAD + 6 * len(self.preds)
                           + 6 * len(self.aggs) + 6 * len(self.passes)
                           + 5 * len(self.staged) + 4 * len(self.raw)
                           + len(_TOP_PLANES)
                           + len(_COL_PLANES) * len(self.cols))

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
        n_ints, n_floats, R, K * R, n_passes, n_staged, n_raw, then the
        word offsets of the predicate, aggregate, pass, staged-plane,
        raw-plane and pointer tables]; per predicate (slot, kind, op,
        literal word after the parameter head, staged word 0, staged word
        1 or -1); per aggregate (fn, slot or -1, kind, ivec offset, fvec
        offset, pass or -1); per pass ``passes``' entry; per staged plane
        (slot, order word or -1 for arith, then ``staged_at``'s entry);
        per raw plane ``raw``'s entry; then the planes' addresses (0 for a
        missing arith)."""
        n_cols = len(self.cols)
        off_preds = _HEAD
        off_aggs = off_preds + 6 * len(self.preds)
        off_passes = off_aggs + 6 * len(self.aggs)
        off_staged = off_passes + 6 * len(self.passes)
        off_raw = off_staged + 5 * len(self.staged)
        off_ptrs = off_raw + 4 * len(self.raw)
        w = np.zeros(off_ptrs + len(table), np.int64)
        w[:_HEAD] = (n_cols, len(self.preds), len(self.aggs), self.n_params,
                     self.n_ints, self.n_floats, self.R, self.K * self.R,
                     len(self.passes), len(self.staged), len(self.raw),
                     off_preds, off_aggs, off_passes, off_staged, off_raw,
                     off_ptrs)
        for q, (p, lit, vs) in enumerate(zip(self.preds, self.lit_offsets,
                                             self.pred_staged)):
            w[off_preds + 6 * q: off_preds + 6 * q + 6] = (
                self.slot[p.col_id], _KIND[p.kind], _OP[p.op],
                lit - PARAM_HEAD, *vs)
        for i, a in enumerate(self.aggs):
            w[off_aggs + 6 * i: off_aggs + 6 * i + 6] = (
                _FN[a.fn], -1 if a.col_id is None else self.slot[a.col_id],
                _KIND.get(a.kind, 0), self.ioffs[i], self.foffs[i],
                self.agg_pass[i])
        for i, ps in enumerate(self.passes):
            w[off_passes + 6 * i: off_passes + 6 * i + 6] = ps
        for i, (st, at) in enumerate(zip(self.staged, self.staged_at)):
            w[off_staged + 5 * i: off_staged + 5 * i + 5] = (*st, *at)
        for i, raw in enumerate(self.raw):
            w[off_raw + 4 * i: off_raw + 4 * i + 4] = raw
        w[off_ptrs:] = [0 if t is None else t.data_ptr() for t in table]
        assert w.size == self.desc_words
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

def shared_layout(plan: FullAggPlan, chunk: int, G: int, tile: int,
                  async_copy: bool, n_cls: int) -> int:
    """Dynamic shared bytes of a window block (csrc/full_agg.cu layout):
    the descriptor, each spec's accumulators (``G`` sets a spec), the
    staged specs (head and biased literals), the read classes, each
    staged plane's place in a tile buffer, each lane's row masks (``n_cls``
    read classes, the candidates, each predicate and pass), the decoded
    tile (class bits and column bits a row), and the tile buffers: one,
    or two with the asynchronous copy, each the value planes of ``tile``
    rows and with the copy their hybrid-time, expiry and bool planes
    too."""
    def align16(x):
        return (x + 15) // 16 * 16

    slot_words = SLOT_HEAD + PASS_WORDS * len(plan.passes)
    head_words = SPEC_HEAD + plan.n_params - PARAM_HEAD
    nnw = (len(plan.cols) + 31) // 32
    buf = align16(plan.val_words * tile * 4)
    if async_copy:
        buf += 16 * tile + align16((3 + 2 * len(plan.cols)) * tile)
    return (align16(plan.desc_words * 8) + align16(chunk * G * slot_words * 4)
            + align16(chunk * head_words * 4) + align16(CLASS_WORDS * 4)
            + align16(len(plan.staged) * 8)
            + WARPS * 32 * 4 * (n_cls + 1 + len(plan.preds) + len(plan.passes))
            + align16(tile * 4)
            + align16(nnw * tile * 4) + (2 if async_copy else 1) * buf)


def launch_geometry(plan: FullAggPlan, params: np.ndarray, W: int,
                    aligned: bool = True) -> dict:
    """The partition of a launch over the parameter rows ``params`` on a
    run of ``W`` windows, as ``csrc/full_agg.cu`` takes it (``GEOMETRY``'s
    keys). Pass 1 runs over the windows from the smallest ``w_first`` to
    the largest ``w_last`` of the specs with a window (``w_base``,
    ``windows``): grid.y over ``chunks`` chunks of at most ``chunk``
    (<= MAX_SPEC_CHUNK) specs, dealt evenly; grid.x over ``blocks`` runs
    of ``windows_per_block`` consecutive windows (more than one only for
    windows under BLOCK_ROWS rows, and only as far as the grid keeps
    TARGET_BLOCKS blocks); each window walked in tiles of ``tile_rows``
    rows, served by ``warps_per_spec`` warps a spec (8 / the chunk
    rounded up to a power of two, at least 1). A tile is copied with
    cp.async one ahead of the tile being served (``async_copy``) when
    every plane is ``aligned`` to 16 bytes and a window is a multiple of
    16 rows, then decoded ``rows_per_load`` rows a thread (tile_rows /
    THREADS in [1, 4]); else loaded and decoded one row a thread. The
    tile is the largest power of two from the window's rows in [256,
    1024] whose block fits BLOCKS_PER_SM to an SM (FEW_BLOCKS_PER_SM for
    a chunk of fewer than 8 specs), else the largest in [32, 1024] that
    fits SMEM_LIMIT (else the chunks shrink). The aggregates run in
    ``passes`` column passes over ``staged`` staged planes;
    ``read_classes`` is the most read points a chunk stages visibility
    for. Pass 2 is a block of ``fold_threads`` a spec."""
    n = params.shape[0]
    spans = [(int(a), int(b)) for a, b in params[:, 2:4].tolist() if a < b]
    w_base = min((a for a, _b in spans), default=0)
    w_end = max((b for _a, b in spans), default=0)
    if spans and (w_base < 0 or w_end > W):
        raise ValueError(f"windows [{w_base}, {w_end}) outside the run's "
                         f"{W}")
    windows = w_end - w_base
    N = plan.K * plan.R
    async_copy = bool(aligned and N % 16 == 0)
    top = min(MAX_TILE_ROWS, max(256, 1 << (N.bit_length() - 1)))
    chunks = -(-n // MAX_SPEC_CHUNK)
    while True:
        chunk = -(-n // chunks)
        G8 = WARPS // (1 << (min(chunk, WARPS) - 1).bit_length())
        n_cls = int(read_classes(params, chunk)[1][:, 0].max())

        def smem(t):
            return shared_layout(plan, chunk, min(G8, t // 32), t,
                                 async_copy, n_cls)

        tiles = [top >> k for k in range((top // MIN_TILE_ROWS)
                                         .bit_length())]
        per_sm = FEW_BLOCKS_PER_SM if chunk < WARPS else BLOCKS_PER_SM
        fit = [t for t in tiles if t >= 256
               and smem(t) <= SMEM_LIMIT // per_sm]
        fit = fit or [t for t in tiles if smem(t) <= SMEM_LIMIT]
        if fit:
            tile = fit[0]
            break
        if chunk == 1:
            raise ValueError(f"a K5 tile of {plan.desc_words} descriptor "
                             f"words and {len(plan.staged)} staged planes "
                             f"needs {smem(MIN_TILE_ROWS)} shared bytes")
        chunks += 1
    G = min(G8, tile // 32)
    vec = max(1, min(4, tile // THREADS)) if async_copy else 1
    wpb = max(1, min(BLOCK_ROWS // N, -(-windows * chunks // TARGET_BLOCKS)))
    items = 1 + len(plan.aggs)
    return dict(zip(GEOMETRY, (
        w_base, windows, n, chunk, chunks, tile, wpb, -(-windows // wpb),
        G, vec, int(async_copy), n_cls, len(plan.passes), len(plan.staged),
        smem(tile), THREADS, 32 * min(items, FOLD_WARPS), plan.rec_words)))


def fold_digits(windows) -> list:
    """The digits of one ``agg_fold.carry_step`` a window over the
    windows' limb sums (``windows``: [T][4] non-negative ints), in closed
    form from the totals and the last 7 windows, as ``csrc/full_agg.cu``
    fold_digits computes them. With S_k(t) the sum of limb k over the
    first t windows and C_k(t) the carries digit k has passed on after
    step t (C_-1 = 0; all 0 at t <= 0): C_k(t) = (S_k(t) + C_(k-1)(t-1))
    >> 16, and digit k = ((S_k(T) + C_(k-1)(T-1)) mod 2^16) + C_(k-1)(T)
    - C_(k-1)(T-1)."""
    T = len(windows)
    total = [sum(int(x[k]) for x in windows) for k in range(4)]
    prev, out = [0] * 8, []
    for k in range(agg_fold.DIGITS):
        acc = total[k] if k < 4 else 0
        s0 = acc if T > 0 else 0
        cur = []
        for j in range(8):
            cin = prev[j + 1] if j + 1 < 8 else 0
            cur.append((acc + cin) >> 16 if T - j > 0 else 0)
            if k < 4 and j < 7 and T - 1 - j >= 0:
                acc -= int(windows[T - 1 - j][k])
        out.append(((s0 + prev[1]) & 0xFFFF) + prev[0] - prev[1])
        prev = cur
    return out


def read_classes(params: np.ndarray, chunk: int) -> tuple:
    """The read points each chunk of ``chunk`` specs stages visibility
    for: (class [N] int32, each spec's index among its chunk's first
    READ_CLASSES distinct read points or -1; [chunks, CLASS_WORDS] int32,
    each chunk's count of classes, then their read planes)."""
    n = params.shape[0]
    classes = np.full(n, -1, np.int32)
    table = np.zeros((-(-n // chunk), CLASS_WORDS), np.int32)
    for c in range(table.shape[0]):
        seen = {}
        for s in range(c * chunk, min(n, (c + 1) * chunk)):
            key = tuple(int(v) for v in params[s, 4:8])
            if key not in seen and len(seen) < READ_CLASSES:
                table[c, 1 + 4 * len(seen): 5 + 4 * len(seen)] = key
                seen[key] = len(seen)
            classes[s] = seen.get(key, -1)
        table[c, 0] = len(seen)
    return classes, table


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
    require_plain(arrays, "K5")
    table, B = _check(plan, arrays, params)
    device = table[0].device
    if device.type == "cpu":
        return full_aggregate_plain(plan, arrays, params)
    if device.type != "cuda":
        raise ValueError(f"full_aggregate runs on cuda or cpu, not {device}")
    aligned = all(t.data_ptr() % 16 == 0 for t in table if t is not None)
    geo = launch_geometry(plan, params, B // plan.K, aligned)
    n = params.shape[0]
    lib = _library()
    classes, creads = read_classes(params, geo["chunk"])
    sched = np.concatenate([params.ravel(), classes, creads.ravel()])
    if sched.size % 2:
        sched = np.append(sched, np.int32(0))
    # One upload from pinned memory, not waited for: the descriptor's
    # int64 words, then the int32 schedule.
    words = plan.descriptor(table)
    buf = torch.from_numpy(np.concatenate([words, sched.view(np.int64)])
                           ).pin_memory().to(device, non_blocking=True)
    rec = torch.empty((n, max(geo["windows"], 1), plan.rec_words),
                      dtype=torch.int32, device=device)
    ivec = torch.empty((n, plan.n_ints), dtype=torch.int32, device=device)
    fvec = torch.empty((n, max(plan.n_floats, 1)), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.full_agg_launch(
            ctypes.c_void_p(buf.data_ptr()), words.size,
            ctypes.c_void_p(buf.data_ptr() + 8 * words.size), n,
            plan.n_params, len(plan.cols), len(plan.preds), len(plan.aggs),
            len(plan.passes), len(plan.staged), plan.val_words,
            geo["read_classes"], plan.K * plan.R,
            plan.rec_words,
            geo["w_base"], geo["windows"], geo["chunk"], geo["tile_rows"],
            geo["windows_per_block"], geo["warps_per_spec"],
            geo["rows_per_load"], geo["async_copy"],
            ctypes.c_void_p(rec.data_ptr()),
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
    """The partition of this process's last K5 launch as the library
    reports it (``launch_geometry``'s keys)."""
    lib = _library()
    out = (ctypes.c_int32 * len(GEOMETRY))()
    lib.full_agg_last_launch(out)
    return dict(zip(GEOMETRY, out))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = native.load_library("full_agg")
    I, P = ctypes.c_int, ctypes.c_void_p
    lib.full_agg_launch.argtypes = [
        P, I, P, I, I, I, I, I, I, I, I, I, ctypes.c_longlong, I, I, I, I,
        I, I, I, I, I, P, P, I, P, I, P]
    lib.full_agg_launch.restype = ctypes.c_int
    lib.full_agg_error_string.argtypes = [ctypes.c_int]
    lib.full_agg_error_string.restype = ctypes.c_char_p
    lib.full_agg_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.full_agg_last_launch.restype = None
    return lib
