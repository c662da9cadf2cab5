"""Flat-run MVCC aggregate fold: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas_agg.py``, whose Pallas TPU
kernel becomes ``csrc/flat_agg.cu`` here (its source note says how the
design differs). On a flat run (one version per key) it computes what the
flat fold computes for eligible signatures: COUNT(*) / COUNT(col), exact
SUM over i32/i64 columns (16-bit limb partials) and MIN/MAX over i32/i64
order planes, under i32/i64 predicates (``=, !=, <, <=, >, >=``).

- ``eligible``: which signatures the kernel takes;
- ``make_plan``: a signature's kernel plan (descriptor, parameter rows,
  partial-row layout);
- ``flat_aggregate``: the wrapper. On CUDA tensors it launches the kernel
  (or raises); on CPU tensors it runs ``flat_aggregate_plain``, the same
  arithmetic in torch ops. Either returns ``[N, G, S]`` int64 partial rows
  in the Pallas kernel's slot order: ``[count, scanned, per aggregate:
  count | 4 limbs + n | hi, lo, n]``; ``scanned`` counts the existing
  rows in range before predicates, as the Pallas kernel's slot 1 does;
- ``launch_geometry``: the kernel's launch shape (tile rows, grid x, spec
  chunk per block, dynamic shared memory), pure Python;
- ``fold_partials``: the torch fold of ``[N, G, S]`` to ``[N, S]`` (the
  counterpart of ``pallas_agg.combine_partials``'s reduction, not a
  kernel); ``FlatAggPlan.combine`` / ``FlatAggPlan.to_packed`` read a
  folded row on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import native
from yugabyte_db_tpu_torch.ops.encodings import require_plain
from yugabyte_db_tpu_torch.ops.agg_fold import DIGITS
from yugabyte_db_tpu_torch.ops.scan import I32_MAX, I32_MIN, le2
from yugabyte_db_tpu_torch.utils import planes as PL

# Descriptor limits and launch shape; csrc/flat_agg.cu holds the same
# constants.
MAX_COLS = 16
MAX_PREDS = 8
MAX_AGGS = 8
THREADS = 256
VEC = 4                      # consecutive rows a thread loads as vectors
TILE_ROWS = THREADS * VEC    # rows a block loads at once
BLOCKS_PER_SM = 4            # resident blocks the kernel is built for
SPEC_CHUNK = 64              # specs one block serves (grid.y chunks more)
SMEM_LIMIT = 232_448         # shared-memory bytes a block may use
ALIGN = 16                   # plane base alignment for 16-byte loads
_SPEC_HEAD_BYTES = 32        # read key, expiry key, row_lo, row_hi, class
READ_CLASSES = 4             # read points a block masks once per tile
HEAD_WORDS = 4               # staged hybrid-time and expiry words a row
MASK_KINDS = 2 + READ_CLASSES  # staged row masks besides one per column
_HEAD = 5
DESC_WORDS = _HEAD + MAX_COLS + 4 * MAX_PREDS + 3 * MAX_AGGS
PARAM_HEAD = 6  # row_lo, row_hi, read_hi, read_lo, rexp_hi, rexp_lo

_FN = {"count": 0, "sum": 1, "min": 2, "max": 3}
_OP = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_KIND = {"i32": 0, "i64": 1}
# Partial-row slots per aggregate (after [count, scanned]).
_SLOTS = {"count": 1, "sum": 5, "min": 3, "max": 3}

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def eligible(sig) -> bool:
    """Kernel applicability for a ``ScanSig``: flat run; COUNT of any
    column, SUM/MIN/MAX of i32/i64 columns; i32/i64 predicates without
    IN; within the descriptor's limits (``sig.cols`` is every value
    column: existence reads them all)."""
    if not sig.flat or not sig.aggs or len(sig.aggs) > MAX_AGGS:
        return False
    if len(sig.preds) > MAX_PREDS or len(sig.cols) > MAX_COLS:
        return False
    for ag in sig.aggs:
        if ag.fn == "count":
            continue
        if ag.fn not in ("sum", "min", "max") or ag.kind not in _KIND:
            return False
    return all(p.kind in _KIND and p.op in _OP for p in sig.preds)


@functools.lru_cache(maxsize=256)
def make_plan(aggs: tuple, preds: tuple, col_ids: tuple) -> FlatAggPlan:
    """The kernel plan of one signature; ``col_ids`` lists every value
    column of the run (their set/isnull planes decide existence)."""
    return FlatAggPlan(aggs, preds, col_ids)


class FlatAggPlan:
    """Static layout of one signature: which column slot each predicate
    and aggregate reads, the parameter-row layout and the partial-row
    layout."""

    def __init__(self, aggs: tuple, preds: tuple, col_ids: tuple):
        self.aggs = tuple(aggs)
        self.preds = tuple(preds)
        self.col_ids = tuple(col_ids)
        used = [p.col_id for p in self.preds] + [
            a.col_id for a in self.aggs if a.col_id is not None]
        if any(cid not in self.col_ids for cid in used):
            raise ValueError("a predicate or aggregate reads a column "
                             "missing from col_ids")
        if len(self.col_ids) > MAX_COLS or len(self.aggs) > MAX_AGGS or \
                len(self.preds) > MAX_PREDS:
            raise ValueError("signature exceeds the kernel's descriptor")
        self.slot = {cid: i for i, cid in enumerate(self.col_ids)}
        self.lit_offsets = []
        off = PARAM_HEAD
        for p in self.preds:
            self.lit_offsets.append(off)
            off += 1 if p.kind == "i32" else 2
        self.n_params = off
        self.offsets = []
        off = 2
        for a in self.aggs:
            self.offsets.append(off)
            off += _SLOTS[a.fn]
        self.n_out = off
        # Columns whose order planes the kernel reads.
        self.cmp_cols = frozenset(
            [p.col_id for p in self.preds]
            + [a.col_id for a in self.aggs if a.fn != "count"])

    # -- what the kernel is given ------------------------------------------
    def plane_table(self, arrays: dict) -> list[torch.Tensor]:
        """The run's planes in the kernel's table order: ht_hi, ht_lo,
        exp_hi, exp_lo, valid, tomb, live, then per column slot set,
        isnull, cmp ([B, R, P] int32, read with stride P)."""
        require_plain(arrays, "K1")
        out = [arrays[n] for n in ("ht_hi", "ht_lo", "exp_hi", "exp_lo",
                                   "valid", "tomb", "live")]
        for cid in self.col_ids:
            c = arrays["cols"][cid]
            out.extend((c["set"], c["isnull"], c["cmp"]))
        return out

    def descriptor(self, table: list[torch.Tensor]) -> np.ndarray:
        """int32 words: [n_cols, n_preds, n_aggs, n_params, n_out],
        cmp planes per row per slot, (col, kind, op, literal offset) per
        predicate, (fn, col, kind) per aggregate; unused entries zero."""
        w = np.zeros(DESC_WORDS, np.int32)
        w[:_HEAD] = (len(self.col_ids), len(self.preds), len(self.aggs),
                     self.n_params, self.n_out)
        for k in range(len(self.col_ids)):
            w[_HEAD + k] = table[9 + 3 * k].shape[-1]
        base = _HEAD + MAX_COLS
        for q, (p, lit) in enumerate(zip(self.preds, self.lit_offsets)):
            w[base + 4 * q: base + 4 * q + 4] = (
                self.slot[p.col_id], _KIND[p.kind], _OP[p.op], lit)
        base += 4 * MAX_PREDS
        for a_i, a in enumerate(self.aggs):
            w[base + 3 * a_i: base + 3 * a_i + 3] = (
                _FN[a.fn],
                -1 if a.col_id is None else self.slot[a.col_id],
                _KIND.get(a.kind, 0))
        return w

    def param_row(self, row_lo: int, row_hi: int, read_planes, lits) -> list:
        """One spec's parameter row: row range, read point planes (read
        hi/lo, expiry hi/lo), then one word per i32 literal and two (hi,
        lo) per i64 literal."""
        total = (1 << 31) - 1
        row = [max(0, min(row_lo, total)), max(0, min(row_hi, total)),
               *(int(v) for v in read_planes)]
        for p, lit in zip(self.preds, lits):
            row.extend(int(v) for v in np.atleast_1d(lit)[:1 if p.kind ==
                                                         "i32" else 2])
        return row

    def cmp_words(self, table: list[torch.Tensor]) -> int:
        """Order-plane words per row the kernel stages in shared memory:
        one per order plane of each column a predicate or aggregate
        reads."""
        return sum(table[9 + 3 * k].shape[-1]
                   for k, cid in enumerate(self.col_ids)
                   if cid in self.cmp_cols)

    def bytes_per_row(self, table: list[torch.Tensor]) -> int:
        """Plane bytes the fold needs per row in range: hybrid-time and
        expiry planes, valid/tomb/live, set/isnull of every column, and
        the order planes of the columns predicates and aggregates read."""
        n = 16 + 3 + 2 * len(self.col_ids)
        for k, cid in enumerate(self.col_ids):
            if cid in self.cmp_cols:
                n += 4 * table[9 + 3 * k].shape[-1]
        return n

    # -- reading a folded row ----------------------------------------------
    def combine(self, row) -> tuple:
        """Folded partial row -> (count, scanned, per-aggregate value),
        the values ``pallas_agg.combine_partials`` gives."""
        row = [int(x) for x in row]
        vals = []
        for a, off in zip(self.aggs, self.offsets):
            if a.fn == "count":
                vals.append(row[off])
            elif a.fn == "sum":
                n = row[off + 4]
                bias = (1 << 31) if a.kind == "i32" else (1 << 63)
                vals.append(_limb_total(row, off) - n * bias if n else None)
            elif row[off + 2] == 0:
                vals.append(None)
            elif a.kind == "i32":
                vals.append(row[off])
            else:
                vals.append(int(PL.ordered_planes_to_i64(
                    np.array([row[off]], np.int32),
                    np.array([row[off + 1]], np.int32))[0]))
        return row[0], row[1], vals

    def to_packed(self, row) -> tuple[np.ndarray, np.ndarray]:
        """Folded partial row -> ``agg_fold.pack``'s (ivec int32, fvec
        float32) layout, so the engine's unpack/finalize serve both
        routes. ivec[0] is the engine's statistic: rows that pass every
        predicate (the flat fold's ``scanned``); limb sums are carried
        into base-2^16 digits."""
        row = [int(x) for x in row]
        ints = [row[0]]
        for a, off in zip(self.aggs, self.offsets):
            if a.fn == "count":
                ints.append(row[off])
            elif a.fn == "sum":
                u = _limb_total(row, off)
                ints.extend((u >> (16 * j)) & 0xFFFF for j in range(DIGITS))
                ints.append(row[off + 4])
            elif a.kind == "i32":
                ints.extend((row[off], row[off + 2]))
            else:
                ints.extend((row[off], row[off + 1], row[off + 2]))
        return np.array(ints, np.int32), np.zeros((0,), np.float32)


def _limb_total(row: list, off: int) -> int:
    """The biased sum that four 16-bit limb sums at ``row[off:]`` carry."""
    return sum(row[off + k] << (16 * k) for k in range(4))


# -- the wrapper --------------------------------------------------------------

class Geometry(NamedTuple):
    tile_rows: int    # rows a block loads at once
    grid_x: int       # blocks over the rows (grid-stride over tiles)
    spec_chunk: int   # specs a block serves
    n_chunks: int     # grid.y: chunks of the batch, each reading the planes
    smem_bytes: int   # dynamic shared memory of a block


def launch_geometry(n_specs: int, n_rows: int, n_cols: int, cmp_words: int,
                    n_preds: int, n_out: int, sms: int) -> Geometry:
    """The kernel's launch shape for ``n_specs`` parameter rows over
    ``n_rows`` rows: shared memory holds the tile's staged words
    (``HEAD_WORDS`` of hybrid time and expiry, ``cmp_words`` of order
    planes, each an int32 a row), its row masks (one byte per ``VEC``
    rows for the candidate rows, the predicates' columns, each of
    ``READ_CLASSES`` read points and each of the ``n_cols`` columns) and
    each spec of the chunk's record (read and expiry keys, row range,
    read class, one 8-byte key per literal, one int64 per partial-row
    slot). csrc/flat_agg.cu checks the same sum."""
    if not 1 <= n_specs <= 65535:
        raise ValueError(f"{n_specs} specs; the kernel takes 1..65535")
    chunk = min(n_specs, SPEC_CHUNK)
    tiles = max(1, -(-n_rows // TILE_ROWS))
    spec_bytes = _SPEC_HEAD_BYTES + 8 * n_preds + 8 * n_out
    return Geometry(TILE_ROWS, min(tiles, BLOCKS_PER_SM * sms), chunk,
                    -(-n_specs // chunk),
                    (HEAD_WORDS + cmp_words) * TILE_ROWS * 4
                    + (MASK_KINDS + n_cols) * (TILE_ROWS // VEC)
                    + chunk * spec_bytes)


def _check(plan: FlatAggPlan, table, params: torch.Tensor) -> tuple:
    device = params.device
    if len(table) != 7 + 3 * len(plan.col_ids):
        raise ValueError("plane table does not match the plan's columns")
    B, R = table[0].shape
    if B * R >= (1 << 31):
        raise ValueError(f"{B * R} rows exceed the kernel's int32 row range")
    for k, t in enumerate(table):
        if t.device != device:
            raise ValueError(f"plane {k} on {t.device}, params on {device}")
        if not t.is_contiguous():
            raise ValueError(f"plane {k} is not contiguous")
        want = torch.int32 if (k < 4 or (k >= 7 and (k - 7) % 3 == 2)) \
            else torch.bool
        if t.dtype != want:
            raise ValueError(f"plane {k} is {t.dtype}, want {want}")
        if tuple(t.shape[:2]) != (B, R) or (
                t.dim() != (3 if want is torch.int32 and k >= 7 else 2)):
            raise ValueError(f"plane {k} has shape {tuple(t.shape)}")
        if k >= 7 and (k - 7) % 3 == 2 and t.shape[2] not in (1, 2):
            raise ValueError(f"plane {k}: {t.shape[2]} order planes")
    if params.dtype != torch.int32 or params.dim() != 2 or \
            params.shape[1] != plan.n_params or not params.is_contiguous():
        raise ValueError(f"params must be contiguous int32 "
                         f"[N, {plan.n_params}]")
    if not 1 <= params.shape[0] <= 65535:
        raise ValueError(f"{params.shape[0]} specs; the kernel takes "
                         "1..65535")
    return B, R


def check_launchable(table: list[torch.Tensor]) -> None:
    """What the CUDA kernel alone needs of a plane table (the plain
    version needs none of it): every plane 16-byte aligned, a row count
    that is a multiple of ``VEC`` and whose row indices stay int32 past
    the last tile."""
    n_rows = table[0].numel()
    if n_rows > (1 << 31) - TILE_ROWS:
        raise ValueError(f"{n_rows} rows exceed the kernel's int32 row "
                         "range")
    if n_rows % VEC:
        raise ValueError(f"{n_rows} rows: the kernel loads {VEC} rows at "
                         "once and needs a multiple of that")
    for k, t in enumerate(table):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"plane {k} is not {ALIGN}-byte aligned")


def flat_aggregate(plan: FlatAggPlan, table: list[torch.Tensor],
                   params: torch.Tensor) -> torch.Tensor:
    """[N, G, S] int64 partial rows of the N specs whose parameter rows
    are ``params`` over the planes in ``table`` (``plan.plane_table``).
    Launches the CUDA kernel for CUDA tensors, runs the plain version for
    CPU tensors, and raises for anything else."""
    B, R = _check(plan, table, params)
    device = params.device
    if device.type == "cpu":
        return flat_aggregate_plain(plan, table, params)
    if device.type != "cuda":
        raise ValueError(f"flat_aggregate runs on cuda or cpu, not {device}")
    check_launchable(table)
    lib = _library()
    n_specs = params.shape[0]
    geo = launch_geometry(
        n_specs, B * R, len(plan.col_ids), plan.cmp_words(table),
        len(plan.preds), plan.n_out,
        torch.cuda.get_device_properties(device).multi_processor_count)
    out = torch.empty((n_specs, geo.grid_x, plan.n_out), dtype=torch.int64,
                      device=device)
    desc = plan.descriptor(table)
    ptrs = (ctypes.c_void_p * len(table))(*[t.data_ptr() for t in table])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flat_agg_launch(
            ptrs, len(table),
            desc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(desc),
            ctypes.c_void_p(params.data_ptr()), n_specs, B * R,
            ctypes.c_void_p(out.data_ptr()), geo.grid_x, geo.spec_chunk,
            geo.smem_bytes, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flat_agg kernel launch failed ({rc}): "
                           f"{lib.flat_agg_error_string(rc).decode()}")
    flat_aggregate.launches += 1
    return out


# Kernel launches since the count was last set to 0.
flat_aggregate.launches = 0


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = native.load_library("flat_agg")
    lib.flat_agg_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.flat_agg_launch.restype = ctypes.c_int
    lib.flat_agg_error_string.argtypes = [ctypes.c_int]
    lib.flat_agg_error_string.restype = ctypes.c_char_p
    return lib


# -- the plain version ----------------------------------------------------------

def _pred_mask(kind: str, op: str, cmp, lit_hi: int, lit_lo: int):
    hi = cmp[:, 0]
    if kind == "i32":
        return {"=": hi == lit_hi, "!=": hi != lit_hi, "<": hi < lit_hi,
                "<=": hi <= lit_hi, ">": hi > lit_hi,
                ">=": hi >= lit_hi}[op]
    lo = cmp[:, 1]
    eq = (hi == lit_hi) & (lo == lit_lo)
    lt = (hi < lit_hi) | ((hi == lit_hi) & (lo < lit_lo))
    return {"=": eq, "!=": ~eq, "<": lt, "<=": lt | eq, ">": ~(lt | eq),
            ">=": ~lt}[op]


def _order_key(cmp, kind: str):
    """int64 whose order is the planes' order (the kernel's order_key)."""
    if kind == "i32":
        return cmp[:, 0].long()
    return cmp[:, 0].long() * (1 << 32) + (cmp[:, 1].long() + (1 << 31))


def flat_aggregate_plain(plan: FlatAggPlan, table: list[torch.Tensor],
                         params: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, one spec at a time, over the
    whole run as a single tile: [N, 1, S] int64 partial rows."""
    n_rows = table[0].numel()
    flat = [t.reshape(n_rows, -1) if t.dim() == 3 else t.reshape(n_rows)
            for t in table]
    ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live = flat[:7]
    cols = {cid: flat[7 + 3 * k: 10 + 3 * k]
            for k, cid in enumerate(plan.col_ids)}
    rowidx = torch.arange(n_rows, device=valid.device)
    out = torch.zeros((params.shape[0], 1, plan.n_out), dtype=torch.int64,
                      device=valid.device)
    for n, p in enumerate(params.tolist()):
        row_lo, row_hi, read_hi, read_lo, rexp_hi, rexp_lo = p[:PARAM_HEAD]
        visible = valid & le2(ht_hi, ht_lo, read_hi, read_lo)
        expired = le2(exp_hi, exp_lo, rexp_hi, rexp_lo)
        alive = visible & ~tomb
        exists = alive & live & ~expired
        notnull = {}
        for cid, (set_, isnull, _cmp) in cols.items():
            notnull[cid] = alive & set_ & ~isnull & ~expired
            exists = exists | notnull[cid]
        pre = exists & (rowidx >= row_lo) & (rowidx < row_hi)
        mask = pre
        for ps, lit in zip(plan.preds, plan.lit_offsets):
            lit_lo = p[lit + 1] if ps.kind == "i64" else 0
            mask = mask & notnull[ps.col_id] & _pred_mask(
                ps.kind, ps.op, cols[ps.col_id][2], p[lit], lit_lo)
        slots = [mask.sum(), pre.sum()]
        for ag in plan.aggs:
            m = mask if ag.col_id is None else mask & notnull[ag.col_id]
            n_m = m.sum()
            if ag.fn == "count":
                slots.append(n_m)
                continue
            cmp = cols[ag.col_id][2]
            if ag.fn == "sum":
                u_hi = cmp[:, 0].long() + (1 << 31)
                if ag.kind == "i32":
                    limbs = [u_hi & 0xFFFF, u_hi >> 16]
                else:
                    u_lo = cmp[:, 1].long() + (1 << 31)
                    limbs = [u_lo & 0xFFFF, u_lo >> 16, u_hi & 0xFFFF,
                             u_hi >> 16]
                sums = [torch.where(m, limb, 0).sum() for limb in limbs]
                sums += [torch.zeros_like(n_m)] * (4 - len(sums))
                slots.extend(sums + [n_m])
                continue
            is_max = ag.fn == "max"
            if ag.kind == "i32":
                fill = int(I32_MIN) if is_max else int(I32_MAX)
            else:
                fill = _I64_MIN if is_max else _I64_MAX
            key = _order_key(cmp, ag.kind).masked_fill(~m, fill)
            best = key.amax() if is_max else key.amin()
            if ag.kind == "i32":
                slots.extend((best, torch.zeros_like(best), n_m))
            else:
                slots.extend((best >> 32, (best & 0xFFFFFFFF) - (1 << 31),
                              n_m))
        out[n, 0] = torch.stack(slots)
    return out


# -- the fold over partial rows --------------------------------------------------

def fold_partials(plan: FlatAggPlan, partials: torch.Tensor) -> torch.Tensor:
    """[N, G, S] partial rows -> [N, S] on their device: sums over G, and
    MIN/MAX as the lexicographic extreme of the (hi, lo) planes over the
    partials whose n > 0."""
    out = partials.sum(dim=1)
    for ag, off in zip(plan.aggs, plan.offsets):
        if ag.fn not in ("min", "max"):
            continue
        hi, lo, n = (partials[:, :, off + j] for j in range(3))
        key = hi * (1 << 32) + (lo + (1 << 31))
        if ag.fn == "max":
            best = key.masked_fill(n == 0, _I64_MIN).amax(dim=1)
        else:
            best = key.masked_fill(n == 0, _I64_MAX).amin(dim=1)
        out[:, off] = best >> 32
        out[:, off + 1] = ((best & 0xFFFFFFFF) - (1 << 31)
                           if ag.kind == "i64" else 0)
    return out
