"""GROUP BY and expression aggregates: the bucket-table fold K8, the CUDA
kernel and its plain version.

Counterpart of the JAX package's ``ops/group_agg.py``
``grouped_aggregate`` (an XLA program), which becomes
``csrc/group_agg.cu`` here (its source note says how the design differs).
For each spec of a launch it folds the rows of a flat run (or of a
multi-version run's resolved view, ``ops.mvcc_resolve``) that are visible
at the spec's read point, lie in its row range and pass its predicates
into a table of ``NUM_BUCKETS`` buckets, keyed by a hash of the group
columns' order planes:

- per bucket: the row count, ``rep`` (the smallest matching row: on a
  view, its key group's first row), the min and max of every key plane
  (a bucket whose min and max differ holds two groups: a collision), and
  per aggregate its COUNT, or for a SUM ``n`` (rows whose inputs are all
  non-NULL) and the exact sum of ``base * f1 [* f2]`` as a 128-bit
  integer (two int64 words, low and high);
- per spec: ``scanned`` (rows that exist in range, before predicates:
  the JAX program's ``pre_pred``) and ``negs`` (rows where a sum's base or
  a factor is negative; the engine re-serves those specs on the host, as
  the JAX engine does).

The bucket hash is the JAX program's, bit for bit: FNV-style over each
group column's planes (zeroed when NULL) and its null flag, then the
murmur3 fmix step, modulo ``NUM_BUCKETS``.

- ``GAgg`` / ``GroupAggSig``: the JAX package's dataclasses without the
  window fields (B, R, K, flat, apply_preds) that only the XLA program
  needs; the port always folds flat planes with predicates applied;
- ``make_plan``: a signature's descriptor, ``[N, P]`` parameter rows and
  output layout; ``eligible``: whether the descriptor takes it;
- ``grouped_aggregate``: the wrapper. On CUDA tensors it launches the
  kernel (or raises); on CPU tensors it runs ``grouped_aggregate_plain``.
  Either returns ``[N, NUM_BUCKETS + 1, S]`` int64 (row ``NUM_BUCKETS``
  holds ``scanned`` and ``negs``); ``grouped_aggregate.launches`` counts
  launches;
- ``launch_geometry``: the launch shape (chunks of specs on grid.y, one
  wave of blocks walking 128-row pieces on grid.x) and the shared bytes
  (``tile_bytes``, ``spec_bytes``, and an encoded table's copies and
  dictionaries: ``copy_layout``), pure Python and the single source of
  the partition; ``plan_launch`` picks the layout that fits, and
  ``last_launch`` is the shape the library reports for its last launch;
- ``group_bytes``: the bytes the function must move, for the bound.

The planes may be a run's encoded leaves (``ops.encodings``): K8 decodes
them as it stages its tiles, a leaf descriptor a plane (kind, arrays,
run slots or dictionary entries), so a run's encoded tree is read as it
is resident. The encoded build copies each piece's per-row arrays (bits
words, u16 offsets, run ids, codes) into its warp's buffer in shared
memory one piece ahead (``copy_layout``: a 16-byte aligned array of a
plane the staging reads; the others are loaded from the run), and keeps
the dictionaries the staging reads in shared memory up to
``DICT_SMEM_CAP`` bytes (past it, through the read-only cache). A
promoted string predicate (kind ``"code"``) compares its dictionary
column's code plane: the dictionary leaf's codes, or on a plain tree
(a view, a side-car) the ``code`` plane beside the column's ``cmp``,
which ``plane_table`` appends after the columns' planes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import encodings as enc
from yugabyte_db_tpu_torch.ops import native
from yugabyte_db_tpu_torch.ops.scan import I32_MAX, I32_MIN, le2

NUM_BUCKETS = 512
# Descriptor limits, launch shape and shared-memory layout;
# csrc/group_agg.cu holds the same constants.
MAX_COLS = 16
MAX_PREDS = 8
MAX_GROUP = 4        # group columns
MAX_AGGS = 8
MAX_FACTORS = 2      # small factors of one sum
MAX_NODES = 8        # postfix nodes of one factor
WARPS = 4
THREADS = 32 * WARPS
PIECE_ROWS = 128     # rows a warp stages and folds at once, four a lane
SLOTS = 16           # a spec's slots (buckets in shared memory) in a block
SPEC_CHUNK = 16      # specs a block serves (grid.y runs the chunks)
HEAD_WORDS = 5       # staged words a row: hybrid time, expiry, row word
SMEM_LIMIT = 232_448  # shared-memory bytes a block may use
# The kernel's static shared memory: the union range, the slots' tags, each
# warp's bucket steps and its scanned and negs a spec, the key planes' map.
STATIC_SMEM = (8 + 4 * SLOTS + 8 * WARPS * PIECE_ROWS + 16 * WARPS * SPEC_CHUNK
               + 8 * 3 * MAX_GROUP)
_HEAD = 7
DESC_WORDS = (_HEAD + MAX_COLS + 4 * MAX_PREDS + 2 * MAX_GROUP + 6 * MAX_AGGS
              + 2 * MAX_NODES * MAX_FACTORS * MAX_AGGS)
PARAM_HEAD = 6  # row_lo, row_hi, read_hi, read_lo, rexp_hi, rexp_lo

_OP = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
# Predicate kinds the kernel takes, and the literal words each reads.
_PLANES = {"i32": 1, "i64": 2, "f64": 2, "code": 1}
CODE_PLANES = 3  # a code predicate's planes word in the descriptor
# Leaf kinds of csrc/group_agg.cu's leaf table.
_LEAF = {None: 0, "bits": 1, "const": 2, "delta16": 3, "rle": 4, "dict": 5}
# A leaf's words: kind, rle run slots or dictionary entries, second and
# third array, its piece's offset in a warp's copy, its dictionary's first
# entry in shared memory (-1: none).
LEAF_WORDS = 6
# Shared bytes a block gives the dictionaries the encoded build stages
# (int2 entries); a dictionary past them is read through the read-only
# cache. Lineitem's hold 4 entries each (32 bytes).
DICT_SMEM_CAP = 2048
# The per-row array of a leaf kind that the encoded build copies, and its
# bytes a piece (PIECE_ROWS rows) a plane word.
_COPIED = {"bits": ("bw", PIECE_ROWS // 8), "delta16": ("doff", 2 * PIECE_ROWS),
           "rle": ("rid", 2 * PIECE_ROWS), "dict": ("codes", 2 * PIECE_ROWS)}
# Factor nodes (postfix): end, constant, column, +, -, *.
_NODE = {"k": 1, "c": 2, "+": 3, "-": 4, "*": 5}
# Hash constants of the JAX program, as uint32.
HASH_SEED = 0x01000193
HASH_MUL = -2128831035 & 0xFFFFFFFF
MIX_MUL = -2048144789 & 0xFFFFFFFF


@dataclass(frozen=True)
class GAgg:
    kind: str            # 'count' | 'sum_prod'
    col_id: int | None   # count: the column (None: COUNT(*)); sum: the base
    planes: int = 1      # base column plane count (1 = i32, 2 = i64)
    factors: tuple = ()  # sum_prod: factor tuples ("k", v) | ("c", cid) |
    #                      (op, left, right), op in "+-*"
    need_cols: tuple = ()  # col_ids whose non-NULL gates the row


@dataclass(frozen=True)
class GroupAggSig:
    NB: int
    cols: tuple          # tuple[ColSig]: every value column (existence)
    preds: tuple         # tuple[PredSig]
    group_cols: tuple    # tuple[(col_id, planes)]
    aggs: tuple          # tuple[GAgg]


def _nodes(expr) -> list:
    if expr[0] in ("k", "c"):
        return [expr]
    return _nodes(expr[1]) + _nodes(expr[2]) + [(expr[0],)]


def eligible(sig: GroupAggSig) -> bool:
    """Whether the kernel's descriptor takes ``sig`` and a block holds
    its warps' areas, a chunk of specs and DICT_SMEM_CAP bytes of
    dictionaries."""
    if len(sig.cols) > MAX_COLS or len(sig.preds) > MAX_PREDS or \
            len(sig.group_cols) > MAX_GROUP or len(sig.aggs) > MAX_AGGS:
        return False
    if any(p.kind not in _PLANES or p.op not in _OP for p in sig.preds):
        return False
    for ag in sig.aggs:
        if len(ag.factors) > MAX_FACTORS or any(
                len(_nodes(f)) > MAX_NODES for f in ag.factors):
            return False
    n_params = PARAM_HEAD + sum(_PLANES[p.kind] for p in sig.preds)
    return (tile_bytes(sig) + SPEC_CHUNK * spec_bytes(sig, n_params)
            + DICT_SMEM_CAP + STATIC_SMEM <= SMEM_LIMIT)


def key_planes(sig: GroupAggSig) -> int:
    """KP: key planes a bucket keeps (each group column's order planes
    and its null flag), at least 1 as in the JAX program."""
    return max(1, sum(p + 1 for _c, p in sig.group_cols))


def staged_words(sig: GroupAggSig) -> int:
    """The words a row stages in its warp's area of shared memory: the
    hybrid time, expiry and row word, the order planes of each column a
    predicate or group column reads, and four limbs a sum."""
    two = {c.col_id: c.two_plane for c in sig.cols}
    staged = ({p.col_id for p in sig.preds if p.kind != "code"}
              | {c for c, _p in sig.group_cols})
    n_sums = sum(1 for a in sig.aggs if a.kind != "count")
    return (HEAD_WORDS + sum(1 + two[c] for c in staged)
            + len(code_cols(sig)) + 4 * n_sums)


def code_cols(sig: GroupAggSig) -> tuple:
    """The columns a code predicate reads, in first-use order (each
    stages its code word; ``plane_table`` appends their code planes)."""
    return tuple(dict.fromkeys(p.col_id for p in sig.preds
                               if p.kind == "code"))


def tile_bytes(sig: GroupAggSig) -> int:
    """A block's warp areas: WARPS pieces of PIECE_ROWS rows."""
    return WARPS * PIECE_ROWS * 4 * staged_words(sig)


def spec_bytes(sig: GroupAggSig, n_params: int) -> int:
    """One spec's records in a block: its slot table (SLOTS slots, each two
    64-bit words a sum and 32-bit words for the count, rep, key minima and
    maxima and each aggregate's count or n) and its parameter row, rounded
    up to 16 bytes."""
    n_sums = sum(1 for a in sig.aggs if a.kind != "count")
    n32 = 2 + 2 * key_planes(sig) + len(sig.aggs)
    raw = SLOTS * (16 * n_sums + 4 * n32) + 4 * n_params
    return -(-raw // 16) * 16


def spec_chunks(n_specs: int) -> tuple[int, int]:
    """(specs a block, chunks): balanced chunks of at most SPEC_CHUNK."""
    chunks = -(-n_specs // SPEC_CHUNK)
    return -(-n_specs // chunks), chunks


@functools.lru_cache(maxsize=256)
def make_plan(sig: GroupAggSig) -> GroupAggPlan:
    return GroupAggPlan(sig)


class GroupAggPlan:
    """Static layout of one signature: column slots, parameter-row and
    output-row layouts, and the kernel's descriptor."""

    def __init__(self, sig: GroupAggSig):
        if sig.NB != NUM_BUCKETS:
            raise ValueError(f"the kernel has {NUM_BUCKETS} buckets")
        if not eligible(sig):
            raise ValueError("signature exceeds the kernel's descriptor")
        self.sig = sig
        self.col_ids = tuple(cs.col_id for cs in sig.cols)
        self.slot = {cid: i for i, cid in enumerate(self.col_ids)}
        self.code_cols = code_cols(sig)
        used = [p.col_id for p in sig.preds] + [c for c, _p in sig.group_cols]
        for a in sig.aggs:
            used += list(a.need_cols) + ([a.col_id] if a.col_id is not None
                                         else [])
        if any(cid not in self.slot for cid in used):
            raise ValueError("a predicate, group column or aggregate reads a "
                             "column missing from the signature's columns")
        self.lit_offsets = []
        off = PARAM_HEAD
        for p in sig.preds:
            self.lit_offsets.append(off)
            off += _PLANES[p.kind]
        self.n_params = off
        self.kp = key_planes(sig)
        self.offsets = []  # output slot of each aggregate
        off = 2 + 2 * self.kp
        for a in sig.aggs:
            self.offsets.append(off)
            off += 1 if a.kind == "count" else 3
        self.n_out = off
        self.tile_bytes = tile_bytes(sig)
        self.spec_bytes = spec_bytes(sig, self.n_params)

    # -- what the kernel is given ------------------------------------------
    def plane_table(self, arrays: dict) -> list:
        """The planes (tensors or encoded leaves) in the kernel's order:
        ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live, then per column
        slot set, isnull, cmp; then per code column (``code_cols``) its
        code plane where the tree is plain (None where its ``cmp`` is a
        dictionary leaf, whose codes it reads)."""
        out = [arrays[n] for n in ("ht_hi", "ht_lo", "exp_hi", "exp_lo",
                                   "valid", "tomb", "live")]
        for cid in self.col_ids:
            c = arrays["cols"][cid]
            out.extend((c["set"], c["isnull"], c["cmp"]))
        for cid in self.code_cols:
            c = arrays["cols"][cid]
            if enc.leaf_kind(c["cmp"]) == "dict":
                out.append(None)
            elif "code" in c:
                out.append(c["code"])
            else:
                raise ValueError(f"column {cid} has no code plane for a "
                                 "code predicate")
        return out

    def descriptor(self, table: list[torch.Tensor]) -> np.ndarray:
        """int32 words: [n_cols, n_preds, n_group, n_aggs, n_params, KP,
        S], order planes per row per column slot, (slot, planes, op,
        literal offset) per predicate, (slot, planes) per group column,
        (kind, slot or -1, base planes, need-mask, factor count, output
        slot) per aggregate, then per aggregate and factor MAX_NODES
        postfix (node, argument) pairs; unused entries zero."""
        sig = self.sig
        w = np.zeros(DESC_WORDS, np.int32)
        w[:_HEAD] = (len(self.col_ids), len(sig.preds), len(sig.group_cols),
                     len(sig.aggs), self.n_params, self.kp, self.n_out)
        for k in range(len(self.col_ids)):
            w[_HEAD + k] = plane_width(table[9 + 3 * k])
        base = _HEAD + MAX_COLS
        for q, (p, lit) in enumerate(zip(sig.preds, self.lit_offsets)):
            w[base + 4 * q: base + 4 * q + 4] = (
                self.slot[p.col_id],
                CODE_PLANES if p.kind == "code" else _PLANES[p.kind],
                _OP[p.op], lit)
        base += 4 * MAX_PREDS
        for g, (cid, planes) in enumerate(sig.group_cols):
            w[base + 2 * g: base + 2 * g + 2] = (self.slot[cid], planes)
        base += 2 * MAX_GROUP
        for a_i, (a, off) in enumerate(zip(sig.aggs, self.offsets)):
            need = 0
            for cid in a.need_cols:
                need |= 1 << self.slot[cid]
            w[base + 6 * a_i: base + 6 * a_i + 6] = (
                0 if a.kind == "count" else 1,
                -1 if a.col_id is None else self.slot[a.col_id],
                a.planes, need, len(a.factors), off)
        base += 6 * MAX_AGGS
        for a_i, a in enumerate(sig.aggs):
            for f_i, f in enumerate(a.factors):
                at = base + 2 * MAX_NODES * (MAX_FACTORS * a_i + f_i)
                for n_i, node in enumerate(_nodes(f)):
                    arg = 0
                    if node[0] == "k":
                        arg = int(node[1])
                    elif node[0] == "c":
                        arg = self.slot[node[1]]
                    w[at + 2 * n_i: at + 2 * n_i + 2] = (_NODE[node[0]], arg)
        return w

    def param_row(self, row_lo: int, row_hi: int, read_planes, lits) -> list:
        """One spec's parameter row: row range, read point planes (read
        hi/lo, expiry hi/lo), then one word per i32 literal and two (hi,
        lo) per i64 or f64 literal."""
        total = (1 << 31) - 1
        row = [max(0, min(row_lo, total)), max(0, min(row_hi, total)),
               *(int(v) for v in read_planes)]
        for p, lit in zip(self.sig.preds, lits):
            row.extend(int(v) for v in
                       np.atleast_1d(lit)[:_PLANES[p.kind]])
        return row

    # -- reading an output table -------------------------------------------
    def sum_value(self, table_row, a_i: int) -> int:
        """The exact sum of aggregate ``a_i`` in one bucket's row: its
        two 64-bit words as one unsigned 128-bit integer."""
        off = self.offsets[a_i]
        lo, hi = int(table_row[off + 1]), int(table_row[off + 2])
        return (lo & ((1 << 64) - 1)) | ((hi & ((1 << 64) - 1)) << 64)


def plane_width(entry) -> int:
    """Order planes a row of a cmp entry (a tensor or an encoded leaf):
    1 or 2 (a dictionary's: its two prefix planes)."""
    k = enc.leaf_kind(entry)
    if k is None:
        return entry.shape[-1]
    e = entry[k]
    if k == "dict":
        return 2
    arr = {"const": e.get("cval"), "delta16": e.get("doff"),
           "rle": e.get("rvals")}[k]
    return int(np.prod(arr.shape[2:], dtype=np.int64)) if arr.dim() > 2 \
        else 1


def _leaf_arrays(entry) -> list:
    """An entry's arrays in the kernel's order (a, b, c): a plain plane;
    bits bw; const cval; delta16 dbase, doff; rle rid, rvals; dict codes,
    dhi, dlo."""
    k = enc.leaf_kind(entry)
    if k is None:
        return [entry]
    e = entry[k]
    return [e[n] for n in {"bits": ("bw",), "const": ("cval",),
                           "delta16": ("dbase", "doff"),
                           "rle": ("rid", "rvals"),
                           "dict": ("codes", "dhi", "dlo")}[k]]


class CopyLayout(NamedTuple):
    """What the encoded build keeps in shared memory for a plane table
    (``copy_layout``): per plane of the table's columns (the first 7 + 3
    n_cols), the offset of its piece in a warp's copy (``raw``) and its
    dictionary's first entry (``dsh``), -1 where none; the bytes of a
    piece's copy and of the dictionaries; and masks: ``copied`` (bit k:
    plane k), ``dict_shared`` and ``dict_cached`` (bit c: slot c's
    dictionary in shared memory, or read through the read-only cache)."""
    encoded: bool
    raw: tuple
    dsh: tuple
    raw_bytes: int
    dict_bytes: int
    copied: int
    dict_shared: int
    dict_cached: int
    loaded_bytes: int = 0  # a piece's bytes the staging loads from the run


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def value_cols(plan: GroupAggPlan) -> set:
    """The column slots whose order planes the staging reads (predicates
    other than code ones, group columns, each sum's base and its factors'
    columns)."""
    sig = plan.sig
    cids = {p.col_id for p in sig.preds if p.kind != "code"}
    cids |= {c for c, _p in sig.group_cols}
    for a in sig.aggs:
        if a.kind == "count":
            continue
        cids.add(a.col_id)
        for f in a.factors:
            cids |= {n[1] for n in _nodes(f) if n[0] == "c"}
    return {plan.slot[c] for c in cids}


def copy_layout(plan: GroupAggPlan, table: list, copies: bool = True,
                dict_cap: int = DICT_SMEM_CAP) -> CopyLayout:
    """The shared-memory layout of the encoded build over ``table``:

    - copied, in plane order, each plane the staging reads (every flag
      and time plane, the order planes of ``value_cols`` and of the code
      predicates' columns) whose leaf has a per-row array (``_COPIED``)
      that is 16-byte aligned, its pieces back to back; the others are
      loaded from the run (``copies`` False: none is copied);
    - in shared memory, in plane order, each dictionary of a
      ``value_cols`` column while the entries (8 bytes each) stay within
      ``dict_cap`` bytes; past it, read through the read-only cache.

    A table whose planes the staging reads are all plain takes the plain
    build: nothing of this."""
    n = 7 + 3 * len(plan.col_ids)
    raw, dsh = [-1] * n, [-1] * n
    values = value_cols(plan)
    read = set(range(7))
    for k, cid in enumerate(plan.col_ids):
        read |= {7 + 3 * k, 8 + 3 * k}
        if k in values or cid in plan.code_cols:
            read.add(9 + 3 * k)
    if not any(enc.leaf_kind(table[k]) is not None for k in read):
        return CopyLayout(False, tuple(raw), tuple(dsh), 0, 0, 0, 0, 0)
    off = entries = copied = shared = cached = loaded = 0
    for k in range(n):
        kind = enc.leaf_kind(table[k])
        if k in read and not (copies and kind in _COPIED and table[k][kind][
                _COPIED[kind][0]].data_ptr() % 16 == 0):
            loaded += piece_bytes(table[k])
        if kind == "dict" and (k - 7) // 3 in values:
            d = table[k]["dict"]["dhi"].numel()
            if 8 * (entries + d) <= dict_cap:
                dsh[k] = entries
                entries += d
                shared |= 1 << (k - 7) // 3
            else:
                cached |= 1 << (k - 7) // 3
        if not copies or k not in read or kind not in _COPIED:
            continue
        name, per_word = _COPIED[kind]
        if table[k][kind][name].data_ptr() % 16:
            continue
        raw[k] = off
        off += per_word * (plane_width(table[k]) if kind == "delta16" else 1)
        copied |= 1 << k
    return CopyLayout(True, tuple(raw), tuple(dsh), off,
                      _align16(8 * entries), copied, shared, cached, loaded)


def piece_bytes(entry) -> int:
    """Bytes of a piece (PIECE_ROWS rows) of a plane table entry's per-row
    arrays: ``row_bytes`` a row."""
    return int(row_bytes(entry) * PIECE_ROWS)


def copies_pay(plan: GroupAggPlan, table: list, layout: CopyLayout,
               chunk: int) -> bool:
    """Whether a launch's copies pay for themselves. The build with the
    copy's code folds more slowly than the build without it: a spec
    whose groups overflow a block's slots ~20% slower, a batch of specs
    too (PERF.md §6); and a copy that is a small part of a piece saves
    little. So the copies go to a chunk of one spec whose groups all fit
    the slots (its group columns dictionaries whose entries multiply to
    at most SLOTS) and whose copied bytes are at least a quarter of a
    piece's staged bytes."""
    groups = 1
    for cid, _planes in plan.sig.group_cols:
        leaf = table[9 + 3 * plan.slot[cid]]
        if enc.leaf_kind(leaf) != "dict":
            return False
        groups *= leaf["dict"]["dhi"].numel()
    return (chunk == 1 and groups <= SLOTS and
            4 * layout.raw_bytes >= layout.raw_bytes + layout.loaded_bytes)


def leaf_table(plan: GroupAggPlan, table: list,
               layout: CopyLayout | None = None) -> tuple:
    """(pointers, leaf words) of a plane table for the kernel: each
    plane's first array, and per plane LEAF_WORDS int64 words (kind, rle
    run slots or dictionary entries, second and third array, a plain
    cmp's third being its code plane; then ``layout``'s copy offset and
    dictionary entry, -1 without a layout)."""
    n = 7 + 3 * len(plan.col_ids)
    code_at = {cid: table[n + j] for j, cid in enumerate(plan.code_cols)}
    ptrs, words = [], np.zeros((n, LEAF_WORDS), np.int64)
    for k, entry in enumerate(table[:n]):
        arrays = _leaf_arrays(entry)
        kind = enc.leaf_kind(entry)
        ptrs.append(arrays[0].data_ptr())
        words[k, 0] = _LEAF[kind]
        if kind == "rle":
            words[k, 1] = arrays[1].shape[1]
        elif kind == "dict":
            words[k, 1] = arrays[1].numel()
        for j, a in enumerate(arrays[1:3]):
            words[k, 2 + j] = a.data_ptr()
        if k >= 7 and (k - 7) % 3 == 2 and kind is None:
            code = code_at.get(plan.col_ids[(k - 7) // 3])
            if code is not None:
                words[k, 3] = code.data_ptr()
        words[k, 4] = layout.raw[k] if layout else -1
        words[k, 5] = layout.dsh[k] if layout else -1
    return ptrs, words


# -- the wrapper --------------------------------------------------------------

class Geometry(NamedTuple):
    """The launch's shape as launch_geometry gives it and the library
    reports it (csrc/group_agg.cu g_last_launch, these fields in order)."""
    encoded: int      # the build: 1 encoded, 0 plain
    threads: int      # threads a block
    blocks: int       # grid.x: blocks walking a chunk's row pieces
    chunks: int       # grid.y: spec chunks, each reading the planes once
    chunk: int        # specs a block serves
    smem_bytes: int   # dynamic shared memory of a block
    raw_bytes: int    # a piece's copy (the encoded build)
    buffers: int      # copies a warp holds: 0 (none), 1 or 2
    dict_bytes: int   # the dictionaries in shared memory
    copied_lo: int    # copied planes 0..31 (bits, as int32)
    copied_hi: int    # copied planes 32..
    dict_shared: int  # slots whose dictionary is in shared memory
    dict_cached: int  # slots whose dictionary is read through the cache


def _i32(x: int) -> int:
    """A 32-bit mask as the int32 the library reports."""
    return x - (1 << 32) if x >= 1 << 31 else x


def launch_geometry(n_specs: int, n_rows: int, tile: int, spec: int,
                    sms: int, per_sm, layout: CopyLayout | None = None
                    ) -> Geometry:
    """The kernel's launch shape: the specs in balanced chunks of at most
    SPEC_CHUNK (grid.y), each block holding its chunk's records (``spec``
    bytes a spec) beside its warps' areas (``tile`` bytes) and, for an
    encoded ``layout``, each warp's copies of a piece (two buffers where
    ``per_sm`` holds as many blocks an SM as with one, else one), the
    shared dictionaries and the copy's tables (``copy_table_bytes``);
    grid.x as many blocks as one wave of ``per_sm(smem_bytes)``
    resident blocks on each of ``sms`` SMs holds beside the other chunks
    (a second, partial wave would double the time of its blocks' rows),
    but no more than the row pieces need. csrc/group_agg.cu checks the
    same sum."""
    if not 1 <= n_specs <= 65535:
        raise ValueError(f"{n_specs} specs; the kernel takes 1..65535")
    chunk, chunks = spec_chunks(n_specs)
    lay = layout or CopyLayout(False, (), (), 0, 0, 0, 0, 0)
    raw = lay.raw_bytes
    extra = lay.dict_bytes + copy_table_bytes(lay)

    def smem_of(buffers):
        return tile + chunk * spec + WARPS * buffers * raw + extra

    buffers = 0
    if raw:
        buffers = 2 if (smem_of(2) + STATIC_SMEM <= SMEM_LIMIT and
                        per_sm(smem_of(2)) >= per_sm(smem_of(1))) else 1
    smem = smem_of(buffers)
    if smem + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"a {smem}-byte block does not fit shared memory")
    resident = per_sm(smem)
    if resident < 1:
        raise ValueError("a block does not fit an SM")
    pieces = -(-n_rows // PIECE_ROWS)
    blocks = max(1, min(resident * sms // chunks, -(-pieces // WARPS)))
    return Geometry(int(lay.encoded), THREADS, blocks, chunks, chunk, smem,
                    raw, buffers, lay.dict_bytes,
                    _i32(lay.copied & 0xFFFFFFFF), _i32(lay.copied >> 32),
                    lay.dict_shared, lay.dict_cached)


def build_of(layout: CopyLayout) -> int:
    """The kernel's build a layout takes: 0 plain, 1 encoded, 2 encoded
    with the copies."""
    return 0 if not layout.encoded else 2 if layout.raw_bytes else 1


def copy_table_bytes(layout: CopyLayout) -> int:
    """Shared bytes of a layout's copy tables: each copied plane's source
    (16 bytes) and each 16-byte chunk of a piece's copy (2 bytes)."""
    return _align16(16 * bin(layout.copied).count("1")
                    + 2 * (layout.raw_bytes // 16))


def plan_launch(plan: GroupAggPlan, table: list, n_specs: int, sms: int,
                per_sm) -> tuple:
    """(layout, geometry) of a launch over ``table``, ``per_sm(smem,
    build)`` the blocks an SM holds: ``copy_layout``'s where its copies
    pay (``copies_pay``), cost no SM a block beside the same layout
    without copies and fit shared memory; else that layout without copies
    (the pieces loaded from the run, by the build without the copy's
    code), which always fits: ``eligible`` keeps DICT_SMEM_CAP bytes free
    for its dictionaries."""
    B, R = enc.leaf_dims(table[4])

    def geometry(layout):
        return launch_geometry(
            n_specs, B * R, plan.tile_bytes, plan.spec_bytes, sms,
            lambda smem: per_sm(smem, build_of(layout)), layout)

    bare = copy_layout(plan, table, copies=False)
    bare_geo = geometry(bare)
    full = copy_layout(plan, table)
    if full.raw_bytes and copies_pay(plan, table, full, bare_geo.chunk):
        try:
            geo = geometry(full)
        except ValueError:
            return bare, bare_geo
        if per_sm(geo.smem_bytes, 2) >= per_sm(bare_geo.smem_bytes, 1):
            return full, geo
    return bare, bare_geo


_INT_KINDS = (None, "const", "delta16", "rle")


def _check(plan: GroupAggPlan, table, params: torch.Tensor) -> tuple:
    """(B, R) of a valid plane table; raises on anything else."""
    device = params.device
    n = 7 + 3 * len(plan.col_ids)
    if len(table) != n + len(plan.code_cols):
        raise ValueError("plane table does not match the plan's columns")
    B, R = enc.leaf_dims(table[4])
    if B * R > (1 << 31) - 1 - PIECE_ROWS:
        raise ValueError(f"{B * R} rows exceed the kernel's int32 row range")
    for k, t in enumerate(table):
        if t is None:
            cid = plan.code_cols[k - n] if k >= n else None
            if cid is None or enc.leaf_kind(
                    table[9 + 3 * plan.slot[cid]]) != "dict":
                raise ValueError(f"plane {k} is missing")
            continue
        cmp = k >= 7 and k < n and (k - 7) % 3 == 2
        flag = 4 <= k < 7 or (7 <= k < n and not cmp)
        kind = enc.leaf_kind(t)
        allowed = (("bits", None) if flag else
                   _INT_KINDS + ("dict",) if cmp else
                   _INT_KINDS if k < 4 else (None,))
        if kind not in allowed:
            raise ValueError(f"plane {k}: a {kind} leaf where the kernel "
                             "takes none")
        for a in _leaf_arrays(t):
            if a.device != device:
                raise ValueError(f"plane {k} on {a.device}, params on "
                                 f"{device}")
            if not a.is_contiguous():
                raise ValueError(f"plane {k} is not contiguous")
        if enc.leaf_dims(t) not in (None, (B, R)):
            raise ValueError(f"plane {k} has dims {enc.leaf_dims(t)}")
        if kind is None:
            want = torch.bool if flag else torch.int32
            if t.dtype != want:
                raise ValueError(f"plane {k} is {t.dtype}, want {want}")
            if t.dim() != (3 if cmp else 2):
                raise ValueError(f"plane {k} has shape {tuple(t.shape)}")
        elif kind in ("const", "rle") and \
                _leaf_arrays(t)[-1].dtype != torch.int32:
            raise ValueError(f"plane {k}: a {kind} leaf of "
                             f"{_leaf_arrays(t)[-1].dtype}")
        if cmp and plane_width(t) not in (1, 2):
            raise ValueError(f"plane {k}: {plane_width(t)} order planes")
        if k < 4 and kind is not None and plane_width(t) != 1:
            raise ValueError(f"plane {k}: more than one plane")
    for p in plan.sig.preds:
        if p.kind != "code" and plane_width(
                table[9 + 3 * plan.slot[p.col_id]]) < _PLANES[p.kind]:
            raise ValueError(f"predicate on column {p.col_id} needs "
                             f"{_PLANES[p.kind]} order planes")
    if params.dtype != torch.int32 or params.dim() != 2 or \
            params.shape[1] != plan.n_params or not params.is_contiguous():
        raise ValueError(f"params must be contiguous int32 "
                         f"[N, {plan.n_params}]")
    if not 1 <= params.shape[0] <= 65535:
        raise ValueError(f"{params.shape[0]} specs; the kernel takes "
                         "1..65535")
    return B, R


def _check_launchable(plan: GroupAggPlan, table, n_rows: int) -> None:
    """What the CUDA kernel needs beyond the function: 16-byte aligned
    first arrays (it loads four rows of a plane at once) and a row count
    that is a multiple of 4."""
    if n_rows % 4:
        raise ValueError(f"{n_rows} rows: the kernel takes a multiple of 4")
    n = 7 + 3 * len(plan.col_ids)
    for k, t in enumerate(table):
        if t is None:
            continue
        if _leaf_arrays(t)[0].data_ptr() % 16:
            raise ValueError(f"plane {k} is not 16-byte aligned")


def grouped_aggregate(plan: GroupAggPlan, table: list[torch.Tensor],
                      params: torch.Tensor) -> torch.Tensor:
    """[N, NUM_BUCKETS + 1, S] int64 bucket tables of the N specs whose
    parameter rows are ``params`` over the planes in ``table``
    (``plan.plane_table``). Launches the CUDA kernel for CUDA tensors,
    runs the plain version for CPU tensors, and raises for anything
    else."""
    _check(plan, table, params)
    device = params.device
    if device.type == "cpu":
        return grouped_aggregate_plain(plan, table, params)
    if device.type != "cuda":
        raise ValueError(f"grouped_aggregate runs on cuda or cpu, not "
                         f"{device}")
    lib = _library()
    layout, geo = device_launch(lib, plan, table, params)
    out = launch(lib, plan, table, params, geo, layout)
    grouped_aggregate.launches += 1
    return out


def device_launch(lib: ctypes.CDLL, plan: GroupAggPlan, table: list,
                  params: torch.Tensor) -> tuple:
    """(layout, geometry) of ``lib``'s launch over ``table`` on the
    parameter rows' card (``plan_launch`` with its SMs and the build's
    occupancy); raises where the kernel cannot take the table."""
    B, R = enc.leaf_dims(table[4])
    _check_launchable(plan, table, B * R)
    return plan_launch(
        plan, table, params.shape[0],
        torch.cuda.get_device_properties(params.device).multi_processor_count,
        lambda smem, build: _occupancy(lib, len(plan.col_ids), smem, build))


def launch(lib: ctypes.CDLL, plan: GroupAggPlan, table: list[torch.Tensor],
           params: torch.Tensor, geo: Geometry,
           layout: CopyLayout | None = None) -> torch.Tensor:
    """One launch of ``lib``'s kernel (any source with the C interface of
    csrc/group_agg.cu) at ``geo`` with ``layout``'s copies and shared
    dictionaries (none without it): the output tables, or a RuntimeError
    naming the code the launch returned."""
    device = params.device
    n_specs = params.shape[0]
    out = torch.empty((n_specs, NUM_BUCKETS + 1, plan.n_out),
                      dtype=torch.int64, device=device)
    desc = plan.descriptor(table)
    B, R = enc.leaf_dims(table[4])
    first, words = leaf_table(plan, table, layout)
    ptrs = (ctypes.c_void_p * len(first))(*first)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.group_agg_launch(
            ptrs, words.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(first), desc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(desc), ctypes.c_void_p(params.data_ptr()), n_specs, B * R,
            R, ctypes.c_void_p(out.data_ptr()), geo.blocks, geo.smem_bytes,
            geo.raw_bytes, geo.buffers, geo.dict_bytes,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"group_agg kernel launch failed ({rc}): "
                           f"{lib.group_agg_error_string(rc).decode()}")
    return out


# Kernel launches since the count was last set to 0.
grouped_aggregate.launches = 0


def last_launch(lib: ctypes.CDLL | None = None) -> Geometry:
    """The shape of this process's last launch of ``lib`` (this tree's
    library by default) as the library reports it."""
    lib = lib or _library()
    out = (ctypes.c_int32 * len(Geometry._fields))()
    lib.group_agg_last_launch(out)
    return Geometry(*out)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("group_agg"))


@functools.lru_cache(maxsize=64)
def _occupancy(lib: ctypes.CDLL, n_cols: int, smem_bytes: int,
               build: int) -> int:
    """Blocks of the kernel's ``build`` (``build_of``) an SM holds at once
    (the CUDA occupancy calculator: registers, threads and shared memory
    counted)."""
    blocks = lib.group_agg_occupancy(n_cols, smem_bytes, build)
    if blocks < 1:
        raise RuntimeError(f"group_agg occupancy query failed ({blocks}): "
                           f"{lib.group_agg_error_string(-blocks).decode()}"
                           if blocks < 0 else
                           "a group_agg block does not fit an SM")
    return blocks


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernel's C
    interface set."""
    I = ctypes.c_int
    lib.group_agg_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        I, ctypes.POINTER(ctypes.c_int32), I, ctypes.c_void_p, I,
        ctypes.c_longlong, I, ctypes.c_void_p, I, I, I, I, I,
        ctypes.c_void_p]
    lib.group_agg_launch.restype = I
    lib.group_agg_occupancy.argtypes = [I, I, I]
    lib.group_agg_occupancy.restype = I
    lib.group_agg_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.group_agg_last_launch.restype = None
    lib.group_agg_error_string.argtypes = [I]
    lib.group_agg_error_string.restype = ctypes.c_char_p
    return lib


# -- the plain version ----------------------------------------------------------

def _flat(plan: GroupAggPlan, table: list) -> list[torch.Tensor]:
    """The table's planes decoded (``ops.encodings.decode_leaf``) and
    flattened to rows: [n] or [n, P] (a dictionary ``cmp``: its two
    prefix planes), each code column's code plane [n] after the
    columns' planes."""
    B, R = enc.leaf_dims(table[4])
    n = B * R
    ncol = 7 + 3 * len(plan.col_ids)
    codes = {}
    out = []
    for k, t in enumerate(table[:ncol]):
        d = enc.decode_leaf(t, B, R)
        if enc.leaf_kind(t) == "dict":
            codes[plan.col_ids[(k - 7) // 3]] = d[..., 2]
            d = d[..., :2]
        out.append(d.reshape(n, -1) if d.dim() == 3 else d.reshape(n))
    for cid, t in zip(plan.code_cols, table[ncol:]):
        out.append((codes[cid] if t is None else t).reshape(n))
    return out


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's wrapping range."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF


def _pred_mask(kind: str, op: str, cmp, lit: list):
    hi = cmp[:, 0]
    if _PLANES[kind] == 1:
        x = lit[0]
        return {"=": hi == x, "!=": hi != x, "<": hi < x, "<=": hi <= x,
                ">": hi > x, ">=": hi >= x}[op]
    lo = cmp[:, 1]
    eq = (hi == lit[0]) & (lo == lit[1])
    lt = (hi < lit[0]) | ((hi == lit[0]) & (lo < lit[1]))
    return {"=": eq, "!=": ~eq, "<": lt, "<=": lt | eq, ">": ~(lt | eq),
            ">=": ~lt}[op]


def _row_masks(plan: GroupAggPlan, flat: list, p: list) -> dict:
    """One spec's per-row masks over the flat planes: ``in_range``,
    ``visible`` (in range, valid, committed at the read point), ``alive``
    (visible, not a tombstone), ``notnull`` per column, ``pre`` (exists),
    ``pred`` (the rows each predicate sees: those that passed the ones
    before it) and ``m`` (matches)."""
    ht_hi, ht_lo, exp_hi, exp_lo, valid, tomb, live = flat[:7]
    row_lo, row_hi, read_hi, read_lo, rexp_hi, rexp_lo = p[:PARAM_HEAD]
    rows = torch.arange(valid.numel(), device=valid.device)
    in_range = (rows >= row_lo) & (rows < row_hi)
    visible = in_range & valid & le2(ht_hi, ht_lo, read_hi, read_lo)
    alive = visible & ~tomb
    expired = le2(exp_hi, exp_lo, rexp_hi, rexp_lo)
    exists = alive & live & ~expired
    notnull = {}
    for k, cid in enumerate(plan.col_ids):
        notnull[cid] = alive & flat[7 + 3 * k] & ~flat[8 + 3 * k] & ~expired
        exists = exists | notnull[cid]
    m = exists
    pred = []
    ncol = 7 + 3 * len(plan.col_ids)
    for ps, off in zip(plan.sig.preds, plan.lit_offsets):
        pred.append(m)
        if ps.kind == "code":  # the column's code plane, as an i32 plane
            cmp = flat[ncol + plan.code_cols.index(ps.col_id)][:, None]
        else:
            cmp = flat[9 + 3 * plan.slot[ps.col_id]]
        m = m & notnull[ps.col_id] & _pred_mask(
            "i32" if ps.kind == "code" else ps.kind, ps.op, cmp,
            p[off:off + _PLANES[ps.kind]])
    return {"in_range": in_range, "visible": visible, "alive": alive,
            "notnull": notnull, "pre": exists, "pred": pred, "m": m}


def _factor(expr, cmps: dict) -> torch.Tensor:
    """A factor tuple over every row, in wrapping int32 arithmetic."""
    if expr[0] == "k":
        return torch.tensor(int(expr[1]), dtype=torch.int64)
    if expr[0] == "c":
        return cmps[expr[1]][:, 0].long()
    left, right = _factor(expr[1], cmps), _factor(expr[2], cmps)
    if expr[0] == "+":
        return _wrap32(left + right)
    if expr[0] == "-":
        return _wrap32(left - right)
    return _wrap32(left * right)


def _base_value(planes: int, cmp) -> torch.Tensor:
    """A sum's base column as int64: an i32 plane, or an i64 column's two
    ordered planes decoded (each plane is its 32-bit word of v ^ 2^63
    with the top bit flipped, so v = hi * 2^32 + lo + 2^31)."""
    if planes == 1:
        return cmp[:, 0].long()
    return (cmp[:, 0].long() << 32) + (cmp[:, 1].long() + (1 << 31))


def _digit_sums(value: torch.Tensor, factors: list, bucket: torch.Tensor,
                nb: int) -> torch.Tensor:
    """Per bucket, the exact sum of value * f1 [* f2] (non-negative,
    value < 2^63, factors < 2^14) as 8 base-2^16 digits, int64."""
    digits = [(value >> (16 * k)) & 0xFFFF for k in range(4)]
    for f in factors:
        carry = torch.zeros_like(value)
        out = []
        for d in digits:
            t = d * f + carry
            out.append(t & 0xFFFF)
            carry = t >> 16
        digits = out + [carry]
    sums = torch.zeros((nb, 8), dtype=torch.int64, device=value.device)
    for k, d in enumerate(digits[:8]):
        sums[:, k].index_add_(0, bucket, d)
    for k in range(7):  # carry-normalise; the top digit keeps mod 2^16
        sums[:, k + 1] += sums[:, k] >> 16
        sums[:, k] &= 0xFFFF
    sums[:, 7] &= 0xFFFF
    return sums


def _words(d: torch.Tensor) -> torch.Tensor:
    """Four base-2^16 digits [nb, 4] -> the 64-bit word they spell, as
    int64 (the top digit read as signed, so that nothing overflows)."""
    top = torch.where(d[:, 3] >= (1 << 15), d[:, 3] - (1 << 16), d[:, 3])
    return (top << 48) + (d[:, 2] << 32) + (d[:, 1] << 16) + d[:, 0]


def grouped_aggregate_plain(plan: GroupAggPlan, table: list[torch.Tensor],
                            params: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops, one spec at a time over every
    row: the same [N, NUM_BUCKETS + 1, S] int64 tables, byte for byte."""
    sig, kp, nb = plan.sig, plan.kp, NUM_BUCKETS
    flat = _flat(plan, table)
    device = flat[4].device
    cmps = {cid: flat[9 + 3 * k] for k, cid in enumerate(plan.col_ids)}
    rows = torch.arange(flat[4].numel(), device=device)
    out = torch.zeros((params.shape[0], nb + 1, plan.n_out),
                      dtype=torch.int64, device=device)
    for n, p in enumerate(params.tolist()):
        mk = _row_masks(plan, flat, p)
        m, notnull = mk["m"], mk["notnull"]
        h = torch.full_like(rows, HASH_SEED)
        key = []
        for cid, planes in sig.group_cols:
            nn = notnull[cid]
            for pi in range(planes):
                v = torch.where(nn, cmps[cid][:, pi].long(), 0)
                key.append(v)
                h = _mul32(h ^ (v & 0xFFFFFFFF), HASH_MUL)
            null = (~nn).long()
            key.append(null)
            h = _mul32(h ^ null, HASH_MUL)
        h = h ^ (h >> 16)
        h = _mul32(h, MIX_MUL)
        h = h ^ (h >> 13)
        every = (h & 0x7FFFFFFF) % nb  # the bucket of every row
        bucket = every[m]
        t = out[n]
        t[:nb, 0].index_add_(0, bucket, torch.ones_like(bucket))
        t[:nb, 1] = torch.full((nb,), int(I32_MAX), dtype=torch.int64,
                               device=device).scatter_reduce(
            0, bucket, rows[m], "amin")
        t[:nb, 2:2 + kp] = int(I32_MAX)
        t[:nb, 2 + kp:2 + 2 * kp] = int(I32_MIN)
        for k, v in enumerate(key):
            t[:nb, 2 + k].scatter_reduce_(0, bucket, v[m], "amin")
            t[:nb, 2 + kp + k].scatter_reduce_(0, bucket, v[m], "amax")
        negs = 0
        for ag, off in zip(sig.aggs, plan.offsets):
            ok = m
            for cid in ag.need_cols:
                ok = ok & notnull[cid]
            t[:nb, off].index_add_(0, every[ok], torch.ones_like(rows[ok]))
            if ag.kind == "count":
                continue
            value = _base_value(ag.planes, cmps[ag.col_id])
            factors = [_factor(f, cmps).expand_as(value)
                       for f in ag.factors]
            bad = value < 0
            negs += int((ok & bad).sum())
            for f in factors:
                negs += int((ok & (f < 0)).sum())
                bad = bad | (f < 0)
            good = ok & ~bad
            sums = _digit_sums(value[good], [f[good] for f in factors],
                               every[good], nb)
            t[:nb, off + 1] = _words(sums[:, :4])
            t[:nb, off + 2] = _words(sums[:, 4:])
        t[nb, 0] = mk["pre"].sum()
        t[nb, 1] = negs
    return out


# -- the bound -------------------------------------------------------------------

def group_bytes(plan: GroupAggPlan, table: list[torch.Tensor],
                params: torch.Tensor) -> int:
    """Bytes the function must move for these specs: each input plane
    read once, at the rows where some spec needs it (1 byte a flag, 4 an
    order-plane word, 8 a hybrid time or expiry), the parameter rows
    read and the tables written once:

    - every row in some spec's range: its valid flag;
    - at its valid rows: the hybrid time; at visible rows, the tombstone
      flag; at alive rows (visible, no tombstone): the liveness marker,
      the expiry, and each column's set flag, and where set, its isnull
      flag;
    - at rows that exist: the order planes of each predicate's column
      where the predicates before it passed and it is not NULL;
    - at matching rows: the group columns' planes where not NULL, and
      each sum's base and factor columns' planes where its inputs are all
      non-NULL.

    An encoded leaf is charged its own bytes a row (a bits leaf one bit,
    delta16 two bytes a plane, rle and dictionary two, const nothing)."""
    flat = _flat(plan, table)
    n = flat[4].numel()
    zero = torch.zeros(n, dtype=torch.bool, device=flat[4].device)
    need = {k: zero.clone() for k in ("in_range", "valid", "visible",
                                      "alive")}
    set_rows = {cid: zero.clone() for cid in plan.col_ids}
    cmp_rows = {cid: zero.clone() for cid in plan.col_ids}
    for p in params.tolist():
        mk = _row_masks(plan, flat, p)
        need["in_range"] |= mk["in_range"]
        need["valid"] |= mk["in_range"] & flat[4]
        need["visible"] |= mk["visible"]
        need["alive"] |= mk["alive"]
        for k, cid in enumerate(plan.col_ids):
            set_rows[cid] |= mk["alive"] & flat[7 + 3 * k]
        for ps, before in zip(plan.sig.preds, mk["pred"]):
            cmp_rows[ps.col_id] |= before & mk["notnull"][ps.col_id]
        m = mk["m"]
        for cid, _planes in plan.sig.group_cols:
            cmp_rows[cid] |= m & mk["notnull"][cid]
        for ag in plan.sig.aggs:
            if ag.kind == "count":
                continue
            ok = m
            for cid in ag.need_cols:
                ok = ok & mk["notnull"][cid]
            for cid in ag.need_cols:
                cmp_rows[cid] |= ok
    count = {k: int(v.sum()) for k, v in need.items()}
    rb = [row_bytes(t) for t in table]
    total = (rb[4] * count["in_range"] + (rb[0] + rb[1]) * count["valid"]
             + rb[5] * count["visible"]
             + (rb[6] + rb[2] + rb[3]) * count["alive"])
    for k, cid in enumerate(plan.col_ids):
        total += rb[7 + 3 * k] * count["alive"]
        total += rb[8 + 3 * k] * int(set_rows[cid].sum())
        total += rb[9 + 3 * k] * int(cmp_rows[cid].sum())
    return int(total + params.numel() * 4
               + params.shape[0] * (NUM_BUCKETS + 1) * plan.n_out * 8)


def row_bytes(entry) -> float:
    """Bytes a row of a plane table entry: a plain plane's element bytes
    a row; an encoded leaf's per-row arrays (bits 1/8, delta16 2 a plane,
    rle's and a dictionary's 2-byte index); a code plane read beside a
    dictionary's codes (None) nothing."""
    if entry is None:
        return 0.0
    k = enc.leaf_kind(entry)
    if k is None:
        return entry.element_size() * (entry.shape[2] if entry.dim() == 3
                                       else 1)
    if k == "bits":
        return 1 / 8
    if k == "const":
        return 0.0
    if k == "delta16":
        return 2.0 * plane_width(entry)
    return 2.0
