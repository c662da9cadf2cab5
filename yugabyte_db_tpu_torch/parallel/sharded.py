"""Sharded multi-tablet scans over a ("t", "b") device mesh.

The port's copy of the JAX package's ``parallel/sharded.py``. Layout:
every tablet's single run is stacked to [T, B, R, ...] (runs padded to a
common block count divisible by mesh_b x window, pad tablets all
invalid), tablets split over the "t" axis and each tablet's blocks over
"b". A piece is one (tablet, b-shard): Bl = B / mesh_b blocks of one
tablet. Each distinct device of the mesh holds its pieces, in (t, b)
order, as ONE flattened run of [pieces x Bl, R, ...] planes
(``DeviceRun.arrays`` layout), so that one launch of a run kernel serves
all of them, one parameter row a piece.

- Aggregates (K14, the JAX ``_compiled_dist_agg``): a multi-version stack
  is resolved at the read point (``ops.mvcc_resolve``), then one launch of
  K5 (``ops.full_agg``) on each device folds every piece into one packed
  accumulator row (row bounds and windows clipped to the piece), and one
  launch of ``ops.mesh.combine`` reduces all pieces' rows to one: sums,
  int64 digit sums carry-normalised, and the two-plane lexicographic
  extremes (the JAX psum / pmax). With several devices, their rows are
  copied to the mesh's first device for that launch.
- Row pages (the JAX ``_compiled_dist_page``): one launch of K7
  (``ops.row_gather.gather_rows``) on each device, one parameter row a
  piece, bounds rebased and clipped to the piece as ``_page_body`` does;
  the match total is the sum of the pieces' counts; the host assembles
  the LIMIT page in (tablet, key) order and decodes only its rows.
- The slot update (the JAX ``_compiled_stack_update``): tablet t's slot of
  every leaf written by one launch of ``ops.mesh.stack_update`` a device,
  from the host run or from the tablet's resident device planes (K10
  decodes their encoded leaves). The write waits for the dispatches in
  flight on the stack, and a dispatch reads the planes and the runs under
  the stack's ``lock`` from its launches to its host decode, so that it
  sees one version of both (the JAX update builds new arrays instead).

Encoded stacks: the planes of each device are encoded with the host
encoders over the flattened block axis and charged at their encoded
bytes, as the JAX stack is. The JAX program decodes inline; the port
decodes the device's run with K10 into a temporary plain run at each
dispatch.

Group/window invariant: key groups never span blocks (storage.columnar
build invariant), so any contiguous block range — in particular a piece —
is segment-complete and partials add up exactly.

Reference analog of the combine being replaced: the client-side merge of
per-tablet partial aggregates (src/yb/yql/cql/ql/exec/eval_aggr.cc,
src/yb/docdb/pgsql_operation.cc:473).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.ops import agg_fold, decode, encodings, full_agg
from yugabyte_db_tpu_torch.ops import mesh as mesh_ops
from yugabyte_db_tpu_torch.ops import mvcc_resolve
from yugabyte_db_tpu_torch.ops import row_gather as RG
from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
from yugabyte_db_tpu_torch.parallel.mesh import DeviceMesh, device_label
from yugabyte_db_tpu_torch.storage.columnar import ColumnarRun
from yugabyte_db_tpu_torch.storage.residency import device_nbytes, hbm_cache
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
from yugabyte_db_tpu_torch.utils import planes as PL
from yugabyte_db_tpu_torch.utils.memtracker import root_tracker

_TOP = ("valid", "group_start", "tomb", "live", "ht_hi", "ht_lo", "exp_hi",
        "exp_lo")


class MeshSpecError(ValueError):
    """A spec the mesh program does not serve exactly (the JAX module's
    ``ValueError``s): the caller takes the per-tablet path. A kernel's own
    error is never one."""


# -- host-side assembly ------------------------------------------------------

def shard_dev_bytes(trees: dict) -> dict:
    """Per-device byte map of a stack's device trees ({device: tree}):
    each device charged the bytes of the planes it holds — the
    ``dev_bytes`` the residency cache partitions its budget by."""
    out: dict[str, int] = {}
    for device, tree in trees.items():
        lbl = device_label(device)
        out[lbl] = out.get(lbl, 0) + device_nbytes(tree)
    return out


def _tree_struct(tree):
    """Hashable encoding structure of a plane tree: leaf name -> encoding
    kind (None = plain), per top-level plane and per column."""
    planes = tuple(sorted((n, encodings.leaf_kind(l))
                          for n, l in tree.items() if n != "cols"))
    cols = tuple(sorted(
        (cid, tuple(sorted((n, encodings.leaf_kind(p))
                           for n, p in col.items())))
        for cid, col in tree["cols"].items()))
    return planes, cols


def _layout(tree) -> tuple:
    """A plain tree's leaves and each one's shape past the block axis."""
    planes = tuple((n, tuple(tree[n].shape[1:])) for n in _TOP)
    cols = tuple(sorted(
        (cid, tuple(sorted((n, tuple(p.shape[1:]))
                           for n, p in col.items() if n != "code")))
        for cid, col in tree["cols"].items()))
    return planes, cols


def _layout_leaves(layout: tuple):
    """((leaf key, shape past the block axis), ...) of a ``_layout``."""
    planes, cols = layout
    for n, shape in planes:
        yield (None, n), shape
    for cid, entry in cols:
        for n, shape in entry:
            yield (cid, n), shape


def _slot(tree, t: int) -> dict:
    """Tablet ``t``'s [B, ...] slot of a stacked [T, B, ...] host tree."""
    out = {n: tree[n][t] for n in _TOP}
    out["cols"] = {cid: {n: p[t] for n, p in col.items()}
                   for cid, col in tree["cols"].items()}
    return out


def _leaves(tree):
    """(key, leaf) of every leaf of a plane tree: key (None, name) or
    (column id, name)."""
    for n in _TOP:
        yield (None, n), tree[n]
    for cid, col in tree["cols"].items():
        for n, leaf in col.items():
            yield (cid, n), leaf


def _leaf(tree, key):
    cid, n = key
    return tree[n] if cid is None else tree["cols"][cid][n]


def _run_leaf(run: ColumnarRun, key):
    """A host run's leaf ``key``, [run.B, R, ...] (None where it holds no
    such plane)."""
    cid, n = key
    if cid is None:
        return getattr(run, n)
    col = run.cols.get(cid)
    if col is None:
        return None
    return {"set": col.set_, "isnull": col.isnull, "cmp": col.cmp_planes,
            "arith": col.arith}[n]


def _tablet_slice(tree, pieces, Bl: int):
    """The flattened [len(pieces) x Bl, ...] run of the ``pieces`` ((t, j)
    pairs) of a stacked [T, B, ...] host tree; the whole stack in (t, b)
    order is a reshape."""
    T, B = tree["valid"].shape[:2]
    whole = list(pieces) == [(t, j) for t in range(T)
                             for j in range(B // Bl)]

    def one(a):
        if whole:
            return a.reshape((T * B,) + a.shape[2:])
        return np.concatenate([a[t, j * Bl:(j + 1) * Bl] for t, j in pieces])

    out = {n: one(tree[n]) for n in _TOP}
    out["cols"] = {cid: {n: one(p) for n, p in col.items()}
                   for cid, col in tree["cols"].items()}
    return out


def _encode_stack(flat):
    """Encode a device's flattened plain planes with the host encoders
    (ops.encodings) over the flattened block axis. Padding (invalid
    blocks / pad tablets) is already baked into the plain planes, so
    decode is byte-identical by construction. The stack-level encoder
    never emits dict leaves; pathological planes stay plain."""
    out = {n: encodings.encode_bool_plane(flat[n])
           for n in ("valid", "group_start", "tomb", "live")}
    for n in ("ht_hi", "ht_lo", "exp_hi", "exp_lo"):
        out[n] = encodings.encode_int_plane(flat[n])
    out["cols"] = {}
    for cid, col in flat["cols"].items():
        e = {"set": encodings.encode_bool_plane(col["set"]),
             "isnull": encodings.encode_bool_plane(col["isnull"]),
             "cmp": encodings.encode_int_plane(col["cmp"])}
        if "arith" in col:
            e["arith"] = encodings.encode_float_plane(col["arith"])
        out["cols"][cid] = e
    return out


class _ReadWriteLock:
    """Scans share a stack; the slot update takes it alone. The update
    waits for the dispatches in flight, and scans that come while it waits
    wait for it, so that a dispatch reads one version of the planes and of
    the runs from its launches to its host decode."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False
        self._waiting = 0

    @contextlib.contextmanager
    def reading(self):
        with self._cond:
            while self._writing or self._waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def writing(self):
        with self._cond:
            self._waiting += 1
            while self._writing or self._readers:
                self._cond.wait()
            self._waiting -= 1
            self._writing = True
        try:
            yield
        finally:
            with self._cond:
                self._writing = False
                self._cond.notify_all()


class _Shard:
    """One distinct device's part of a stack: its pieces ((t, j) pairs in
    (t, b) order) and their flattened run (``arrays``, the device's
    planes, encoded or plain)."""

    __slots__ = ("device", "pieces", "arrays", "encoded", "decode_plan")

    def __init__(self, device, pieces, arrays, encoded):
        self.device = device
        self.pieces = pieces
        self.arrays = arrays
        self.encoded = encoded
        # K10's part table of an encoded run on a card, laid out once (a
        # few hundred bytes of device memory, outside the stack's charge,
        # as the JAX stack charges only its planes).
        self.decode_plan = (decode.plan_tree(arrays)
                            if encoded and device.type == "cuda" else None)


class ShardedTablets:
    """Stacked, mesh-sharded device residency for T tablets' single runs.

    Each tablet contributes one ColumnarRun (compact first); runs are
    padded to a common block count divisible by mesh_b * window and
    stacked to [T, B, R, ...]. Dummy all-invalid tablets pad T to a
    multiple of mesh_t. Each distinct device holds its pieces as one
    flattened run (``shards``)."""

    def __init__(self, schema: Schema, runs: list[ColumnarRun],
                 mesh: DeviceMesh, window_blocks: int = 8,
                 encode: bool | None = None):
        if not runs:
            raise MeshSpecError("need at least one run")
        R = runs[0].R
        if any(r.R != R for r in runs):
            raise MeshSpecError("all runs must share rows_per_block")
        self.schema = schema
        self.mesh = mesh
        self.K = window_blocks
        self.R = R
        mesh_t = mesh.shape["t"]
        mesh_b = mesh.shape["b"]
        self.T = len(runs)
        self.runs = list(runs)
        self.lock = _ReadWriteLock()
        pad_t = (-self.T) % mesh_t
        chunk = mesh_b * window_blocks
        Bmax = max(r.B for r in runs)
        self.B = Bmax + ((-Bmax) % chunk)
        self.Bl = self.B // mesh_b
        if self.Bl % window_blocks:
            raise AssertionError("local block count not a window multiple")
        self.padded_T = self.T + pad_t

        stacked = self._stack(runs, pad_t)
        if encode is None:
            from yugabyte_db_tpu_torch.storage import gpu_engine
            encode = gpu_engine.DEFAULT_PLANE_ENCODING != "off"
        Tl = self.padded_T // mesh_t
        by_device: dict = {}
        for i in range(mesh_t):
            for j in range(mesh_b):
                by_device.setdefault(mesh.devices[i][j], []).extend(
                    (t, j) for t in range(i * Tl, (i + 1) * Tl))
        self.shards = []
        for device in mesh.distinct():
            pieces = sorted(set(by_device[device]))
            flat = _tablet_slice(stacked, pieces, self.Bl)
            if encode:
                flat = _encode_stack(flat)
            self.enc_struct = _tree_struct(flat)
            arrays = DeviceRun.from_reference_planes(flat, R, device).arrays
            self.shards.append(_Shard(device, pieces, arrays,
                                      encodings.tree_encoded(arrays)))
        self.encoded = any(s.encoded for s in self.shards)
        self._layout = _layout(_slot(stacked, 0))
        # The stack lives outside the demand-upload path but inside the
        # same device budget: a pinned external entry, charged a device
        # at a time (the bytes each device holds).
        dev_bytes = shard_dev_bytes({s.device: s.arrays
                                     for s in self.shards})
        self._res_key = hbm_cache().add_external(
            self, sum(dev_bytes.values()),
            root_tracker().child("device").child("sharded"), "sharded_mesh",
            dev_bytes=dev_bytes)

    @property
    def flat(self) -> bool:
        """Every run holds one version a key group."""
        return all(r.max_group_versions <= 1 for r in self.runs)

    @property
    def nbytes(self) -> int:
        """Device bytes of the stack's planes, every device's."""
        return sum(device_nbytes(s.arrays) for s in self.shards)

    def close(self) -> None:
        """Release the stack's residency accounting. The planes stay
        usable for scans already holding this stack (they free when the
        last reference dies) — a flush/compaction can supersede a stack
        mid-serve without breaking the in-flight page."""
        if self._res_key is not None:
            hbm_cache().invalidate(self._res_key)
            self._res_key = None

    def plain_run(self, shard: _Shard) -> dict:
        """A device's plain planes: its own, or K10's decode of its
        encoded ones into a temporary run (at each dispatch)."""
        if not shard.encoded:
            return shard.arrays
        return decode.decode_tree(shard.arrays, shard.decode_plan)

    def update_tablet(self, t: int, run: ColumnarRun,
                      device_arrays=None) -> bool:
        """Replace tablet ``t``'s slot of the stacked planes in place (one
        ``ops.mesh.stack_update`` launch a device) — the incremental path
        when a flush/compaction swaps a single tablet's run.
        ``device_arrays``, when given, is a ``DeviceRun.arrays`` tree
        already on a device (the device flush's output, or a run's
        upload): its planes are the source, decoded by K10 where encoded;
        a leaf the stack holds and they lack (an encoded upload keeps no
        arith plane of an integer column) is uploaded from the host run's
        own plane, as is every leaf without ``device_arrays``. The write
        waits for the dispatches in flight on this stack (``lock``).
        Returns False when the stack must be rebuilt instead (encoded
        stack, block overflow, row-shape or column mismatch); residency
        accounting is unchanged either way because every shape is."""
        if self.encoded or t >= self.T or run.R != self.R:
            return False
        if max(run.B, 1) > self.B:
            return False
        sources = self._sources(run, device_arrays)
        if sources is None:
            return False
        Bl = self.Bl
        tables = []
        for shard in self.shards:
            moved: dict = {}

            def on_device(key, lo, hi):
                if key not in moved:
                    leaf = sources[key][0]
                    if isinstance(leaf, np.ndarray):
                        leaf = _upload(np.ascontiguousarray(leaf),
                                       shard.device)
                    moved[key] = leaf.to(shard.device).contiguous()
                return moved[key][lo:hi]

            entries = []
            for p, (tt, j) in enumerate(shard.pieces):
                if tt != t:
                    continue
                for key, leaf in _leaves(shard.arrays):
                    Bd = sources[key][1]
                    lo_b, hi_b = j * Bl, min((j + 1) * Bl, Bd)
                    n = max(hi_b - lo_b, 0)
                    dst = leaf[p * Bl:(p + 1) * Bl]
                    if n:
                        entries.append((dst[:n], on_device(key, lo_b, hi_b),
                                        None))
                    if n < Bl:
                        entries.append((dst[n:], None,
                                        int(key == (None, "group_start"))))
            if entries:
                tables.append(entries)
        with self.lock.writing():
            for entries in tables:
                mesh_ops.stack_update(entries)
            self.runs[t] = run
        return True

    def _sources(self, run: ColumnarRun, device_arrays) -> dict | None:
        """{leaf key: (source [Bd, ...], Bd)} of every leaf of the stack:
        the device planes' where they hold it (Bd their blocks), else the
        host run's own plane (Bd = run.B); the slot's blocks past Bd take
        the stack's padding, and the planes of a column the stack does not
        hold (a dropped one) are no source. None when a source's shape
        differs from the stack's or the device planes hold a leaf of one
        of its columns that it lacks."""
        want = dict(_layout_leaves(self._layout))
        got = {}
        if device_arrays is not None:
            src = self._device_src(device_arrays)
            if src is not None:
                tree, Bd = src
                held = {cid for (cid, _n) in want}
                have = {k: shape for k, shape in
                        _layout_leaves(_layout(tree)) if k[0] in held}
                if any(want.get(k) != shape for k, shape in have.items()):
                    return None
                got = {k: (_leaf(tree, k), Bd) for k in have}
        for k, shape in want.items():
            if k in got:
                continue
            leaf = _run_leaf(run, k)
            if leaf is None or tuple(leaf.shape[1:]) != shape or \
                    leaf.shape[0] != run.B:
                return None
            got[k] = (leaf, run.B)
        return got

    def _device_src(self, arrays):
        """(plain tree [Bd, R, ...], Bd) from device-resident run planes:
        encoded leaves decode ON DEVICE (K10; a dictionary's code plane is
        dropped), the slot's blocks past Bd are written with the stack's
        padding values. None when the planes don't fit the stack's
        shape."""
        B, R = encodings.tree_dims(arrays)
        if B > self.B or R != self.R:
            return None
        if encodings.tree_encoded(arrays):
            arrays = decode.decode_tree(arrays)
        tree = {n: arrays[n] for n in _TOP}
        tree["cols"] = {cid: {n: p for n, p in col.items() if n != "code"}
                        for cid, col in arrays["cols"].items()}
        return tree, int(B)

    def _stack(self, runs, pad_t):
        B, R = self.B, self.R
        T = len(runs) + pad_t

        def alloc(shape, dtype, fill=0):
            return np.full((T, B) + shape, fill, dtype=dtype)

        out = {
            "valid": alloc((R,), bool, False),
            # pad rows are their own groups so they never join a real one
            "group_start": alloc((R,), bool, True),
            "tomb": alloc((R,), bool, False),
            "live": alloc((R,), bool, False),
            "ht_hi": alloc((R,), np.int32),
            "ht_lo": alloc((R,), np.int32),
            "exp_hi": alloc((R,), np.int32),
            "exp_lo": alloc((R,), np.int32),
            "cols": {},
        }
        for c in self.schema.value_columns:
            # A run mid-ALTER may lack an added column; a dropped one's
            # planes stay in the runs, outside the stack.
            have = [r.cols.get(c.col_id) for r in runs]
            if any(col is None for col in have):
                raise MeshSpecError(f"a run holds no planes of column "
                                    f"{c.name}")
            nplanes = have[0].cmp_planes.shape[-1]
            if any(col.cmp_planes.shape[-1] != nplanes or
                   (col.arith is None) != (have[0].arith is None)
                   for col in have):
                raise MeshSpecError(f"the runs' planes of column {c.name} "
                                    f"differ")
            entry = {
                "set": alloc((R,), bool, False),
                "isnull": alloc((R,), bool, False),
                "cmp": alloc((R, nplanes), np.int32),
            }
            if have[0].arith is not None:
                entry["arith"] = alloc((R,), np.float32)
            out["cols"][c.col_id] = entry
        for t, run in enumerate(runs):
            b = run.B
            out["valid"][t, :b] = run.valid
            out["group_start"][t, :b] = run.group_start
            out["tomb"][t, :b] = run.tomb
            out["live"][t, :b] = run.live
            out["ht_hi"][t, :b] = run.ht_hi
            out["ht_lo"][t, :b] = run.ht_lo
            out["exp_hi"][t, :b] = run.exp_hi
            out["exp_lo"][t, :b] = run.exp_lo
            for cid, e in out["cols"].items():
                col = run.cols[cid]
                e["set"][t, :b] = col.set_
                e["isnull"][t, :b] = col.isnull
                e["cmp"][t, :b] = col.cmp_planes
                if col.arith is not None:
                    e["arith"][t, :b] = col.arith
        return out

    # -- per-tablet exact row bounds (host bisection over full key bytes) ---
    def row_bounds(self, lower: bytes, upper: bytes):
        lo = np.zeros(self.padded_T, dtype=np.int32)
        hi = np.zeros(self.padded_T, dtype=np.int32)
        for t, run in enumerate(self.runs):
            lo[t] = run.lower_row(lower)
            hi[t] = run.upper_row(upper)
        return lo, hi

    def piece_rows(self, lo: int, hi: int, j: int) -> tuple:
        """A tablet's row range [lo, hi) clipped to its b-shard ``j``, in
        the piece's own rows [0, Bl x R]."""
        n = self.Bl * self.R
        base = j * n
        return (min(max(int(lo) - base, 0), n),
                min(max(int(hi) - base, 0), n))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: from pinned memory, not waited for, on
    a card."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _read_planes(read_ht: int) -> tuple:
    r_hi, r_lo = PL.scalar_ht_planes(min(read_ht, MAX_HT))
    e_hi, e_lo = PL.scalar_ht_planes(min(read_ht, MAX_HT - 1))
    return r_hi, r_lo, e_hi, e_lo


# -- public API --------------------------------------------------------------

def agg_params(st: ShardedTablets, plan, shard: _Shard, lo, hi,
               read_planes, lits) -> np.ndarray:
    """K5's parameter rows of a device's pieces, one a piece: the tablet's
    row bounds clipped to the piece, the piece's windows, the read and
    expiry planes, the literals."""
    n, W = st.Bl * st.R, st.Bl // st.K
    KR = st.K * st.R
    rows = []
    for p, (t, j) in enumerate(shard.pieces):
        a, b = st.piece_rows(lo[t], hi[t], j)
        if b > a:
            w0, w1 = a // KR, (b - 1) // KR + 1
        else:
            a = b = w0 = w1 = 0
        rows.append(plan.param_row(p * n + a, p * n + b, p * W + w0,
                                   p * W + w1, read_planes, lits))
    return np.array(rows, np.int32)


def sharded_aggregate(st: ShardedTablets, spec: ScanSpec) -> ScanResult:
    """Evaluate spec's aggregates over all tablets on the mesh.

    Constraints (``MeshSpecError`` otherwise; callers fall back to the
    per-tablet path): aggregate-only spec, no GROUP BY, device-exact
    predicates only (non-key i32/i64/f64 columns), numeric aggregate
    columns, and a signature K5 takes.
    """
    if not spec.is_aggregate or spec.group_by:
        raise MeshSpecError("sharded_aggregate handles plain aggregate specs")
    schema = st.schema
    name_to_id = {c.name: c.col_id for c in schema.value_columns}
    kinds = {c.col_id: _kind(c) for c in schema.value_columns}
    key_names = {c.name for c in schema.key_columns}

    pred_sigs, pred_lits = [], []
    for p in spec.predicates:
        if p.column in key_names or p.op == "IN" or \
                p.column not in name_to_id:
            raise MeshSpecError(f"predicate on {p.column} not device-exact")
        cid = name_to_id[p.column]
        if kinds[cid] in ("str", "f32"):
            raise MeshSpecError(f"predicate kind {kinds[cid]} not "
                                f"device-exact")
        pred_sigs.append(dscan.PredSig(cid, kinds[cid], p.op))
        pred_lits.append(agg_fold.pred_literal_host(kinds[cid], p.value))

    for a in spec.aggregates:
        if a.expr is not None:
            # lower_aggs drops the expression tree silently; without
            # this guard a sum(a*b) spec would fold the wrong thing.
            raise MeshSpecError("expression aggregates need the host path")
        if a.column and a.column not in name_to_id:
            raise MeshSpecError(f"aggregate on key column {a.column}")
        if a.column and kinds[name_to_id[a.column]] == "str" and \
                a.fn != "count":
            raise MeshSpecError("string min/max needs the host path")
    dev_aggs, lowering = agg_fold.lower_aggs(spec.aggregates, name_to_id,
                                             kinds)
    col_sigs = tuple(dscan.ColSig(c.col_id, kinds[c.col_id])
                     for c in schema.value_columns)
    sig = dscan.ScanSig(B=st.B, R=st.R, K=st.K, cols=col_sigs,
                        preds=tuple(pred_sigs), aggs=dev_aggs,
                        apply_preds=True, flat=True)
    if not full_agg.supports(sig):
        raise MeshSpecError(f"K5 does not take {dev_aggs} {pred_sigs} at "
                            f"R={st.R}, K={st.K}")
    plan = full_agg.make_plan(dev_aggs, tuple(pred_sigs), col_sigs, st.R,
                              st.K)
    with st.lock.reading():
        lo, hi = st.row_bounds(spec.lower, spec.upper)
        reads = _read_planes(spec.read_ht)
        ivecs, fvecs = [], []
        for shard in st.shards:
            run = st.plain_run(shard)
            if not st.flat:
                B = int(run["valid"].shape[0])
                run = mvcc_resolve.resolve_view(
                    run, *reads, mvcc_resolve.constant_planes(B, st.R,
                                                              shard.device))
            params = agg_params(st, plan, shard, lo, hi, reads, pred_lits)
            iv, fv = full_agg.full_aggregate(plan, run, params)
            ivecs.append(iv)
            fvecs.append(fv)
        first = st.shards[0].device
        ivec = torch.cat([x.to(first) for x in ivecs]).contiguous()
        fvec = torch.cat([x.to(first) for x in fvecs]).contiguous()
        out_i, out_f = mesh_ops.combine(dev_aggs, ivec, fvec)
        # One fetch each: finalize() reads every word.
        acc, scanned = agg_fold.unpack(dev_aggs, out_i.tolist(),
                                       out_f.tolist())

    out_row, names = [], []
    for a, (fn_name, di) in zip(spec.aggregates, lowering):
        names.append(f"{a.fn}({a.column or '*'})")
        out_row.append(agg_fold.finalize(dev_aggs[di], acc[di], fn_name))
    return ScanResult(names, [tuple(out_row)], None, int(scanned))


def _kind(c):
    from yugabyte_db_tpu_torch.ops.device_run import dtype_kind
    return dtype_kind(c.dtype)


# -- sharded row/paging path -------------------------------------------------
#
# The cluster ROW read path on the mesh: each device runs the packed row
# gather K7 (ops.row_gather — the same MVCC resolve and compaction the
# single-run engine serves pages with) over its pieces, one parameter row
# a piece, emitting each piece's first M matches IN KEY ORDER plus its
# match count; the host assembles LIMIT pages in tablet order (a piece
# covers a contiguous disjoint row range, so concatenating a tablet's
# pieces in "b" order is already key order) and decodes ONLY the page's
# rows from the fetched value planes. This is the device-sharded analog
# of the per-tablet parallel read fan-out (reference:
# src/yb/client/batcher.h:80).

_PAGE_BUCKETS = (128, 512, 2048)


def page_params(st: ShardedTablets, shard: _Shard, lo, hi, read_planes,
                int_lits) -> np.ndarray:
    """K7's parameter rows of a device's pieces, one a piece: the global
    row bounds of the tablet rebased to the piece and clipped to it
    (empty when the tablet's range misses the piece), its windows
    (inclusive; ``w_last`` < ``w_first`` for none), then offset to the
    piece's place in the device's flattened run, as ``_page_body``
    rebases them."""
    n = st.Bl * st.R
    KR = st.K * st.R
    Wl = st.Bl // st.K
    rows = []
    for p, (t, j) in enumerate(shard.pieces):
        a, b = st.piece_rows(lo[t], hi[t], j)
        w_first = min(max(a // KR, 0), Wl - 1)
        w_last = min(max((b - 1) // KR, 0), Wl - 1) if b > a \
            else w_first - 1
        ip, _f = RG.pack_params(p * Wl + w_first, p * Wl + w_last,
                                p * n + a, p * n + b, read_planes, int_lits,
                                [], scan_from=p * n + a)
        rows.append(ip)
    return np.stack(rows)


def local_buffers(sig: RG.GatherSig, st: ShardedTablets, shard: _Shard,
                  out: np.ndarray) -> dict:
    """{(t, j): [M+1, W] int32} of a device's K7 output in the JAX
    program's piece-local form: group-start and setter rows less the
    piece's first row in the flattened run, ``w_end`` less its first
    window."""
    M = sig.M
    n = st.Bl * st.R
    Wl = st.Bl // st.K
    idx_offs = [i for _c, _n, i in RG.out_layout(sig)[1].values()
                if i is not None]
    bufs = {}
    for p, (t, j) in enumerate(shard.pieces):
        buf = out[p].copy()
        k = min(int(buf[M, 0]), M)
        buf[:k, 0] -= p * n
        for off in idx_offs:
            col = buf[:k, off]
            col[col >= 0] -= p * n
        buf[M, 2] -= p * Wl
        bufs[t, j] = buf
    return bufs


def sharded_row_page(st: ShardedTablets, spec: ScanSpec,
                     resume: bytes | None = None) -> ScanResult:
    """LIMIT page over all tablets on the mesh: ONE launch of K7 a device
    runs the packed MVCC row gather on every piece; the host takes the
    first `limit` in (tablet, key) order and decodes them from the
    fetched value planes (result-proportional host work — varlen/f32
    payloads fetch by setter index from the host run). Serves
    multi-version AND encoded stacks. Constraints (``MeshSpecError``
    otherwise; callers fall back to the per-tablet path): exact (i32/
    i64/f64 value-column) predicates, no aggregates, and the columns,
    predicates and output columns K7's descriptor holds.

    Cross-tablet paging: the returned resume_key encodes
    (tablet index, last key) — pass it back as ``resume`` to continue
    (the QLPagingStatePB next_partition_key + next_row_key shape)."""
    if spec.is_aggregate:
        raise MeshSpecError("sharded_row_page serves row scans")
    schema = st.schema
    name_to_id = {c.name: c.col_id for c in schema.value_columns}
    kinds = {c.col_id: _kind(c) for c in schema.value_columns}
    key_names = {c.name for c in schema.key_columns}
    pred_sigs, int_lits = [], []
    for p in spec.predicates:
        if p.column in key_names or p.op == "IN" or \
                p.column not in name_to_id:
            raise MeshSpecError(f"predicate on {p.column} not device-exact")
        cid = name_to_id[p.column]
        kind = kinds[cid]
        if kind not in ("i32", "i64", "f64"):
            raise MeshSpecError(f"predicate kind {kind} not device-exact")
        if kind == "i32":
            int_lits.append(int(p.value))
        elif kind == "i64":
            phi, plo = PL.i64_to_ordered_planes(
                np.array([int(p.value)], dtype=np.int64))
            int_lits += [int(phi[0]), int(plo[0])]
        else:
            phi, plo = PL.f64_to_ordered_planes(
                np.array([p.value], dtype=np.float64))
            int_lits += [int(phi[0]), int(plo[0])]
        pred_sigs.append(dscan.PredSig(cid, kind, p.op))

    limit = spec.limit if spec.limit is not None else _PAGE_BUCKETS[-1]
    M = next((m for m in _PAGE_BUCKETS if m >= limit),
             -(-limit // 128) * 128)
    projection = spec.projection or [c.name for c in schema.columns]
    key_pos = {c.name: i for i, c in enumerate(schema.key_columns)}
    unknown = [nm for nm in projection
               if nm not in key_pos and nm not in name_to_id]
    if unknown:
        raise MeshSpecError(f"columns {unknown} not in the stack's schema")
    out_cols = tuple(
        RG.OutCol(name_to_id[nm],
                  2 if kinds[name_to_id[nm]] in ("i64", "f64", "str")
                  else 1,
                  kinds[name_to_id[nm]] in ("str", "f32"))
        for nm in projection if nm not in key_pos)
    col_sigs = tuple(dscan.ColSig(c.col_id, kinds[c.col_id])
                     for c in schema.value_columns)
    if len(col_sigs) > RG.MAX_COLS or len(pred_sigs) > RG.MAX_PREDS or \
            len(out_cols) > RG.MAX_OUT:
        raise MeshSpecError(f"{len(col_sigs)} columns, {len(pred_sigs)} "
                            f"predicates, {len(out_cols)} output columns: "
                            f"past K7's descriptor")

    with st.lock.reading():
        start_t = 0
        start_key = spec.lower
        from yugabyte_db_tpu_torch.utils import codec as _codec

        if resume is not None:
            start_t, last_key = _codec.decode(resume)
            start_key = max(spec.lower, last_key + b"\x00")
        lo, hi = st.row_bounds(spec.lower, spec.upper)
        if resume is not None:
            for t in range(min(start_t, len(st.runs))):
                lo[t] = hi[t]  # earlier tablets: already consumed
            if start_t < len(st.runs):
                lo[start_t] = max(lo[start_t],
                                  st.runs[start_t].lower_row(start_key))
        reads = _read_planes(spec.read_ht)
        flat = st.flat
        bufs: dict = {}
        total = 0
        sig = None
        for shard in st.shards:
            run = st.plain_run(shard)
            sig = RG.GatherSig(B=len(shard.pieces) * st.Bl, R=st.R,
                               K=st.K, M=M, cols=col_sigs,
                               preds=tuple(pred_sigs), apply_preds=True,
                               out_cols=out_cols, flat=flat, packed=True)
            ip = page_params(st, shard, lo, hi, reads, int_lits)
            out = RG.gather_rows(
                sig, run, _upload(ip, shard.device),
                torch.zeros((ip.shape[0], 1), dtype=torch.float32,
                            device=shard.device))
            # One fetch a device: the pieces' buffers, counts included.
            out = out.cpu().numpy()
            total += int(out[:, M, 0].astype(np.int64).sum())
            bufs.update(local_buffers(sig, st, shard, out))

        W, col_offs = RG.out_layout(sig)
        rows: list[tuple] = []
        budget = limit
        mesh_b = st.mesh.shape["b"]
        shard_rows = st.Bl * st.R
        KR = st.K * st.R
        Wl = st.Bl // st.K
        resume_out = None
        for t, run in enumerate(st.runs):
            truncated = False
            sel: list[tuple] = []  # (global row, buf row, shard base)
            for b in range(mesh_b):
                buf = bufs[t, b]
                c = int(buf[M, 0])
                w_end = int(buf[M, 2])
                base = b * shard_rows
                lo_loc = min(max(int(lo[t]) - base, 0), shard_rows)
                hi_loc = min(max(int(hi[t]) - base, 0), shard_rows)
                w_last = (hi_loc - 1) // KR if hi_loc > lo_loc else -1
                # Early exit (count hit M before w_last) leaves windows
                # unscanned: matches may remain beyond the buffer.
                if c > M or (c >= M and w_end <= min(w_last, Wl - 1)):
                    truncated = True
                for m in range(min(c, M)):
                    sel.append((base + int(buf[m, 0]), buf[m], base))
            more_in_tablet = truncated or len(sel) > budget
            sel = sel[:budget]
            for g, br, sbase in sel:
                rows.append(_decode_buf_row(run, schema, br, col_offs,
                                            sbase, projection, key_pos,
                                            kinds))
            budget -= len(sel)
            page_full = budget <= 0
            if sel and (more_in_tablet
                        or (page_full and t + 1 < len(st.runs))):
                resume_out = _codec.encode([t, run.key_at(sel[-1][0])])
                break
            if page_full:
                break
        return ScanResult(list(projection), rows, resume_out, int(total))


def _decode_buf_row(run, schema, buf_row, col_offs, shard_base,
                    projection, key_pos, kinds):
    """One packed gather output row -> result tuple (the engine's
    fetched-plane decode split: fixed-width values from the device
    planes, varlen/f32 payloads by setter index from the host run,
    key columns from the group-start key)."""
    from yugabyte_db_tpu_torch.models.datatypes import DataType

    key_vals = None
    out = []
    for nm in projection:
        if nm in key_pos:
            if key_vals is None:
                key_vals = run.key_vals_at(shard_base + int(buf_row[0]))
            out.append(key_vals[key_pos[nm]])
            continue
        col = schema.column(nm)
        cmp_off, null_off, idx_off = col_offs[col.col_id]
        if buf_row[null_off]:
            out.append(None)
            continue
        kind = kinds[col.col_id]
        if kind in ("str", "f32"):
            g = shard_base + int(buf_row[idx_off])
            b, r = divmod(g, run.R)
            out.append(run.row_versions[b][r].columns[col.col_id])
        elif kind == "i32":
            v = int(buf_row[cmp_off])
            out.append(bool(v) if col.dtype == DataType.BOOL else v)
        elif kind == "i64":
            out.append(int(PL.ordered_planes_to_i64(
                buf_row[cmp_off:cmp_off + 1],
                buf_row[cmp_off + 1:cmp_off + 2])[0]))
        else:
            out.append(float(PL.ordered_planes_to_f64(
                buf_row[cmp_off:cmp_off + 1],
                buf_row[cmp_off + 1:cmp_off + 2])[0]))
    return tuple(out)
