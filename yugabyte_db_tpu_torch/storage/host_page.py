"""Host page-cache path: small LIMIT pages served from the columnar
host mirror instead of a device round trip.

The port's copy of the JAX package's ``storage/host_page.py``, its numpy
path: ``HostPageIndex``, ``encode_pred_items``, ``plan_pages`` /
``decode_pages`` and ``serve_pages`` over them, and the wire page
(``WirePage``, ``wire_from_result``: the Python serializer the engine
seam's ``scan_batch_wire`` uses, ``models.wirefmt``'s bytes). The native
page server (the JAX ``serve_pages_wire``) waits for ROADMAP.md §1 item
16; the JAX engine's native and Python paths produce the same bytes.

Why this exists (the latency story): a LIMIT-k page is *result-bound* —
it returns ~k rows no matter how large the table. On the serving
topology the device link charges a full fetch cycle per synchronous
page and the result bytes ride a narrow D2H pipe, so the roofline
choice for a k≈100-row page is the host mirror of the run, which the
engine already holds (ColumnarRun keeps every plane as numpy — the
build/compaction input). This mirrors the reference serving short
scans/point gets from the RocksDB block cache rather than re-reading
SSTables (src/yb/rocksdb/table/block_based_table_reader.cc); the device
remains the engine for throughput-bound work: aggregates, wide scans,
compaction.

Semantics are an exact host transcription of the device *flat* resolve
(ops/scan.py:_resolve_flat): MVCC visibility at the read point,
tombstones, TTL expiry, liveness/column existence, and device-exact
predicates — eligibility is restricted to exactly the cases where the
device path itself is exact (single source, flat run, i32/i64/f64
value-column predicates), so results are bit-identical to both the
device path and the CPU oracle (engine-diff tests enforce it).

The core data structure is a per-(run, read point, predicates) **match
index**: one vectorized pass computes the row-exists and
predicate-match masks for the whole run, and ``np.nonzero`` turns them
into sorted global-row-index arrays. A page is then two
``searchsorted`` calls + a bounded slice — O(log n + k) — and many
pages amortize one shared decode (scan_batch groups same-structure
pages and decodes their union with one vectorized pass per column).
"""

from __future__ import annotations

import threading

import numpy as np

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
from yugabyte_db_tpu_torch.utils import planes as P

# Kinds whose plane comparisons are exact on host (mirrors the device
# "exact" predicate set; str/f32 are superset-only and stay on the
# verify paths).
_EXACT_KINDS = ("i32", "i64", "f64")

MAX_PAGE_LIMIT = 4096   # larger scans go to the device gather path
_MASK_CACHE_ENTRIES = 8  # distinct (read point, predicates) per run


def _le2(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


class HostPageIndex:
    """Lazily-built host mirror views + match-index cache for one run."""

    def __init__(self, crun):
        self.crun = crun
        n = crun.B * crun.R
        # reshape(-1) of C-contiguous [B, R] arrays: views, not copies.
        self.valid = crun.valid.reshape(n)
        self.tomb = crun.tomb.reshape(n)
        self.live = crun.live.reshape(n)
        self.ht_hi = crun.ht_hi.reshape(n)
        self.ht_lo = crun.ht_lo.reshape(n)
        self.exp_hi = crun.exp_hi.reshape(n)
        self.exp_lo = crun.exp_lo.reshape(n)
        self.cols = {}
        for cid, col in crun.cols.items():
            self.cols[cid] = (
                col.set_.reshape(n), col.isnull.reshape(n),
                col.cmp_planes.reshape(n, col.cmp_planes.shape[-1]))
        self._lock = threading.Lock()
        self._masks: dict = {}
        self._ht_bounds = None

    _TIMELESS = ("timeless",)

    def cache_planes(self, read_planes):
        """Collapse the mask-cache key for 'current' reads: every read
        point at or beyond the run's last commit and before its first
        expiry sees identical masks, so a server whose read hybrid time
        advances with every write (the steady state) reuses ONE cached
        entry instead of recomputing full-run masks per read point.
        Reference analog: RocksDB serves such reads from the same block
        cache entries regardless of snapshot sequence number."""
        if self._ht_bounds is None:
            v = self.valid
            if v.any():
                hh, hl = self.ht_hi[v], self.ht_lo[v]
                mh = int(hh.max())
                commit = (mh, int(hl[hh == mh].max()))
                eh, el = self.exp_hi[v], self.exp_lo[v]
                xh = int(eh.min())
                expiry = (xh, int(el[eh == xh].min()))
            else:
                commit = (2**31 - 1, 2**31 - 1)  # never canonicalize
                expiry = (-2**31, -2**31)
            self._ht_bounds = (commit, expiry)
        commit, expiry = self._ht_bounds
        r_hi, r_lo, e_hi, e_lo = read_planes
        if commit <= (r_hi, r_lo) and expiry > (e_hi, e_lo):
            return self._TIMELESS
        return read_planes

    def masks(self, read_planes, pred_items, cache_planes=None):
        """(match_idx, exists_idx, notnull{cid}) for one read point +
        predicate list; cached. ``pred_items`` is a hashable tuple of
        (cid, kind, op, literal-encoding). ``cache_planes`` overrides
        the cache key (see cache_planes())."""
        key = (read_planes if cache_planes is None else cache_planes,
               pred_items)
        with self._lock:
            hit = self._masks.get(key)
            if hit is not None:
                return hit
        r_hi, r_lo, e_hi, e_lo = read_planes
        visible = self.valid & _le2(self.ht_hi, self.ht_lo, r_hi, r_lo)
        expired = _le2(self.exp_hi, self.exp_lo, e_hi, e_lo)
        alive = visible & ~self.tomb
        not_expired = ~expired
        exists = alive & self.live & not_expired
        notnull = {}
        for cid, (set_f, isnull_f, _cmp) in self.cols.items():
            nn = alive & set_f & ~isnull_f & not_expired
            notnull[cid] = nn
            exists = exists | nn
        result = exists
        for cid, kind, op, lit in pred_items:
            result = result & notnull[cid] & self._pred_mask(cid, kind,
                                                             op, lit)
        entry = (np.nonzero(result)[0], np.nonzero(exists)[0], notnull)
        with self._lock:
            if len(self._masks) >= _MASK_CACHE_ENTRIES:
                self._masks.pop(next(iter(self._masks)))
            self._masks[key] = entry
        return entry

    def _pred_mask(self, cid, kind, op, lit):
        cmp = self.cols[cid][2]
        if kind == "i32":
            v, x = cmp[:, 0], lit
            return {"=": v == x, "!=": v != x, "<": v < x, "<=": v <= x,
                    ">": v > x, ">=": v >= x}[op]
        hi, lo = cmp[:, 0], cmp[:, 1]
        lhi, llo = lit
        eq = (hi == lhi) & (lo == llo)
        lt = (hi < lhi) | ((hi == lhi) & (lo < llo))
        return {"=": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
                ">": ~(lt | eq), ">=": ~lt}[op]


def encode_pred_items(engine, preds):
    """Predicates -> hashable (cid, kind, op, literal-encoding) tuple, or
    None when any predicate isn't host-exact (caller falls back)."""
    items = []
    for p in preds:
        cid = engine._name_to_id.get(p.column)
        if cid is None:
            return None
        kind = engine._kinds[cid]
        if kind not in _EXACT_KINDS or p.op == "IN":
            return None
        if kind == "i32":
            lit = int(p.value)
        elif kind == "i64":
            hi, lo = P.i64_to_ordered_planes(
                np.array([int(p.value)], dtype=np.int64))
            lit = (int(hi[0]), int(lo[0]))
        else:  # f64
            hi, lo = P.f64_to_ordered_planes(
                np.array([p.value], dtype=np.float64))
            lit = (int(hi[0]), int(lo[0]))
        items.append((cid, kind, p.op, lit))
    return tuple(items)


class HostPage:
    """One planned page: the index slice is computed at plan time (pure
    host work, batch-vectorized in plan_pages); decode happens batched
    at finish time."""

    __slots__ = ("engine", "trun", "spec", "sel", "scanned", "hit_limit",
                 "notnull", "struct_key")

    def __init__(self, engine, trun, spec, sel, scanned, hit_limit,
                 notnull):
        self.engine = engine
        self.trun = trun
        self.spec = spec
        self.sel = sel
        self.scanned = scanned
        self.hit_limit = hit_limit
        self.notnull = notnull
        self.struct_key = (id(trun), tuple(spec.projection or ()))

    def result(self, rows, columns=None) -> ScanResult:
        crun = self.trun.crun
        if columns is None:
            columns = list(self.spec.projection
                           or (c.name for c in self.engine.schema.columns))
        resume = (crun.key_at(int(self.sel[-1])) + b"\x00"
                  if self.hit_limit else None)
        return ScanResult(columns, rows, resume, self.scanned)


def plan_pages(engine, items):
    """Plan many pages at once: items is [(trun, spec, pred_items)];
    pages sharing (run, read point, predicates) — the common server
    shape — resolve their range bounds with ONE vectorized searchsorted
    over the shared match index. Returns [HostPage] in items order."""
    out = [None] * len(items)
    groups: dict = {}
    for i, (trun, spec, pred_items) in enumerate(items):
        idx = trun.host_index
        if idx is None:
            idx = trun.host_index = HostPageIndex(trun.crun)
        read_planes = engine._read_plane_ints(spec)
        crp = idx.cache_planes(read_planes)
        key = (id(trun), crp, pred_items)
        g = groups.get(key)
        if g is None:
            g = groups[key] = (trun, read_planes, crp, pred_items, [])
        g[4].append((i, spec))
    for trun, read_planes, crp, pred_items, members in groups.values():
        crun = trun.crun
        idx = trun.host_index
        match_idx, exists_idx, notnull = idx.masks(read_planes, pred_items,
                                                   cache_planes=crp)
        n_rows = crun.total_rows()
        row_los = [crun.lower_row(s.lower) for _i, s in members]
        i0s = match_idx.searchsorted(np.array(row_los, dtype=np.int64))
        for (i, spec), row_lo, i0 in zip(members, row_los, i0s.tolist()):
            if spec.upper:
                row_hi = crun.upper_row(spec.upper)
                i1 = int(match_idx.searchsorted(row_hi))
            else:
                row_hi = n_rows
                i1 = len(match_idx)
            limit = spec.limit
            take = min(i1 - i0, limit) if limit is not None else (i1 - i0)
            sel = match_idx[i0:i0 + take]
            hit_limit = limit is not None and take >= limit and take > 0
            # Work statistic: existing rows examined through the last
            # consumed row (whole range when nothing matched).
            hi_row = int(sel[-1]) + 1 if take > 0 else row_hi
            scanned = int(exists_idx.searchsorted(hi_row) -
                          exists_idx.searchsorted(row_lo))
            out[i] = HostPage(engine, trun, spec, sel, scanned, hit_limit,
                              notnull)
    return out


def decode_pages(engine, pages: list[HostPage]) -> list[ScanResult]:
    """Decode a group of same-structure pages with ONE vectorized pass
    per projected column over the union of their selected rows."""
    if not pages:
        return []
    trun = pages[0].trun
    crun = trun.crun
    notnull = pages[0].notnull
    projection = (pages[0].spec.projection
                  or [c.name for c in engine.schema.columns])
    counts = [len(p.sel) for p in pages]
    parts = [p.sel for p in pages if len(p.sel)]
    if parts:
        sel = np.concatenate(parts) if len(parts) > 1 else parts[0]
        key_col_pos = {c.name: i
                       for i, c in enumerate(engine.schema.key_columns)}
        kv_cols = None
        if any(nm in key_col_pos for nm in projection):
            kv_cols = crun.key_col_arrays(
                None if crun.kv_ready
                else np.unique(sel // crun.R).tolist())
        cols_out = []
        for nm in projection:
            if nm in key_col_pos:
                cols_out.append(kv_cols[key_col_pos[nm]][sel].tolist())
            else:
                cols_out.append(
                    _decode_value_col(engine, trun, nm, sel, notnull))
        rows_all = list(zip(*cols_out))
    else:
        rows_all = []
    cols_list = list(projection)
    out = []
    off = 0
    for p, n in zip(pages, counts):
        # NOTE: results share one columns list per group; callers treat
        # ScanResult.columns as read-only (every engine path does).
        out.append(p.result(rows_all[off:off + n], cols_list))
        off += n
    return out

def serve_pages(engine, items):
    """Serve many pages: items is [(trun, spec, pred_items)]; pages are
    planned together (``plan_pages``) and decoded in groups of one
    structure (``decode_pages``). Returns [ScanResult] in items order."""
    planned = plan_pages(engine, items)
    groups: dict = {}
    for i, pg in enumerate(planned):
        groups.setdefault(pg.struct_key, []).append((i, pg))
    out = [None] * len(items)
    for members in groups.values():
        decoded = decode_pages(engine, [pg for _i, pg in members])
        for (i, _pg), res in zip(members, decoded):
            out[i] = res
    return out


def _decode_value_col(engine, trun, name, sel, notnull):
    crun = trun.crun
    cid = engine._name_to_id[name]
    kind = engine._kinds[cid]
    nn = notnull[cid][sel]
    if kind in ("str", "f32"):
        # Exact payloads live host-side on the RowVersion (flat run: the
        # row IS the single setter) — same source the device path uses.
        R = crun.R
        out = []
        for i, g in enumerate(sel.tolist()):
            if not nn[i]:
                out.append(None)
                continue
            b, r = divmod(g, R)
            out.append(crun.row_versions[b][r].columns[cid])
        return out
    cmp = trun.host_index.cols[cid][2]
    if kind == "i32":
        raw = cmp[sel, 0].tolist()
    elif kind == "i64":
        raw = P.ordered_planes_to_i64(cmp[sel, 0], cmp[sel, 1]).tolist()
    else:  # f64
        raw = P.ordered_planes_to_f64(cmp[sel, 0], cmp[sel, 1]).tolist()
    dt = engine._dtypes[cid]
    if dt == DataType.BOOL:
        return [bool(v) if n else None for v, n in zip(raw, nn.tolist())]
    if nn.all():
        return raw
    for i in np.nonzero(~nn)[0].tolist():
        raw[i] = None
    return raw


# -- wire pages -------------------------------------------------------------
# A wire page is a result page serialized once into protocol bytes (CQL
# binary cells or PG DataRow messages). Reference contract:
# QLRowBlock::Serialize rows_data (src/yb/common/ql_rowblock.h:66),
# forwarded untouched by the CQL service (cql_processor.cc).

WIRE_CQL = 0
WIRE_PG = 1


class WirePage:
    """One serialized result page (scan_batch_wire output)."""

    __slots__ = ("columns", "data", "nrows", "resume", "scanned",
                 "read_ht")

    def __init__(self, columns, data, nrows, resume, scanned,
                 read_ht=None):
        self.columns = columns
        self.data = data
        self.nrows = nrows
        self.resume = resume
        self.scanned = scanned
        self.read_ht = read_ht


def wire_from_result(engine, res: ScanResult, fmt) -> WirePage:
    """ScanResult -> WirePage via the Python serializer (models.wirefmt
    defines the bytes)."""
    from yugabyte_db_tpu_torch.models import wirefmt

    fmt_name = "cql" if fmt in (WIRE_CQL, "cql") else "pg"
    by_name = {c.name: c.dtype for c in engine.schema.columns}
    dts = []
    for i, nm in enumerate(res.columns):
        dt = by_name.get(nm)
        if dt is None:  # computed column (aggregate): infer from values
            dt = DataType.INT64
            for row in res.rows:
                v = row[i]
                if v is None:
                    continue
                dt = (DataType.BOOL if isinstance(v, bool)
                      else DataType.INT64 if isinstance(v, int)
                      else DataType.DOUBLE if isinstance(v, float)
                      else DataType.BINARY
                      if isinstance(v, (bytes, bytearray))
                      else DataType.STRING)
                break
        dts.append(dt)
    data = wirefmt.serialize_rows(fmt_name, dts, res.rows)
    return WirePage(list(res.columns), data, len(res.rows),
                    res.resume_key, res.rows_scanned)
