"""The ``gpu`` engine's row path: the JAX ``tpu`` engine's routes for row
scans, and for aggregates the device folds cannot take.

``GpuStorageEngine`` (``storage.gpu_engine``) takes these methods from
``RowPath``. Each route is the JAX engine's (``storage/tpu_engine.py``),
and so is each route's ``rows_scanned``:

1. an exact-key read (``_point_get_row``): a bloom-pruned version lookup
   over the runs and the memtable; ``rows_scanned`` is 1 if any version
   was found, else 0;
2. a LIMIT page of at most ``host_page.MAX_PAGE_LIMIT`` rows on one flat
   run with exact predicates only: the host page index
   (``storage.host_page``); ``rows_scanned`` counts the rows that exist
   from the range's start through the last row consumed;
3. any other scan of one run: the gather (``_plan_gather``), whose
   pages K7 (``ops.row_gather.gather_rows``) compacts on the device.
   ``chunks`` mode (no LIMIT, no predicate) emits one whole window a
   params row; ``paged`` mode walks windows until M matches and
   continues from where the buffer filled (``_GatherScan``). Superset
   ('str', 'f32') and host-only (key-column, IN, opaque) predicates are
   verified on the decoded rows, and an aggregate spec feeds the
   ``Aggregator``. ``rows_scanned`` counts the groups that exist in range
   before predicates over the whole windows walked (a LIMIT page counts
   its last window whole);
4. several sources (``_row_scan``): each run's candidate keys from K9
   (``ops.row_gather.scan_candidates``, predicates applied only over a
   single source), merged in key order with the memtable's keys, each
   key's versions merged across sources, predicates applied on the host;
   ``rows_scanned`` counts the distinct candidate keys examined (for the
   memtable, every key in range, existing or not).

The host re-serve behind the circuit breaker (``_serve_host_batch``, the
JAX engine's) serves a whole batch without the device: exact-key reads as
in 1, everything else through ``_row_scan`` with ``device_ok`` False,
whose candidates are every valid key in range of each run's host planes
(``_host_candidates``), all predicates applied on the host. Its rows and
resume keys are the device routes'; its ``rows_scanned`` counts the
distinct keys examined.

Every gather params row of a batch that shares a signature and a run goes
in one K7 launch a round: the first round is launched in
``scan_batch_async``, continuation rounds in ``_AsyncBatch.finish``.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.ops import row_gather
from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.storage.cpu_engine import Aggregator
from yugabyte_db_tpu_torch.storage.expr import columns_of
from yugabyte_db_tpu_torch.storage.merge import merge_versions
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT
from yugabyte_db_tpu_torch.storage.scan_spec import (ScanResult, ScanSpec,
                                                     point_key_of)
from yugabyte_db_tpu_torch.utils import planes as P

WINDOW_BLOCKS = 8   # blocks per window on the row path (the JAX engine's)
CANDIDATE_BATCH_MAX = 64  # windows of one K9 launch, once the range grows


class RowPath:
    """The row-path methods of ``GpuStorageEngine``."""

    # -- planning helpers --------------------------------------------------
    def _read_plane_ints(self, spec: ScanSpec) -> tuple:
        """(read hi, read lo, expiry hi, expiry lo) of the spec's read
        point; a small keyed cache (pages share read points)."""
        cached = self._read_plane_cache.get(spec.read_ht)
        if cached is not None:
            return cached
        r_hi, r_lo = P.scalar_ht_planes(min(spec.read_ht, MAX_HT))
        e_hi, e_lo = P.scalar_ht_planes(min(spec.read_ht, MAX_HT - 1))
        planes = (r_hi, r_lo, e_hi, e_lo)
        if len(self._read_plane_cache) >= 64:
            self._read_plane_cache.pop(next(iter(self._read_plane_cache)))
        self._read_plane_cache[spec.read_ht] = planes
        return planes

    def _col_sigs(self) -> tuple:
        return tuple(dscan.ColSig(c.col_id, self._kinds[c.col_id])
                     for c in self.schema.value_columns)

    def _pred_kind(self, p) -> str:
        """The device plane kind a predicate compares: ``"code"`` for a
        promoted dictionary-code predicate, else its column's kind."""
        if getattr(p, "promoted", False):
            return "code"
        return self._kinds[self._name_to_id[p.column]]

    def _pred_sigs_only(self, preds) -> tuple:
        return tuple(dscan.PredSig(self._name_to_id[p.column],
                                   self._pred_kind(p), p.op) for p in preds)

    def _pred_host_literals(self, preds):
        """Predicate literals -> (int32 plane list, f32 list), host values."""
        int_lits, f32_lits = [], []
        for p in preds:
            kind = self._pred_kind(p)
            if kind == "f32":
                f32_lits.append(float(p.value))
            elif kind in ("i32", "code"):
                int_lits.append(int(p.value))
            elif kind == "i64":
                hi, lo = P.i64_to_ordered_planes(
                    np.array([int(p.value)], dtype=np.int64))
                int_lits += [int(hi[0]), int(lo[0])]
            elif kind == "f64":
                hi, lo = P.f64_to_ordered_planes(
                    np.array([p.value], dtype=np.float64))
                int_lits += [int(hi[0]), int(lo[0])]
            else:
                raw = (p.value.encode("utf-8", "surrogateescape")
                       if isinstance(p.value, str) else bytes(p.value))
                hi, lo = P.varlen_prefix_planes([raw])
                int_lits += [int(hi[0]), int(lo[0])]
        return int_lits, f32_lits

    # -- route 1: exact-key reads ------------------------------------------
    def _point_versions(self, key: bytes, mem) -> list:
        """Bloom-pruned version lookup of one key across the runs and the
        memtable (the JAX engine's ``_point_versions``)."""
        from yugabyte_db_tpu_torch.models.encoding import hashed_prefix

        versions = []
        hp = hashed_prefix(key)
        # The bloom earns its (lazy, full-run) build only when it can
        # skip several runs per get; with 1-2 runs the per-run binary
        # search is already O(log n), so only probe a bloom that exists.
        many_runs = len(self.runs) > 2
        for t in self.runs:
            crun = t.crun
            if crun.num_versions == 0 or crun.max_key < key \
                    or crun.min_key > key:
                continue
            if hp and (many_runs or crun.bloom_ready) \
                    and not crun.may_contain_hashed(hp):
                continue
            versions.extend(crun.find_versions(key))
        versions.extend(mem.versions(key))
        return versions

    def _point_get_row(self, spec: ScanSpec, mem, key: bytes) -> ScanResult:
        """One exact-key read: merge, predicates, materialization;
        ``rows_scanned`` 1 if any version was found."""
        versions = self._point_versions(key, mem)
        projection = spec.projection or [c.name for c in self.schema.columns]
        rows = []
        if versions:
            merged = merge_versions(key, versions, spec.read_ht)
            if merged.exists:
                key_vals = self.mat.key_values(key)
                if self.mat.matches(spec, key_vals, merged):
                    rows.append(tuple(self.mat.value(nm, key_vals, merged)
                                      for nm in projection))
        resume = (key + b"\x00" if spec.limit is not None
                  and len(rows) >= spec.limit else None)
        return ScanResult(list(projection), rows, resume,
                          1 if versions else 0)

    # -- the host re-serve (the breaker's fallback) -------------------------
    def _serve_host_batch(self, specs: list[ScanSpec],
                          deadline=None) -> list[ScanResult]:
        """Serve a whole batch WITHOUT the device: candidate keys from the
        authoritative host runs, the shared merge and materialize loop
        applying every predicate on the host, so the rows equal the
        device routes' (and the CPU oracle's). ``deadline`` is checked
        before each spec."""
        self.host_reserves += 1
        out = []
        for spec in specs:
            if deadline is not None:
                deadline.check("gpu_engine.host_serve")
            out.append(self._host_scan(spec))
        return out

    def _host_scan(self, spec: ScanSpec) -> ScanResult:
        mem = self.memtable
        runs = self._overlapping_runs(spec)
        mem_live = not mem.is_empty and mem.has_keys(spec.lower, spec.upper)
        if not spec.is_aggregate:
            pk = point_key_of(spec, self.schema)
            if pk is not None:
                return self._point_get_row(spec, mem, pk)
        return self._row_scan(spec, runs, mem_live,
                              self._split_predicates(spec),
                              spec.is_aggregate, mem, device_ok=False)

    @staticmethod
    def _host_candidates(trun, spec: ScanSpec):
        """Every valid key of one run in the range, from its host planes
        (a key's versions adjacent: the merge loop dedups them), the
        device-free twin of ``_device_candidates``. Pad rows past a
        block's valid prefix hold no key and are skipped."""
        crun = trun.crun
        row_lo = crun.lower_row(spec.lower)
        row_hi = crun.upper_row(spec.upper)
        R = crun.R
        for row in range(row_lo, row_hi):
            b, r = divmod(row, R)
            if r < crun.blocks[b].num_valid:
                yield crun.row_keys[b][r]

    # -- route 4: several sources -----------------------------------------
    def _device_candidates(self, trun, spec: ScanSpec, preds,
                           apply_preds: bool):
        """The run's candidate keys in the range, in key order: K9 over
        the range's windows, launched in batches of 1, 4, 16, then 64
        windows, so that a LIMIT scan that stops early launches little."""
        self._device_fault_point()
        crun = trun.crun
        row_lo = crun.lower_row(spec.lower)
        row_hi = crun.upper_row(spec.upper)
        if row_lo >= row_hi:
            return
        R, K = crun.R, WINDOW_BLOCKS
        w_first, w_last = row_lo // (K * R), (row_hi - 1) // (K * R)
        sig = dscan.ScanSig(B=trun.B, R=R, K=K, cols=self._col_sigs(),
                            preds=self._pred_sigs_only(preds), aggs=(),
                            apply_preds=apply_preds, flat=trun.flat)
        int_lits, f32_lits = self._pred_host_literals(preds)
        read = self._read_plane_ints(spec)
        device = trun.device
        w, n = w_first, 1
        while w <= w_last:
            n = min(n, w_last - w + 1)
            ip, fp = row_gather.pack_params(w, w + n - 1, row_lo, row_hi,
                                            read, int_lits, f32_lits)
            res, start, ng = row_gather.scan_candidates(
                sig, trun.plain(), torch.from_numpy(ip).to(device),
                torch.from_numpy(fp).to(device), n)
            res, start, ng = res.cpu().numpy(), start.cpu().numpy(), \
                ng.cpu().numpy()
            for j in range(n):
                base = (w + j) * K * R
                for g in np.nonzero(res[j, :ng[j]])[0].tolist():
                    yield crun.key_at(base + int(start[j, g]))
            w += n
            n = min(4 * n, CANDIDATE_BATCH_MAX)

    def _row_scan(self, spec: ScanSpec, runs, mem_live, pred_split,
                  aggregate: bool, mem, device_ok: bool = True) -> ScanResult:
        """The JAX engine's ``_row_scan``: candidates from every source in
        key order (K9's, or with ``device_ok`` False the host planes'),
        each key merged across sources, predicates and the aggregate (or
        the projection) on the host."""
        exact, superset, _host_only = pred_split
        apply_preds = len(runs) == 1 and not mem_live and device_ok
        preds = exact + superset if apply_preds else []
        key_streams = [self._device_candidates(t, spec, preds, apply_preds)
                       if device_ok else self._host_candidates(t, spec)
                       for t in runs]
        if mem_live or not mem.is_empty:
            key_streams.append(mem.scan_keys(spec.lower, spec.upper))
        candidates = heapq.merge(*key_streams)
        projection = spec.projection or [c.name for c in self.schema.columns]
        agg = Aggregator(spec.aggregates or [], spec.group_by or []) \
            if aggregate else None
        rows = []
        scanned = 0
        resume = None
        last = None
        for key in candidates:
            if key == last:
                continue
            last = key
            scanned += 1
            versions = []
            for t in runs:
                versions.extend(t.crun.find_versions(key))
            versions.extend(mem.versions(key))
            merged = merge_versions(key, versions, spec.read_ht)
            if not merged.exists:
                continue
            key_vals = self.mat.key_values(key)
            if not self.mat.matches(spec, key_vals, merged):
                continue
            if aggregate:
                agg.add(lambda name: self.mat.value(name, key_vals, merged))
                continue
            rows.append(tuple(
                self.mat.value(name, key_vals, merged) for name in projection))
            if spec.limit is not None and len(rows) >= spec.limit:
                resume = key + b"\x00"
                break
        if aggregate:
            return ScanResult(agg.column_names(), agg.results(), None, scanned)
        return ScanResult(projection, rows, resume, scanned)

    # -- route 3: the gather ------------------------------------------------
    def _gather_out_cols(self, names) -> tuple:
        seen = {}
        for name in names:
            cid = self._name_to_id.get(name)
            if cid is None or cid in seen:
                continue  # key column (decoded from the key) or duplicate
            kind = self._kinds[cid]
            planes = 2 if kind in ("i64", "f64", "str") else 1
            # FLOAT round-trips through f32 planes lossily against the
            # stored python value; STRING/BINARY payloads live host-side:
            # both fetch the original value through the setter row.
            seen[cid] = row_gather.OutCol(cid, planes, kind in ("str", "f32"))
        return tuple(seen.values())

    def _decode_col(self, cid, buf, n, crun, col_offs) -> list:
        """Packed buffer columns -> python value list (None for NULL)."""
        kind = self._kinds[cid]
        cmp_off, null_off, idx_off = col_offs[cid]
        null = buf[:n, null_off] != 0
        if kind in ("str", "f32"):
            idxs = buf[:n, idx_off]
            R = crun.R
            out = []
            for i in range(n):
                gi = int(idxs[i])
                if null[i] or gi < 0:
                    out.append(None)
                else:
                    b, r = divmod(gi, R)
                    out.append(crun.row_versions[b][r].columns[cid])
            return out
        if kind == "i32":
            raw = buf[:n, cmp_off].tolist()
        elif kind == "i64":
            raw = P.ordered_planes_to_i64(
                buf[:n, cmp_off], buf[:n, cmp_off + 1]).tolist()
        else:  # f64
            raw = P.ordered_planes_to_f64(
                buf[:n, cmp_off], buf[:n, cmp_off + 1]).tolist()
        if self._dtypes[cid] == DataType.BOOL:
            return [None if null[i] else bool(raw[i]) for i in range(n)]
        if not null.any():
            return raw
        for i in np.nonzero(null)[0].tolist():
            raw[i] = None
        return raw

    def _plan_gather(self, trun, spec: ScanSpec, pred_split,
                     aggregate: bool) -> "_GatherScan":
        """A single-run scan resolved on the device: K7 compacts the
        matched rows' value planes into one int32 buffer a page and the
        host decodes them in bulk. Superset and host-only predicates are
        verified on the decoded values. A LIMIT page is one params row
        whose window walk stops once the buffer holds M matches; an
        unbounded, unpredicated scan is one params row a window, each
        window emitted in place."""
        exact, superset, host_only = pred_split
        crun = trun.crun
        # Structural plan cache: a server runs many pages of one shape
        # (projection, predicates, limit) a batch.
        cache_key = None
        if not aggregate:
            try:
                cache_key = (id(trun), spec.limit,
                             tuple(spec.projection or ()),
                             tuple((p.column, p.op, p.value)
                                   for p in spec.predicates))
                cached = self._plan_cache.get(cache_key)
            except TypeError:
                cache_key = cached = None  # unhashable literal: no cache
            if cached is not None:
                return self._finish_plan_gather(trun, spec, dict(cached))
        projection = spec.projection or [c.name for c in self.schema.columns]
        verify_preds = superset + host_only
        if aggregate:
            agg = Aggregator(spec.aggregates or [], spec.group_by or [])
            out_names = ([a.column for a in (spec.aggregates or [])
                          if a.column is not None]
                         + [c for a in (spec.aggregates or [])
                            if a.expr is not None
                            for c in sorted(columns_of(a.expr))]
                         + list(spec.group_by or []))
        else:
            agg = None
            out_names = list(projection)
        out_names += [p.column for p in verify_preds]
        device_preds = exact + superset
        int_lits, f32_lits = self._pred_host_literals(device_preds)
        limit = None if aggregate else spec.limit
        K, R = WINDOW_BLOCKS, crun.R
        ctx = {
            "crun": crun, "trun": trun, "agg": agg,
            "aggregate": aggregate, "projection": projection,
            "verify_preds": verify_preds,
            "decode_ids": {self._name_to_id[n] for n in out_names
                           if n in self._name_to_id},
            "limit": limit, "out_cols": self._gather_out_cols(out_names),
            "pred_sigs": self._pred_sigs_only(device_preds),
            "int_lits": int_lits, "f32_lits": f32_lits,
            "key_col_pos": {c.name: i
                            for i, c in enumerate(self.schema.key_columns)},
        }
        if limit is None and not device_preds and not verify_preds:
            # Unbounded, unpredicated: every row is a result row.
            ctx["mode"] = "chunks"
            ctx["M"] = M = K * R
            ctx["sig"] = self._gather_sig(ctx, M, packed=False)
        else:
            ctx["mode"] = "paged"
            # The smallest buffer that completes a LIMIT page in one
            # round; 4096 rows a round otherwise.
            M = 4096
            if limit is not None and not verify_preds:
                M = next((m for m in (104, 256, 1024, 4096) if m >= limit),
                         -(-limit // 8) * 8)
            ctx["M"] = M
            ctx["sig"] = self._gather_sig(ctx, M)
        if cache_key is not None:
            if len(self._plan_cache) >= 1024:  # distinct literals bound it
                self._plan_cache.pop(next(iter(self._plan_cache)))
            ctx["struct_key"] = cache_key
            self._plan_cache[cache_key] = dict(ctx)
        return self._finish_plan_gather(trun, spec, ctx)

    def _finish_plan_gather(self, trun, spec: ScanSpec, ctx) -> "_GatherScan":
        """Per-spec completion of a (possibly cached) gather plan: row
        bounds, read point, params rows."""
        crun = trun.crun
        read_planes = self._read_plane_ints(spec)
        ctx["read_planes"] = read_planes
        row_lo = crun.lower_row(spec.lower)
        row_hi = crun.upper_row(spec.upper)
        if row_lo >= row_hi:
            return _GatherScan(self, ctx, "paged", [], 0, 0)
        KR = ctx["sig"].K * crun.R
        w_first, w_last = row_lo // KR, (row_hi - 1) // KR
        if ctx["mode"] == "chunks":
            param_rows = [
                row_gather.pack_params(w, w, row_lo, row_hi, read_planes,
                                       ctx["int_lits"], ctx["f32_lits"])
                for w in range(w_first, w_last + 1)]
            return _GatherScan(self, ctx, "chunks", param_rows, w_last,
                               row_hi)
        return _GatherScan(self, ctx, "paged", [row_gather.pack_params(
            w_first, w_last, row_lo, row_hi, read_planes, ctx["int_lits"],
            ctx["f32_lits"])], w_last, row_hi)

    def _gather_sig(self, ctx, M, packed=True) -> row_gather.GatherSig:
        return row_gather.GatherSig(
            B=ctx["trun"].B, R=ctx["crun"].R, K=WINDOW_BLOCKS, M=M,
            cols=self._col_sigs(), preds=ctx["pred_sigs"], apply_preds=True,
            out_cols=ctx["out_cols"], flat=ctx["trun"].flat, packed=packed)

    def _issue_round(self, states, pending) -> list:
        """One K7 launch per (signature, run) of every pending params row
        of the round, all pages on its grid: [(members, device output)]."""
        self._device_fault_point()
        by_sig: dict = {}
        for pi, rows in pending.items():
            st = states[pi]
            for ri, (ip, fp) in enumerate(rows):
                by_sig.setdefault((st.sig, id(st.trun)),
                                  (st.trun, []))[1].append((pi, ri, ip, fp))
        dispatches = []
        for (sig, _tid), (trun, members) in by_sig.items():
            device = trun.device
            ip = torch.from_numpy(np.stack([m[2] for m in members]))
            fp = torch.from_numpy(np.stack([m[3] for m in members]))
            out = row_gather.gather_rows(sig, trun.plain(), ip.to(device),
                                         fp.to(device))
            dispatches.append((members, out))
        return dispatches

    def _feed_round(self, states, pending, members_list, bufs_list) -> dict:
        """Feed fetched buffers back to their gathers; returns the next
        round's pending params rows ({} when every gather completed).
        Finished LIMIT pages that need no host verification are decoded
        together, one pass a plan structure (``_batch_emit``)."""
        groups: dict = {}
        handled: set[int] = set()
        for members, bufs in zip(members_list, bufs_list):
            tails = None
            for j, (pi, ri, _ip, _fp) in enumerate(members):
                st = states[pi]
                ctx = st.ctx
                if (ri != 0 or len(pending[pi]) != 1 or st.rows or
                        st.mode != "paged" or ctx["aggregate"] or
                        ctx["verify_preds"] or ctx["limit"] is None or
                        ctx.get("struct_key") is None):
                    continue
                if tails is None:  # one vectorized read per launch
                    tails = bufs[:, ctx["M"], :2].tolist()
                groups.setdefault(ctx["struct_key"], []).append(
                    (pi, st, bufs[j], tails[j]))
        for group in groups.values():
            self._batch_emit(group)
            handled.update(pi for pi, _st, _b, _t in group)
        plan_bufs: dict[int, dict[int, np.ndarray]] = {}
        for members, bufs in zip(members_list, bufs_list):
            for j, (pi, ri, _ip, _fp) in enumerate(members):
                if pi not in handled:
                    plan_bufs.setdefault(pi, {})[ri] = bufs[j]
        next_pending = {}
        for pi, rows in pending.items():
            st = states[pi]
            if pi in handled:
                st.pending = []
                continue
            more = st.consume([plan_bufs[pi][ri] for ri in range(len(rows))])
            if more:
                next_pending[pi] = more
        return next_pending

    def _decode_rows(self, ctx, buf, n) -> list:
        """The projection's rows of the first ``n`` rows of a packed
        buffer: key columns from the run's decoded key arrays (only the
        blocks the rows touch), each value column decoded at once."""
        crun, key_col_pos = ctx["crun"], ctx["key_col_pos"]
        _w, col_offs = row_gather.out_layout(ctx["sig"])
        starts = buf[:n, 0]
        projection = ctx["projection"]
        kv_cols = (crun.key_col_arrays(np.unique(starts // crun.R).tolist())
                   if any(nm in key_col_pos for nm in projection) else None)
        return list(zip(*[
            kv_cols[key_col_pos[nm]][starts].tolist() if nm in key_col_pos
            else self._decode_col(self._name_to_id[nm], buf, n, crun,
                                  col_offs)
            for nm in projection]))

    def _batch_emit(self, group) -> None:
        """Decode many finished LIMIT pages that share one plan structure:
        one concatenate and one decode a column for the whole group, then
        per-page slices."""
        ctx = group[0][1].ctx
        M, limit, crun = ctx["M"], ctx["limit"], ctx["crun"]
        parts, metas = [], []
        for _pi, st, buf, (count, scanned) in group:
            n_take = min(count, M, limit)
            st.scanned += scanned
            if n_take:
                parts.append(buf[:n_take])
            metas.append((st, n_take))
        rows_all, starts = [], None
        if parts:
            flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
            starts = flat[:, 0]
            rows_all = self._decode_rows(ctx, flat, flat.shape[0])
        off = 0
        for st, n_take in metas:
            st.rows = rows_all[off:off + n_take]
            if n_take >= limit:
                st.resume = crun.key_at(
                    int(starts[off + n_take - 1])) + b"\x00"
            off += n_take

    def _emit_fetched(self, ctx, buf, rows):
        """Decode one fetched buffer into ctx's sinks. Returns (count,
        emitted n, hit_limit, last_start): ``last_start`` is the global row
        of the last consumed row (for resume and continuation bounds)."""
        crun = ctx["crun"]
        M = ctx["M"]
        limit = ctx["limit"]
        verify_preds = ctx["verify_preds"]
        aggregate = ctx["aggregate"]
        agg = ctx["agg"]
        projection = ctx["projection"]
        key_col_pos = ctx["key_col_pos"]
        count = int(buf[M, 0])
        if not ctx["sig"].packed:
            # A window in place: compact the matched rows with numpy.
            body = buf[:M]
            buf = body[body[:, 0] >= 0]
            n = buf.shape[0]
        else:
            n = min(count, M)
            buf = buf[:n]
        if n == 0:
            return 0, 0, False, None
        starts = buf[:n, 0]
        if not verify_preds and not aggregate:
            # Columnar path: decode only the rows the page emits.
            n_take = n if limit is None else min(n, limit - len(rows))
            rows.extend(self._decode_rows(ctx, buf, n_take))
            hit_limit = limit is not None and len(rows) >= limit
            return count, n, hit_limit, int(starts[n_take - 1])

        _w, col_offs = row_gather.out_layout(ctx["sig"])
        colvals = {cid: self._decode_col(cid, buf, n, crun, col_offs)
                   for cid in ctx["decode_ids"]}

        def getter(name, i):
            if name in key_col_pos:
                return crun.key_vals_at(int(starts[i]))[key_col_pos[name]]
            return colvals[self._name_to_id[name]][i]

        hit_limit = False
        taken_i = -1
        for i in range(n):
            if verify_preds and not all(
                    p.matches(getter(p.column, i)) for p in verify_preds):
                taken_i = i
                continue
            if aggregate:
                agg.add(lambda nm, _i=i: getter(nm, _i))
                taken_i = i
                continue
            rows.append(tuple(getter(nm, i) for nm in projection))
            taken_i = i
            if limit is not None and len(rows) >= limit:
                hit_limit = True
                break
        last = int(starts[taken_i]) if taken_i >= 0 else None
        return count, n, hit_limit, last

    def _gather_result(self, ctx, rows, scanned, resume) -> ScanResult:
        if ctx["aggregate"]:
            return ScanResult(ctx["agg"].column_names(),
                              ctx["agg"].results(), None, scanned)
        return ScanResult(ctx["projection"], rows, resume, scanned)


class _GatherScan:
    """One gather in flight across a batch's rounds. ``pending`` holds the
    params rows of this round; ``consume`` decodes the fetched buffers and
    returns the next round's rows ([] once complete). Continuations
    advance by global row only: no host key lookups."""

    def __init__(self, eng, ctx, mode: str, pending, w_last: int,
                 row_hi: int):
        self.eng = eng
        self.ctx = ctx
        self.mode = mode          # "paged" | "chunks"
        self.pending = pending
        self.sig = ctx["sig"]
        self.trun = ctx["trun"]
        self.w_last = w_last
        self.row_hi = row_hi
        self.rows: list[tuple] = []
        self.scanned = 0
        self.resume: bytes | None = None

    def consume(self, bufs) -> list:
        eng, ctx = self.eng, self.ctx
        M = ctx["M"]
        if self.mode == "chunks":
            for buf in bufs:
                self.scanned += int(buf[M, 1])
                eng._emit_fetched(ctx, buf, self.rows)
            return []
        buf = bufs[0]
        prev_ip = self.pending[0][0]
        w_cap = int(prev_ip[1])
        count = int(buf[M, 0])
        self.scanned += int(buf[M, 1])
        w_end = int(buf[M, 2])
        n = min(count, M)
        last_start = int(buf[n - 1, 0]) if n else None
        _c, _n, hit_limit, last = eng._emit_fetched(ctx, buf, self.rows)
        if hit_limit:
            self.resume = ctx["crun"].key_at(last) + b"\x00"
            self.pending = []
            return []
        # Complete iff no match was dropped (count > M: overflow) and the
        # walk reached the range's last window.
        if count <= M and w_end > w_cap and w_cap >= self.w_last:
            self.pending = []
            return []
        KR = self.sig.K * self.sig.R
        row_lo2 = last_start + 1 if count > M else max(int(prev_ip[2]),
                                                       w_end * KR)
        if row_lo2 >= self.row_hi:
            self.pending = []
            return []
        # Windows before w_end were counted already: a mid-window resume
        # must not count them again.
        scan_from = max(row_lo2, w_end * KR)
        self.pending = [row_gather.pack_params(
            row_lo2 // KR, self.w_last, row_lo2, self.row_hi,
            ctx["read_planes"], ctx["int_lits"], ctx["f32_lits"],
            scan_from=scan_from)]
        return self.pending

    def result(self) -> ScanResult:
        return self.eng._gather_result(self.ctx, self.rows, self.scanned,
                                       self.resume)
