"""YBSession: buffered ops, per-tablet batching, scans with merge.

Reference analog: src/yb/client/session.cc (YBSession::Apply/FlushAsync)
+ batcher.cc (group ops per tablet, one RPC per tablet per flush) + the
frontend-side result merging the reference does for multi-tablet reads
(CQL executor page merging; aggregate combine as in
PgsqlReadOperation partials, src/yb/docdb/pgsql_operation.cc:473).

Aggregate fan-out: avg is decomposed into sum+count partials per tablet
and recombined here — the cross-shard combine (CP analog) of SURVEY §2.4.

The port's copy of the JAX package's ``client/session.py``. Two
departures: every table's writes take the row path (one ``ts.write`` of
wire rows per tablet), because the native write plane that encodes the
JAX session's block writes (``yb_wp``) is ROADMAP.md §1 item 16; and the
mesh scans (``ts.multi_agg_scan`` / ``ts.multi_row_scan``) are tried for
tables on the ``gpu`` engine (the JAX session's ``tpu``): a tablet server
leading two or more of the table's tablets serves them as one mesh
program, and any other reply sends the group down the per-tablet path.
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.client.client import YBClient, YBTable
from yugabyte_db_tpu_torch.storage import wire
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import (AggSpec, Predicate, ScanResult,
                                               ScanSpec)
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.status import TabletSplit

class YBSession:
    # One process-wide batcher pool shared by every session: bounded at 16
    # threads total (instead of 16 per session) and alive for the process
    # lifetime — flush() never nests another flush, so sharing can't
    # deadlock.
    _shared_pool = None
    _shared_pool_lock = __import__("threading").Lock()

    def __init__(self, client: YBClient):
        self.client = client
        # Unified write buffer, in op order. Entries are either
        #   ("b", table, kind, key_src, cols_src, expire_ht, ttl_us)
        # (materialized at flush) or
        #   ("r", table, hash_code, row)
        # (a materialized RowVersion: counters, processor-built rows).
        # Every op takes the row path, in op order, which preserves
        # same-key ordering within the flush.
        self._ops: list[tuple] = []

    # -- write ops -----------------------------------------------------------
    def insert(self, table: YBTable, values: dict,
               ttl_expire_ht: int = MAX_HT,
               ttl_us: int | None = None) -> None:
        names = getattr(table, "_key_names", None)
        if names is None:
            names = table._key_names = tuple(
                c.name for c in table.schema.key_columns)
        for n in names:
            if n not in values:
                raise KeyError(n)
        # Copy: the op encodes at flush time, and callers may legally
        # reuse/mutate their dict between ops (the old eager-encoding
        # API allowed it).
        self._ops.append(("b", table, 0, dict(values), None,
                          ttl_expire_ht, ttl_us))

    def update(self, table: YBTable, key_values: dict, set_values: dict,
               ttl_expire_ht: int = MAX_HT) -> None:
        value_ids = getattr(table, "_value_ids", None)
        if value_ids is None:
            value_ids = table._value_ids = {
                c.name for c in table.schema.value_columns}
        for name in set_values:
            if name not in table.col_id:
                raise KeyError(name)
        self._check_key_values(table, key_values)
        if all(n in value_ids for n in set_values):
            self._ops.append(("b", table, 1, dict(key_values),
                              dict(set_values), ttl_expire_ht, None))
            return
        # SET of a key column: historical behavior stores it under the
        # key column's id (a no-op for reads).
        cols = {table.col_id[n]: v for n, v in set_values.items()}
        row = RowVersion(table.encode_key(key_values), ht=0, liveness=False,
                         columns=cols, expire_ht=ttl_expire_ht)
        self._ops.append(("r", table, table.hash_code(key_values), row))

    def delete(self, table: YBTable, key_values: dict) -> None:
        self._check_key_values(table, key_values)
        self._ops.append(("b", table, 2, dict(key_values), None,
                          MAX_HT, None))

    @staticmethod
    def _check_key_values(table: YBTable, key_values: dict) -> None:
        """Eager missing-key validation — errors must surface at the op
        call (the old eager-encoding behavior), never mid-flush where
        the buffer is already popped."""
        names = getattr(table, "_key_names", None)
        if names is None:
            names = table._key_names = tuple(
                c.name for c in table.schema.key_columns)
        for n in names:
            if n not in key_values:
                raise KeyError(n)

    def apply_row(self, table: YBTable, hash_code: int, row: RowVersion) -> None:
        self._ops.append(("r", table, hash_code, row))

    @property
    def pending_ops(self) -> int:
        return len(self._ops)

    def _op_to_row(self, op) -> tuple[YBTable, int, RowVersion]:
        """Materialize one buffered op as (table, hash_code, RowVersion)
        for the row path."""
        if op[0] == "r":
            return op[1], op[2], op[3]
        _tag, table, kind, key_src, cols_src, expire_ht, ttl_us = op
        key_values = {c.name: key_src[c.name]
                      for c in table.schema.key_columns}
        if kind == 0:
            cols = {table.col_id[c.name]: key_src[c.name]
                    for c in table.schema.value_columns
                    if c.name in key_src}
            row = RowVersion(table.encode_key(key_values), ht=0,
                             liveness=True, columns=cols,
                             expire_ht=expire_ht, ttl_us=ttl_us)
        elif kind == 1:
            cols = {table.col_id[n]: v for n, v in cols_src.items()}
            row = RowVersion(table.encode_key(key_values), ht=0,
                             liveness=False, columns=cols,
                             expire_ht=expire_ht)
        else:
            row = RowVersion(table.encode_key(key_values), ht=0,
                             tombstone=True)
        return table, table.hash_code(key_values), row

    def flush(self, timeout_s: float = 15.0) -> int:
        """Group buffered ops per tablet and issue the per-tablet write
        RPCs IN PARALLEL (the Batcher: each write waits a full Raft
        commit round, so serializing them would multiply flush latency by
        the tablet count — the reference's Batcher/AsyncRpc issues them
        concurrently, src/yb/client/batcher.h:80). Returns the number of
        rows written. Raises on any tablet failure (ops for OTHER tablets
        may have applied — same per-tablet atomicity as the reference
        without transactions)."""
        ops, self._ops = self._ops, []
        # Partition ops per table.
        per_table: dict[str, list] = {}
        tables: dict[str, YBTable] = {}
        for op in ops:
            t = op[1]
            per_table.setdefault(t.name, []).append(op)
            tables[t.name] = t

        # (table, loc, rows) row groups
        row_groups: dict[str, tuple[YBTable, object, list]] = {}

        def row_path(table, table_ops):
            for op in table_ops:
                _t, hash_code, row = self._op_to_row(op)
                loc = self.client.meta_cache.lookup_by_hash(table.name,
                                                            hash_code)
                g = row_groups.get(loc.tablet_id)
                if g is None:
                    g = row_groups[loc.tablet_id] = (table, loc, [])
                g[2].append((hash_code, row))

        errors = []
        for name, table_ops in per_table.items():
            table = tables[name]
            # One table's bad op must not drop OTHER tables' buffered
            # writes (the buffer is already popped): isolate per table,
            # surface the first error after everything else sent.
            try:
                row_path(table, table_ops)
            except Exception as e:  # noqa: BLE001 — surfaced after sends
                errors.append(e)

        def send_rows(table, loc, hrows):
            """Write one tablet group of (hash_code, row) pairs. A
            tablet_split reply means the target was sealed by a split
            mid-flush: re-route every row by its hash through a fresh
            location lookup and keep going until the writes land (the
            split-commit window bounds how long the re-plan loop spins;
            the flush deadline bounds it absolutely)."""
            import time as _time

            deadline = _time.monotonic() + timeout_s
            pending = [(loc, hrows)]
            written = 0
            while pending:
                l, hr = pending.pop()
                try:
                    self.client.tablet_rpc(
                        table.name, l, "ts.write",
                        {"rows": wire.encode_rows([r for _h, r in hr]),
                         # Exactly-once across retries: tablet_rpc resends
                         # the SAME payload, so the id survives every
                         # retry attempt.
                         "client_id": self.client.client_id,
                         "request_id": self.client.next_request_id()},
                        timeout_s=timeout_s)
                    written += len(hr)
                except TabletSplit:
                    if _time.monotonic() >= deadline:
                        raise
                    _time.sleep(0.05)
                    regrouped: dict = {}
                    for h, r in hr:
                        nl = self.client.meta_cache.lookup_by_hash(
                            table.name, h)
                        regrouped.setdefault(
                            nl.tablet_id, (nl, []))[1].append((h, r))
                    pending.extend(regrouped.values())
            return written

        written = 0
        # Row groups replicate in parallel on the batcher pool.
        futs = [self._pool().submit(send_rows, *g)
                for g in row_groups.values()]
        for f in futs:
            try:
                written += f.result()
            except Exception as e:
                errors.append(e)
        if errors:
            raise errors[0]
        return written

    @classmethod
    def _pool(cls):
        with cls._shared_pool_lock:
            if cls._shared_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                cls._shared_pool = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="session-batcher")
            return cls._shared_pool

    # -- point read ----------------------------------------------------------
    def get(self, table: YBTable, key_values: dict) -> tuple | None:
        """Point read by full primary key."""
        from yugabyte_db_tpu_torch.models.encoding import prefix_successor
        key = table.encode_key(key_values)
        spec = ScanSpec(lower=key, upper=prefix_successor(key), limit=1)
        res = self.scan(table, spec)
        return res.rows[0] if res.rows else None

    def get_many(self, table: YBTable, kv_list: list[dict],
                 timeout_s: float = 30.0) -> list[tuple | None]:
        """Batched point reads: keys group by tablet and each tablet
        serves its whole group in ONE scan-batch RPC (reference: the
        batcher packing many ops per tserver call,
        src/yb/client/batcher.h:80). Results align with kv_list.
        Re-plans from refreshed locations when a tablet splits
        mid-batch (reads are idempotent: a full replay is safe)."""
        return self._split_replan(
            table, timeout_s,
            lambda: self._get_many_once(table, kv_list, timeout_s))

    def _get_many_once(self, table: YBTable, kv_list: list[dict],
                       timeout_s: float) -> list[tuple | None]:
        from yugabyte_db_tpu_torch.models.encoding import prefix_successor

        groups: dict = {}
        for i, kv in enumerate(kv_list):
            key = table.encode_key(kv)
            hc = table.hash_code(kv)
            loc = self.client.meta_cache.lookup_by_hash(table.name, hc)
            spec = ScanSpec(lower=key, upper=prefix_successor(key),
                            limit=1)
            g = groups.get(loc.tablet_id)
            if g is None:
                g = groups[loc.tablet_id] = (loc, [])
            g[1].append((i, spec))
        out: list = [None] * len(kv_list)
        for loc, items in groups.values():
            resp = self.client.tablet_rpc(
                table.name, loc, "ts.scan_batch",
                {"specs": [wire.encode_spec(s) for _i, s in items]},
                timeout_s=timeout_s)
            for (i, _s), enc in zip(items, resp["results"]):
                res = wire.decode_result(enc)
                out[i] = res.rows[0] if res.rows else None
        return out

    # -- scans ---------------------------------------------------------------
    def _stale_prefer(self, loc) -> str | None:
        """Same-zone replica for a stale read (read-replica routing):
        prefer a replica matching the client's locality labels."""
        ci = self.client.cloud_info
        if not ci:
            return None
        for r in loc.replicas:
            if loc.replica_clouds.get(r) == ci:
                return r
        return None

    def _split_replan(self, table: YBTable, timeout_s: float, fn):
        """Run an idempotent read ``fn``, restarting it from refreshed
        locations whenever a tablet splits underneath it. During the
        seal->commit window the refreshed list still names the sealed
        parent, so the loop keeps re-trying (bounded by timeout_s)
        until the children start serving."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while True:
            try:
                return fn()
            except TabletSplit as e:
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.05)
                try:
                    self.client.meta_cache.locations(table.name,
                                                     refresh=True)
                except Exception as err:  # noqa: BLE001 — retry decides
                    count_swallowed("session.split_replan", err)
                del e

    def scan(self, table: YBTable, spec: ScanSpec,
             timeout_s: float = 30.0, stale_ok: bool = False) -> ScanResult:
        """Split-aware scan entry point: the fan-out restarts from
        refreshed locations when a tablet splits mid-scan (scans are
        idempotent; a full replay cannot duplicate side effects)."""
        return self._split_replan(
            table, timeout_s,
            lambda: self._scan_once(table, spec, timeout_s, stale_ok))

    def _scan_once(self, table: YBTable, spec: ScanSpec,
                   timeout_s: float = 30.0,
                   stale_ok: bool = False) -> ScanResult:
        """Fan a scan out over the table's tablets and merge.

        Row scans: tablets are visited in partition order, honoring
        spec.limit across tablets with per-tablet paging. Aggregates:
        per-tablet partials combined client-side (avg via sum+count).

        ``stale_ok``: serve from ANY replica at its applied state
        (bounded-staleness read-replica reads) — same-zone replicas are
        preferred when the client carries locality labels (reference:
        follower reads / read replicas, master.proto read_replicas)."""
        if spec.is_aggregate:
            return self._scan_aggregate(table, spec, timeout_s, stale_ok)
        locs = self.client.meta_cache.locations(table.name)
        # Snapshot consistency across pages/tablets: the first sub-scan's
        # server-chosen read time is pinned for every subsequent request
        # (the reference's ConsistentReadPoint contract — the server returns
        # the chosen read_ht precisely so the client can pin it). The
        # mutable scan state is shared with the mesh-group helper.
        state = {"rows": [], "columns": [], "scanned": 0,
                 "read_ht": spec.read_ht}
        # Mesh path first: CONSECUTIVE tablets led by the same tserver
        # page as ONE ts.multi_row_scan group — the tserver runs them as
        # one device program (tserver.mesh_scan) and the cross-tablet
        # resume token stays opaque here. Consecutive-only keeps rows in
        # partition (key) order; singleton or ineligible groups take the
        # per-tablet path below.
        groups: list[tuple[str | None, list]] = []
        for loc in locs.tablets:
            leader = (loc.leader if (not stale_ok and not spec.group_by
                                     and table.engine == "gpu") else None)
            if groups and leader is not None and groups[-1][0] == leader:
                groups[-1][1].append(loc)
            else:
                groups.append((leader, [loc]))
        for leader, group in groups:
            if spec.limit is not None and len(state["rows"]) >= spec.limit:
                break
            if leader is not None and len(group) >= 2 and \
                    self._mesh_row_pages(leader, group, spec, state,
                                         timeout_s):
                continue
            for loc in group:
                resume = spec.lower
                while True:
                    remaining = (None if spec.limit is None
                                 else spec.limit - len(state["rows"]))
                    if remaining is not None and remaining <= 0:
                        return ScanResult(state["columns"], state["rows"],
                                          None, state["scanned"])
                    sub = ScanSpec(lower=resume, upper=spec.upper,
                                   read_ht=state["read_ht"],
                                   predicates=spec.predicates,
                                   projection=spec.projection,
                                   limit=remaining,
                                   group_by=spec.group_by)
                    payload = {"spec": wire.encode_spec(sub)}
                    if stale_ok:
                        payload["allow_stale"] = True
                    resp = self.client.tablet_rpc(
                        table.name, loc, "ts.scan", payload,
                        timeout_s=timeout_s,
                        prefer=self._stale_prefer(loc) if stale_ok else None,
                        mark_leader=not stale_ok)
                    if "read_ht" in resp:
                        state["read_ht"] = resp["read_ht"]
                    res = wire.decode_result(resp)
                    state["columns"] = res.columns
                    state["rows"].extend(res.rows)
                    state["scanned"] += res.rows_scanned
                    if res.resume_key is None:
                        break
                    resume = res.resume_key
        return ScanResult(state["columns"], state["rows"], None,
                          state["scanned"])

    def _mesh_row_pages(self, leader: str, group: list, spec: ScanSpec,
                        state: dict, timeout_s: float) -> bool:
        """Page one leader's consecutive-tablet group through
        ts.multi_row_scan (the whole group served per page by ONE mesh
        device program). Returns True when the group was fully served
        (or the global limit filled) on the mesh; False rolls back any
        partial mesh pages for the group and sends the caller down the
        per-tablet path — so a mid-stream failure can never duplicate or
        drop rows."""
        mark_rows, mark_scanned = len(state["rows"]), state["scanned"]
        resume = None
        mesh_timeout = min(5.0, timeout_s)
        while True:
            remaining = (None if spec.limit is None
                         else spec.limit - len(state["rows"]))
            if remaining is not None and remaining <= 0:
                return True
            sub = ScanSpec(lower=spec.lower, upper=spec.upper,
                           read_ht=state["read_ht"],
                           predicates=spec.predicates,
                           projection=spec.projection, limit=remaining)
            payload = {"tablet_ids": [g.tablet_id for g in group],
                       "spec": wire.encode_spec(sub),
                       # Budget rides server-side (below the transport
                       # timeout) so a slow pin returns a clean timed_out
                       # and the per-tablet fallback still has time.
                       "timeout": max(0.05, round(mesh_timeout * 0.8, 3))}
            if resume is not None:
                payload["resume"] = resume
            try:
                resp = self.client.transport.send(
                    leader, "ts.multi_row_scan", payload,
                    timeout=mesh_timeout)
            except Exception as e:  # noqa: BLE001 — per-tablet fallback
                count_swallowed("session.multi_row_scan", e)
                resp = {}
            if resp.get("code") != "ok":
                del state["rows"][mark_rows:]
                state["scanned"] = mark_scanned
                return False
            if "read_ht" in resp:
                state["read_ht"] = resp["read_ht"]
            res = wire.decode_result(resp)
            state["columns"] = res.columns
            state["rows"].extend(res.rows)
            state["scanned"] += res.rows_scanned
            if res.resume_key is None:
                return True
            resume = res.resume_key

    def _scan_aggregate(self, table: YBTable, spec: ScanSpec,
                        timeout_s: float,
                        stale_ok: bool = False) -> ScanResult:
        # Decompose avg into sum+count partials (reference: per-tablet
        # EvalAggregate partials recombined above the scan).
        partial_aggs: list[AggSpec] = []
        mapping: list[tuple[str, int, int | None]] = []
        for a in spec.aggregates:
            if a.fn == "avg":
                mapping.append(("avg", len(partial_aggs),
                                len(partial_aggs) + 1))
                partial_aggs.append(AggSpec("sum", a.column, expr=a.expr))
                partial_aggs.append(AggSpec("count", a.column, expr=a.expr))
            else:
                mapping.append((a.fn, len(partial_aggs), None))
                partial_aggs.append(a)
        locs = self.client.meta_cache.locations(table.name)
        gb = spec.group_by or []
        ngb = len(gb)
        # group key -> per-partial-agg accumulators
        groups: dict[tuple, list[list]] = {}
        scanned = 0
        read_ht = spec.read_ht  # pinned after the first sub-scan (see scan())

        def consume(resp):
            nonlocal read_ht, scanned
            if "read_ht" in resp:
                read_ht = resp["read_ht"]
            res = wire.decode_result(resp)
            scanned += res.rows_scanned
            for row in res.rows:
                gkey = tuple(row[:ngb])
                groups.setdefault(gkey, []).append(list(row[ngb:]))

        # Mesh path first: tablets grouped by leading tserver, ONE
        # ts.multi_agg_scan per group — the tserver runs all its tablets
        # as one device program with an ICI collective combine
        # (tserver.mesh_scan). Any non-ok reply demotes that group to the
        # per-tablet path below; the host combine here remains only the
        # cross-tserver (and fallback) merge.
        remaining_tablets = list(locs.tablets)
        if not gb and table.engine == "gpu" and not stale_ok:
            by_leader: dict[str, list] = {}
            for loc in locs.tablets:
                if loc.leader:
                    by_leader.setdefault(loc.leader, []).append(loc)
            for leader, group in by_leader.items():
                if len(group) < 2:
                    continue
                sub = ScanSpec(lower=spec.lower, upper=spec.upper,
                               read_ht=read_ht, predicates=spec.predicates,
                               aggregates=partial_aggs)
                mesh_timeout = min(5.0, timeout_s)
                try:
                    # Budget rides server-side (below the transport
                    # timeout) so a slow pin returns a clean timed_out
                    # and the per-tablet fallback still has time to run.
                    resp = self.client.transport.send(
                        leader, "ts.multi_agg_scan",
                        {"tablet_ids": [g.tablet_id for g in group],
                         "spec": wire.encode_spec(sub),
                         "timeout": max(0.05,
                                        round(mesh_timeout * 0.8, 3))},
                        timeout=mesh_timeout)
                except Exception as e:  # noqa: BLE001 — per-tablet fallback
                    count_swallowed("session.multi_agg_scan", e)
                    continue
                if resp.get("code") != "ok":
                    continue
                consume(resp)
                served = {g.tablet_id for g in group}
                remaining_tablets = [t for t in remaining_tablets
                                     if t.tablet_id not in served]

        for loc in remaining_tablets:
            sub = ScanSpec(lower=spec.lower, upper=spec.upper,
                           read_ht=read_ht, predicates=spec.predicates,
                           aggregates=partial_aggs, group_by=spec.group_by)
            payload = {"spec": wire.encode_spec(sub)}
            if stale_ok:
                payload["allow_stale"] = True
            resp = self.client.tablet_rpc(
                table.name, loc, "ts.scan", payload, timeout_s=timeout_s,
                prefer=self._stale_prefer(loc) if stale_ok else None,
                mark_leader=not stale_ok)
            consume(resp)
        if not groups and not gb:
            groups[()] = []
        out_rows = []
        for gkey in sorted(groups, key=_group_sort_key):
            partials = groups[gkey]
            combined: list = []
            for i, a in enumerate(partial_aggs):
                vals = [p[i] for p in partials if p[i] is not None]
                if a.fn == "count":
                    combined.append(sum(vals) if vals else 0)
                elif a.fn == "sum":
                    combined.append(sum(vals) if vals else None)
                elif a.fn == "min":
                    combined.append(min(vals) if vals else None)
                elif a.fn == "max":
                    combined.append(max(vals) if vals else None)
            row = list(gkey)
            for fn, i, j in mapping:
                if fn == "avg":
                    s, n = combined[i], combined[j]
                    row.append(s / n if n else None)
                else:
                    row.append(combined[i])
            out_rows.append(tuple(row))
        names = list(gb)
        for a in spec.aggregates:
            names.append(a.output_name)
        return ScanResult(names, out_rows, None, scanned)


def _group_sort_key(gkey: tuple):
    # Matches the engine-side group ordering (cpu_engine._sortable).
    return tuple((v is None, v) for v in gkey)
