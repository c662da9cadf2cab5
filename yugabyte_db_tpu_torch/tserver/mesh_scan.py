"""MeshScanService: multi-tablet scans over the device mesh.

The cluster read path for a tserver leading several tablets of a table:
instead of one ts.scan per tablet with the CLIENT merging on host (the
reference's shape — per-tablet EvalAggregate partials recombined by the
CQL executor / PG FDW, src/yb/docdb/pgsql_operation.cc:473, and the
batcher's thread-per-tablet row fan-out, src/yb/client/batcher.h:80),
the tserver serves them with ONE device program: tablets sharded over
the mesh "t" axis, each tablet's blocks over "b".

- Aggregates: each device's pieces folded by one K5 launch, all pieces'
  partials combined by one launch of the mesh combine
  (parallel.sharded.sharded_aggregate).
- Row scans: the packed MVCC row gather K7 runs on every (tablet,
  block-range) piece, one launch a device, and the host decodes only the
  LIMIT page's rows (parallel.sharded.sharded_row_page). Cross-tablet
  paging rides the (tablet index, last key) resume token, opaque to the
  client.

The client-side merge remains only as the cross-tserver / ineligible-
spec fallback. The port's copy of the JAX package's
``tserver/mesh_scan.py``.

Mesh policy: built once for the engines' device type from the visible
devices (``parallel.mesh.mesh_from_visible``) — "t" gets the larger
factor, "b" gets 2 when the device count is even. A single-card node (or
the CPU) degenerates to a 1x1 mesh and still executes the same program,
so the code path is identical from one card to many.

Stack lifecycle: stacked device residency is cached per run set. A
flush/compaction replaces ONE tablet's ColumnarRun; when the stack is
un-encoded the cache updates that tablet's slot in place with one
``stack_update`` launch a device, after the dispatches in flight on that
stack. Its source is the run's resident device planes (the device
flush's output, K10 decoding their encoded leaves) where they are on
device; the leaves they lack (an encoded upload keeps no arith plane of
an integer column), or every leaf when no planes are resident, are
uploaded from the host run's own planes. Otherwise the superseded
stack's residency is released immediately (close() — in-flight scans
holding the old planes finish unharmed; the bytes leave the budget when
the last reference dies).

Fallbacks, as in the JAX service: an ineligible peer (more than one run,
memtable keys in range, a non-``gpu`` engine; here also peers at more
than one schema version, an ALTER reaching the tablets one at a time), a
spec or runs the mesh program refuses (``parallel.sharded.MeshSpecError``:
runs mid-ALTER lack an added column's planes), or a fired
``fault.mesh_dispatch``. The eligibility checks run before any dispatch,
and a kernel's error raises through the handler: it is never a fallback.
"""

from __future__ import annotations

import threading

from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
from yugabyte_db_tpu_torch.utils.fault_injection import maybe_fault


class MeshScanService:
    """Per-tserver service executing multi-tablet scans on the device
    mesh. Stateless between calls except for a small cache of stacked
    device residency, invalidated incrementally as flush/compaction
    replace ColumnarRun objects."""

    def __init__(self, max_cached_stacks: int = 2):
        self._lock = threading.Lock()
        self._meshes: dict = {}
        self._stacks: dict[tuple, object] = {}
        self._max_cached = max_cached_stacks
        self.served = 0       # aggregates answered on the mesh
        self.served_rows = 0  # row pages answered on the mesh
        self.updated = 0      # stacks refreshed in place (update_tablet)
        self.fallbacks = 0    # ineligible requests bounced to per-tablet
        self.chip_losses = 0  # mesh dispatches lost to a dropped chip

    def _get_mesh(self, device):
        """The mesh of the visible devices of ``device``'s type, built
        once a type."""
        mesh = self._meshes.get(device.type)
        if mesh is None:
            from yugabyte_db_tpu_torch.parallel.mesh import mesh_from_visible

            mesh = self._meshes[device.type] = mesh_from_visible(device.type)
        return mesh

    def eligible_peer(self, peer, spec: ScanSpec) -> bool:
        """Engine-state eligibility: ``gpu`` engine, exactly one run, no
        memtable data in the scanned range (single-source — the mesh
        program has no host-merge stage)."""
        engine = peer.tablet.engine
        runs = getattr(engine, "runs", None)
        if runs is None or len(runs) != 1:
            return False
        if not hasattr(runs[0], "crun"):
            return False  # not the gpu engine
        if engine._memtable_in_range(spec) or runs[0].crun.num_versions == 0:
            return False
        return True

    def _get_stack(self, peers: list, runs: list):
        """The cached ShardedTablets for this exact run set and schema
        version, refreshed incrementally when exactly one tablet's run
        changed since a cached stack (the flush/compaction case): the
        changed slot is
        rewritten in place on device, seeded from the run's resident
        flush planes when they exist. Full rebuilds release the
        superseded stack's residency immediately. None = runs the stack
        refuses (``MeshSpecError``; caller falls back)."""
        schema = peers[0].tablet.meta.schema
        # The schema's version is part of the key: ALTER grows a run's
        # planes in place (the same run objects under a new schema).
        key = (schema.version, tuple(id(r) for r in runs))
        mesh = self._get_mesh(peers[0].tablet.engine.device)
        with self._lock:
            st = self._stacks.get(key)
            if st is not None:
                return st
            for okey in list(self._stacks):
                if okey[0] != key[0] or len(okey[1]) != len(key[1]):
                    continue
                diff = [i for i, (a, b) in enumerate(zip(okey[1], key[1]))
                        if a != b]
                if len(diff) != 1:
                    continue
                t = diff[0]
                ost = self._stacks[okey]
                trun = peers[t].tablet.engine.runs[0]
                dev = getattr(trun, "peek_device", lambda: None)()
                if ost.update_tablet(t, runs[t],
                                     device_arrays=(dev.arrays
                                                    if dev is not None
                                                    else None)):
                    del self._stacks[okey]
                    self._stacks[key] = ost
                    self.updated += 1
                    return ost
                break
            from yugabyte_db_tpu_torch.parallel import (MeshSpecError,
                                                        ShardedTablets)

            try:
                st = ShardedTablets(schema, runs, mesh)
            except MeshSpecError:
                return None  # runs the stack does not take
            while len(self._stacks) >= self._max_cached:
                old = self._stacks.pop(next(iter(self._stacks)))
                old.close()  # release residency; in-flight scans finish
            self._stacks[key] = st
            return st

    def drop_stacks(self) -> int:
        """Release every cached stack's residency (chip loss / device
        hot-unplug: placements on the lost chip are unusable, so the
        whole per-device footprint unwinds — in-flight scans holding
        the old planes finish unharmed). Subsequent eligible scans
        rebuild on the surviving mesh. Returns the number dropped."""
        with self._lock:
            stacks = list(self._stacks.values())
            self._stacks.clear()
        for st in stacks:
            st.close()
        return len(stacks)

    def _lost_chip(self) -> bool:
        """The ``fault.mesh_dispatch`` point, evaluated right before a
        device dispatch: a fired fault models a mesh chip dropping out
        mid-scan. The service releases all stacked residency and bounces
        the request to the per-tablet path (byte-identical serve); it
        does NOT retry on the device — the caller's fallback is the
        availability story, exactly like the engine breaker's."""
        if not maybe_fault("fault.mesh_dispatch"):
            return False
        with self._lock:
            self.chip_losses += 1
            self.fallbacks += 1
        self.drop_stacks()
        return True

    def _fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def _eligible_runs(self, peers: list, spec: ScanSpec):
        # One schema version over the peers: an ALTER reaches each tablet
        # on its own (the stack takes one schema).
        if len({p.tablet.meta.schema.version for p in peers}) != 1:
            return None
        if not all(self.eligible_peer(p, spec) for p in peers):
            return None
        return [p.tablet.engine.runs[0].crun for p in peers]

    def aggregate(self, peers: list, spec: ScanSpec) -> ScanResult | None:
        """Run spec's aggregates over all peers' tablets on the mesh.
        Returns None when ineligible (caller falls back to per-tablet
        scans + host combine)."""
        from yugabyte_db_tpu_torch.parallel import (MeshSpecError,
                                                    sharded_aggregate)

        if not spec.is_aggregate or spec.group_by:
            self._fallback()
            return None
        runs = self._eligible_runs(peers, spec)
        st = self._get_stack(peers, runs) if runs else None
        if st is None:
            self._fallback()
            return None
        if self._lost_chip():
            return None
        try:
            res = sharded_aggregate(st, spec)
        except MeshSpecError:
            self._fallback()
            return None  # spec not device-exact: fallback
        with self._lock:
            self.served += 1
        return res

    def rows(self, peers: list, spec: ScanSpec,
             resume: bytes | None = None) -> ScanResult | None:
        """Serve one LIMIT row page over all peers' tablets on the mesh
        (parallel.sharded.sharded_row_page). ``resume`` is the previous
        page's resume token (opaque (tablet index, last key)); tablet
        indices resolve against THIS peer list, so callers must pass the
        same tablet order every page. Returns None when ineligible."""
        from yugabyte_db_tpu_torch.parallel import (MeshSpecError,
                                                    sharded_row_page)

        if spec.is_aggregate or spec.group_by:
            self._fallback()
            return None
        runs = self._eligible_runs(peers, spec)
        st = self._get_stack(peers, runs) if runs else None
        if st is None:
            self._fallback()
            return None
        if self._lost_chip():
            return None
        try:
            res = sharded_row_page(st, spec, resume=resume)
        except MeshSpecError:
            self._fallback()
            return None  # spec not device-exact: fallback
        with self._lock:
            self.served_rows += 1
        return res
