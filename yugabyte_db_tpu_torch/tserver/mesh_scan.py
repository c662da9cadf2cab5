"""MeshScanService: multi-tablet scans over the device mesh.

The cluster read path for a tserver leading several tablets of a table:
instead of one ts.scan per tablet with the CLIENT merging on host (the
reference's shape — per-tablet EvalAggregate partials recombined by the
CQL executor / PG FDW, src/yb/docdb/pgsql_operation.cc:473, and the
batcher's thread-per-tablet row fan-out, src/yb/client/batcher.h:80),
the tserver serves them with ONE device program: tablets sharded over
the mesh "t" axis, each tablet's blocks over "b".

The port's copy of the JAX package's ``tserver/mesh_scan.py``: the
service and its counters. Its mesh dispatch (the JAX package's
``parallel/sharded.py`` programs, K14) is ROADMAP.md §1 item 14; until
then ``aggregate`` and ``rows`` answer None for every request, which the
tablet server's ``ts.multi_agg_scan`` / ``ts.multi_row_scan`` handlers
reply as ``{"code": "ineligible"}`` (the JAX service's reply to any
ineligible request), and each such reply is counted in ``fallbacks``.
The client then takes its per-tablet scans and host combine, as it does
for an ineligible spec.
"""

from __future__ import annotations

import threading

from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec


class MeshScanService:
    """Per-tserver service for multi-tablet scans on the device mesh. With
    no mesh program ported, every request is ineligible."""

    def __init__(self):
        self._lock = threading.Lock()
        self.served = 0       # aggregates answered on the mesh
        self.served_rows = 0  # row pages answered on the mesh
        self.updated = 0      # stacks refreshed in place (update_tablet)
        self.fallbacks = 0    # ineligible requests bounced to per-tablet
        self.chip_losses = 0  # mesh dispatches lost to a dropped chip

    def _ineligible(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def aggregate(self, peers: list, spec: ScanSpec) -> ScanResult | None:
        """Run spec's aggregates over all peers' tablets on the mesh: None
        (ineligible; the caller falls back to per-tablet scans + host
        combine) until the mesh program is ported."""
        self._ineligible()
        return None

    def rows(self, peers: list, spec: ScanSpec,
             resume: bytes | None = None) -> ScanResult | None:
        """Serve one LIMIT row page over all peers' tablets on the mesh:
        None (ineligible) until the mesh program is ported."""
        self._ineligible()
        return None
