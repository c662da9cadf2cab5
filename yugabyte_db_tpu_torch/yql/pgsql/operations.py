"""PgsqlReadOp: the pggate-shaped read operation.

Reference analog: PgsqlReadOperation::Execute
(src/yb/docdb/pgsql_operation.cc:345) with EvalAggregate/
PopulateAggregate (:473,487) — a read request carrying WHERE pushdown,
GROUP BY columns, and expression aggregates, executed against one
tablet's storage seam and combined above the scan. The gpu engine
runs the whole grouped/expression evaluation as one kernel launch
(ops.group_agg) when it can; this object is the API carrier.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.storage.scan_spec import AggSpec, ScanResult, ScanSpec


@dataclass
class PgsqlReadOp:
    """One pgsql-style read: build once, execute per tablet, combine."""

    spec: ScanSpec

    @staticmethod
    def aggregate(predicates=None, aggregates=None, group_by=None,
                  read_ht=None, lower=b"", upper=b"") -> "PgsqlReadOp":
        from yugabyte_db_tpu_torch.storage.row_version import MAX_HT

        return PgsqlReadOp(ScanSpec(
            lower=lower, upper=upper,
            read_ht=read_ht if read_ht is not None else MAX_HT,
            predicates=list(predicates or []),
            aggregates=list(aggregates or []),
            group_by=list(group_by) if group_by else None))

    def execute(self, engine) -> ScanResult:
        """Run against one tablet's storage engine (the YQLStorageIf
        seam)."""
        return engine.scan(self.spec)

    def execute_partitioned(self, engines) -> ScanResult:
        """Run against many tablets and combine partial aggregates
        host-side (the above-the-scan combine of the reference's FDW /
        CQL executor)."""
        results = [e.scan(self.spec) for e in engines]
        return combine_grouped(self.spec, results)


def combine_grouped(spec: ScanSpec, results: list[ScanResult]) -> ScanResult:
    """Merge per-tablet grouped aggregate partials (sum/count add,
    min/max extremize)."""
    gb = spec.group_by or []
    ngb = len(gb)
    aggs = spec.aggregates or []
    groups: dict[tuple, list] = {}
    scanned = 0
    for res in results:
        scanned += res.rows_scanned
        for row in res.rows:
            gkey = tuple(row[:ngb])
            acc = groups.get(gkey)
            if acc is None:
                groups[gkey] = list(row[ngb:])
                continue
            for i, a in enumerate(aggs):
                v = row[ngb + i]
                if v is None:
                    continue
                if acc[i] is None:
                    acc[i] = v
                elif a.fn in ("sum", "count"):
                    acc[i] += v
                elif a.fn == "min":
                    acc[i] = min(acc[i], v)
                elif a.fn == "max":
                    acc[i] = max(acc[i], v)
    if not groups and not gb:
        groups[()] = [0 if a.fn == "count" else None for a in aggs]
    rows = [tuple(g) + tuple(groups[g])
            for g in sorted(groups, key=lambda g: tuple(
                (v is None, v) for v in g))]
    names = list(gb) + [a.output_name for a in aggs]
    return ScanResult(names, rows, None, scanned)
