"""Scan specification and results: what the query layer pushes down.

Reference analog: src/yb/common/ql_scanspec.h (QLScanRange/QLScanSpec — the
key-range bounds), the condition PBs of ql_protocol.proto evaluated by
QLExprExecutor (src/yb/common/ql_expr.h:210), and aggregate pushdown
(PgsqlReadOperation::EvalAggregate, src/yb/docdb/pgsql_operation.cc:473).
Paging mirrors QLPagingStatePB: a scan resumes from an encoded key.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.storage.row_version import MAX_HT

# Predicate operators the engines evaluate. NULL semantics are SQL-ish:
# a comparison with NULL is false (rows with null operands never match).
OPS = ("=", "!=", "<", "<=", ">", ">=", "IN")

AGG_FNS = ("count", "sum", "min", "max", "avg")


@dataclass(frozen=True)
class Predicate:
    column: str
    op: str
    value: object  # literal; for IN, a tuple of literals

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"bad predicate op {self.op!r}")

    def matches(self, v) -> bool:
        if v is None:
            return False
        if self.op == "=":
            return v == self.value
        if self.op == "!=":
            return v != self.value
        if self.op == "<":
            return v < self.value
        if self.op == "<=":
            return v <= self.value
        if self.op == ">":
            return v > self.value
        if self.op == ">=":
            return v >= self.value
        if self.op == "IN":
            return v in self.value
        raise AssertionError(self.op)


@dataclass(frozen=True)
class AggSpec:
    fn: str          # count | sum | min | max | avg
    column: str | None  # None for count(*) / expression aggregates
    # Optional pushed-down scalar expression (storage.expr tree) the
    # aggregate runs over instead of a bare column — the TPC-H
    # sum(l_extendedprice * (1 - l_discount)) shape
    # (reference: PgsqlExpressionPB trees, pgsql_operation.cc:473).
    expr: object = None
    label: str | None = None  # output column label override

    def __post_init__(self):
        if self.fn not in AGG_FNS:
            raise ValueError(f"bad aggregate {self.fn!r}")
        if self.fn != "count" and self.column is None and self.expr is None:
            raise ValueError(f"{self.fn} needs a column or expression")

    @property
    def output_name(self) -> str:
        if self.label:
            return self.label
        return f"{self.fn}({self.column or ('<expr>' if self.expr else '*')})"


@dataclass
class ScanSpec:
    """A bounded MVCC scan request against one tablet's storage."""

    lower: bytes = b""          # inclusive encoded-key lower bound
    upper: bytes = b""          # exclusive encoded-key upper bound; b"" = unbounded
    read_ht: int = MAX_HT       # MVCC read point (HybridTime.value)
    predicates: list[Predicate] = field(default_factory=list)
    projection: list[str] | None = None   # column names; None = all columns
    limit: int | None = None              # max rows returned (page size)
    aggregates: list[AggSpec] | None = None
    group_by: list[str] | None = None     # grouping columns (with aggregates)

    def in_range(self, key: bytes) -> bool:
        if key < self.lower:
            return False
        return not self.upper or key < self.upper

    @property
    def is_aggregate(self) -> bool:
        return bool(self.aggregates)


@dataclass
class ScanResult:
    columns: list[str]            # names, in output order
    rows: list[tuple]             # materialized rows (or aggregate row(s))
    resume_key: bytes | None = None  # exclusive "scan resumes at" key, None = done
    # Observability: existing rows the engine examined. A work statistic,
    # not a contract — the device engine resolves whole block windows, so
    # a LIMIT page may report more rows examined than a row-at-a-time
    # engine that stops exactly at the limit. Unlimited tombstone-free
    # scans agree across engines (pinned by tests/test_gather.py).
    rows_scanned: int = 0


def point_key_of(spec: ScanSpec, schema=None) -> bytes | None:
    """The single doc key an exact-key-range spec can contain, or None
    when the spec is not a point read. Shapes: [key, key+0xff) (the
    processor's exact-key convention — lower is always a FULL doc key
    there) and, given the schema, [key, prefix_successor(key)) where
    lower binds every hash AND range component (the client GET / CQL
    full-PK shapes; the prefix spelling gets its terminator appended).
    The schema check matters: a hash-prefix scan (WHERE on the hash
    columns only) also has upper == prefix_successor(lower) but spans
    many keys."""
    if not spec.lower or not spec.upper or spec.is_aggregate or \
            spec.group_by:
        return None
    if spec.upper == spec.lower + b"\xff":
        return spec.lower
    if schema is None:
        return None
    from yugabyte_db_tpu_torch.models.encoding import (full_doc_key_of,
                                                 prefix_successor)

    if spec.upper != prefix_successor(spec.lower):
        return None
    return full_doc_key_of(spec.lower, len(schema.hash_columns),
                           len(schema.range_columns))
