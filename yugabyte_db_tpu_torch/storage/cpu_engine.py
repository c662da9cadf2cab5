"""Host-side row evaluation: the merged-row helpers of the CPU engine.

The port's copy of the JAX package's ``storage/cpu_engine.py``
``RowMaterializer`` and ``Aggregator`` (the exact per-key evaluation the
CPU oracle and the row path run), and of its history GC
(``CpuStorageEngine._gc_versions``, here the function ``gc_versions``:
the retention rule every compaction route of the ``gpu`` engine is held
to). The ``gpu`` engine's delta overlay folds its dirty keys with them,
and so does its scan of a memtable before the first flush.
``CpuStorageEngine`` itself waits for the host layers (ROADMAP.md §1
item 16).

Reference analog: the behavior of DocDB-on-RocksDB reads
(DocRowwiseIterator + GetSubDocument, src/yb/docdb/doc_rowwise_iterator.cc)
and aggregate pushdown (PgsqlReadOperation::EvalAggregate,
src/yb/docdb/pgsql_operation.cc:473).
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.models.encoding import decode_doc_key
from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.storage.expr import eval_expr
from yugabyte_db_tpu_torch.storage.merge import MergedRow, merge_versions
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import AggSpec, ScanSpec


def gc_versions(key: bytes, versions: list[RowVersion],
                cutoff: int) -> list[RowVersion]:
    """History GC: keep the versions any read at read_ht >= cutoff needs
    (``versions`` ht-desc, as a merge gives them): every version newer
    than the cutoff, and the versions at the hybrid times that contribute
    to the key's merged state at the cutoff (each column's latest setter,
    the liveness marker), unless a tombstone at or after them shadows
    them. Tombstones at or below the cutoff drop: nothing older remains
    to shadow.

    Reference analog: DocDBCompactionFilter retention
    (src/yb/docdb/docdb_compaction_filter.cc) driven by
    TabletRetentionPolicy's history cutoff.
    """
    if cutoff <= 0:
        return versions
    state = merge_versions(key, versions, cutoff)
    contributing = set(state.value_hts.values())
    if state.live_ht:
        contributing.add(state.live_ht)
    return [v for v in versions
            if v.ht > cutoff or (v.ht in contributing and v.ht > state.tomb_ht)]


class RowMaterializer:
    """Merged row + decoded key -> column values / predicate evaluation.

    Key columns live in the encoded DocKey (not in the version columns), so
    materialization decodes them positionally (models.encoding layout).
    """

    def __init__(self, schema: Schema):
        self.schema = schema
        self._key_cols = {c.name: i for i, c in enumerate(schema.key_columns)}
        self._val_ids = {c.name: c.col_id for c in schema.value_columns}

    def key_values(self, key: bytes) -> list:
        _, hashed, ranges = decode_doc_key(key)
        return hashed + ranges

    def value(self, name: str, key_vals: list, merged: MergedRow):
        if name in self._key_cols:
            return key_vals[self._key_cols[name]]
        return merged.get(self._val_ids[name])

    def matches(self, spec: ScanSpec, key_vals: list, merged: MergedRow) -> bool:
        return all(
            p.matches(self.value(p.column, key_vals, merged))
            for p in spec.predicates
        )


class Aggregator:
    """Pushdown aggregation: count/sum/min/max/avg with optional GROUP BY,
    over a column or an expression (``storage.expr``, evaluated exactly,
    NULL contagious)."""

    def __init__(self, aggs: list[AggSpec], group_by: list[str]):
        self.aggs = aggs
        self.group_by = group_by
        self.groups: dict[tuple, list] = {}

    def _new_acc(self) -> list:
        return [None] * len(self.aggs)

    def add(self, get_value) -> None:
        gkey = tuple(get_value(c) for c in self.group_by)
        acc = self.groups.get(gkey)
        if acc is None:
            acc = self.groups[gkey] = self._new_acc()
        for i, a in enumerate(self.aggs):
            if a.fn == "count":
                if a.column is None and a.expr is None:
                    acc[i] = (acc[i] or 0) + 1
                elif _input(a, get_value) is not None:
                    acc[i] = (acc[i] or 0) + 1
                continue
            v = _input(a, get_value)
            if v is None:
                continue
            if a.fn == "sum":
                acc[i] = v if acc[i] is None else acc[i] + v
            elif a.fn == "min":
                acc[i] = v if acc[i] is None else min(acc[i], v)
            elif a.fn == "max":
                acc[i] = v if acc[i] is None else max(acc[i], v)
            elif a.fn == "avg":
                s, n = acc[i] or (0, 0)
                acc[i] = (s + v, n + 1)

    def results(self) -> list[tuple]:
        if not self.groups and not self.group_by:
            self.groups[()] = self._new_acc()
        rows = []
        for gkey in sorted(self.groups, key=lambda g: tuple(map(_sortable, g))):
            acc = self.groups[gkey]
            out = list(gkey)
            for i, a in enumerate(self.aggs):
                v = acc[i]
                if a.fn == "count":
                    v = v or 0
                elif a.fn == "avg" and v is not None:
                    v = v[0] / v[1]
                out.append(v)
            rows.append(tuple(out))
        return rows

    def column_names(self) -> list[str]:
        names = list(self.group_by)
        for a in self.aggs:
            names.append(a.output_name)
        return names


def _input(a: AggSpec, get_value):
    """The aggregate's input value of one row: its expression's or its
    column's."""
    if a.expr is not None:
        return eval_expr(a.expr, get_value)
    return get_value(a.column)


def _sortable(v):
    # Group keys may mix None with values; sort None first.
    return (v is None, v)
