"""Wire codecs for storage types crossing RPC/WAL boundaries.

Reference analog: the request/response protos carrying row operations and
scan state (src/yb/common/ql_protocol.proto, wire_protocol.proto). One
canonical encoding serves the WAL body (tablet.py) and the client/tserver
RPCs, so a WAL entry can be shipped verbatim during catchup.

The port's copy of the JAX package's ``storage/wire.py``, whole: the
rows (the WAL body and the intents'), the scan specs and the scan
results as the JAX module's lists, the same bytes once through
``utils.codec``.
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import (AggSpec, Predicate,
                                                     ScanResult, ScanSpec)


# -- rows -------------------------------------------------------------------

def encode_rows(rows: list[RowVersion]) -> list:
    # Column ids ride as INT map keys (the codec supports any scalar
    # key); decode_rows accepts the legacy str-keyed form from older WAL
    # segments.
    return [
        [r.key, r.ht, r.tombstone, r.liveness, r.columns, r.expire_ht,
         r.ttl_us, r.write_id, r.increments or None]
        for r in rows
    ]


def _int_keys(d: dict) -> dict:
    if not d:
        return {}
    for k in d:  # all-int fast path: no per-entry rebuild
        if not isinstance(k, int):
            return {int(c): v for c, v in d.items()}
        break
    return d


def decode_rows(body: list) -> list[RowVersion]:
    return [
        RowVersion(rec[0], ht=rec[1], tombstone=rec[2], liveness=rec[3],
                   columns=_int_keys(rec[4]),
                   expire_ht=rec[5],
                   ttl_us=rec[6] if len(rec) > 6 else None,
                   write_id=rec[7] if len(rec) > 7 else 0,
                   increments=_int_keys(rec[8])
                   if len(rec) > 8 and rec[8] else {})
        for rec in body
    ]


# -- scan specs -------------------------------------------------------------

def encode_spec(spec: ScanSpec) -> dict:
    return {
        "lower": spec.lower,
        "upper": spec.upper,
        "read_ht": spec.read_ht,
        "predicates": [[p.column, p.op,
                        list(p.value) if p.op == "IN" else p.value]
                       for p in spec.predicates],
        "projection": spec.projection,
        "limit": spec.limit,
        "aggregates": ([[a.fn, a.column, _encode_expr(a.expr), a.label]
                        for a in spec.aggregates]
                       if spec.aggregates else None),
        "group_by": spec.group_by,
    }


def _encode_expr(e):
    from yugabyte_db_tpu_torch.storage import expr as X

    if e is None:
        return None
    if isinstance(e, X.Col):
        return ["c", e.name]
    if isinstance(e, X.Const):
        return ["k", e.value]
    return ["b", e.op, _encode_expr(e.left), _encode_expr(e.right)]


def _decode_expr(d):
    from yugabyte_db_tpu_torch.storage import expr as X

    if d is None:
        return None
    if d[0] == "c":
        return X.Col(d[1])
    if d[0] == "k":
        return X.Const(d[1])
    return X.BinOp(d[1], _decode_expr(d[2]), _decode_expr(d[3]))


def decode_spec(d: dict) -> ScanSpec:
    return ScanSpec(
        lower=d.get("lower", b""),
        upper=d.get("upper", b""),
        read_ht=d.get("read_ht", MAX_HT),
        predicates=[
            Predicate(c, op, tuple(v) if op == "IN" else v)
            for c, op, v in d.get("predicates", [])
        ],
        projection=d.get("projection"),
        limit=d.get("limit"),
        aggregates=([AggSpec(a[0], a[1],
                             expr=_decode_expr(a[2]) if len(a) > 2 else None,
                             label=a[3] if len(a) > 3 else None)
                     for a in d["aggregates"]]
                    if d.get("aggregates") else None),
        group_by=d.get("group_by"),
    )


# -- scan results -----------------------------------------------------------

def encode_result(res: ScanResult) -> dict:
    return {
        "columns": res.columns,
        "rows": [list(r) for r in res.rows],
        "resume_key": res.resume_key,
        "rows_scanned": res.rows_scanned,
    }


def decode_result(d: dict) -> ScanResult:
    return ScanResult(
        columns=d["columns"],
        rows=[tuple(r) for r in d["rows"]],
        resume_key=d.get("resume_key"),
        rows_scanned=d.get("rows_scanned", 0),
    )
