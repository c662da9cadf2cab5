"""Wire codecs for storage types crossing RPC/WAL boundaries.

Reference analog: the request/response protos carrying row operations and
scan state (src/yb/common/ql_protocol.proto, wire_protocol.proto). One
canonical encoding serves the WAL body (tablet.py) and the client/tserver
RPCs, so a WAL entry can be shipped verbatim during catchup.

The port's copy of the row codec of the JAX package's ``storage/wire.py``
(``encode_rows`` / ``decode_rows``, the WAL body and the intents'): the
JAX module's lists, the same bytes once through ``utils.codec``. Left
out: the scan-spec and scan-result codecs, which only the RPC layer
reads (ROADMAP.md §1 item 16).
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.storage.row_version import RowVersion


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
