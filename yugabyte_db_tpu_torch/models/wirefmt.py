"""Protocol value serialization shared by the YQL frontends and the
native wire page server.

One definition of "a value's wire bytes" per protocol, used by three
consumers that must agree byte-for-byte:

- the CQL result writer (yql.cql.wire_protocol.encode_value),
- the PG text writer (yql.pgsql.wire._text / data_row),
- the native page server's pre-encoded payload blobs and its fallback
  serializer (storage.host_page), whose C emitter mirrors these rules
  for plane-resident types (see native/writeplane.cc WireEmit).

Reference analog: the reference serializes each result row once into
``rows_data`` (src/yb/common/ql_rowblock.h:66 Serialize) and the
frontends forward bytes; these functions define that row format here.

The port's copy of the JAX package's ``models/wirefmt.py``, whole: the
``gpu`` engine's ``scan_batch_wire`` serializes its results with it, so its
pages are the JAX engine's bytes. The native page server that mirrors these
rules in C waits for ROADMAP.md §1 item 16.
"""

from __future__ import annotations

import struct

from yugabyte_db_tpu_torch.models.datatypes import DataType

# CQL binary widths per integer-semantics logical type (protocol §6).
CQL_INT_WIDTH = {
    DataType.INT8: 1,
    DataType.INT16: 2,
    DataType.INT32: 4,
    DataType.INT64: 8,
    DataType.TIMESTAMP: 8,
    DataType.COUNTER: 8,
}


def _varint_bytes(v: int) -> bytes:
    """Two's-complement minimal big-endian (the CQL varint payload)."""
    n = max(1, (v.bit_length() + 8) // 8)
    return v.to_bytes(n, "big", signed=True)


def cql_cell(dt: DataType, v) -> bytes | None:
    """Python value -> CQL binary cell payload (None -> NULL cell).
    Formats per the native protocol §6 (reference serializers:
    src/yb/common/ql_value.cc Serialize)."""
    if v is None:
        return None
    w = CQL_INT_WIDTH.get(dt)
    if w is not None:
        # Two's-complement wrap (CQL integer arithmetic overflows by
        # wrapping; aggregate sums can exceed the column width).
        return (int(v) & ((1 << (8 * w)) - 1)).to_bytes(w, "big")
    if dt == DataType.BOOL:
        return b"\x01" if v else b"\x00"
    if dt == DataType.DOUBLE:
        return struct.pack(">d", float(v))
    if dt == DataType.FLOAT:
        return struct.pack(">f", float(v))
    if dt == DataType.STRING:
        return str(v).encode("utf-8")
    if dt == DataType.VARINT:
        return _varint_bytes(int(v))
    if dt == DataType.DECIMAL:
        import decimal

        d = decimal.Decimal(v)
        sign, digits, exp = d.as_tuple()
        unscaled = int("".join(map(str, digits)) or "0")
        if sign:
            unscaled = -unscaled
        return struct.pack(">i", -exp) + _varint_bytes(unscaled)
    if dt in (DataType.UUID, DataType.TIMEUUID):
        return v.bytes  # uuid.UUID and TimeUuid both expose raw bytes
    if dt == DataType.INET:
        from yugabyte_db_tpu_torch.models.datatypes import Inet

        return (v if isinstance(v, Inet) else Inet(v)).packed
    if dt == DataType.DATE:
        import datetime

        days = (v - datetime.date(1970, 1, 1)).days
        return struct.pack(">I", days + (1 << 31))
    if dt == DataType.TIME:
        ns = ((v.hour * 60 + v.minute) * 60 + v.second) * 10**9 \
            + v.microsecond * 1000
        return struct.pack(">q", ns)
    if dt == DataType.TUPLE:
        return b"".join(_cql_element(el) for el in v)
    if dt == DataType.FROZEN:
        return _cql_frozen(v)
    return bytes(v)  # BLOB and opaque payloads


def _cql_element(el) -> bytes:
    """[int32 len][payload] for a tuple/collection element, its type
    inferred from the runtime value (elements self-describe)."""
    if el is None:
        return b"\xff\xff\xff\xff"
    from yugabyte_db_tpu_torch.models.encoding import _infer_component_dtype

    b = cql_cell(_infer_component_dtype(el), el)
    return struct.pack(">i", len(b)) + b


def _cql_frozen(v) -> bytes:
    """Frozen collection payload: [int32 count] then length-prefixed
    elements (map: k,v pairs, key-sorted; set: element-sorted)."""
    if isinstance(v, dict):
        keys = sorted(v, key=_cql_element)
        parts = [struct.pack(">i", len(keys))]
        for k in keys:
            parts.append(_cql_element(k))
            parts.append(_cql_element(v[k]))
        return b"".join(parts)
    items = (sorted(v, key=_cql_element)
             if isinstance(v, (set, frozenset)) else list(v))
    return struct.pack(">i", len(items)) + b"".join(
        _cql_element(el) for el in items)


def pg_text(v) -> bytes:
    """Python value -> PG text-format payload (caller handles NULL)."""
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, (bytes, bytearray)):
        return b"\\x" + bytes(v).hex().encode()
    if isinstance(v, (dict, list)):  # jsonb / collections: json text
        import json

        return json.dumps(v, separators=(",", ":")).encode()
    return str(v).encode("utf-8", "replace")


def serialize_rows(fmt: str, dtypes, rows) -> bytes:
    """Rows -> concatenated wire bytes; the Python twin of the native
    emitter (fallback for shapes the page server can't serve).

    fmt "cql": per cell int32 BE length + payload (NULL = -1).
    fmt "pg": one complete DataRow message per row.
    """
    parts: list[bytes] = []
    if fmt == "cql":
        for row in rows:
            for dt, v in zip(dtypes, row):
                b = cql_cell(dt, v)
                if b is None:
                    parts.append(b"\xff\xff\xff\xff")
                else:
                    parts.append(struct.pack(">i", len(b)) + b)
        return b"".join(parts)
    for row in rows:
        cells: list[bytes] = [struct.pack(">H", len(row))]
        for v in row:
            if v is None:
                cells.append(b"\xff\xff\xff\xff")
            else:
                b = pg_text(v)
                cells.append(struct.pack(">i", len(b)) + b)
        body = b"".join(cells)
        parts.append(b"D" + struct.pack(">i", len(body) + 4) + body)
    return b"".join(parts)
