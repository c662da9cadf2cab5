"""CQL native binary protocol v4: frame codec + value (de)serialization.

Reference analog: src/yb/yql/cql/cqlserver/cql_message.{h,cc} — the frame
header (version/flags/stream/opcode/length), the request opcodes
(STARTUP/OPTIONS/QUERY/PREPARE/EXECUTE), and the RESULT payload kinds
(Void/Rows/SetKeyspace/Prepared/SchemaChange). Implements the subset a
standard v4 driver exercises for DDL + DML with prepared statements and
result paging; no compression, no auth, no events.
"""

from __future__ import annotations

import struct

from yugabyte_db_tpu_torch.models.datatypes import DataType

VERSION_REQ = 0x04
VERSION_RESP = 0x84
HEADER = struct.Struct(">BBhBi")   # version, flags, stream, opcode, length

# Opcodes (protocol v4 §2.4)
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_EVENT = 0x0C
OP_AUTH_CHALLENGE = 0x0E
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

# RESULT kinds (§4.2.5)
RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_PREPARED = 0x0004
RESULT_SCHEMA_CHANGE = 0x0005

# Error codes (§9)
ERR_SERVER = 0x0000
ERR_PROTOCOL = 0x000A
ERR_BAD_CREDENTIALS = 0x0100
ERR_UNAUTHORIZED = 0x2100
ERR_INVALID = 0x2200
ERR_ALREADY_EXISTS = 0x2400
ERR_UNPREPARED = 0x2500

# Data type option ids (§6)
T_BIGINT = 0x0002
T_BLOB = 0x0003
T_BOOLEAN = 0x0004
T_COUNTER = 0x0005
T_DECIMAL = 0x0006
T_DOUBLE = 0x0007
T_FLOAT = 0x0008
T_INT = 0x0009
T_TIMESTAMP = 0x000B
T_UUID = 0x000C
T_VARCHAR = 0x000D
T_VARINT = 0x000E
T_TIMEUUID = 0x000F
T_INET = 0x0010
T_DATE = 0x0011
T_TIME = 0x0012
T_SMALLINT = 0x0013
T_TINYINT = 0x0014

_DT_TO_CQL = {
    DataType.INT8: T_TINYINT,
    DataType.INT16: T_SMALLINT,
    DataType.INT32: T_INT,
    DataType.INT64: T_BIGINT,
    DataType.FLOAT: T_FLOAT,
    DataType.DOUBLE: T_DOUBLE,
    DataType.BOOL: T_BOOLEAN,
    DataType.STRING: T_VARCHAR,
    DataType.BINARY: T_BLOB,
    DataType.TIMESTAMP: T_TIMESTAMP,
    DataType.COUNTER: T_COUNTER,
    DataType.DECIMAL: T_DECIMAL,
    DataType.VARINT: T_VARINT,
    DataType.UUID: T_UUID,
    DataType.TIMEUUID: T_TIMEUUID,
    DataType.INET: T_INET,
    DataType.DATE: T_DATE,
    DataType.TIME: T_TIME,
    # TUPLE/FROZEN ship as blobs (self-describing element payloads);
    # full 0x0031 tuple metadata would need per-element type plumbing.
}

_INT_WIDTH = {T_TINYINT: 1, T_SMALLINT: 2, T_INT: 4, T_BIGINT: 8,
              T_COUNTER: 8, T_TIMESTAMP: 8}


def cql_type_id(dt: DataType) -> int:
    return _DT_TO_CQL.get(dt, T_BLOB)


# -- primitive readers/writers (§3) -----------------------------------------

class Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated CQL frame body")
        self.pos += n
        return b

    def byte(self) -> int:
        return self._take(1)[0]

    def short(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def long_string(self) -> str:
        n = self.int32()
        return self._take(n).decode("utf-8")

    def string(self) -> str:
        return self._take(self.short()).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.int32()
        if n < 0:
            return None
        return self._take(n)

    def short_bytes(self) -> bytes:
        return self._take(self.short())

    def string_map(self) -> dict:
        return {self.string(): self.string() for _ in range(self.short())}


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def byte(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">B", v))
        return self

    def short(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">H", v))
        return self

    def int32(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">i", v))
        return self

    def string(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        self.parts.append(struct.pack(">H", len(b)) + b)
        return self

    def long_string(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        self.parts.append(struct.pack(">i", len(b)) + b)
        return self

    def bytes_(self, b: bytes | None) -> "Writer":
        if b is None:
            self.parts.append(struct.pack(">i", -1))
        else:
            self.parts.append(struct.pack(">i", len(b)) + b)
        return self

    def short_bytes(self, b: bytes) -> "Writer":
        self.parts.append(struct.pack(">H", len(b)) + b)
        return self

    def string_list(self, items) -> "Writer":
        self.short(len(items))
        for s in items:
            self.string(s)
        return self

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def frame(opcode: int, stream: int, body: bytes) -> bytes:
    return HEADER.pack(VERSION_RESP, 0, stream, opcode, len(body)) + body


def error_frame(stream: int, code: int, message: str) -> bytes:
    w = Writer().int32(code).string(message)
    return frame(OP_ERROR, stream, w.getvalue())


# -- typed values (§6) -------------------------------------------------------

def encode_value(dt: DataType, v) -> bytes | None:
    """Python value -> CQL serialized bytes (None -> null). The cell
    format definition lives in models.wirefmt (shared with the native
    wire page server)."""
    from yugabyte_db_tpu_torch.models.wirefmt import cql_cell

    return cql_cell(dt, v)


def decode_value(dt: DataType, b: bytes | None):
    """CQL serialized bytes -> Python value (None stays None)."""
    if b is None:
        return None
    from yugabyte_db_tpu_torch.utils.status import InvalidArgument

    tid = cql_type_id(dt)
    if tid in _INT_WIDTH:
        # Fixed-width cells must be exactly their width (§6): reject a
        # mis-typed bind instead of reinterpreting its bytes.
        if len(b) != _INT_WIDTH[tid]:
            raise InvalidArgument(
                f"expected {_INT_WIDTH[tid]} bytes for type {dt.name}, "
                f"got {len(b)}")
        return int.from_bytes(b, "big", signed=True)
    if tid == T_BOOLEAN:
        if len(b) != 1:
            raise InvalidArgument(
                f"expected 1 byte for BOOLEAN, got {len(b)}")
        return b != b"\x00"
    if tid == T_DOUBLE:
        if len(b) != 8:
            raise InvalidArgument(
                f"expected 8 bytes for DOUBLE, got {len(b)}")
        return struct.unpack(">d", b)[0]
    if tid == T_FLOAT:
        if len(b) != 4:
            raise InvalidArgument(
                f"expected 4 bytes for FLOAT, got {len(b)}")
        return struct.unpack(">f", b)[0]
    if tid == T_VARCHAR:
        return b.decode("utf-8")
    if tid == T_VARINT:
        return int.from_bytes(b, "big", signed=True)
    if tid == T_DECIMAL:
        import decimal

        scale = struct.unpack(">i", b[:4])[0]
        unscaled = int.from_bytes(b[4:], "big", signed=True)
        return decimal.Decimal(unscaled).scaleb(-scale)
    if tid in (T_UUID, T_TIMEUUID):
        import uuid as _uuid

        from yugabyte_db_tpu_torch.models.datatypes import TimeUuid

        u = _uuid.UUID(bytes=b)
        return TimeUuid(u) if tid == T_TIMEUUID else u
    if tid == T_INET:
        from yugabyte_db_tpu_torch.models.datatypes import Inet

        return Inet(b)
    if tid == T_DATE:
        import datetime

        days = struct.unpack(">I", b)[0] - (1 << 31)
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    if tid == T_TIME:
        import datetime

        ns = struct.unpack(">q", b)[0]
        us, _ = divmod(ns, 1000)
        s, us = divmod(us, 10**6)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        return datetime.time(h, m, s, us)
    return b


# -- RESULT payloads ---------------------------------------------------------

def rows_result(stream: int, keyspace: str, table: str,
                columns: list[tuple[str, DataType]], rows: list[tuple],
                paging_state: bytes | None = None) -> bytes:
    w = Writer().int32(RESULT_ROWS)
    flags = 0x0001  # global_tables_spec
    if paging_state is not None:
        flags |= 0x0002  # has_more_pages
    w.int32(flags).int32(len(columns))
    if paging_state is not None:
        w.bytes_(paging_state)
    w.string(keyspace).string(table)
    for name, dt in columns:
        w.string(name).short(cql_type_id(dt))
    w.int32(len(rows))
    for row in rows:
        for (name, dt), v in zip(columns, row):
            w.bytes_(encode_value(dt, v))
    return frame(OP_RESULT, stream, w.getvalue())


def rows_result_wire(stream: int, keyspace: str, table: str,
                     columns: list[tuple[str, DataType]], nrows: int,
                     rows_data: bytes,
                     paging_state: bytes | None = None) -> bytes:
    """Rows RESULT from pre-serialized cell bytes (the rows_data
    contract: the storage layer emitted the cells; this adds only the
    metadata header). Byte-identical to rows_result over the same
    rows."""
    w = Writer().int32(RESULT_ROWS)
    flags = 0x0001  # global_tables_spec
    if paging_state is not None:
        flags |= 0x0002
    w.int32(flags).int32(len(columns))
    if paging_state is not None:
        w.bytes_(paging_state)
    w.string(keyspace).string(table)
    for name, dt in columns:
        w.string(name).short(cql_type_id(dt))
    w.int32(nrows)
    body = w.getvalue() + rows_data
    return frame(OP_RESULT, stream, body)


def void_result(stream: int) -> bytes:
    return frame(OP_RESULT, stream, Writer().int32(RESULT_VOID).getvalue())


def set_keyspace_result(stream: int, ks: str) -> bytes:
    w = Writer().int32(RESULT_SET_KEYSPACE).string(ks)
    return frame(OP_RESULT, stream, w.getvalue())


def schema_change_result(stream: int, change: str, target: str,
                         ks: str, name: str = "") -> bytes:
    w = Writer().int32(RESULT_SCHEMA_CHANGE)
    w.string(change).string(target).string(ks)
    if target != "KEYSPACE":
        w.string(name)
    return frame(OP_RESULT, stream, w.getvalue())


def prepared_result(stream: int, stmt_id: bytes, keyspace: str, table: str,
                    bind_cols: list[tuple[str, DataType]]) -> bytes:
    w = Writer().int32(RESULT_PREPARED).short_bytes(stmt_id)
    # bind metadata: global_tables_spec, no pk indices (v4 sends pk count)
    w.int32(0x0001).int32(len(bind_cols)).int32(0)  # flags, cols, pk count
    w.string(keyspace or "default").string(table or "")
    for name, dt in bind_cols:
        w.string(name).short(cql_type_id(dt))
    # result metadata: no_metadata flag (client uses the per-query one)
    w.int32(0x0004).int32(0)
    return frame(OP_RESULT, stream, w.getvalue())
