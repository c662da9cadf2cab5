"""Thin CQL native-protocol v4 client (DataStax-driver analog).

Implements the client side of the protocol from the spec, independent
of the server's wire module: own frame codec, own typed-value
(de)serialization keyed off the RESULT metadata's wire type ids, the
SASL-PLAIN auth exchange, prepared statements, and result paging.
`discover()` performs the control-connection handshake a stock driver
runs right after STARTUP — reading system.local, system.peers, and the
system_schema tables to build its topology + schema view.

The port's copy of the JAX package's ``drivers/minicql.py``. Its one
departure: ``execute_prepared_many`` writes each refill of its window in
one socket write and takes every reply already read before the next
refill, where the JAX driver writes and reads one frame at a time.

Reference analog: the driver side expected by
src/yb/yql/cql/cqlserver/cql_message.{h,cc}; handshake shape from the
java/yb-cql driver tests.
"""

from __future__ import annotations

import socket
import struct
import threading

_HEADER = struct.Struct(">BBhBi")   # version, flags, stream, opcode, len

_OP_ERROR = 0x00
_OP_STARTUP = 0x01
_OP_READY = 0x02
_OP_AUTHENTICATE = 0x03
_OP_OPTIONS = 0x05
_OP_SUPPORTED = 0x06
_OP_QUERY = 0x07
_OP_RESULT = 0x08
_OP_PREPARE = 0x09
_OP_EXECUTE = 0x0A
_OP_AUTH_RESPONSE = 0x0F
_OP_AUTH_SUCCESS = 0x10

_RESULT_VOID = 0x0001
_RESULT_ROWS = 0x0002
_RESULT_SET_KEYSPACE = 0x0003
_RESULT_PREPARED = 0x0004
_RESULT_SCHEMA_CHANGE = 0x0005

# Wire type option ids (protocol v4 §6).
T_ASCII, T_BIGINT, T_BLOB, T_BOOLEAN = 0x0001, 0x0002, 0x0003, 0x0004
T_COUNTER, T_DECIMAL, T_DOUBLE, T_FLOAT = 0x0005, 0x0006, 0x0007, 0x0008
T_INT, T_TIMESTAMP, T_UUID, T_VARCHAR = 0x0009, 0x000B, 0x000C, 0x000D
T_VARINT, T_TIMEUUID, T_INET, T_DATE = 0x000E, 0x000F, 0x0010, 0x0011
T_TIME, T_SMALLINT, T_TINYINT = 0x0012, 0x0013, 0x0014
T_LIST, T_MAP, T_SET, T_UDT, T_TUPLE = 0x0020, 0x0021, 0x0022, 0x0030, 0x0031

_INT_WIDTHS = {T_BIGINT: 8, T_COUNTER: 8, T_TIMESTAMP: 8, T_INT: 4,
               T_SMALLINT: 2, T_TINYINT: 1}


class CqlError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"[{code:#06x}] {message}")
        self.code = code
        self.message = message


class _Buf:
    def __init__(self, data: bytes):
        self.b = data
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise CqlError(0x000A, "short frame")
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    def byte(self) -> int:
        return self.take(1)[0]

    def short(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def string(self) -> str:
        return self.take(self.short()).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.int32()
        return None if n < 0 else self.take(n)

    def short_bytes(self) -> bytes:
        return self.take(self.short())

    def type_spec(self):
        """Recursive type option: (id, params) — params hold element
        specs for collections / tuples, field list for UDTs."""
        tid = self.short()
        if tid in (T_LIST, T_SET):
            return (tid, [self.type_spec()])
        if tid == T_MAP:
            return (tid, [self.type_spec(), self.type_spec()])
        if tid == T_TUPLE:
            return (tid, [self.type_spec() for _ in range(self.short())])
        if tid == T_UDT:
            self.string()  # keyspace
            self.string()  # type name
            fields = []
            for _ in range(self.short()):
                fname = self.string()
                fields.append((fname, self.type_spec()))
            return (tid, fields)
        return (tid, None)


def _pstr(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _plstr(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">i", len(b)) + b


def _pbytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def encode_cql(value) -> bytes | None:
    """Client-side bind serialization by Python type (what a driver
    does before it learns the server's bind metadata)."""
    import datetime
    import decimal
    import uuid

    if value is None:
        return None
    if isinstance(value, bool):
        return b"\x01" if value else b"\x00"
    if isinstance(value, int):
        return struct.pack(">q", value)
    if isinstance(value, float):
        return struct.pack(">d", value)
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    if isinstance(value, decimal.Decimal):
        sign, digits, exp = value.as_tuple()
        unscaled = int("".join(map(str, digits)))
        if sign:
            unscaled = -unscaled
        n = max(1, (unscaled.bit_length() + 8) // 8)
        return struct.pack(">i", -exp) + unscaled.to_bytes(n, "big",
                                                          signed=True)
    if isinstance(value, uuid.UUID):
        return value.bytes
    if isinstance(value, datetime.date):
        days = (value - datetime.date(1970, 1, 1)).days
        return struct.pack(">I", days + (1 << 31))
    raise CqlError(0x2200, f"cannot serialize {type(value).__name__}")


def encode_cql_typed(value, spec) -> bytes | None:
    """Bind serialization keyed off the server's bind metadata: a
    prepared INT column takes 4 bytes on the wire, SMALLINT 2, FLOAT a
    4-byte IEEE single — not the 8-byte guess the untyped path makes
    from the Python type. Falls back to encode_cql for types whose
    wire form does not depend on the column (text, blob, uuid, ...)."""
    if value is None:
        return None
    is_int = isinstance(value, int) and not isinstance(value, bool)
    is_num = is_int or isinstance(value, float)
    tid, _params = spec
    if tid in _INT_WIDTHS and is_int:
        width = _INT_WIDTHS[tid]
        try:
            return value.to_bytes(width, "big", signed=True)
        except OverflowError:
            raise CqlError(
                0x2200, f"value {value!r} out of range for "
                f"{width}-byte integer column") from None
    if tid == T_FLOAT and is_num:
        return struct.pack(">f", float(value))
    if tid == T_DOUBLE and is_num:
        return struct.pack(">d", float(value))
    if tid == T_VARINT and is_int:
        n = max(1, (value.bit_length() + 8) // 8)
        return value.to_bytes(n, "big", signed=True)
    if tid == T_BOOLEAN and isinstance(value, bool):
        return b"\x01" if value else b"\x00"
    # Type mismatch or column-independent wire form: the untyped
    # encoder's bytes go out and the server reports any mismatch.
    return encode_cql(value)


def decode_cql(spec, raw: bytes | None):
    """Wire bytes -> Python value from the RESULT metadata type spec."""
    import datetime
    import decimal
    import uuid

    if raw is None:
        return None
    tid, params = spec
    if tid in _INT_WIDTHS or tid == T_VARINT:
        return int.from_bytes(raw, "big", signed=True)
    if tid == T_BOOLEAN:
        return raw != b"\x00"
    if tid == T_DOUBLE:
        return struct.unpack(">d", raw)[0]
    if tid == T_FLOAT:
        return struct.unpack(">f", raw)[0]
    if tid in (T_VARCHAR, T_ASCII):
        return raw.decode("utf-8")
    if tid == T_DECIMAL:
        scale = struct.unpack(">i", raw[:4])[0]
        unscaled = int.from_bytes(raw[4:], "big", signed=True)
        return decimal.Decimal(unscaled).scaleb(-scale)
    if tid in (T_UUID, T_TIMEUUID):
        return uuid.UUID(bytes=raw)
    if tid == T_DATE:
        days = struct.unpack(">I", raw)[0] - (1 << 31)
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    if tid == T_TIME:
        ns = struct.unpack(">q", raw)[0]
        us, _ = divmod(ns, 1000)
        s, us = divmod(us, 10 ** 6)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        return datetime.time(h, m, s, us)
    if tid in (T_LIST, T_SET):
        b = _Buf(raw)
        n = b.int32()
        out = [decode_cql(params[0], b.bytes_()) for _ in range(n)]
        return set(out) if tid == T_SET and _hashable(out) else out
    if tid == T_MAP:
        b = _Buf(raw)
        n = b.int32()
        return {decode_cql(params[0], b.bytes_()):
                decode_cql(params[1], b.bytes_()) for _ in range(n)}
    if tid == T_TUPLE:
        b = _Buf(raw)
        return tuple(decode_cql(p, b.bytes_()) for p in params)
    if tid == T_UDT:
        b = _Buf(raw)
        out = {}
        for fname, fspec in params:
            if b.i >= len(b.b):
                out[fname] = None
            else:
                out[fname] = decode_cql(fspec, b.bytes_())
        return out
    return raw


def _hashable(items) -> bool:
    try:
        set(items)
        return True
    except TypeError:
        return False


class CqlResult:
    def __init__(self, kind: str, columns=None, rows=None,
                 paging_state=None, keyspace=None):
        self.kind = kind                # "rows"|"void"|"set_keyspace"|
        self.columns = columns or []    # "schema_change"
        self.rows = rows or []
        self.paging_state = paging_state
        self.keyspace = keyspace

    @property
    def has_more_pages(self) -> bool:
        return self.paging_state is not None


class Prepared:
    def __init__(self, stmt_id: bytes, bind_specs: list):
        self.stmt_id = stmt_id
        self.bind_specs = bind_specs


class CqlConnection:
    """One driver connection: OPTIONS -> STARTUP -> (auth) -> queries."""

    def __init__(self, host: str, port: int, user: str | None = None,
                 password: str | None = None, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self._buf = b""
        self._stream = 0
        self._lock = threading.Lock()
        self.supported = self._handshake(user, password)

    # -- framing -------------------------------------------------------------
    def _frame(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        """(stream, request frame) on the next stream id."""
        self._stream = (self._stream + 1) % 32768
        hdr = _HEADER.pack(0x04, 0, self._stream, opcode, len(body))
        return self._stream, hdr + body

    def _send(self, opcode: int, body: bytes) -> int:
        stream, frame = self._frame(opcode, body)
        self.sock.sendall(frame)
        return stream

    def _frame_buffered(self) -> bool:
        """Whether a whole response frame is already read off the
        socket."""
        if len(self._buf) < _HEADER.size:
            return False
        ln = _HEADER.unpack_from(self._buf)[4]
        return len(self._buf) >= _HEADER.size + ln

    def _recv_frame(self):
        """Next response frame (any stream): (stream, opcode, body).
        ERROR frames are returned, not raised — callers decide."""
        while len(self._buf) < _HEADER.size:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise CqlError(0x0000, "connection closed")
            self._buf += chunk
        ver, _fl, stream, opcode, ln = _HEADER.unpack_from(self._buf)
        if ver != 0x84:
            raise CqlError(0x000A, f"bad response version {ver:#x}")
        total = _HEADER.size + ln
        while len(self._buf) < total:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise CqlError(0x0000, "connection closed")
            self._buf += chunk
        body = self._buf[_HEADER.size:total]
        self._buf = self._buf[total:]
        return stream, opcode, body

    def _recv(self, want_stream: int):
        while True:
            stream, opcode, body = self._recv_frame()
            if stream != want_stream:
                continue  # e.g. unsolicited EVENT frames
            if opcode == _OP_ERROR:
                b = _Buf(body)
                raise CqlError(b.int32(), b.string())
            return opcode, body

    def _call(self, opcode: int, body: bytes):
        with self._lock:
            return self._recv(self._send(opcode, body))

    # -- handshake -----------------------------------------------------------
    def _handshake(self, user, password) -> dict:
        op, body = self._call(_OP_OPTIONS, b"")
        supported = {}
        if op == _OP_SUPPORTED:
            b = _Buf(body)
            for _ in range(b.short()):
                key = b.string()
                supported[key] = [b.string()
                                  for _ in range(b.short())]
        startup = struct.pack(">H", 1) + _pstr("CQL_VERSION") \
            + _pstr("3.0.0")
        op, body = self._call(_OP_STARTUP, startup)
        if op == _OP_AUTHENTICATE:
            token = b"\x00" + (user or "").encode() + b"\x00" \
                + (password or "").encode()
            op, _ = self._call(_OP_AUTH_RESPONSE, _pbytes(token))
            if op != _OP_AUTH_SUCCESS:
                raise CqlError(0x0100, f"auth failed (opcode {op:#x})")
        elif op != _OP_READY:
            raise CqlError(0x000A, f"unexpected STARTUP reply {op:#x}")
        return supported

    # -- queries -------------------------------------------------------------
    @staticmethod
    def _query_params(values=None, page_size=None,
                      paging_state=None, bind_specs=None) -> bytes:
        flags = (0x01 if values else 0) | (0x04 if page_size else 0) \
            | (0x08 if paging_state else 0)
        out = struct.pack(">HB", 0x0001, flags)  # consistency ONE
        if values:
            out += struct.pack(">H", len(values))
            for i, v in enumerate(values):
                if bind_specs is not None and i < len(bind_specs):
                    out += _pbytes(encode_cql_typed(v, bind_specs[i]))
                else:
                    out += _pbytes(encode_cql(v))
        if page_size:
            out += struct.pack(">i", page_size)
        if paging_state:
            out += _pbytes(paging_state)
        return out

    def execute(self, query: str, values=None, page_size=None,
                paging_state=None) -> CqlResult:
        body = _plstr(query) + self._query_params(values, page_size,
                                                  paging_state)
        op, payload = self._call(_OP_QUERY, body)
        return self._parse_result(op, payload)

    def prepare(self, query: str) -> Prepared:
        op, payload = self._call(_OP_PREPARE, _plstr(query))
        if op != _OP_RESULT:
            raise CqlError(0x000A, f"unexpected PREPARE reply {op:#x}")
        b = _Buf(payload)
        kind = b.int32()
        if kind != _RESULT_PREPARED:
            raise CqlError(0x000A, f"unexpected result kind {kind}")
        stmt_id = b.short_bytes()
        # Bind-variable metadata (v4): flags, col count, pk count +
        # pk indices, then the (possibly global) column specs.
        flags = b.int32()
        n_cols = b.int32()
        for _ in range(b.int32()):
            b.short()  # pk index
        if flags & 0x0001:
            b.string()
            b.string()
        specs = []
        for _ in range(n_cols):
            if not flags & 0x0001:
                b.string()
                b.string()
            b.string()  # bind marker name
            specs.append(b.type_spec())
        return Prepared(stmt_id, specs)

    def execute_prepared(self, prep: Prepared, values=None,
                         page_size=None, paging_state=None) -> CqlResult:
        body = struct.pack(">H", len(prep.stmt_id)) + prep.stmt_id \
            + self._query_params(values, page_size, paging_state,
                                 bind_specs=prep.bind_specs)
        op, payload = self._call(_OP_EXECUTE, body)
        return self._parse_result(op, payload)

    def execute_prepared_many(self, prep: Prepared, values_list,
                              window: int = 128):
        """Pipelined EXECUTEs: up to `window` requests in flight on
        distinct stream ids before collecting responses — the stream
        multiplexing every stock driver does on one connection.
        Per-request errors come back in-place as CqlError values (like
        a redis pipeline), so one bad statement neither aborts the
        batch nor desyncs the connection.

        The requests of a refill go out in one socket write, and the
        replies already read off the socket are all taken before the
        next refill (the write coalescing a stock driver does), so the
        server sees bursts of frames, which its batch path serves
        together."""
        out: list = [None] * len(values_list)
        with self._lock:
            pending: dict[int, int] = {}  # stream -> result index
            i = 0
            while i < len(values_list) or pending:
                burst = []
                while i < len(values_list) and len(pending) < window:
                    body = (struct.pack(">H", len(prep.stmt_id))
                            + prep.stmt_id
                            + self._query_params(
                                values_list[i],
                                bind_specs=prep.bind_specs))
                    stream, frame = self._frame(_OP_EXECUTE, body)
                    pending[stream] = i
                    burst.append(frame)
                    i += 1
                if burst:
                    self.sock.sendall(b"".join(burst))
                while True:
                    stream, op, payload = self._recv_frame()
                    j = pending.pop(stream, None)
                    if j is not None and op == _OP_ERROR:
                        b = _Buf(payload)
                        out[j] = CqlError(b.int32(), b.string())
                    elif j is not None:
                        out[j] = self._parse_result(op, payload)
                    # j None: e.g. an unsolicited EVENT frame.
                    if not pending or not self._frame_buffered():
                        break
        return out

    def fetch_all(self, query: str, values=None,
                  page_size: int = 100) -> CqlResult:
        """Drain all pages (the driver-side paging loop)."""
        res = self.execute(query, values, page_size=page_size)
        rows = list(res.rows)
        while res.has_more_pages:
            res = self.execute(query, values, page_size=page_size,
                               paging_state=res.paging_state)
            rows.extend(res.rows)
        return CqlResult("rows", res.columns, rows)

    # -- control connection (stock-driver schema discovery) -----------------
    def discover(self) -> dict:
        """The handshake a DataStax driver runs after STARTUP: read
        system.local, system.peers, and the schema tables."""
        local = self.execute("SELECT * FROM system.local")
        peers = self.execute("SELECT * FROM system.peers")
        keyspaces = self.execute(
            "SELECT * FROM system_schema.keyspaces")
        tables = self.execute("SELECT * FROM system_schema.tables")
        columns = self.execute("SELECT * FROM system_schema.columns")
        types = self.execute("SELECT * FROM system_schema.types")
        local_row = dict(zip(local.columns, local.rows[0])) \
            if local.rows else {}
        schema: dict = {}
        ks_i = keyspaces.columns.index("keyspace_name")
        for r in keyspaces.rows:
            schema[r[ks_i]] = {"tables": {}, "types": {}}
        tks = tables.columns.index("keyspace_name")
        ttn = tables.columns.index("table_name")
        for r in tables.rows:
            schema.setdefault(r[tks], {"tables": {}, "types": {}})
            schema[r[tks]]["tables"][r[ttn]] = []
        cks = columns.columns.index("keyspace_name")
        ctn = columns.columns.index("table_name")
        ccn = columns.columns.index("column_name")
        for r in columns.rows:
            tbl = schema.get(r[cks], {}).get("tables", {}).get(r[ctn])
            if tbl is not None:
                tbl.append(r[ccn])
        yks = types.columns.index("keyspace_name")
        ytn = types.columns.index("type_name")
        for r in types.rows:
            schema.setdefault(r[yks], {"tables": {}, "types": {}})
            schema[r[yks]]["types"][r[ytn]] = r
        return {"local": local_row,
                "peers": [dict(zip(peers.columns, r))
                          for r in peers.rows],
                "schema": schema}

    # -- RESULT parsing ------------------------------------------------------
    @staticmethod
    def _metadata(b: _Buf):
        flags = b.int32()
        n_cols = b.int32()
        paging_state = b.bytes_() if flags & 0x0002 else None
        names, specs = [], []
        if not flags & 0x0004:  # no_metadata unset
            gks = gtb = None
            if flags & 0x0001:  # global table spec
                gks, gtb = b.string(), b.string()
            for _ in range(n_cols):
                if not flags & 0x0001:
                    b.string()
                    b.string()
                names.append(b.string())
                specs.append(b.type_spec())
        return names, specs, paging_state

    def _parse_result(self, op: int, payload: bytes) -> CqlResult:
        if op != _OP_RESULT:
            raise CqlError(0x000A, f"unexpected reply opcode {op:#x}")
        b = _Buf(payload)
        kind = b.int32()
        if kind == _RESULT_VOID:
            return CqlResult("void")
        if kind == _RESULT_SET_KEYSPACE:
            return CqlResult("set_keyspace", keyspace=b.string())
        if kind == _RESULT_SCHEMA_CHANGE:
            return CqlResult("schema_change")
        if kind == _RESULT_PREPARED:
            raise CqlError(0x000A, "PREPARED outside prepare()")
        if kind != _RESULT_ROWS:
            raise CqlError(0x000A, f"unknown result kind {kind}")
        names, specs, paging_state = self._metadata(b)
        n_rows = b.int32()
        rows = []
        for _ in range(n_rows):
            rows.append(tuple(decode_cql(spec, b.bytes_())
                              for spec in specs))
        return CqlResult("rows", names, rows, paging_state)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
