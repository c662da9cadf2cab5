"""Thin PostgreSQL frontend/backend protocol v3 client (libpq analog).

Implements the client side from the protocol spec, independent of the
server's wire module: startup packet, cleartext-password auth, the
simple query flow (PQexec) and the extended flow PQexecParams uses
(Parse/Bind/Describe/Execute/Sync), RowDescription-driven text-format
decoding by type OID, ErrorResponse field parsing, and transaction
status tracked from ReadyForQuery.

Reference analog: the libpq usage in
src/yb/yql/pgwrapper/pg_libpq-test.cc.
"""

from __future__ import annotations

import socket
import struct

_U32 = struct.Struct(">I")
_PROTO = 196608           # 3.0

_OID_BOOL = 16
_OID_BYTEA = 17
_OID_INT8 = 20
_OID_INT2 = 21
_OID_INT4 = 23
_OID_TEXT = 25
_OID_FLOAT4 = 700
_OID_FLOAT8 = 701
_OID_NUMERIC = 1700


class PgError(Exception):
    def __init__(self, fields: dict):
        self.severity = fields.get("S", "ERROR")
        self.code = fields.get("C", "XX000")
        self.message = fields.get("M", "")
        super().__init__(f"{self.severity} {self.code}: {self.message}")


class PgResultSet:
    def __init__(self):
        self.columns: list[str] = []
        self.oids: list[int] = []
        self.rows: list[tuple] = []
        self.command_tag: str = ""


def _decode_text(oid: int, raw: bytes | None):
    if raw is None:
        return None
    s = raw.decode("utf-8")
    if oid in (_OID_INT2, _OID_INT4, _OID_INT8):
        return int(s)
    if oid in (_OID_FLOAT4, _OID_FLOAT8):
        return float(s)
    if oid == _OID_NUMERIC:
        import decimal

        return decimal.Decimal(s)
    if oid == _OID_BOOL:
        return s == "t"
    if oid == _OID_BYTEA and s.startswith("\\x"):
        return bytes.fromhex(s[2:])
    return s


def _param_text(v) -> bytes | None:
    if v is None:
        return None
    if isinstance(v, bool):
        return b"true" if v else b"false"
    if isinstance(v, (bytes, bytearray)):
        return b"\\x" + bytes(v).hex().encode()
    return str(v).encode("utf-8")


class PgConnection:
    """One backend session. execute() = PQexec (simple protocol);
    execute_params() = PQexecParams (extended protocol)."""

    def __init__(self, host: str, port: int, user: str = "yb",
                 password: str | None = None,
                 database: str | None = None, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self._buf = b""
        self.parameters: dict[str, str] = {}
        self.txn_status = b"I"
        self._startup(user, password, database or user)

    # -- messaging -----------------------------------------------------------
    def _send(self, tag: bytes, payload: bytes = b"") -> None:
        self.sock.sendall(tag + _U32.pack(len(payload) + 4) + payload)

    def _read_msg(self):
        while len(self._buf) < 5:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise PgError({"M": "connection closed"})
            self._buf += chunk
        tag = self._buf[:1]
        (ln,) = _U32.unpack_from(self._buf, 1)
        while len(self._buf) < 1 + ln:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise PgError({"M": "connection closed"})
            self._buf += chunk
        payload = self._buf[5:1 + ln]
        self._buf = self._buf[1 + ln:]
        return tag, payload

    @staticmethod
    def _error_fields(payload: bytes) -> dict:
        fields = {}
        i = 0
        while i < len(payload) and payload[i:i + 1] != b"\x00":
            code = chr(payload[i])
            j = payload.index(b"\x00", i + 1)
            fields[code] = payload[i + 1:j].decode("utf-8", "replace")
            i = j + 1
        return fields

    # -- startup -------------------------------------------------------------
    def _startup(self, user, password, database) -> None:
        kv = (f"user\x00{user}\x00database\x00{database}\x00"
              "application_name\x00minipg\x00\x00").encode()
        self.sock.sendall(_U32.pack(len(kv) + 8) + _U32.pack(_PROTO) + kv)
        while True:
            tag, payload = self._read_msg()
            if tag == b"R":
                (code,) = _U32.unpack_from(payload)
                if code == 0:
                    continue
                if code == 3:  # cleartext password
                    pw = (password or "").encode() + b"\x00"
                    self._send(b"p", pw)
                    continue
                raise PgError({"M": f"unsupported auth code {code}"})
            if tag == b"S":
                k, v = payload.split(b"\x00")[:2]
                self.parameters[k.decode()] = v.decode()
            elif tag == b"K":
                pass  # BackendKeyData
            elif tag == b"E":
                raise PgError(self._error_fields(payload))
            elif tag == b"Z":
                self.txn_status = payload[:1]
                return

    # -- result collection ---------------------------------------------------
    def _collect(self) -> PgResultSet:
        res = PgResultSet()
        err = None
        while True:
            tag, payload = self._read_msg()
            if tag == b"T":
                (n,) = struct.unpack_from(">H", payload)
                off = 2
                for _ in range(n):
                    j = payload.index(b"\x00", off)
                    res.columns.append(payload[off:j].decode())
                    off = j + 1
                    _tbl, _att, oid, _sz, _mod, _fmt = struct.unpack_from(
                        ">IHIhih", payload, off)
                    res.oids.append(oid)
                    off += 18
            elif tag == b"D":
                (n,) = struct.unpack_from(">H", payload)
                off = 2
                vals = []
                for i in range(n):
                    (ln,) = struct.unpack_from(">i", payload, off)
                    off += 4
                    if ln < 0:
                        vals.append(None)
                    else:
                        oid = res.oids[i] if i < len(res.oids) else _OID_TEXT
                        vals.append(_decode_text(oid,
                                                 payload[off:off + ln]))
                        off += ln
                res.rows.append(tuple(vals))
            elif tag == b"C":
                res.command_tag = payload.rstrip(b"\x00").decode()
            elif tag in (b"1", b"2", b"3", b"n", b"I", b"t", b"s"):
                pass  # ParseComplete/BindComplete/CloseComplete/NoData/
                #       EmptyQuery/ParameterDescription/PortalSuspended
            elif tag == b"E":
                err = PgError(self._error_fields(payload))
            elif tag == b"Z":
                self.txn_status = payload[:1]
                if err is not None:
                    raise err
                return res

    # -- simple protocol -----------------------------------------------------
    def execute(self, sql: str) -> PgResultSet:
        self._send(b"Q", sql.encode("utf-8") + b"\x00")
        return self._collect()

    # -- extended protocol (PQexecParams shape) ------------------------------
    def execute_params(self, sql: str, params: list) -> PgResultSet:
        parse = b"\x00" + sql.encode("utf-8") + b"\x00" \
            + struct.pack(">H", 0)
        self._send(b"P", parse)
        bind = b"\x00\x00" + struct.pack(">H", 0)  # portal, stmt, fmts
        bind += struct.pack(">H", len(params))
        for p in params:
            bind += _pbytes(_param_text(p))
        bind += struct.pack(">H", 0)  # result formats: all text
        self._send(b"B", bind)
        self._send(b"D", b"P\x00")    # Describe portal
        self._send(b"E", b"\x00" + _U32.pack(0))
        self._send(b"S")
        return self._collect()

    def prepare(self, name: str, sql: str) -> None:
        parse = name.encode() + b"\x00" + sql.encode("utf-8") + b"\x00" \
            + struct.pack(">H", 0)
        self._send(b"P", parse)
        self._send(b"S")
        self._collect()

    def execute_prepared(self, name: str, params: list) -> PgResultSet:
        bind = b"\x00" + name.encode() + b"\x00" + struct.pack(">H", 0)
        bind += struct.pack(">H", len(params))
        for p in params:
            bind += _pbytes(_param_text(p))
        bind += struct.pack(">H", 0)
        self._send(b"B", bind)
        self._send(b"D", b"P\x00")
        self._send(b"E", b"\x00" + _U32.pack(0))
        self._send(b"S")
        return self._collect()

    def close(self) -> None:
        try:
            self._send(b"X")
            self.sock.close()
        except OSError:
            pass


def _pbytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b
