"""PgServer: a PostgreSQL v3 wire-protocol frontend (simple query flow).

Reference analog: in the reference, YSQL IS a postgres process
(pgwrapper spawns it, src/yb/tserver/tablet_server_main.cc:160) and the
backend's FE/BE protocol handling is PostgreSQL's own. The
redesign keeps the framework single-runtime: this server speaks the
same FE/BE v3 protocol (startup, AuthenticationOk, simple Query,
RowDescription/DataRow/CommandComplete, ErrorResponse) directly on the
shared rpc Messenger via a pluggable ConnectionContext — the exact seam
the CQL and Redis frontends ride (src/yb/rpc/connection_context.h).

Covered: SSLRequest (refused with 'N'), StartupMessage (incl. the
cleartext-password handshake behind ysql_require_auth), simple Query
('Q', multi-statement), Terminate ('X'), and the extended query
protocol drivers actually use — Parse ('P'), Bind ('B'), Describe
('D'), Execute ('E'), Close ('C'), Flush ('H'), Sync ('S') with
error-skip-until-Sync semantics. Describe-portal executes the portal
eagerly (results cached for Execute) so RowDescription can be answered
without a separate planner output-schema pass.
"""

from __future__ import annotations

import struct

from yugabyte_db_tpu_torch.rpc.messenger import ConnectionContext, Messenger
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent, InvalidArgument,
                                          NotFound)
from yugabyte_db_tpu_torch.yql.pgsql.executor import PgProcessor, PgResult
from yugabyte_db_tpu_torch.yql.pgsql.parser import parse_script

_U32 = struct.Struct(">I")
_SSL_REQUEST = 80877103
_CANCEL_REQUEST = 80877102
_PROTO_V3 = 196608

# type OIDs (pg_type.h)
_OID_BOOL, _OID_BYTEA, _OID_INT8, _OID_INT4 = 16, 17, 20, 23
_OID_TEXT, _OID_FLOAT8 = 25, 701


# -- message builders --------------------------------------------------------

def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + _U32.pack(len(payload) + 4) + payload


def auth_ok() -> bytes:
    return _msg(b"R", _U32.pack(0))


def auth_cleartext_password() -> bytes:
    """AuthenticationCleartextPassword (R, code 3)."""
    return _msg(b"R", _U32.pack(3))


def parameter_status(key: str, value: str) -> bytes:
    return _msg(b"S", key.encode() + b"\x00" + value.encode() + b"\x00")


def ready_for_query(status: bytes = b"I") -> bytes:
    """'I' idle, 'T' in transaction, 'E' failed transaction."""
    return _msg(b"Z", status)


def command_complete(tag: str) -> bytes:
    return _msg(b"C", tag.encode() + b"\x00")


def empty_query_response() -> bytes:
    return _msg(b"I", b"")


def error_response(message: str, code: str = "XX000") -> bytes:
    fields = (b"SERROR\x00" + b"C" + code.encode() + b"\x00"
              + b"M" + message.encode("utf-8", "replace") + b"\x00\x00")
    return _msg(b"E", fields)


def _infer_oid(rows, col: int) -> int:
    for r in rows:
        v = r[col]
        if v is None:
            continue
        if isinstance(v, bool):
            return _OID_BOOL
        if isinstance(v, int):
            return _OID_INT8
        if isinstance(v, float):
            return _OID_FLOAT8
        if isinstance(v, (bytes, bytearray)):
            return _OID_BYTEA
        return _OID_TEXT
    return _OID_TEXT


def row_description(res: PgResult) -> bytes:
    parts = [struct.pack(">H", len(res.columns))]
    for i, name in enumerate(res.columns):
        oid = _infer_oid(res.rows, i)
        parts.append(name.encode() + b"\x00"
                     + struct.pack(">IHIhih", 0, 0, oid, -1, -1, 0))
    return _msg(b"T", b"".join(parts))


def _text(v) -> bytes:
    # Format definition shared with the native wire page server.
    from yugabyte_db_tpu_torch.models.wirefmt import pg_text

    return pg_text(v)


def data_row(row: tuple) -> bytes:
    parts = [struct.pack(">H", len(row))]
    for v in row:
        if v is None:
            parts.append(struct.pack(">i", -1))
        else:
            b = _text(v)
            parts.append(struct.pack(">i", len(b)) + b)
    return _msg(b"D", b"".join(parts))


# -- connection context ------------------------------------------------------

class PgConnectionContext(ConnectionContext):
    """Stateful FE/BE framing: a connection starts in the startup phase
    (untyped length-prefixed packet), then switches to typed messages.
    Calls carry the context itself so the service keeps per-connection
    sessions without the messenger knowing about them."""

    ordered_responses = True

    def __init__(self):
        self._buf = bytearray()
        self._started = False
        self.session = None  # attached by the service on startup
        # Extended-protocol state.
        self.prepared: dict = {}       # name -> parsed statement AST
        self.portals: dict = {}        # name -> {"stmt","params","result"}
        self.skip_until_sync = False

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        calls = []
        while True:
            if not self._started:
                if len(self._buf) < 4:
                    return calls
                (length,) = _U32.unpack_from(self._buf, 0)
                if length < 8 or length > 1 << 20:
                    raise ValueError(f"bad startup packet length {length}")
                if len(self._buf) < length:
                    return calls
                payload = bytes(self._buf[4:length])
                del self._buf[:length]
                (proto,) = _U32.unpack_from(payload, 0)
                if proto == _SSL_REQUEST:
                    calls.append((0, "pg", (self, "ssl", None)))
                    continue  # stay in startup phase
                if proto == _CANCEL_REQUEST:
                    continue  # no cancel support: ignore
                params = {}
                kv = payload[4:].split(b"\x00")
                for k, v in zip(kv[::2], kv[1::2]):
                    if k:
                        params[k.decode()] = v.decode()
                self._started = True
                calls.append((0, "pg", (self, "startup", params)))
                continue
            if len(self._buf) < 5:
                return calls
            tag = bytes(self._buf[:1])
            (length,) = _U32.unpack_from(self._buf, 1)
            if length < 4 or length > 64 * 1024 * 1024:
                raise ValueError(f"bad message length {length}")
            end = 1 + length
            if len(self._buf) < end:
                return calls
            payload = bytes(self._buf[5:end])
            del self._buf[:end]
            calls.append((0, "pg", (self, tag.decode(), payload)))

    def serialize(self, response) -> bytes:
        _tag, status, body = response
        if status == "ok":
            return body
        # Handler raised outside the per-statement guard: wire-level
        # error. Report the session's REAL txn state — claiming 'I'
        # while a transaction is open desyncs the driver's state machine.
        st = b"I"
        if self.session is not None and self.session.in_txn:
            st = self.session.txn_status.encode()
        return error_response(str(body)) + ready_for_query(st)


class PgServiceImpl:
    """Executes FE messages. Each connection gets its own PgProcessor
    (mirroring one backend per connection)."""

    def __init__(self, cluster):
        self.cluster = cluster

    @staticmethod
    def _session_ready() -> bytes:
        return (parameter_status("server_version", "11.2-yb-tpu")
                + parameter_status("client_encoding", "UTF8")
                + parameter_status("integer_datetimes", "on")
                + ready_for_query())

    def handle(self, _method: str, call) -> bytes:
        from yugabyte_db_tpu_torch.utils.flags import FLAGS

        ctx, kind, payload = call
        if kind == "ssl":
            return b"N"  # SSL refused; client retries in cleartext
        if kind == "startup":
            if FLAGS.get("ysql_require_auth"):
                # Cleartext-password handshake (reference: pg_hba
                # password auth); the role must exist with LOGIN and a
                # matching password in the replicated role store.
                ctx.pending_user = payload.get("user", "")
                return auth_cleartext_password()
            ctx.session = PgProcessor(self.cluster)
            return auth_ok() + self._session_ready()
        if kind == "p":  # PasswordMessage
            user = getattr(ctx, "pending_user", None)
            if user is None or ctx.session is not None:
                return error_response("unexpected password message",
                                      "08P01")
            password = payload.rstrip(b"\x00").decode(
                "utf-8", "surrogateescape")
            store = getattr(self.cluster, "auth_store", None)
            if store is None or not store().check_login(user, password):
                return error_response(
                    f'password authentication failed for user "{user}"',
                    "28P01")
            ctx.session = PgProcessor(self.cluster)
            ctx.session.login_role = user
            return auth_ok() + self._session_ready()
        if ctx.session is None and kind in "QPBDECHS":
            return error_response("not authenticated", "28000") \
                + ready_for_query()
        if kind == "Q":
            return self._query(ctx, payload)
        if kind in "PBDECH":
            if ctx.skip_until_sync:
                return b""  # discard until Sync after an error
            try:
                return self._extended(ctx, kind, payload)
            except Exception as e:  # noqa: BLE001 — protocol error reply
                ctx.skip_until_sync = True
                code = {  # same mapping as the simple-query path
                    "InvalidArgument": "42601", "AlreadyPresent": "23505",
                    "NotFound": "42P01", "SerializationFailure": "40001",
                    "FailedTransaction": "25P02",
                }.get(type(e).__name__, "XX000")
                return error_response(str(e), code)
        if kind == "S":  # Sync
            ctx.skip_until_sync = False
            st = b"I"
            if ctx.session is not None and ctx.session.in_txn:
                st = ctx.session.txn_status.encode()
            return ready_for_query(st)
        if kind == "X":
            return b""  # client closes after Terminate
        st = b"I"
        if ctx.session is not None and ctx.session.in_txn:
            st = ctx.session.txn_status.encode()
        return error_response(f"unsupported message {kind!r}",
                              code="0A000") + ready_for_query(st)

    # -- extended query protocol --------------------------------------------
    @staticmethod
    def _cstr(payload: bytes, pos: int) -> tuple[str, int]:
        end = payload.index(b"\x00", pos)
        return payload[pos:end].decode("utf-8", "surrogateescape"), end + 1

    def _extended(self, ctx, kind: str, payload: bytes) -> bytes:
        from yugabyte_db_tpu_torch.yql.pgsql.parser import parse_script

        if kind == "P":  # Parse: name, query, n param-type oids
            name, pos = self._cstr(payload, 0)
            query, pos = self._cstr(payload, pos)
            stmts = parse_script(query)
            if len(stmts) > 1:
                raise ValueError(
                    "cannot insert multiple commands into a prepared "
                    "statement")
            ctx.prepared[name] = stmts[0] if stmts else None
            return _msg(b"1", b"")  # ParseComplete
        if kind == "B":  # Bind: portal, stmt, formats, params, result fmts
            portal, pos = self._cstr(payload, 0)
            sname, pos = self._cstr(payload, pos)
            if sname not in ctx.prepared:
                raise ValueError(f"prepared statement {sname!r} "
                                 "does not exist")
            (nfmt,) = struct.unpack_from(">H", payload, pos)
            pos += 2
            fmts = struct.unpack_from(f">{nfmt}H", payload, pos)
            pos += 2 * nfmt
            (nparams,) = struct.unpack_from(">H", payload, pos)
            pos += 2
            params = []
            for i in range(nparams):
                (ln,) = struct.unpack_from(">i", payload, pos)
                pos += 4
                if ln < 0:
                    params.append(None)
                    continue
                raw = payload[pos:pos + ln]
                pos += ln
                fmt = fmts[i] if i < nfmt else (fmts[0] if nfmt else 0)
                if fmt != 0:
                    raise ValueError(
                        "binary parameter format is not supported")
                params.append(raw.decode("utf-8", "surrogateescape"))
            ctx.portals[portal] = {"stmt": ctx.prepared[sname],
                                   "params": params, "result": None,
                                   "done": False}
            return _msg(b"2", b"")  # BindComplete
        if kind == "D":  # Describe
            target = chr(payload[0])
            name, _pos = self._cstr(payload, 1)
            if target == "S":
                if name not in ctx.prepared:
                    raise ValueError(f"prepared statement {name!r} "
                                     "does not exist")
                # Unspecified param types (text); result shape resolves
                # at portal describe/execute time.
                return _msg(b"t", struct.pack(">H", 0)) + _msg(b"n", b"")
            p = ctx.portals.get(name)
            if p is None:
                raise ValueError(f"portal {name!r} does not exist")
            self._run_portal(ctx, p)
            res = p["result"]
            if res is None or not res.columns:
                return _msg(b"n", b"")  # NoData
            return row_description(res)
        if kind == "E":  # Execute: portal, max rows (0 = all)
            name, pos = self._cstr(payload, 0)
            p = ctx.portals.get(name)
            if p is None:
                raise ValueError(f"portal {name!r} does not exist")
            self._run_portal(ctx, p)
            res = p["result"]
            out = bytearray()
            if res is None:
                out += command_complete("OK")
            else:
                for r in res.rows:
                    out += data_row(r)
                if res.command.startswith(("SELECT", "select")) \
                        or res.columns:
                    out += command_complete(f"SELECT {len(res.rows)}")
                else:
                    out += command_complete(res.command)
            return bytes(out)
        if kind == "C":  # Close statement/portal
            target = chr(payload[0])
            name, _pos = self._cstr(payload, 1)
            (ctx.prepared if target == "S" else ctx.portals).pop(name, None)
            return _msg(b"3", b"")  # CloseComplete
        # 'H' Flush: responses are written immediately; nothing buffered.
        return b""

    def _run_portal(self, ctx, p: dict) -> None:
        """Execute a bound portal once (Describe-portal triggers it so
        RowDescription reflects the real result shape; Execute reuses
        the cached result)."""
        if p["done"]:
            return
        p["result"] = (None if p["stmt"] is None
                       else ctx.session.execute(p["stmt"], p["params"]))
        p["done"] = True

    def _query(self, ctx, payload: bytes) -> bytes:
        from yugabyte_db_tpu_torch.yql.pgsql.executor import (FailedTransaction,
                                                        SerializationFailure)

        session = ctx.session or PgProcessor(self.cluster)

        def txn_status() -> bytes:
            return session.txn_status.encode()

        sql = payload.rstrip(b"\x00").decode("utf-8", "replace")
        out = bytearray()
        try:
            stmts = parse_script(sql)
        except Exception as e:  # noqa: BLE001 - parse error to client
            return bytes(error_response(str(e), "42601")
                         + ready_for_query(txn_status()))
        if not stmts:
            return bytes(empty_query_response()
                         + ready_for_query(txn_status()))
        for stmt in stmts:
            try:
                res = session.execute(stmt)
            except SerializationFailure as e:
                out += error_response(str(e), "40001")
                break
            except FailedTransaction as e:
                out += error_response(str(e), "25P02")
                break
            except InvalidArgument as e:
                out += error_response(str(e), "42601")
                break
            except AlreadyPresent as e:
                out += error_response(str(e), "23505")
                break
            except NotFound as e:
                out += error_response(str(e), "42P01")
                break
            except Exception as e:  # noqa: BLE001
                out += error_response(str(e))
                break
            if res is None:
                out += command_complete("OK")
            elif res.command.startswith(("SELECT", "select")) or res.columns:
                out += row_description(res)
                for r in res.rows:
                    out += data_row(r)
                out += command_complete(f"SELECT {len(res.rows)}")
            else:
                out += command_complete(res.command)
        out += ready_for_query(txn_status())
        return bytes(out)


class PgServer:
    """The YSQL frontend daemon: a Messenger listener with the PG
    connection context (the reference shape: tserver spawns the SQL
    frontend on port 5433)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.service = PgServiceImpl(cluster)
        self.messenger = Messenger("pg-server")

    def listen(self, host: str = "127.0.0.1", port: int = 0):
        return self.messenger.listen(host, port, self.service.handle,
                                     context_factory=PgConnectionContext)

    def shutdown(self) -> None:
        self.messenger.shutdown()
