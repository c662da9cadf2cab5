"""CQLServer: the Cassandra native-protocol proxy over the messenger.

Reference analog: src/yb/yql/cql/cqlserver/ — CQLServer (cql_server.cc)
riding the shared rpc::Messenger through a pluggable ConnectionContext
(CQLConnectionContext, cql_rpc.cc), CQLServiceImpl + CQLProcessor
dispatching requests (cql_service.cc, cql_processor.cc), and the
prepared-statement cache (cql_statement.cc).

The service executes statements through yql.cql.QLProcessor against any
Cluster seam — the in-process LocalCluster or the distributed client
adapter (client_cluster.ClientCluster), which is how the reference's CQL
proxy speaks to tservers through its embedded YBClient.
"""

from __future__ import annotations

import hashlib
import threading

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.rpc.messenger import ConnectionContext, Messenger
from yugabyte_db_tpu_torch.utils.metrics import (count_swallowed,
                                           observe_serve_batch)
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent, InvalidArgument,
                                          NotFound)
from yugabyte_db_tpu_torch.yql.cql import ast
from yugabyte_db_tpu_torch.yql.cql import wire_protocol as W
from yugabyte_db_tpu_torch.yql.cql.parser import Parser
from yugabyte_db_tpu_torch.yql.cql.processor import (QLProcessor, ResultSet,
                                               Unauthorized)


class CQLConnectionContext(ConnectionContext):
    """Parses CQL frames off the socket. Calls are handed to the service
    as (stream, "cql", (opcode, body)); responses are raw frame bytes."""

    ordered_responses = True  # one CQL statement at a time per connection

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        calls = []
        while True:
            if len(self._buf) < W.HEADER.size:
                return calls
            version, flags, stream, opcode, length = W.HEADER.unpack_from(
                self._buf, 0)
            if length < 0 or length > 64 * 1024 * 1024:
                raise ValueError(f"CQL frame too large: {length}")
            end = W.HEADER.size + length
            if len(self._buf) < end:
                return calls
            body = bytes(self._buf[W.HEADER.size:end])
            del self._buf[:end]
            calls.append((stream, "cql", (opcode, body)))

    def serialize(self, response) -> bytes:
        stream, status, body = response
        if status == "ok":
            return body
        return W.error_frame(stream, W.ERR_SERVER, str(body))


class PreparedStatement:
    __slots__ = ("stmt_id", "query", "stmt", "bind_cols", "table",
                 "keyspace")

    def __init__(self, stmt_id, query, stmt, bind_cols, keyspace, table):
        self.stmt_id = stmt_id
        self.query = query
        self.stmt = stmt
        self.bind_cols = bind_cols
        self.keyspace = keyspace
        self.table = table


class CQLServiceImpl:
    """Executes CQL frames. One instance per server; the prepared cache
    is shared across connections keyed by statement id (md5 of the query,
    like cql_statement.cc). Each CONNECTION owns its QLProcessor —
    keyspace state and in-flight bind params are per-session, and the
    messenger runs one statement at a time per connection
    (ordered_responses), so processor state never races across workers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prepared: dict[bytes, PreparedStatement] = {}
        # ROWS metadata-header cache for the batch serving path:
        # (id(stmt), keyspace, columns) -> (stmt, header bytes). The
        # header (kind/flags/colspecs) is identical for every frame of a
        # statement; only nrows + rows_data vary. The stmt ref pins the
        # id; a rename/projection change shifts the columns key.
        self._rows_hdr: dict = {}

    # -- frame dispatch ------------------------------------------------------
    def handle_call(self, processor: QLProcessor, stream: int, opcode: int,
                    body: bytes) -> bytes:
        from yugabyte_db_tpu_torch.utils.flags import FLAGS

        try:
            if opcode == W.OP_STARTUP:
                if FLAGS.get("use_cassandra_authentication"):
                    w = W.Writer()
                    w.string("org.apache.cassandra.auth."
                             "PasswordAuthenticator")
                    return W.frame(W.OP_AUTHENTICATE, stream, w.getvalue())
                return W.frame(W.OP_READY, stream, b"")
            if opcode == W.OP_AUTH_RESPONSE:
                # SASL PLAIN token: \x00<user>\x00<password>.
                token = W.Reader(body).bytes_() or b""
                parts = token.split(b"\x00")
                if len(parts) != 3:
                    return W.error_frame(stream, W.ERR_PROTOCOL,
                                         "malformed auth token")
                user = parts[1].decode("utf-8", "surrogateescape")
                password = parts[2].decode("utf-8", "surrogateescape")
                if not processor.cluster.auth_store().check_login(
                        user, password):
                    return W.error_frame(
                        stream, W.ERR_BAD_CREDENTIALS,
                        "Provided username or password is incorrect")
                processor.login_role = user
                w = W.Writer()
                w.bytes_(None)
                return W.frame(W.OP_AUTH_SUCCESS, stream, w.getvalue())
            if opcode == W.OP_OPTIONS:
                w = W.Writer()
                w.short(2)
                w.string("CQL_VERSION").string_list(["3.4.4"])
                w.string("COMPRESSION").string_list([])
                return W.frame(W.OP_SUPPORTED, stream, w.getvalue())
            if opcode == W.OP_REGISTER:
                return W.frame(W.OP_READY, stream, b"")
            if opcode == W.OP_QUERY:
                return self._query(processor, stream, body)
            if opcode == W.OP_PREPARE:
                return self._prepare(processor, stream, body)
            if opcode == W.OP_EXECUTE:
                return self._execute(processor, stream, body)
            return W.error_frame(stream, W.ERR_PROTOCOL,
                                 f"unsupported opcode {opcode:#x}")
        except InvalidArgument as e:
            return W.error_frame(stream, W.ERR_INVALID, str(e))
        except Unauthorized as e:
            return W.error_frame(stream, W.ERR_UNAUTHORIZED, str(e))
        except AlreadyPresent as e:
            return W.error_frame(stream, W.ERR_ALREADY_EXISTS, str(e))
        except NotFound as e:
            return W.error_frame(stream, W.ERR_INVALID, str(e))
        except Exception as e:  # noqa: BLE001 — surface as server error
            return W.error_frame(stream, W.ERR_SERVER,
                                 f"{type(e).__name__}: {e}")

    # -- QUERY ---------------------------------------------------------------
    def _read_query_params(self, r: W.Reader, bind_cols=None):
        """consistency + flags + optional values/page_size/paging_state."""
        r.short()  # consistency (ignored: the cluster owns consistency)
        flags = r.byte()
        params = []
        if flags & 0x01:  # values
            n = r.short()
            for i in range(n):
                raw = r.bytes_()
                dt = (bind_cols[i][1] if bind_cols and i < len(bind_cols)
                      else DataType.BINARY)
                params.append(W.decode_value(dt, raw))
        page_size = r.int32() if flags & 0x04 else None
        paging_state = r.bytes_() if flags & 0x08 else None
        return params, page_size, paging_state

    def _query(self, processor, stream: int, body: bytes) -> bytes:
        r = W.Reader(body)
        query = r.long_string()
        stmt, nmarkers = parse_with_markers(query)
        bind_cols = self._bind_columns(processor, stmt, nmarkers)
        params, page_size, paging_state = self._read_query_params(
            r, bind_cols)
        return self._run(processor, stream, stmt, params, page_size,
                         paging_state)

    # -- PREPARE / EXECUTE ---------------------------------------------------
    def _prepare(self, processor, stream: int, body: bytes) -> bytes:
        query = W.Reader(body).long_string()
        stmt, nmarkers = parse_with_markers(query)
        bind_cols = self._bind_columns(processor, stmt, nmarkers)
        stmt_id = hashlib.md5(query.encode()).digest()[:16]
        ks, table = self._stmt_target(stmt)
        with self._lock:
            self._prepared[stmt_id] = PreparedStatement(
                stmt_id, query, stmt, bind_cols, ks, table)
        return W.prepared_result(stream, stmt_id, ks, table, bind_cols)

    def _execute(self, processor, stream: int, body: bytes) -> bytes:
        r = W.Reader(body)
        stmt_id = r.short_bytes()
        with self._lock:
            ps = self._prepared.get(stmt_id)
        if ps is None:
            return W.error_frame(stream, W.ERR_UNPREPARED,
                                 "unknown prepared statement")
        params, page_size, paging_state = self._read_query_params(
            r, ps.bind_cols)
        return self._run(processor, stream, ps.stmt, params, page_size,
                         paging_state)

    def handle_execute_batch(self, processor: QLProcessor,
                             frames: list) -> bytes:
        """One pipelined burst of EXECUTE frames as ONE call — the CQL
        entry of the native request-batch serving path. ``frames`` is
        [(stream, body), ...] in arrival order; the return value is the
        reply frames concatenated in that same order (each carries its
        own stream id, so a single response body preserves pairing).
        Frames the batched wire path can't serve — unknown statement,
        non-point SELECT, writes, errors — run through handle_call one
        by one, which is exactly the pre-batch behavior."""
        observe_serve_batch("cql", len(frames))
        decoded: list = [None] * len(frames)  # (stmt, params, ps, pg)
        for fi, (stream, body) in enumerate(frames):
            try:
                r = W.Reader(body)
                stmt_id = r.short_bytes()
                with self._lock:
                    ps = self._prepared.get(stmt_id)
                if ps is None:
                    continue
                params, page_size, paging_state = self._read_query_params(
                    r, ps.bind_cols)
                decoded[fi] = (ps.stmt, params, page_size, paging_state)
            except Exception as e:  # noqa: BLE001 — handle_call below
                count_swallowed("cql.batch_decode", e)
        results: list = [None] * len(frames)
        items = [(fi, d) for fi, d in enumerate(decoded) if d is not None]
        if items:
            try:
                served = processor.execute_wire_point_batch(
                    [d for _fi, d in items])
            except Exception as e:  # noqa: BLE001 — per-frame fallback
                count_swallowed("cql.batch_execute", e)
                served = [None] * len(items)
            for (fi, d), rs in zip(items, served):
                if rs is None:
                    continue
                stream = frames[fi][0]
                hkey = (id(d[0]), processor.keyspace, tuple(rs.columns))
                hit = self._rows_hdr.get(hkey)
                if hit is not None and hit[0] is d[0]:
                    hdr = hit[1]
                    body_len = len(hdr) + 4 + len(rs.wire_data)
                    results[fi] = (
                        W.HEADER.pack(W.VERSION_RESP, 0, stream,
                                      W.OP_RESULT, body_len)
                        + hdr + rs.wire_rows.to_bytes(4, "big")
                        + rs.wire_data)
                    continue
                out = self._rows(processor, stream, d[0], rs)
                # Split the canonical frame around nrows+rows_data: the
                # leading metadata header is reusable verbatim, which
                # also guarantees cached replies stay byte-identical.
                hdr = out[W.HEADER.size:len(out) - 4 - len(rs.wire_data)]
                self._rows_hdr[hkey] = (d[0], hdr)
                results[fi] = out
        for fi, (stream, body) in enumerate(frames):
            if results[fi] is None:
                results[fi] = self.handle_call(processor, stream,
                                               W.OP_EXECUTE, body)
        return b"".join(results)

    # -- execution -----------------------------------------------------------
    def _run(self, processor, stream: int, stmt, params, page_size,
             paging_state) -> bytes:
        res = processor.execute(stmt, params=params,
                                page_size=page_size,
                                paging_state=paging_state,
                                wire_results=True)
        if isinstance(stmt, ast.UseKeyspace):
            return W.set_keyspace_result(stream, stmt.name)
        if isinstance(stmt, (ast.CreateKeyspace, ast.DropKeyspace)):
            change = ("CREATED" if isinstance(stmt, ast.CreateKeyspace)
                      else "DROPPED")
            return W.schema_change_result(stream, change, "KEYSPACE",
                                          stmt.name)
        if isinstance(stmt, ast.CreateTable):
            return W.schema_change_result(stream, "CREATED", "TABLE",
                                          processor.keyspace, stmt.name)
        if isinstance(stmt, ast.DropTable):
            return W.schema_change_result(stream, "DROPPED", "TABLE",
                                          processor.keyspace, stmt.name)
        if res is None:
            return W.void_result(stream)
        return self._rows(processor, stream, stmt, res)

    def _rows(self, processor, stream: int, stmt, res: ResultSet) -> bytes:
        table = getattr(stmt, "table", "") or ""
        dts = self._result_types(processor, stmt, res)
        if res.wire_data is not None:
            # Pre-serialized cells from the storage wire path: forward
            # verbatim under the metadata header (rows_data contract).
            return W.rows_result_wire(
                stream, processor.keyspace, table.split(".")[-1],
                list(zip(res.columns, dts)), res.wire_rows,
                res.wire_data, paging_state=res.paging_state)
        return W.rows_result(
            stream, processor.keyspace, table.split(".")[-1],
            list(zip(res.columns, dts)), res.rows,
            paging_state=res.paging_state)

    def _result_types(self, processor, stmt,
                      res: ResultSet) -> list[DataType]:
        table = getattr(stmt, "table", None)
        schema = None
        if table:
            try:
                handle = processor.cluster.table(processor._qualify(table))
                schema = handle.schema
            except Exception:  # noqa: BLE001
                schema = None
        out = []
        items = getattr(stmt, "items", None) or []
        for i, name in enumerate(res.columns):
            dt = None
            col = items[i].column if i < len(items) and \
                hasattr(items[i], "column") else name
            agg = items[i].agg_fn if i < len(items) and \
                hasattr(items[i], "agg_fn") else None
            if agg == "count":
                dt = DataType.INT64
            elif agg == "avg":
                dt = DataType.DOUBLE
            elif schema is not None and col and schema.has_column(col):
                dt = schema.column(col).dtype
                if agg == "sum":
                    # Sums widen: narrow ints overflow their own width.
                    dt = (DataType.DOUBLE
                          if dt in (DataType.FLOAT, DataType.DOUBLE)
                          else DataType.INT64)
            if dt is None and schema is not None and \
                    schema.has_column(name):
                dt = schema.column(name).dtype
            if dt is None:
                # Unresolvable columns degrade to text.
                dt = DataType.STRING
            out.append(dt)
        return out

    # -- bind metadata -------------------------------------------------------
    def _bind_columns(self, processor, stmt,
                      nmarkers: int) -> list[tuple[str, DataType]]:
        """(name, type) per ``?`` marker, in marker order, resolved from
        the statement's target table schema. Sized by the parser's true
        marker count so unnoted positions still get a (blob) slot."""
        markers: dict[int, tuple[str, DataType]] = {}
        table = getattr(stmt, "table", None)
        schema = None
        if table:
            try:
                handle = processor.cluster.table(processor._qualify(table))
                schema = handle.schema
            except Exception:  # noqa: BLE001
                schema = None

        def col_dt(col_name):
            if schema is not None and schema.has_column(col_name):
                return schema.column(col_name).dtype
            return DataType.BINARY

        def note(value, col_name):
            if isinstance(value, ast.BindMarker):
                markers[value.index] = (col_name, col_dt(col_name))
            elif isinstance(value, (list, tuple)):
                for v in value:
                    note(v, col_name)

        if isinstance(stmt, ast.Insert):
            for cname, v in zip(stmt.columns, stmt.values):
                note(v, cname)
        if isinstance(stmt, ast.Update):
            for cname, v in stmt.assignments:
                note(v, cname)
        for rel in getattr(stmt, "where", None) or []:
            note(rel.value, rel.column)
        lim = getattr(stmt, "limit", None)
        if isinstance(lim, ast.BindMarker):
            markers[lim.index] = ("[limit]", DataType.INT32)
        ttl = getattr(stmt, "ttl_seconds", None)
        if isinstance(ttl, ast.BindMarker):
            markers[ttl.index] = ("[ttl]", DataType.INT32)
        return [markers.get(i, (f"p{i}", DataType.BINARY))
                for i in range(nmarkers)]

    @staticmethod
    def _stmt_target(stmt) -> tuple[str, str]:
        table = getattr(stmt, "table", "") or ""
        if "." in table:
            ks, t = table.split(".", 1)
            return ks, t
        return "default", table


def parse_with_markers(query: str):
    """Parse one statement, returning (ast, number of ? markers)."""
    p = Parser(query)
    stmt = p.parse()
    return stmt, p.bind_count


class CQLServer:
    """Standalone CQL wire server: owns a messenger listener and a
    service over a Cluster seam. Each accepted connection gets its own
    QLProcessor (session keyspace + bind state), sharing the cluster and
    the prepared-statement cache."""

    def __init__(self, cluster, messenger: Messenger | None = None):
        self.cluster = cluster
        self.service = CQLServiceImpl()
        self._own_messenger = messenger is None
        self.messenger = messenger or Messenger(name="cql")

    def listen(self, host: str = "127.0.0.1", port: int = 0):
        # The messenger hands the handler (method, body) with the call id
        # (== CQL stream id) kept aside for response pairing; the stream
        # and the connection's processor also matter INSIDE the handler,
        # so the context tags both onto the body tuple.
        cluster = self.cluster

        def handler(_method, payload):
            processor, stream, opcode, body = payload
            if opcode == "execute_batch":
                return self.service.handle_execute_batch(processor, body)
            return self.service.handle_call(processor, stream, opcode, body)

        class _Ctx(CQLConnectionContext):
            def __init__(self):
                super().__init__()
                self.processor = QLProcessor(cluster)

            def feed(self, data):
                # Runs of pipelined EXECUTEs collapse into ONE
                # "execute_batch" call (the native request-batch serving
                # path). The single reply body carries one frame per
                # request frame, each tagged with its own stream id, so
                # response pairing survives the coalescing.
                calls = []
                run: list = []
                for stream, _m, (op, body) in super().feed(data):
                    if op == W.OP_EXECUTE:
                        run.append((stream, body))
                        continue
                    self._flush_run(calls, run)
                    calls.append(
                        (stream, "cql", (self.processor, stream, op, body)))
                self._flush_run(calls, run)
                return calls

            def _flush_run(self, calls, run):
                if not run:
                    return
                if len(run) == 1:
                    stream, body = run[0]
                    calls.append((stream, "cql",
                                  (self.processor, stream, W.OP_EXECUTE,
                                   body)))
                else:
                    stream = run[0][0]
                    calls.append((stream, "cql",
                                  (self.processor, stream, "execute_batch",
                                   list(run))))
                run.clear()

        return self.messenger.listen(host, port, handler,
                                     context_factory=_Ctx)

    def shutdown(self) -> None:
        if self._own_messenger:
            self.messenger.shutdown()
