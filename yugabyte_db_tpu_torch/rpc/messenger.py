"""Messenger: reactor event loop + service dispatch.

Reference analog: src/yb/rpc/messenger.cc + reactor.cc — a small number of
event-loop threads own all sockets; complete inbound calls are handed to a
worker pool (service_pool.cc); responses are queued back to the reactor via
a wakeup pipe. ConnectionContext (connection_context.h) turns raw bytes
into calls and serializes responses, so CQL/RESP servers reuse this loop.

The port's copy of the JAX package's ``rpc/messenger.py``, whole.
"""

from __future__ import annotations

import logging
import selectors
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

from yugabyte_db_tpu_torch.utils import codec

_LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024


class RpcCallError(Exception):
    """Remote handler raised; carries the remote error message."""


class ConnectionContext:
    """Parses inbound bytes into calls; serializes responses.

    Subclass per wire protocol. ``feed(data)`` returns a list of parsed
    call objects; ``serialize(response)`` returns bytes to write back.

    ``ordered_responses``: foreign byte protocols (RESP, CQL without
    stream ids) match replies to requests by ORDER, so their handlers must
    run one-at-a-time per connection. The native context matches by call
    id and keeps full cross-call concurrency on one connection.
    """

    ordered_responses = True

    def feed(self, data: bytes) -> list:
        raise NotImplementedError

    def serialize(self, response) -> bytes:
        raise NotImplementedError


class RpcConnectionContext(ConnectionContext):
    """The native framed-codec protocol: [len][codec([call_id, method, body])]."""

    ordered_responses = False  # call ids pair requests with responses

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        calls = []
        while True:
            if len(self._buf) < _LEN.size:
                return calls
            (length,) = _LEN.unpack_from(self._buf, 0)
            if length > MAX_FRAME:
                raise ValueError(f"frame too large: {length}")
            end = _LEN.size + length
            if len(self._buf) < end:
                return calls
            payload = bytes(self._buf[_LEN.size:end])
            del self._buf[:end]
            call_id, method, body = codec.decode(payload)
            calls.append((call_id, method, body))

    def serialize(self, response) -> bytes:
        call_id, status, body = response
        payload = codec.encode([call_id, status, body])
        return _LEN.pack(len(payload)) + payload


class _Connection:
    def __init__(self, sock: socket.socket, context: ConnectionContext):
        self.sock = sock
        self.context = context
        self.out = bytearray()
        self.out_lock = threading.Lock()
        self.closed = False
        # Ordered-dispatch state (foreign protocols): a FIFO of parsed
        # calls drained by at most one worker at a time.
        self.call_queue: list = []
        self.draining = False


class Messenger:
    """Owns the reactor thread, listeners, and the service worker pool."""

    def __init__(self, name: str = "messenger", num_workers: int = 8):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._pool = ThreadPoolExecutor(max_workers=num_workers,
                                        thread_name_prefix=f"{name}-svc")
        # Dedicated per-service pools (reference: one ServicePool per
        # service, service_pool.cc). Without them a worker pool full of
        # user writes BLOCKED on majority replication starves the very
        # consensus RPCs that would unblock them.
        self._service_pools: list[tuple[str, ThreadPoolExecutor]] = []
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        self._lock = threading.Lock()
        self._listeners: list[socket.socket] = []
        self._conns: set[_Connection] = set()
        self._running = True
        self._thread = threading.Thread(target=self._reactor_loop,
                                        name=f"reactor-{name}", daemon=True)
        self._thread.start()

    # -- listeners ----------------------------------------------------------
    def listen(self, host: str, port: int, handler,
               context_factory=RpcConnectionContext) -> tuple[str, int]:
        """Serve ``handler(method, body) -> body`` (for the native context)
        or protocol-defined calls (for foreign contexts) on host:port.
        Returns the bound address (port may be ephemeral 0)."""
        srv = socket.create_server((host, port), reuse_port=False)
        srv.setblocking(False)
        with self._lock:
            self._listeners.append(srv)
        self._sel.register(srv, selectors.EVENT_READ,
                           ("accept", (handler, context_factory)))
        self._wake()
        return srv.getsockname()[:2]

    # -- reactor ------------------------------------------------------------
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _reactor_loop(self) -> None:
        while self._running:
            try:
                events = self._sel.select(timeout=0.2)
                for key, mask in events:
                    kind, data = key.data
                    if kind == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except BlockingIOError:
                            pass
                        self._flush_writable()
                    elif kind == "accept":
                        self._accept(key.fileobj, *data)
                    elif kind == "conn":
                        self._on_conn_event(key.fileobj, data, mask)
            except Exception:  # a dead reactor silently stops ALL rpc
                logging.getLogger(__name__).exception(
                    "reactor %s: event dispatch failed", self.name)
        # shutdown: close everything
        for srv in self._listeners:
            try:
                srv.close()
            except OSError:
                pass
        for conn in list(self._conns):
            self._close_conn(conn)

    def _accept(self, srv, handler, context_factory) -> None:
        try:
            sock, _ = srv.accept()
        except OSError:
            return
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Connection(sock, context_factory())
        conn.handler = handler
        with self._lock:
            self._conns.add(conn)
        self._sel.register(sock, selectors.EVENT_READ, ("conn", conn))

    def _on_conn_event(self, sock, conn: _Connection, mask) -> None:
        if mask & selectors.EVENT_READ:
            try:
                data = sock.recv(256 * 1024)
            except (BlockingIOError, InterruptedError):
                data = None
            except OSError:
                self._close_conn(conn)
                return
            if data == b"":
                self._close_conn(conn)
                return
            if data:
                try:
                    calls = conn.context.feed(data)
                except Exception:
                    self._close_conn(conn)
                    return
                if conn.context.ordered_responses:
                    # Replies pair with requests by order: serialize
                    # handler execution per connection.
                    with conn.out_lock:
                        conn.call_queue.extend(calls)
                        start_drain = calls and not conn.draining
                        if start_drain:
                            conn.draining = True
                    if start_drain:
                        self._pool.submit(self._drain_ordered, conn)
                else:
                    for call in calls:
                        self._pool_for(call[1]).submit(
                            self._dispatch, conn, call)
        if mask & selectors.EVENT_WRITE:
            self._try_write(conn)

    def _drain_ordered(self, conn: _Connection) -> None:
        while True:
            with conn.out_lock:
                if not conn.call_queue or conn.closed:
                    conn.draining = False
                    return
                call = conn.call_queue.pop(0)
            self._dispatch(conn, call)

    def _dispatch(self, conn: _Connection, call) -> None:
        """Worker-side: run the handler, enqueue the response.

        A handler with ``takes_conn = True`` receives the connection as
        its first argument — foreign protocols with server-push frames
        (Redis pubsub/monitor) address pushes via send_on(conn, ...)."""
        call_id, method, body = call
        try:
            if getattr(conn.handler, "takes_conn", False):
                result = conn.handler(conn, method, body)
            else:
                result = conn.handler(method, body)
            response = (call_id, "ok", result)
        except Exception as e:  # propagate as remote error
            response = (call_id, "error", f"{type(e).__name__}: {e}")
        try:
            out = conn.context.serialize(response)
        except Exception:
            self._close_conn(conn)
            return
        if out:
            self.send_on(conn, out)

    def add_service_pool(self, prefix: str, num_workers: int) -> None:
        """Route native-protocol methods starting with ``prefix`` onto a
        dedicated worker pool."""
        self._service_pools.append((prefix, ThreadPoolExecutor(
            max_workers=num_workers,
            thread_name_prefix=f"{self.name}-{prefix.rstrip('.')}")))

    def _pool_for(self, method) -> ThreadPoolExecutor:
        if self._service_pools and isinstance(method, str):
            for prefix, pool in self._service_pools:
                if method.startswith(prefix):
                    return pool
        return self._pool

    def send_on(self, conn: _Connection, data: bytes) -> None:
        """Queue bytes on a connection (thread-safe; used by workers and by
        foreign-protocol servers pushing frames)."""
        with conn.out_lock:
            conn.out.extend(data)
        self._wake()

    def _flush_writable(self) -> None:
        for conn in list(self._conns):
            with conn.out_lock:
                pending = bool(conn.out)
            if pending:
                self._try_write(conn)

    def _try_write(self, conn: _Connection) -> None:
        with conn.out_lock:
            if not conn.out or conn.closed:
                self._watch(conn, write=False)
                return
            try:
                # Bounded chunk: copy at most 256K per send, not the whole
                # pending buffer (a 4MB response would otherwise be O(n^2)).
                n = conn.sock.send(bytes(conn.out[:256 * 1024]))
                del conn.out[:n]
            except (BlockingIOError, InterruptedError):
                n = 0
            except OSError:
                self._close_conn(conn)
                return
            self._watch(conn, write=bool(conn.out))

    def _watch(self, conn: _Connection, write: bool) -> None:
        if conn.closed:
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if write else 0)
        try:
            self._sel.modify(conn.sock, events, ("conn", conn))
        except (KeyError, ValueError, OSError):
            pass

    def _close_conn(self, conn: _Connection) -> None:
        if conn.closed:
            return
        conn.closed = True
        with self._lock:
            self._conns.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def shutdown(self) -> None:
        self._running = False
        self._wake()
        self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False, cancel_futures=True)
        for _prefix, pool in self._service_pools:
            pool.shutdown(wait=False, cancel_futures=True)
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()
