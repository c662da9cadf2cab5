"""Proxy: outbound RPC client with call-id multiplexing.

Reference analog: src/yb/rpc/proxy.cc + outbound_call.cc — many concurrent
calls share one connection; responses are matched by call id; deadlines are
per-call. One background reader thread per connection (the reference uses
its reactor for this; a dedicated reader keeps the client usable without a
Messenger, e.g. in tools).

The port's copy of the JAX package's ``rpc/proxy.py``, whole.
"""

from __future__ import annotations

import socket
import struct
import threading

from yugabyte_db_tpu_torch.rpc.messenger import MAX_FRAME, RpcCallError
from yugabyte_db_tpu_torch.utils import codec
from yugabyte_db_tpu_torch.utils.retry import Deadline

_LEN = struct.Struct("<I")


class _PendingCall:
    __slots__ = ("event", "status", "body")

    def __init__(self):
        self.event = threading.Event()
        self.status = None
        self.body = None


class Proxy:
    def __init__(self, host: str, port: int, connect_timeout: float = 5.0):
        self.addr = (host, port)
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: dict[int, _PendingCall] = {}
        self._next_id = 1
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"proxy-read-{host}:{port}",
                                        daemon=True)
        self._reader.start()

    def call(self, method: str, body, timeout: float = 10.0,
             deadline: Deadline | None = None):
        """Send one call and wait for its response. ``deadline`` (the
        propagated utils.retry budget) caps ``timeout`` at the caller's
        remaining budget, so a retry loop's later attempts never wait
        longer than the one deadline they all debit."""
        if deadline is not None:
            timeout = deadline.timeout(timeout)
        with self._lock:
            if self._closed:
                raise ConnectionError(f"proxy to {self.addr} is closed")
            call_id = self._next_id
            self._next_id += 1
            pc = _PendingCall()
            self._pending[call_id] = pc
        payload = codec.encode([call_id, method, body])
        frame = _LEN.pack(len(payload)) + payload
        try:
            with self._send_lock:
                self._sock.sendall(frame)
        except OSError as e:
            with self._lock:
                self._pending.pop(call_id, None)
            self.close()
            raise ConnectionError(f"send to {self.addr} failed: {e}") from e
        if not pc.event.wait(timeout):
            with self._lock:
                self._pending.pop(call_id, None)
            raise TimeoutError(f"rpc {method} to {self.addr} timed out")
        if pc.status == "conn_closed":
            # Transport-level loss, NOT a remote handler error: callers'
            # failover paths key on ConnectionError.
            raise ConnectionError(f"connection to {self.addr} dropped "
                                  f"mid-call ({method})")
        if pc.status != "ok":
            raise RpcCallError(pc.body)
        return pc.body

    def _read_loop(self) -> None:
        buf = bytearray()
        sock = self._sock
        try:
            while True:
                data = sock.recv(256 * 1024)
                if not data:
                    break
                buf.extend(data)
                while len(buf) >= _LEN.size:
                    (length,) = _LEN.unpack_from(buf, 0)
                    if length > MAX_FRAME:
                        raise ValueError("oversized frame")
                    end = _LEN.size + length
                    if len(buf) < end:
                        break
                    call_id, status, body = codec.decode(bytes(buf[_LEN.size:end]))
                    del buf[:end]
                    with self._lock:
                        pc = self._pending.pop(call_id, None)
                    if pc is not None:
                        pc.status, pc.body = status, body
                        pc.event.set()
        except (OSError, ValueError):
            pass  # link-level loss: close() fails pending calls over
        except Exception:  # decode/dispatch bug — never die silently
            import logging

            logging.getLogger(__name__).exception(
                "proxy read loop to %s failed", self.addr)
        finally:
            self.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for pc in pending:
            pc.status, pc.body = "conn_closed", None
            pc.event.set()
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed
