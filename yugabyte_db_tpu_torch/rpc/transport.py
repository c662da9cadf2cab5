"""SocketTransport: the consensus/cluster Transport over real TCP.

Plugs the rpc layer in behind the same seam LocalTransport implements, so
a TabletPeer group (and later the tserver/master daemons) runs unchanged
over loopback sockets — the reference's MiniCluster mode (real servers on
ephemeral loopback ports, mini_cluster.h:92-106).

The port's copy of the JAX package's ``rpc/transport.py``, whole.
"""

from __future__ import annotations

import threading

from yugabyte_db_tpu_torch.rpc.interface import Transport, TransportError
from yugabyte_db_tpu_torch.rpc.proxy import Proxy


class SocketTransport(Transport):
    """Routes ``send(dst_uuid, ...)`` through a Proxy to the address the
    uuid resolves to. The address book is shared and mutable (heartbeats /
    master location updates refresh it)."""

    def __init__(self, address_book: dict[str, tuple[str, int]] | None = None):
        self.address_book = address_book if address_book is not None else {}
        self._proxies: dict[str, Proxy] = {}
        self._lock = threading.Lock()

    def register(self, uuid: str, handler) -> None:
        raise NotImplementedError(
            "socket servers register via Messenger.listen; SocketTransport "
            "is the client side")

    def unregister(self, uuid: str) -> None:
        with self._lock:
            p = self._proxies.pop(uuid, None)
        if p is not None:
            p.close()

    def set_address(self, uuid: str, host: str, port: int) -> None:
        with self._lock:
            old = self.address_book.get(uuid)
            self.address_book[uuid] = (host, port)
            stale = self._proxies.pop(uuid, None) if old != (host, port) else None
        if stale is not None:
            stale.close()

    def _proxy_for(self, uuid: str) -> Proxy:
        with self._lock:
            p = self._proxies.get(uuid)
            if p is not None and not p.closed:
                return p
            addr = self.address_book.get(uuid)
        if addr is None:
            raise TransportError(f"no address for {uuid}")
        try:
            p = Proxy(*addr)
        except OSError as e:
            raise TransportError(f"connect to {uuid}@{addr} failed: {e}") from e
        with self._lock:
            existing = self._proxies.get(uuid)
            if existing is not None and not existing.closed:
                p.close()
                return existing
            self._proxies[uuid] = p
        return p

    def send(self, dst: str, method: str, payload, timeout: float = 5.0):
        from yugabyte_db_tpu_torch.utils.resources import note_blocking

        note_blocking("rpc")
        try:
            return self._proxy_for(dst).call(method, payload, timeout=timeout)
        except (ConnectionError, TimeoutError, OSError) as e:
            raise TransportError(f"rpc to {dst} failed: {e}") from e

    def close(self) -> None:
        with self._lock:
            proxies = list(self._proxies.values())
            self._proxies.clear()
        for p in proxies:
            p.close()
