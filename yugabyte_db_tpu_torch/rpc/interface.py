"""The one-method messaging seam every layer above rpc programs against.

Reference analog: the Messenger/Proxy surface of src/yb/rpc/ as consumed
by consensus and the daemons — ``send(dst, method, payload) -> response``
with node-level handlers. The ABC lives here in the rpc layer (not in
consensus) so the dependency points down the stack: consensus,
integration, and the daemons all import the seam from rpc;
implementations are ``LocalTransport`` (consensus.transport, in-process
with fault injection) and ``SocketTransport`` (rpc.transport, real TCP).

The port's copy of the JAX package's ``rpc/interface.py``. The port has
``LocalTransport`` (consensus.transport) so far; the socket transport and
the messenger come with the tserver (ROADMAP.md §1 item 12).
"""

from __future__ import annotations

import abc


class TransportError(Exception):
    """Delivery failure (unreachable, partitioned, dropped, timed out)."""


class Transport(abc.ABC):
    @abc.abstractmethod
    def send(self, dst: str, method: str, payload: dict,
             timeout: float = 5.0) -> dict:
        """Deliver a request to node ``dst``; return its response.
        Raises TransportError if the node is unreachable."""

    @abc.abstractmethod
    def register(self, uuid: str, handler) -> None:
        """Register ``handler(method, payload) -> response`` for a node."""

    @abc.abstractmethod
    def unregister(self, uuid: str) -> None:
        ...
