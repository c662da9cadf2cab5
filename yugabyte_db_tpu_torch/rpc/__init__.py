"""RPC framework: the single IO engine of every daemon.

Reference analog: src/yb/rpc/ — Messenger owning Reactor threads
(reactor.cc), Proxy for outbound calls (proxy.cc), ServicePool dispatching
inbound calls to worker threads (service_pool.cc), and the pluggable
ConnectionContext that lets the SAME server sockets carry foreign byte
protocols (CQL native protocol, RESP) next to the native framed-codec RPC
(cql_rpc.cc / redis_rpc.cc plug in exactly this way).

Wire format (native context): [u32 len][payload], payload =
codec.encode([call_id, method, body]) for requests and
[call_id, status, body] for responses — the spirit of the reference's
Hadoop-IPC-style framing (src/yb/rpc/README:25-33) with the framework's
own codec instead of protobuf.

The port's copy of the JAX package's ``rpc/``, whole: its frames are the
JAX frames byte for byte (the port's ``utils/codec.py``), so a port
``Proxy`` calls a JAX ``Messenger`` and the other way round.
"""

from yugabyte_db_tpu_torch.rpc.interface import Transport, TransportError
from yugabyte_db_tpu_torch.rpc.messenger import (ConnectionContext,
                                                 Messenger, RpcCallError,
                                                 RpcConnectionContext)
from yugabyte_db_tpu_torch.rpc.proxy import Proxy
from yugabyte_db_tpu_torch.rpc.transport import SocketTransport

__all__ = ["Messenger", "Proxy", "ConnectionContext", "RpcConnectionContext",
           "RpcCallError", "SocketTransport", "Transport", "TransportError"]
