"""RPC: the messaging seam every layer above it programs against.

Reference analog: src/yb/rpc/ (Messenger, Proxy). The port's ``rpc``
package holds only the seam of the JAX package's ``rpc/interface.py``:
``Transport`` (``send(dst, method, payload) -> response`` with node-level
handlers) and ``TransportError``. The messenger, proxies and the socket
transport come with the tablet server (ROADMAP.md §1 item 12).
"""

from yugabyte_db_tpu_torch.rpc.interface import Transport, TransportError

__all__ = ["Transport", "TransportError"]
