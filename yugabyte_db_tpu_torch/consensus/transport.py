"""Message transport between consensus peers / cluster nodes.

Reference analog: the rpc layer's Messenger/Proxy pair (src/yb/rpc/) as seen
by consensus — ``Peer`` sends UpdateConsensus/RequestConsensusVote through a
``ConsensusServiceProxy``. Here the seam is one method:
``send(dst, method, payload) -> response`` with node-level handlers.

``LocalTransport`` is the in-process fabric used by MiniCluster-style tests
(reference: mini_cluster.h runs real servers on loopback; we go one step
lighter and skip sockets). It supports fault injection — partitions, drops,
latency — the ExternalMiniCluster role of forcing failure paths. A socket
transport plugs in behind the same seam (the JAX package's
``rpc/transport.py``; the port's comes with the tablet server).

The port's copy of the JAX package's ``consensus/transport.py``.
"""

from __future__ import annotations

import random
import threading
import time

# The seam itself lives in the rpc layer; re-exported here because
# consensus is where most callers historically imported it from.
from yugabyte_db_tpu_torch.rpc.interface import Transport, TransportError
from yugabyte_db_tpu_torch.utils.retry import Deadline, RetryPolicy

__all__ = ["Transport", "TransportError", "LocalTransport",
           "BoundTransport", "send_with_retry"]

# Default policy for one-off sends through the seam: a short budget with
# jittered backoff (server-to-server fire-and-forget helpers; latency-
# sensitive loops construct their own).
_SEND_POLICY = RetryPolicy(timeout_s=5.0, initial_backoff_s=0.05,
                           max_backoff_s=0.5)


def send_with_retry(transport: Transport, dst: str, method: str,
                    payload: dict, *, policy: RetryPolicy | None = None,
                    deadline: Deadline | None = None,
                    timeout_s: float | None = None,
                    attempt_cap: float = 2.0) -> dict:
    """``transport.send`` under a RetryPolicy: transient transport
    failures and retriable wire codes back off and retry until the one
    deadline budget runs out; terminal responses return immediately.
    Raises TransportError when the policy gives up."""
    policy = policy or _SEND_POLICY
    last: object = None
    for attempt in policy.attempts(deadline=deadline, timeout_s=timeout_s):
        try:
            resp = transport.send(dst, method, payload,
                                  timeout=attempt.timeout(attempt_cap))
        except (TransportError, TimeoutError, ConnectionError) as e:
            last = e
            attempt.note(e)
            continue
        if not policy.retriable(resp):
            return resp
        last = resp
        attempt.note(resp)
    raise TransportError(
        f"{dst} unreachable before deadline ({method}): {last}")


class LocalTransport(Transport):
    """In-process transport with fault injection for tests."""

    def __init__(self, seed: int = 0):
        self._handlers: dict[str, object] = {}
        self._lock = threading.Lock()
        self._partitioned: set[frozenset] = set()
        self._isolated: set[str] = set()
        self.drop_rate = 0.0
        self.delay_s = 0.0
        self._rng = random.Random(seed)

    # -- wiring ------------------------------------------------------------
    def register(self, uuid: str, handler) -> None:
        with self._lock:
            self._handlers[uuid] = handler

    def unregister(self, uuid: str) -> None:
        with self._lock:
            self._handlers.pop(uuid, None)

    # -- fault injection ---------------------------------------------------
    def partition(self, a: str, b: str) -> None:
        """Block traffic between a and b (both directions)."""
        with self._lock:
            self._partitioned.add(frozenset((a, b)))

    def heal(self, a: str | None = None, b: str | None = None) -> None:
        with self._lock:
            if a is None:
                self._partitioned.clear()
                self._isolated.clear()
            elif b is None:
                self._isolated.discard(a)
                self._partitioned = {p for p in self._partitioned if a not in p}
            else:
                self._partitioned.discard(frozenset((a, b)))

    def isolate(self, uuid: str) -> None:
        """Cut a node off from everyone (network-level "kill")."""
        with self._lock:
            self._isolated.add(uuid)

    # -- delivery ----------------------------------------------------------
    def send(self, dst: str, method: str, payload: dict,
             timeout: float = 5.0, src: str | None = None) -> dict:
        from yugabyte_db_tpu_torch.utils.resources import note_blocking

        note_blocking("rpc")
        with self._lock:
            handler = self._handlers.get(dst)
            blocked = (dst in self._isolated
                       or (src is not None
                           and (src in self._isolated
                                or frozenset((src, dst)) in self._partitioned)))
            drop = self.drop_rate and self._rng.random() < self.drop_rate
            delay = self.delay_s
        if delay:
            time.sleep(delay)
        if handler is None or blocked or drop:
            raise TransportError(f"{dst} unreachable ({method})")
        return handler(method, payload)

    def bind(self, src: str) -> "BoundTransport":
        """A view that stamps the sender uuid (so partitions apply)."""
        return BoundTransport(self, src)


class BoundTransport(Transport):
    def __init__(self, inner: LocalTransport, src: str):
        self._inner = inner
        self.src = src

    def send(self, dst: str, method: str, payload: dict, timeout: float = 5.0) -> dict:
        return self._inner.send(dst, method, payload, timeout, src=self.src)

    def register(self, uuid: str, handler) -> None:
        self._inner.register(uuid, handler)

    def unregister(self, uuid: str) -> None:
        self._inner.unregister(uuid)
