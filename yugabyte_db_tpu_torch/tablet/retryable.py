"""RetryableRequests: exactly-once semantics for client write retries.

Reference analog: src/yb/consensus/retryable_requests.h:34 — each write
carries a (client id, request id); the tablet remembers applied ids so a
client retry after a lost response returns the ORIGINAL outcome instead
of double-applying. The registry is rebuilt deterministically: request
ids ride inside the replicated write entries, are recorded at APPLY
time on every replica, snapshot to a sidecar at flush, and replay from
the WAL tail on restart — exactly the intents/coordinator discipline.

The port's copy of the JAX package's ``tablet/retryable.py``, whole: the
sidecar file (``retryable.bin``) is the JAX tablet's byte for byte.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

# Per-client retention: retries arrive within seconds; 4096 outstanding
# ids per client is far beyond any batcher's in-flight window
# (reference: bounded by the client's running-request watermark).
MAX_IDS_PER_CLIENT = 4096


class RetryableRequests:
    def __init__(self, tablet_dir: str):
        self._lock = threading.Lock()
        self.path = os.path.join(tablet_dir, "retryable.bin")
        # client_id -> OrderedDict[request_id -> ht] (insertion = age)
        self.clients: dict[str, OrderedDict] = {}
        self.load()

    def seen(self, client_id: str, request_id: int) -> int | None:
        """The original write's hybrid time, or None if unseen."""
        with self._lock:
            reqs = self.clients.get(client_id)
            if reqs is None:
                return None
            return reqs.get(request_id)

    def record(self, client_id: str, request_id: int, ht: int) -> None:
        """Called at apply time (replicated, deterministic on every
        replica)."""
        with self._lock:
            reqs = self.clients.setdefault(client_id, OrderedDict())
            reqs[request_id] = ht
            while len(reqs) > MAX_IDS_PER_CLIENT:
                reqs.popitem(last=False)

    # -- persistence (sidecar at flush, like intents) -----------------------
    def load(self) -> None:
        from yugabyte_db_tpu_torch.utils import codec

        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            d = codec.decode(f.read())
        with self._lock:
            for cid, pairs in d.items():
                self.clients[cid] = OrderedDict(pairs)

    def dump(self) -> dict:
        with self._lock:
            return {cid: list(reqs.items())
                    for cid, reqs in self.clients.items()}

    def snapshot(self) -> None:
        from yugabyte_db_tpu_torch.utils import codec

        d = self.dump()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(codec.encode(d))
            f.flush()
            # snapshot() runs under the tablet's flush barrier by
            # contract: the WAL frontier may not advance past state that
            # isn't durable yet.
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def stats(self) -> dict:
        with self._lock:
            return {"clients": len(self.clients),
                    "request_ids": sum(len(r) for r in
                                       self.clients.values())}
