"""The propagated deadline of a blocking call.

Reference analog: src/yb/rpc/rpc.h — every retry loop in the reference
debits ONE propagated deadline. The port's copy of the ``Deadline`` /
``DeadlineExpired`` part of the JAX package's ``utils/retry.py``: an
absolute point on the monotonic clock, created once at the RPC edge and
passed down through every layer, which the tablet's read fence and the
``gpu`` engine's batches check. Left out: ``RetryPolicy`` / ``Attempt``
and the retriable-code sets, which only the client and RPC layers use
(ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import time

from yugabyte_db_tpu_torch.utils.status import Code, Status, StatusError


class DeadlineExpired(StatusError):
    """The propagated budget ran out (Code.TIMED_OUT on the wire)."""

    def __init__(self, message: str):
        super().__init__(Status(Code.TIMED_OUT, message))


class Deadline:
    """An absolute expiry on the monotonic clock, passed down the call
    chain so every layer debits the same budget."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = expires_at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        """Raise DeadlineExpired if the budget ran out."""
        if self.expired():
            raise DeadlineExpired(f"{what}: deadline expired")

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"
