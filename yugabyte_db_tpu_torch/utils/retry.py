"""Unified retry/deadline policy for every blocking RPC loop.

Reference analog: src/yb/rpc/rpc.h (RpcRetrier: exponential backoff with
jitter budgeted against the call's deadline) and the TabletInvoker /
MetaCache retry discipline (src/yb/client/tablet_rpc.cc) — every retry
loop in the reference debits ONE propagated deadline, classifies the
failure by Status code, and backs off with jitter so a thundering herd
of retries cannot synchronize.

Two primitives:

- ``Deadline``: an absolute point on the monotonic clock. Created once
  at the RPC edge, passed down through every layer, and debited by each
  attempt — a callee never waits past the caller's budget
  (``deadline.timeout(cap)`` caps a per-attempt transport timeout at
  the remaining budget).

- ``RetryPolicy``: backoff shape + retriable-code classification. The
  ``attempts()`` iterator drives a retry loop: it yields numbered
  ``Attempt``s, sleeps the (jittered, exponentially growing) backoff
  between them, and stops when the deadline or attempt budget is
  exhausted — the loop body only decides success / retriable / terminal.

    policy = RetryPolicy(timeout_s=10.0)
    for attempt in policy.attempts():
        try:
            resp = transport.send(dst, m, p, timeout=attempt.timeout(2.0))
        except TransportError as e:
            attempt.note(e)
            continue
        if policy.retriable(resp.get("code")):
            attempt.note(resp)
            continue
        return resp
    raise Unavailable(...)   # attempts exhausted

The port's copy of the JAX package's ``utils/retry.py``, whole: the
tablet's read fence and the ``gpu`` engine's batches check a ``Deadline``,
and consensus's ``send_with_retry`` drives a ``RetryPolicy``.
"""

from __future__ import annotations

import random
import time

from yugabyte_db_tpu_torch.utils.status import Code, Status, StatusError

# Codes a retry can plausibly outwait: transient transport/availability
# failures and leadership churn. Everything else (corruption, invalid
# argument, txn conflicts/aborts...) is terminal — retrying cannot
# change the outcome. EXPIRED is deliberately absent: it means the
# operation's own deadline passed, the one budget retries debit.
RETRIABLE_CODES = frozenset({
    Code.TIMED_OUT,
    Code.SERVICE_UNAVAILABLE,
    Code.NETWORK_ERROR,
    Code.TRY_AGAIN,
    Code.LEADER_NOT_READY,
    Code.LEADER_HAS_NO_LEASE,
})

# String response codes (the RPC payload convention) a retry can
# outwait; mirrors RETRIABLE_CODES for dict-shaped responses.
RETRIABLE_WIRE_CODES = frozenset({
    "timed_out", "not_leader", "service_unavailable", "try_again",
    "leader_not_ready", "network_error", "not_found",
})


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

    @classmethod
    def infinite(cls) -> "Deadline":
        return cls(float("inf"))

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def timeout(self, cap: float | None = None) -> float:
        """Per-attempt wait budget: the remaining deadline, capped at
        ``cap`` (floored at 0 — a caller passing this to a transport
        gets an immediate timeout rather than a negative wait)."""
        rem = max(0.0, self.remaining())
        if cap is None or self.expires_at == float("inf"):
            return cap if cap is not None else rem
        return min(cap, rem)

    def check(self, what: str = "operation") -> None:
        """Raise DeadlineExpired if the budget ran out."""
        if self.expired():
            raise DeadlineExpired(f"{what}: deadline expired")

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


class Attempt:
    """One iteration of a retry loop: its ordinal, the shared deadline,
    and the last failure noted (for the exhaustion error message)."""

    __slots__ = ("number", "deadline", "last")

    def __init__(self, number: int, deadline: Deadline):
        self.number = number
        self.deadline = deadline
        self.last = None

    def timeout(self, cap: float | None = None) -> float:
        return self.deadline.timeout(cap)

    def note(self, failure: object) -> None:
        """Record why this attempt failed (carried to the next attempt
        and surfaced when the policy gives up)."""
        self.last = failure


class RetryPolicy:
    """Exponential backoff with jitter, budgeted against one deadline.

    ``timeout_s`` is the overall budget when the caller doesn't pass an
    explicit Deadline; ``max_attempts=None`` means deadline-bounded
    only. The jitter factor spreads each backoff uniformly over
    ``[base*(1-jitter), base*(1+jitter)]`` so synchronized retries
    de-correlate (the reference's RandomizedNumber in RpcRetrier)."""

    def __init__(self, *, timeout_s: float | None = None,
                 max_attempts: int | None = None,
                 initial_backoff_s: float = 0.02,
                 max_backoff_s: float = 1.0,
                 multiplier: float = 2.0,
                 jitter: float = 0.25,
                 retriable_codes: frozenset = RETRIABLE_CODES,
                 retriable_wire_codes: frozenset = RETRIABLE_WIRE_CODES,
                 rng: random.Random | None = None,
                 sleep=time.sleep):
        if timeout_s is None and max_attempts is None:
            raise ValueError("RetryPolicy needs timeout_s or max_attempts "
                             "(an unbounded retry loop is the bug this "
                             "class exists to prevent)")
        self.timeout_s = timeout_s
        self.max_attempts = max_attempts
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.retriable_codes = retriable_codes
        self.retriable_wire_codes = retriable_wire_codes
        self._rng = rng or random.Random()
        self._sleep = sleep

    # -- classification ------------------------------------------------------
    def retriable(self, failure: object) -> bool:
        """Is this failure worth another attempt? Accepts a Status, a
        Code, a wire code string, an exception, or a response dict with
        a ``code`` key."""
        if failure is None:
            return False
        if isinstance(failure, Status):
            return failure.code in self.retriable_codes
        if isinstance(failure, Code):
            return failure in self.retriable_codes
        if isinstance(failure, str):
            return failure in self.retriable_wire_codes
        if isinstance(failure, dict):
            return self.retriable(failure.get("code"))
        if isinstance(failure, StatusError):
            return failure.status.code in self.retriable_codes
        if isinstance(failure, (TimeoutError, ConnectionError)):
            return True
        return False

    # -- the retry loop driver -----------------------------------------------
    def backoff_s(self, attempt_number: int) -> float:
        """Jittered backoff before attempt ``attempt_number + 1``."""
        base = min(self.max_backoff_s,
                   self.initial_backoff_s
                   * (self.multiplier ** (attempt_number - 1)))
        lo = base * (1.0 - self.jitter)
        hi = base * (1.0 + self.jitter)
        return self._rng.uniform(lo, hi)

    def attempts(self, deadline: Deadline | None = None,
                 timeout_s: float | None = None):
        """Yield ``Attempt``s until the deadline or attempt budget is
        exhausted, sleeping the jittered backoff between yields (never
        past the deadline). The caller returns on success; falling out
        of the loop means the policy gave up."""
        if deadline is None:
            budget = timeout_s if timeout_s is not None else self.timeout_s
            deadline = (Deadline.after(budget) if budget is not None
                        else Deadline.infinite())
        attempt = Attempt(0, deadline)
        while True:
            attempt = Attempt(attempt.number + 1, deadline)
            yield attempt
            if (self.max_attempts is not None
                    and attempt.number >= self.max_attempts):
                return
            pause = self.backoff_s(attempt.number)
            rem = deadline.remaining()
            if rem <= 0:
                return
            self._sleep(min(pause, rem))
            if deadline.expired():
                return

    def call(self, fn, *, deadline: Deadline | None = None,
             timeout_s: float | None = None, describe: str = "rpc"):
        """Run ``fn(attempt)`` until it succeeds or the budget runs out.
        A retriable exception (per ``retriable()``) triggers backoff;
        anything else propagates immediately. Exhaustion re-raises the
        last failure (or DeadlineExpired if nothing ever ran)."""
        last_exc: Exception | None = None
        for attempt in self.attempts(deadline=deadline, timeout_s=timeout_s):
            try:
                return fn(attempt)
            except Exception as e:  # noqa: BLE001 — classified below
                if not self.retriable(e):
                    raise
                last_exc = e
        if last_exc is not None:
            raise last_exc
        raise DeadlineExpired(f"{describe}: no attempt fit the deadline")


# Default policies for the common call shapes; callers with different
# budgets construct their own.
DEFAULT_RPC_POLICY = RetryPolicy(timeout_s=10.0)
