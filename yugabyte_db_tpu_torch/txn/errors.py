"""Transaction error types.

These live at the bottom of the txn package so both sides of the stack
can raise/catch them without layering violations: the coordinator and
participant (txn layer) raise them upward, and the client-side session
API imports them downward.

The port's copy of the JAX package's ``txn/errors.py``, whole.
"""

from __future__ import annotations


class TransactionConflict(Exception):
    """The transaction lost a conflict and must be retried by the app."""


class TransactionAborted(Exception):
    """The transaction was aborted (expiry, wound, or explicit)."""
