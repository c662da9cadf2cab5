"""Distributed transactions: the coordinator and the participant.

Reference analog: the transaction stack of src/yb/tablet/
transaction_coordinator.cc (status-tablet state machine) and
transaction_participant.cc (per-tablet intents + apply). The port's copy
of the JAX package's ``txn`` package, whole: every tablet builds a
participant, the status table's tablets a coordinator, and the
client-side session API (``client.transaction``) is re-exported lazily,
as in the JAX package.
"""

from yugabyte_db_tpu_torch.txn.coordinator import (TXN_STATUS_TABLE,
                                                   TransactionCoordinator)
from yugabyte_db_tpu_torch.txn.errors import (TransactionAborted,
                                              TransactionConflict)
from yugabyte_db_tpu_torch.txn.participant import (IntentConflict,
                                                   TransactionParticipant)


def __getattr__(name):
    # Lazy re-export of the client-side session API, which lives in
    # yugabyte_db_tpu_torch.client.transaction. Loading it eagerly here
    # would recurse: client.transaction imports txn.coordinator, which
    # runs this package __init__ first.
    if name in ("TransactionManager", "YBTransaction"):
        from yugabyte_db_tpu_torch.client import transaction
        return getattr(transaction, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "IntentConflict",
    "TransactionAborted",
    "TransactionConflict",
    "TransactionCoordinator",
    "TransactionManager",
    "TransactionParticipant",
    "TXN_STATUS_TABLE",
    "YBTransaction",
]
