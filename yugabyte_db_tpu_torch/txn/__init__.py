"""Distributed transactions: the coordinator and the participant.

Reference analog: the transaction stack of src/yb/tablet/
transaction_coordinator.cc (status-tablet state machine) and
transaction_participant.cc (per-tablet intents + apply). The port's copy
of the JAX package's ``txn`` package as far as the tablet reads it: every
tablet builds a participant, the status table's tablets a coordinator.
Left out: the JAX ``txn/__init__``'s lazy re-export of the client-side
session API (``client.transaction``), which comes with the client
(ROADMAP.md §1 item 16).
"""

from yugabyte_db_tpu_torch.txn.coordinator import (TXN_STATUS_TABLE,
                                                   TransactionCoordinator)
from yugabyte_db_tpu_torch.txn.errors import (TransactionAborted,
                                              TransactionConflict)
from yugabyte_db_tpu_torch.txn.participant import (IntentConflict,
                                                   TransactionParticipant)

__all__ = [
    "IntentConflict",
    "TransactionAborted",
    "TransactionConflict",
    "TransactionCoordinator",
    "TransactionParticipant",
    "TXN_STATUS_TABLE",
]
