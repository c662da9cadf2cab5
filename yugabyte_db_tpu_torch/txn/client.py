"""Compatibility shim: the client-side transaction API moved to
``yugabyte_db_tpu_torch.client.transaction``.

TransactionManager/YBTransaction are client code — they drive YBClient
RPCs — so they belong in the client layer; keeping them here put a
client import inside the txn layer (4 layering/upward-import findings).
The server-side machinery (coordinator, participant) stays in this
package, and the shared exception types live in ``txn/errors.py``.

New code should import from ``yugabyte_db_tpu_torch.client.transaction`` (or
``yugabyte_db_tpu_torch.client``); this module re-exports the old names so
existing callers keep working. The one remaining upward import below is
the deliberate, suppressed price of backward compatibility.

The port's copy of the JAX package's ``txn/client.py``, whole.
"""

from __future__ import annotations

# yb-lint: disable=layering/upward-import
from yugabyte_db_tpu_torch.client.transaction import (TransactionManager,
                                                YBTransaction)
from yugabyte_db_tpu_torch.txn.errors import (TransactionAborted,
                                        TransactionConflict)

__all__ = ["TransactionAborted", "TransactionConflict",
           "TransactionManager", "YBTransaction"]
