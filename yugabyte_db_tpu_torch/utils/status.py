"""Status error-propagation primitives.

Reference analog: src/yb/util/status.h. The port's copy of the part of the
JAX package's ``utils/status.py`` that the tablet and the engine read: the
``Code`` enum, the ``Status`` value, the ``StatusError`` exception carrying
one, ``InvalidArgument`` and ``NotFound`` (``auth.RoleStore``),
``AlreadyPresent`` (the tablet's ``if_not_exists`` write, a role created
twice),
``IllegalState`` (``fs``'s data-directory identity) and ``TabletSplit``
(the tablet peer's writes to a sealed tablet). Left out:
the other exception classes and the ``Status`` constructors, which only
the RPC and query layers use (ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Code(enum.IntEnum):
    OK = 0
    NOT_FOUND = 1
    CORRUPTION = 2
    NOT_SUPPORTED = 3
    INVALID_ARGUMENT = 4
    IO_ERROR = 5
    ALREADY_PRESENT = 6
    RUNTIME_ERROR = 7
    NETWORK_ERROR = 8
    ILLEGAL_STATE = 9
    NOT_AUTHORIZED = 10
    ABORTED = 11
    REMOTE_ERROR = 12
    SERVICE_UNAVAILABLE = 13
    TIMED_OUT = 14
    UNINITIALIZED = 15
    CONFIGURATION_ERROR = 16
    INCOMPLETE = 17
    END_OF_FILE = 18
    INTERNAL_ERROR = 19
    EXPIRED = 20
    LEADER_NOT_READY = 21
    LEADER_HAS_NO_LEASE = 22
    TRY_AGAIN = 23
    QL_ERROR = 24


@dataclass(frozen=True)
class Status:
    code: Code = Code.OK
    message: str = ""
    # Optional structured payload (e.g. CQL error code) for the wire protocols.
    payload: dict = field(default_factory=dict)

    @property
    def is_ok(self) -> bool:
        return self.code == Code.OK

    def __bool__(self) -> bool:
        return self.is_ok

    def __str__(self) -> str:
        if self.is_ok:
            return "OK"
        return f"{self.code.name}: {self.message}"

    def raise_if_error(self) -> "Status":
        if not self.is_ok:
            raise StatusError(self)
        return self


class StatusError(Exception):
    """Exception carrying a Status, for in-process error propagation."""

    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


class InvalidArgument(StatusError):
    def __init__(self, message: str):
        super().__init__(Status(Code.INVALID_ARGUMENT, message))


class NotFound(StatusError):
    def __init__(self, message: str):
        super().__init__(Status(Code.NOT_FOUND, message))


class AlreadyPresent(StatusError):
    def __init__(self, message: str):
        super().__init__(Status(Code.ALREADY_PRESENT, message))


class IllegalState(StatusError):
    def __init__(self, message: str):
        super().__init__(Status(Code.ILLEGAL_STATE, message))


class TabletSplit(StatusError):
    """The addressed tablet has been sealed for (or replaced by) a
    split: the caller's location entry is stale at TABLET granularity.
    Carries the split tablet's id so the client can invalidate exactly
    that entry and re-plan from fresh locations (reference: the
    TABLET_SPLIT error of tserver_error.h driving per-tablet meta-cache
    invalidation in client-side LookupRpc retries)."""

    def __init__(self, tablet_id: str):
        super().__init__(Status(Code.ILLEGAL_STATE,
                                f"tablet {tablet_id} has been split",
                                {"tablet_id": tablet_id}))
        self.tablet_id = tablet_id
