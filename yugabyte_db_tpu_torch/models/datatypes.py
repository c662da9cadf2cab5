"""Logical data types and their device representations.

Reference analog: src/yb/common/ql_type.h / DataType in common.proto. Each
logical type maps to (a) a byte-comparable key encoding (models.encoding),
and (b) a device column representation: a numpy/jax dtype for fixed-width
types, or a varlen byte-pool + 64-bit order-preserving prefix planes for
strings/binary (TPU kernels compare/select on the prefix; the host resolves
rare prefix ties and materializes full bytes).
"""

from __future__ import annotations

import enum

import numpy as np


class DataType(enum.IntEnum):
    NULL = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    FLOAT = 5
    DOUBLE = 6
    BOOL = 7
    STRING = 8
    BINARY = 9
    TIMESTAMP = 10  # micros since epoch, int64 semantics
    COUNTER = 11    # int64 with increment semantics (YCQL counter)
    # Opaque host-resident types: the value lives host-side like a varlen
    # payload (device planes carry a serialized prefix, used only for
    # grouping/equality heuristics; predicates on these are host-only).
    # Collections store normalized python containers (SET as a sorted
    # list, MAP with sorted keys) so replicas serialize identically.
    LIST = 12
    SET = 13
    MAP = 14
    JSONB = 15      # parsed JSON value (reference: common/jsonb.cc)
    # Extended QL scalar surface (reference: common.proto:65-99 DECIMAL/
    # VARINT/INET/UUID/TIMEUUID/DATE/TIME, util/decimal.h ordering,
    # util/uuid.cc comparable encoding). Values are rich host objects
    # (decimal.Decimal, int, yb UUID/Inet wrappers, datetime.date/time,
    # tuples, frozen containers); keys get dedicated byte-comparable
    # encodings (models.encoding), value columns ride the varlen host-
    # payload path (host-exact predicates).
    DECIMAL = 16    # arbitrary-precision decimal (decimal.Decimal)
    VARINT = 17     # arbitrary-precision integer (int)
    UUID = 18       # uuid.UUID, lexicographic byte order
    TIMEUUID = 19   # TimeUuid (v1), ordered by embedded timestamp
    INET = 20       # Inet wrapper (v4 sorts before v6)
    DATE = 21       # datetime.date
    TIME = 22       # datetime.time (ns precision per CQL)
    TUPLE = 23      # python tuple of scalar values
    FROZEN = 24     # frozen collection (normalized list/set/map)

    @property
    def is_fixed_width(self) -> bool:
        return self not in (DataType.STRING, DataType.BINARY,
                            DataType.LIST, DataType.SET, DataType.MAP,
                            DataType.JSONB, DataType.DECIMAL,
                            DataType.VARINT, DataType.UUID,
                            DataType.TIMEUUID, DataType.INET,
                            DataType.DATE, DataType.TIME,
                            DataType.TUPLE, DataType.FROZEN)

    @property
    def is_integer(self) -> bool:
        return self in (
            DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64,
            DataType.TIMESTAMP, DataType.COUNTER,
        )

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self in (DataType.FLOAT, DataType.DOUBLE)

    @property
    def np_dtype(self) -> np.dtype:
        """Host (numpy) storage dtype of a value column of this type."""
        return {
            DataType.INT8: np.dtype(np.int8),
            DataType.INT16: np.dtype(np.int16),
            DataType.INT32: np.dtype(np.int32),
            DataType.INT64: np.dtype(np.int64),
            DataType.TIMESTAMP: np.dtype(np.int64),
            DataType.COUNTER: np.dtype(np.int64),
            DataType.FLOAT: np.dtype(np.float32),
            DataType.DOUBLE: np.dtype(np.float64),
            DataType.BOOL: np.dtype(np.bool_),
        }[self]

    @property
    def device_planes(self) -> int:
        """Number of int32/float32 planes this type occupies device-side.

        int64-family and double columns ship as two 32-bit planes (TPU has no
        cheap 64-bit); varlen types ship as two planes of order-preserving
        8-byte prefix.
        """
        if not self.is_fixed_width:
            return 2
        if self.np_dtype.itemsize == 8:
            return 2
        return 1

    @staticmethod
    def parse(name: str) -> "DataType":
        aliases = {
            "DECIMAL": DataType.DECIMAL,
            "NUMERIC": DataType.DECIMAL,
            "VARINT": DataType.VARINT,
            "UUID": DataType.UUID,
            "TIMEUUID": DataType.TIMEUUID,
            "INET": DataType.INET,
            "DATE": DataType.DATE,
            "TIME": DataType.TIME,
            "TUPLE": DataType.TUPLE,
            "FROZEN": DataType.FROZEN,
            "INT8": DataType.INT8,
            "INT16": DataType.INT16,
            "INT64": DataType.INT64,
            "TINYINT": DataType.INT8,
            "SMALLINT": DataType.INT16,
            "INT": DataType.INT32,
            "INT32": DataType.INT32,
            "INTEGER": DataType.INT32,
            "BIGINT": DataType.INT64,
            "FLOAT": DataType.FLOAT,
            "REAL": DataType.FLOAT,
            "DOUBLE": DataType.DOUBLE,
            "BOOLEAN": DataType.BOOL,
            "BOOL": DataType.BOOL,
            "TEXT": DataType.STRING,
            "VARCHAR": DataType.STRING,
            "STRING": DataType.STRING,
            "BLOB": DataType.BINARY,
            "BINARY": DataType.BINARY,
            "TIMESTAMP": DataType.TIMESTAMP,
            "COUNTER": DataType.COUNTER,
            "LIST": DataType.LIST,
            "SET": DataType.SET,
            "MAP": DataType.MAP,
            "JSONB": DataType.JSONB,
        }
        key = name.strip().upper()
        if key not in aliases:
            raise ValueError(f"unknown data type: {name}")
        return aliases[key]


class TimeUuid:
    """A v1 (time-based) UUID ordered by its embedded timestamp, then
    raw bytes — CQL timeuuid comparison semantics (reference:
    src/yb/util/uuid.cc ToComparable's time-component reordering)."""

    __slots__ = ("u",)

    def __init__(self, u):
        import uuid as _uuid

        self.u = u if isinstance(u, _uuid.UUID) else _uuid.UUID(str(u))

    @property
    def bytes(self) -> bytes:
        return self.u.bytes

    def sort_key(self):
        return (self.u.time, self.u.bytes)

    def __eq__(self, other):
        o = other.u if isinstance(other, TimeUuid) else other
        return self.u == o

    def __hash__(self):
        return hash(self.u)

    def __lt__(self, other):
        return self.sort_key() < TimeUuid(
            other.u if isinstance(other, TimeUuid) else other).sort_key()

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        return not self <= other

    def __ge__(self, other):
        return not self < other

    def __str__(self):
        return str(self.u)

    def __repr__(self):
        return f"TimeUuid('{self.u}')"


class Inet:
    """An IPv4/IPv6 address; v4 sorts before v6, then by packed bytes
    (one column may mix families — plain ipaddress objects refuse to
    compare across versions)."""

    __slots__ = ("version", "packed")

    def __init__(self, addr):
        import ipaddress

        if isinstance(addr, Inet):
            self.version, self.packed = addr.version, addr.packed
            return
        a = ipaddress.ip_address(addr)
        self.version = a.version
        self.packed = a.packed

    def __eq__(self, other):
        o = Inet(other) if not isinstance(other, Inet) else other
        return (self.version, self.packed) == (o.version, o.packed)

    def __hash__(self):
        return hash((self.version, self.packed))

    def __lt__(self, other):
        o = Inet(other) if not isinstance(other, Inet) else other
        return (self.version, self.packed) < (o.version, o.packed)

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        return not self <= other

    def __ge__(self, other):
        return not self < other

    def __str__(self):
        import ipaddress

        return str(ipaddress.ip_address(self.packed))

    def __repr__(self):
        return f"Inet('{self}')"


def python_value_matches(dtype: DataType, value) -> bool:
    """Loose runtime type check for a python value against a logical type."""
    import datetime
    import decimal
    import uuid as _uuid

    if value is None:
        return True
    if dtype == DataType.DECIMAL:
        return isinstance(value, (decimal.Decimal, int))
    if dtype == DataType.VARINT:
        return isinstance(value, int) and not isinstance(value, bool)
    if dtype == DataType.UUID:
        return isinstance(value, (_uuid.UUID, TimeUuid))
    if dtype == DataType.TIMEUUID:
        return isinstance(value, (TimeUuid, _uuid.UUID))
    if dtype == DataType.INET:
        return isinstance(value, Inet)
    if dtype == DataType.DATE:
        return isinstance(value, datetime.date) and \
            not isinstance(value, datetime.datetime)
    if dtype == DataType.TIME:
        return isinstance(value, datetime.time)
    if dtype == DataType.TUPLE:
        return isinstance(value, tuple)
    if dtype == DataType.FROZEN:
        return isinstance(value, (list, dict, tuple, set, frozenset))
    if dtype.is_integer:
        return isinstance(value, int) and not isinstance(value, bool)
    if dtype in (DataType.FLOAT, DataType.DOUBLE):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if dtype == DataType.BOOL:
        return isinstance(value, bool)
    if dtype == DataType.STRING:
        return isinstance(value, str)
    if dtype == DataType.BINARY:
        return isinstance(value, (bytes, bytearray))
    if dtype == DataType.LIST:
        return isinstance(value, list)
    if dtype == DataType.SET:
        return isinstance(value, (list, set, frozenset))
    if dtype == DataType.MAP:
        return isinstance(value, dict)
    if dtype == DataType.JSONB:
        return isinstance(value, (dict, list, str, int, float, bool))
    return False
