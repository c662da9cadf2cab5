"""Byte-comparable key encoding: the DocKey of the framework.

Reference analog: src/yb/docdb/doc_key.h:68 (DocKey), primitive_value.cc
(PrimitiveValue::AppendToKey), value_type.h:31-140 (ValueType tags),
src/yb/util/memcmpable_varint.cc. The invariant this module guarantees —
and the whole TPU data plane rests on — is:

    memcmp(encode(a), encode(b))  ==  logical_compare(a, b)

so that device kernels can compare fixed-width big-endian word prefixes of
encoded keys with plain int32 signed comparisons (after bias-flip, see
utils.planes) and reproduce logical key order.

Layout of an encoded DocKey (hash-partitioned table):

    [kHash][2-byte partition hash BE] [hashed components]* [kGroupEnd]
    [range components]* [kGroupEnd]

and for range-partitioned tables the hash prelude is omitted. Each component
is [type tag][payload]; tag values are chosen so kGroupEnd sorts before every
component tag (a shorter key group is a strict prefix and must sort first),
and NULL sorts before all values of a column.

Unlike the reference, the MVCC hybrid time is *not* appended to the key
(reference SubDocKey suffixes a descending-encoded DocHybridTime): columnar
blocks store (key, commit_ht) in separate planes and sort by (key asc,
ht desc) explicitly, which is what the device kernels want.
"""

from __future__ import annotations

import struct

from yugabyte_db_tpu_torch.models.datatypes import DataType

# Type tags. Ordering constraints:
#   GROUP_END < NULL < FALSE < TRUE < INT < DOUBLE-family < STRING < BINARY
# GROUP_END lowest so shorter composite keys sort first; NULL lowest within a
# column so nulls sort first (CQL semantics).
GROUP_END = 0x01
TAG_NULL = 0x04
TAG_FALSE = 0x10
TAG_TRUE = 0x11
TAG_INT = 0x20      # all integer types normalize to int64 in keys
TAG_DATE = 0x22     # days since epoch, offset-binary uint32
TAG_TIME = 0x23     # nanoseconds since midnight, uint64
TAG_DECIMAL = 0x24  # comparable decimal (util/decimal.h semantics)
TAG_VARINT = 0x26   # comparable arbitrary-precision integer
TAG_DOUBLE = 0x28   # float/double normalize to float64 in keys
TAG_STRING = 0x30
TAG_BINARY = 0x32
TAG_UUID = 0x34     # 16 raw bytes (lexicographic)
TAG_TIMEUUID = 0x35  # [8B v1 timestamp][16 raw bytes]
TAG_INET = 0x36     # [version byte][packed address]
TAG_TUPLE = 0x38    # components (value-inferred tags) + GROUP_END
TAG_FROZEN = 0x3A   # [container kind][components] + GROUP_END
TAG_HASH = 0x08     # 2-byte partition-hash prelude (reference kUInt16Hash)

_STRING_TERM = b"\x00\x00"


# -- comparable varint / decimal (reference: util/decimal.h ordering,
#    util/memcmpable_varint.cc technique restated) ---------------------------

def _encode_cmp_varint(v: int) -> bytes:
    """Arbitrary-precision int -> self-delimiting bytes whose memcmp
    order is numeric order: [0xC0+n][n-byte magnitude] for v >= 0,
    [0x3F-n][complemented magnitude] for v < 0 (longer negative
    magnitudes get smaller prefixes; magnitudes <= 62 bytes, i.e.
    ~496 bits — plenty beyond the reference's practical range)."""
    if v >= 0:
        mag = v.to_bytes((v.bit_length() + 7) // 8, "big") if v else b""
        if len(mag) > 62:
            raise ValueError("varint key value too large")
        return bytes([0xC0 + len(mag)]) + mag
    m = -v
    mag = m.to_bytes((m.bit_length() + 7) // 8, "big")
    if len(mag) > 62:
        raise ValueError("varint key value too large")
    return bytes([0x3F - len(mag)]) + bytes(0xFF - b for b in mag)


def _decode_cmp_varint(buf: bytes, pos: int) -> tuple[int, int]:
    first = buf[pos]
    pos += 1
    if first >= 0xC0:
        n = first - 0xC0
        mag = buf[pos:pos + n]
        return (int.from_bytes(mag, "big") if n else 0), pos + n
    n = 0x3F - first
    mag = bytes(0xFF - b for b in buf[pos:pos + n])
    return -int.from_bytes(mag, "big"), pos + n


def _encode_decimal(value) -> bytes:
    """decimal.Decimal -> comparable payload: class byte (0x10 neg /
    0x20 zero / 0x30 pos), then comparable (adjusted exponent, digit
    string) — negatives complemented so order reverses. Matches the
    reference's ordering contract (src/yb/util/decimal.h): trailing
    zeros are insignificant, exponent dominates, digits tiebreak."""
    import decimal

    d = decimal.Decimal(value)
    if d.is_nan() or d.is_infinite():
        raise ValueError("NaN/Infinity decimals are not storable")
    if d == 0:
        return b"\x20"
    sign, digits, exp = d.normalize().as_tuple()
    adj = exp + len(digits) - 1
    body = _encode_cmp_varint(adj) + bytes(dd + 1 for dd in digits) \
        + b"\x00"
    if sign:
        return b"\x10" + bytes(0xFF - b for b in body)
    return b"\x30" + body


def _decode_decimal(buf: bytes, pos: int):
    import decimal

    cls = buf[pos]
    pos += 1
    if cls == 0x20:
        return decimal.Decimal(0), pos
    neg = cls == 0x10
    if neg:
        # Complement lazily: find the complemented terminator (0xFF).
        first = 0xFF - buf[pos]
        n = (first - 0xC0) if first >= 0xC0 else (0x3F - first)
        vpos = pos + 1 + n
        adj, _ = _decode_cmp_varint(
            bytes(0xFF - b for b in buf[pos:vpos]), 0)
        digits = []
        while buf[vpos] != 0xFF:
            digits.append((0xFF - buf[vpos]) - 1)
            vpos += 1
        pos = vpos + 1
    else:
        adj, vpos = _decode_cmp_varint(buf, pos)
        digits = []
        while buf[vpos] != 0x00:
            digits.append(buf[vpos] - 1)
            vpos += 1
        pos = vpos + 1
    ds = "".join(str(dd) for dd in digits)
    text = f"{'-' if neg else ''}{ds[0]}.{ds[1:] or '0'}E{adj}"
    return decimal.Decimal(text).normalize(), pos


def _infer_component_dtype(value) -> DataType:
    """Runtime dtype of a tuple/frozen element (elements self-describe
    via their tags, so nested containers need no schema plumbing)."""
    import datetime
    import decimal
    import uuid as _uuid

    from yugabyte_db_tpu_torch.models.datatypes import Inet, TimeUuid

    if isinstance(value, bool):
        return DataType.BOOL
    if isinstance(value, int):
        return DataType.INT64
    if isinstance(value, float):
        return DataType.DOUBLE
    if isinstance(value, str):
        return DataType.STRING
    if isinstance(value, (bytes, bytearray)):
        return DataType.BINARY
    if isinstance(value, decimal.Decimal):
        return DataType.DECIMAL
    if isinstance(value, TimeUuid):
        return DataType.TIMEUUID
    if isinstance(value, _uuid.UUID):
        return DataType.UUID
    if isinstance(value, Inet):
        return DataType.INET
    if isinstance(value, datetime.datetime):
        raise ValueError("datetime not valid in a key component")
    if isinstance(value, datetime.date):
        return DataType.DATE
    if isinstance(value, datetime.time):
        return DataType.TIME
    if isinstance(value, tuple):
        return DataType.TUPLE
    if isinstance(value, (list, set, frozenset, dict)):
        return DataType.FROZEN
    raise ValueError(f"cannot infer key dtype of {type(value)}")


def _encode_int64(v: int) -> bytes:
    if not -(1 << 63) <= v < (1 << 63):
        raise ValueError(f"integer key value out of int64 range: {v}")
    # Sign-flip to map signed order onto unsigned byte order.
    return struct.pack(">Q", v + (1 << 63))


def _decode_int64(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - (1 << 63)


def _encode_double(v: float) -> bytes:
    v = float(v)
    if v == 0.0:
        v = 0.0  # canonicalize -0.0: logically equal keys must encode equal
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)      # negative: flip all bits
    else:
        bits |= 1 << 63                      # positive: flip sign bit
    return struct.pack(">Q", bits)


def _decode_double(b: bytes) -> float:
    bits = struct.unpack(">Q", b)[0]
    if bits & (1 << 63):
        bits &= ~(1 << 63) & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _encode_str_bytes(raw: bytes) -> bytes:
    # Escape embedded NULs (0x00 -> 0x00 0x01) and terminate with 0x00 0x00,
    # keeping byte order == lexicographic order on the raw bytes
    # (reference: primitive_value.cc ZeroEncodeAndAppendStrToKey).
    return raw.replace(b"\x00", b"\x00\x01") + _STRING_TERM


def _decode_str_bytes(buf: bytes, pos: int) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        nxt = buf.index(b"\x00", pos)
        out += buf[pos:nxt]
        marker = buf[nxt + 1]
        if marker == 0x00:
            return bytes(out), nxt + 2
        if marker != 0x01:
            raise ValueError("corrupt string encoding")
        out.append(0)
        pos = nxt + 2


def encode_key_component(value, dtype: DataType) -> bytes:
    """Encode one key column value as [tag][payload]."""
    if value is None:
        return bytes([TAG_NULL])
    if dtype == DataType.BOOL:
        return bytes([TAG_TRUE if value else TAG_FALSE])
    if dtype == DataType.DATE:
        import datetime

        days = (value - datetime.date(1970, 1, 1)).days
        return bytes([TAG_DATE]) + struct.pack(">I", days + (1 << 31))
    if dtype == DataType.TIME:
        ns = ((value.hour * 60 + value.minute) * 60
              + value.second) * 10**9 + value.microsecond * 1000
        return bytes([TAG_TIME]) + struct.pack(">Q", ns)
    if dtype.is_integer:
        return bytes([TAG_INT]) + _encode_int64(int(value))
    if dtype == DataType.VARINT:
        return bytes([TAG_VARINT]) + _encode_cmp_varint(int(value))
    if dtype == DataType.DECIMAL:
        return bytes([TAG_DECIMAL]) + _encode_decimal(value)
    if dtype in (DataType.FLOAT, DataType.DOUBLE):
        return bytes([TAG_DOUBLE]) + _encode_double(float(value))
    if dtype == DataType.STRING:
        return bytes([TAG_STRING]) + _encode_str_bytes(
            value.encode("utf-8", "surrogateescape"))
    if dtype == DataType.BINARY:
        return bytes([TAG_BINARY]) + _encode_str_bytes(bytes(value))
    if dtype == DataType.UUID:
        return bytes([TAG_UUID]) + value.bytes  # UUID or TimeUuid
    if dtype == DataType.TIMEUUID:
        from yugabyte_db_tpu_torch.models.datatypes import TimeUuid

        tu = value if isinstance(value, TimeUuid) else TimeUuid(value)
        return bytes([TAG_TIMEUUID]) + struct.pack(">Q", tu.u.time) \
            + tu.bytes
    if dtype == DataType.INET:
        from yugabyte_db_tpu_torch.models.datatypes import Inet

        inet = value if isinstance(value, Inet) else Inet(value)
        return bytes([TAG_INET, inet.version]) + inet.packed
    if dtype == DataType.TUPLE:
        out = bytearray([TAG_TUPLE])
        for el in value:
            out += encode_key_component(
                el, _infer_component_dtype(el) if el is not None
                else DataType.NULL)
        out.append(GROUP_END)
        return bytes(out)
    if dtype == DataType.FROZEN:
        return bytes([TAG_FROZEN]) + _encode_frozen(value)
    raise ValueError(f"type {dtype} not valid in a key")


def _encode_frozen(value) -> bytes:
    """Canonical comparable bytes of a frozen container: kind byte
    (list 0x05 / set 0x06 / map 0x07), then self-describing element
    components, GROUP_END-terminated (sets sorted; maps sorted by key,
    flattened k,v — CQL frozen-collection comparison semantics)."""
    def comp(el):
        return encode_key_component(
            el, _infer_component_dtype(el) if el is not None
            else DataType.NULL)

    out = bytearray()
    if isinstance(value, (list, tuple)):
        out.append(0x05)
        items = list(value)
    elif isinstance(value, (set, frozenset)):
        out.append(0x06)
        items = sorted(value, key=comp)
    elif isinstance(value, dict):
        out.append(0x07)
        items = []
        for k in sorted(value, key=comp):
            items += [k, value[k]]
    else:
        raise ValueError(f"not a frozen container: {type(value)}")
    for el in items:
        out += comp(el)
    out.append(GROUP_END)
    return bytes(out)


def decode_key_component(buf: bytes, pos: int) -> tuple[object, int]:
    """Decode one component at pos -> (python value, new pos)."""
    tag = buf[pos]
    pos += 1
    if tag == TAG_NULL:
        return None, pos
    if tag == TAG_FALSE:
        return False, pos
    if tag == TAG_TRUE:
        return True, pos
    if tag == TAG_INT:
        return _decode_int64(buf[pos:pos + 8]), pos + 8
    if tag == TAG_DATE:
        import datetime

        days = struct.unpack(">I", buf[pos:pos + 4])[0] - (1 << 31)
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=days)), pos + 4
    if tag == TAG_TIME:
        import datetime

        ns = struct.unpack(">Q", buf[pos:pos + 8])[0]
        us, _ = divmod(ns, 1000)
        s, us = divmod(us, 10**6)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        return datetime.time(h, m, s, us), pos + 8
    if tag == TAG_VARINT:
        return _decode_cmp_varint(buf, pos)
    if tag == TAG_DECIMAL:
        return _decode_decimal(buf, pos)
    if tag == TAG_DOUBLE:
        return _decode_double(buf[pos:pos + 8]), pos + 8
    if tag == TAG_STRING:
        raw, pos = _decode_str_bytes(buf, pos)
        return raw.decode("utf-8", "surrogateescape"), pos
    if tag == TAG_BINARY:
        return _decode_str_bytes(buf, pos)
    if tag == TAG_UUID:
        import uuid as _uuid

        return _uuid.UUID(bytes=bytes(buf[pos:pos + 16])), pos + 16
    if tag == TAG_TIMEUUID:
        from yugabyte_db_tpu_torch.models.datatypes import TimeUuid
        import uuid as _uuid

        raw = bytes(buf[pos + 8:pos + 24])
        return TimeUuid(_uuid.UUID(bytes=raw)), pos + 24
    if tag == TAG_INET:
        from yugabyte_db_tpu_torch.models.datatypes import Inet

        version = buf[pos]
        n = 4 if version == 4 else 16
        return Inet(bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if tag == TAG_TUPLE:
        out = []
        while buf[pos] != GROUP_END:
            v, pos = decode_key_component(buf, pos)
            out.append(v)
        return tuple(out), pos + 1
    if tag == TAG_FROZEN:
        kind = buf[pos]
        pos += 1
        items = []
        while buf[pos] != GROUP_END:
            v, pos = decode_key_component(buf, pos)
            items.append(v)
        pos += 1
        if kind == 0x05:
            return items, pos
        if kind == 0x06:
            return items, pos  # sets normalize to sorted lists
        pairs = dict(zip(items[::2], items[1::2]))
        return pairs, pos
    raise ValueError(f"unknown key tag 0x{tag:02x} at {pos - 1}")


def encode_doc_key(hash_code: int | None,
                   hashed_components: list[tuple[object, DataType]],
                   range_components: list[tuple[object, DataType]]) -> bytes:
    """Encode a full DocKey. hash_code is the uint16 partition hash, or None
    for range-partitioned tables (reference doc_key.cc DocKey::AppendTo)."""
    return encode_doc_key_prefix(
        hash_code, hashed_components, range_components) + bytes([GROUP_END])


def encode_doc_key_prefix(hash_code: int | None,
                          hashed_components: list[tuple[object, DataType]],
                          range_components: list[tuple[object, DataType]]) -> bytes:
    """Encode a key *prefix* (for range scans bounded on leading range
    columns): like encode_doc_key but without the trailing GROUP_END, so all
    keys extending the given range components share this byte prefix."""
    out = bytearray()
    if hash_code is None:
        if hashed_components:
            raise ValueError("hashed components require a hash_code")
    else:
        out.append(TAG_HASH)
        out += struct.pack(">H", hash_code & 0xFFFF)
        for value, dtype in hashed_components:
            out += encode_key_component(value, dtype)
        out.append(GROUP_END)
    for value, dtype in range_components:
        out += encode_key_component(value, dtype)
    return bytes(out)


def decode_doc_key(buf: bytes) -> tuple[int | None, list, list]:
    """Decode -> (hash_code, hashed values, range values)."""
    pos = 0
    hash_code = None
    hashed: list = []
    if buf and buf[0] == TAG_HASH:
        hash_code = struct.unpack(">H", buf[1:3])[0]
        pos = 3
        while buf[pos] != GROUP_END:
            value, pos = decode_key_component(buf, pos)
            hashed.append(value)
        pos += 1
    ranges: list = []
    while pos < len(buf) and buf[pos] != GROUP_END:
        value, pos = decode_key_component(buf, pos)
        ranges.append(value)
    return hash_code, hashed, ranges


def full_doc_key_of(buf: bytes, num_hash: int,
                    num_range: int) -> bytes | None:
    """The canonical FULL doc key when ``buf`` binds every key column,
    else None. Accepts both spellings: the full encoded key (trailing
    GROUP_END) and the all-components-bound prefix
    (encode_doc_key_prefix output, no terminator) — the prefix gets its
    terminator appended. Used to classify exact-key reads."""
    pos = 0
    hashed = 0
    if num_hash:
        if not buf or buf[0] != TAG_HASH:
            return None
        pos = 3
        try:
            while pos < len(buf) and buf[pos] != GROUP_END:
                _v, pos = decode_key_component(buf, pos)
                hashed += 1
        except Exception:  # noqa: BLE001 — not a decodable key
            return None
        if pos >= len(buf) or hashed != num_hash:
            return None
        pos += 1  # hashed-section GROUP_END
    ranges = 0
    try:
        while pos < len(buf) and buf[pos] != GROUP_END:
            _v, pos = decode_key_component(buf, pos)
            ranges += 1
    except Exception:  # noqa: BLE001
        return None
    if ranges != num_range:
        return None
    if pos == len(buf):
        return buf + bytes([GROUP_END])  # prefix form
    if pos == len(buf) - 1 and buf[pos] == GROUP_END:
        return buf  # already the full key
    return None


def hashed_prefix(buf: bytes) -> bytes:
    """The hashed-components section of an encoded key, INCLUDING its
    terminating GROUP_END — the unit the run bloom filters key on
    (reference: DocDbAwareFilterPolicy's hash-prefix extraction,
    src/yb/docdb/doc_key.h:551-575). b'' for range-partitioned keys
    (no hash section -> filter does not apply)."""
    if not buf or buf[0] != TAG_HASH:
        return b""
    pos = 3
    while pos < len(buf) and buf[pos] != GROUP_END:
        _v, pos = decode_key_component(buf, pos)
    return bytes(buf[:pos + 1])


_EXT_TYPES = None


def encode_component_value(v) -> bytes | None:
    """Rich QL scalar -> its byte-comparable component bytes, or None
    when v is not one (the tagged codec's T_EXT payload; utils/codec.py
    and native/tagcodec.h both call this)."""
    global _EXT_TYPES
    if _EXT_TYPES is None:
        import datetime
        import decimal
        import uuid as _uuid

        from yugabyte_db_tpu_torch.models.datatypes import Inet, TimeUuid

        _EXT_TYPES = (decimal.Decimal, _uuid.UUID, TimeUuid, Inet,
                      datetime.date, datetime.time)
    if not isinstance(v, _EXT_TYPES):
        return None
    return encode_key_component(v, _infer_component_dtype(v))


def decode_component_value(raw: bytes):
    """T_EXT payload -> the rich scalar value."""
    v, _pos = decode_key_component(raw, 0)
    return v


def prefix_successor(prefix: bytes) -> bytes:
    """Smallest byte string greater than every string with this prefix.

    Empty result means "no upper bound" (prefix was all 0xFF). Used to turn a
    key prefix into an exclusive scan upper bound (reference analog:
    rocksdb iterate_upper_bound construction)."""
    b = bytearray(prefix)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return b""
