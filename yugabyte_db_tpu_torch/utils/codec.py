"""Compact self-describing binary codec for WAL records and RPC payloads.

Reference analog: protobuf serialization of consensus/log records
(src/yb/consensus/consensus.proto, log.proto). The port's copy of the JAX
package's ``utils/codec.py``: ``encode`` and ``decode`` dispatch to the
port's native ``yb_codec`` (``native/codec.cc``, built at the first call
by ``yugabyte_db_tpu_torch.native``) when it loads, as the JAX module
dispatches to its own, and take the pure-Python path for an integer wider
than 64 bits (the native codec's ``OverflowError``) and wherever the
native codec cannot be built. The pure-Python encoder and decoder
(``_py_encode`` / ``_py_decode``) are its plain version; either gives the
JAX codec's bytes, so a WAL segment or a run file written by either
package reads in the other. The Python is written for speed (dispatch on
the value's exact type, small integers' encodings precomputed, varints
inline). ``encode_run`` / ``decode_run`` give and read a run file's
records (``storage/run_io.py``) from and into version objects through
``encode`` / ``decode`` of the record lists.

Wire grammar (tag byte, then payload):
  N 0x00 | T 0x01 | F 0x02 | I 0x03 varint(zigzag) | D 0x04 8B f64 LE
  S 0x05 varint len + utf8 | B 0x06 varint len + bytes
  L 0x07 varint count + items | M 0x08 varint count + key/value pairs
  X 0x09 varint len + rich-scalar component bytes (models.encoding)
"""

from __future__ import annotations

import struct

(_T_NONE, _T_TRUE, _T_FALSE, _T_INT, _T_F64, _T_STR, _T_BYTES, _T_LIST,
 _T_MAP, _T_EXT) = range(10)

_F64 = struct.Struct("<d")


def _zigzag(v: int) -> int:
    # Arbitrary-precision zigzag: non-negative -> 2v, negative -> -2v-1.
    return (v << 1) if v >= 0 else ((-v - 1) << 1) | 1


def _unzigzag(v: int) -> int:
    return (v >> 1) if not v & 1 else -((v >> 1) + 1)


def _write_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    _write_varint(out, v)
    return bytes(out)


# Every int in [-4096, 4096) encoded once.
_SMALL_INTS = {i: bytes((_T_INT,)) + _varint_bytes(_zigzag(i))
               for i in range(-4096, 4096)}


def _encode_into(out: bytearray, v) -> None:
    t = type(v)
    if t is int:
        b = _SMALL_INTS.get(v)
        if b is not None:
            out += b
            return
        out.append(_T_INT)
        z = (v << 1) if v >= 0 else ((-v - 1) << 1) | 1
        while z >= 0x80:
            out.append((z & 0x7F) | 0x80)
            z >>= 7
        out.append(z)
    elif t is str:
        raw = v.encode("utf-8", "surrogateescape")
        n = len(raw)
        if n < 0x80:
            out.append(_T_STR)
            out.append(n)
        else:
            out.append(_T_STR)
            _write_varint(out, n)
        out += raw
    elif t is float:
        out.append(_T_F64)
        out += _F64.pack(v)
    elif v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif t is list or t is tuple:
        n = len(v)
        if n < 0x80:
            out.append(_T_LIST)
            out.append(n)
        else:
            out.append(_T_LIST)
            _write_varint(out, n)
        for item in v:
            _encode_into(out, item)
    elif t is bytes:
        out.append(_T_BYTES)
        _write_varint(out, len(v))
        out += v
    elif t is dict:
        out.append(_T_MAP)
        _write_varint(out, len(v))
        for k, val in v.items():
            _encode_into(out, k)
            _encode_into(out, val)
    else:
        _encode_other(out, v)


def _encode_other(out: bytearray, v) -> None:
    """Subclasses of the builtin types, and rich scalars."""
    if isinstance(v, int):
        out.append(_T_INT)
        _write_varint(out, _zigzag(v))
    elif isinstance(v, float):
        out.append(_T_F64)
        out += _F64.pack(v)
    elif isinstance(v, str):
        raw = v.encode("utf-8", "surrogateescape")
        out.append(_T_STR)
        _write_varint(out, len(raw))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out.append(_T_BYTES)
        _write_varint(out, len(v))
        out += bytes(v)
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        _write_varint(out, len(v))
        for item in v:
            _encode_into(out, item)
    elif isinstance(v, dict):
        out.append(_T_MAP)
        _write_varint(out, len(v))
        for k, val in v.items():
            _encode_into(out, k)
            _encode_into(out, val)
    else:
        from yugabyte_db_tpu_torch.models.encoding import (
            encode_component_value)

        comp = encode_component_value(v)
        if comp is None:
            raise TypeError(f"codec cannot encode {type(v).__name__}")
        out.append(_T_EXT)
        _write_varint(out, len(comp))
        out += comp


def _py_encode(v) -> bytes:
    out = bytearray()
    _encode_into(out, v)
    return bytes(out)


# The native module: _UNRESOLVED until the first encode or decode resolves
# it (importing this module builds nothing), then the module or None.
_UNRESOLVED = object()
_native = _UNRESOLVED


def _resolve_native():
    global _native
    from yugabyte_db_tpu_torch import native

    _native = native.yb_codec()
    return _native


def native_loaded() -> bool:
    """Whether ``encode`` / ``decode`` go through the native codec (the
    first call builds it)."""
    nat = _native if _native is not _UNRESOLVED else _resolve_native()
    return nat is not None


def encode(v) -> bytes:
    nat = _native if _native is not _UNRESOLVED else _resolve_native()
    if nat is not None:
        try:
            return nat.encode(v)
        except OverflowError:
            pass  # >64-bit int somewhere in v: arbitrary-precision path
    return _py_encode(v)


def _decode_from(buf: bytes, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == _T_INT:
        b = buf[pos]
        pos += 1
        if b < 0x80:
            return ((b >> 1) if not b & 1 else -((b >> 1) + 1)), pos
        z = b & 0x7F
        shift = 7
        while True:
            b = buf[pos]
            pos += 1
            z |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        return ((z >> 1) if not z & 1 else -((z >> 1) + 1)), pos
    if tag == _T_F64:
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag == _T_STR:
        n = buf[pos]
        if n < 0x80:
            pos += 1
        else:
            n, pos = _read_varint(buf, pos)
        return buf[pos:pos + n].decode("utf-8", "surrogateescape"), pos + n
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_LIST:
        n, pos = _read_varint(buf, pos)
        items = []
        append = items.append
        for _ in range(n):
            item, pos = _decode_from(buf, pos)
            append(item)
        return items, pos
    if tag == _T_BYTES:
        n, pos = _read_varint(buf, pos)
        return bytes(buf[pos:pos + n]), pos + n
    if tag == _T_MAP:
        n, pos = _read_varint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _decode_from(buf, pos)
            val, pos = _decode_from(buf, pos)
            d[k] = val
        return d, pos
    if tag == _T_EXT:
        from yugabyte_db_tpu_torch.models.encoding import (
            decode_component_value)

        n, pos = _read_varint(buf, pos)
        return decode_component_value(buf[pos:pos + n]), pos + n
    raise ValueError(f"codec: bad tag 0x{tag:02x} at {pos - 1}")


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _py_decode(buf: bytes):
    v, pos = _decode_from(buf, 0)
    if pos != len(buf):
        raise ValueError(f"codec: {len(buf) - pos} trailing bytes")
    return v


def decode(buf: bytes):
    nat = _native if _native is not _UNRESOLVED else _resolve_native()
    if nat is not None:
        try:
            return nat.decode(buf)
        except OverflowError:
            pass  # varint beyond uint64: arbitrary-precision path
    return _py_decode(buf)


# -- a run file's records --------------------------------------------------
# A run file is ``encode([magic, payload])``, payload
#   [[key, [[ht, tombstone, liveness, {str(col): val}, expire_ht,
#            write_id], ... ht-desc]], ... key-asc]


def encode_run(magic: str, entries) -> bytes:
    """``encode([magic, payload])`` of (key, versions) ``entries`` (each
    version has ``ht``, ``tombstone``, ``liveness``, ``columns``,
    ``expire_ht`` and ``write_id``)."""
    names: dict = {}
    payload = []
    for key, versions in entries:
        recs = []
        for v in versions:
            cols = {}
            for c, x in v.columns.items():
                n = names.get(c)
                if n is None:
                    n = names[c] = str(c)
                cols[n] = x
            recs.append([v.ht, v.tombstone, v.liveness, cols, v.expire_ht,
                         v.write_id])
        payload.append([key, recs])
    return encode([magic, payload])


def decode_run(buf: bytes, magic: str, make) -> list | None:
    """The (key, versions) entries of ``encode_run``'s bytes, each version
    ``make(key, ht, tombstone, liveness, columns, expire_ht, write_id)``
    with int column ids; None when ``buf`` holds another layout (say, an
    older record without the write id), which the caller reads through
    ``decode``."""
    top = decode(buf)
    if type(top) is not list or len(top) != 2 or top[0] != magic:
        return None
    ids: dict = {}
    out = []
    for key, recs in top[1]:
        versions = []
        for r in recs:
            if len(r) != 6:
                return None
            cols = {}
            for c, x in r[3].items():
                i = ids.get(c)
                if i is None:
                    i = ids[c] = int(c)
                cols[i] = x
            versions.append(make(key, r[0], r[1], r[2], cols, r[4], r[5]))
        out.append((key, versions))
    return out
