"""Compact self-describing binary codec for WAL records and RPC payloads.

Reference analog: protobuf serialization of consensus/log records
(src/yb/consensus/consensus.proto, log.proto). The port's copy of the JAX
package's ``utils/codec.py``, the pure-Python encoder and decoder only
(the JAX module's fallback when its native ``yb_codec`` is missing): the
bytes are the JAX codec's, so a WAL segment or a run file written by
either package reads in the other. The native codec waits for ROADMAP.md
§1 item 16. The Python here is written for speed (dispatch on the value's
exact type, small integers' encodings precomputed, varints inline) and
gives the JAX module's bytes, which ``tests/test_torch_wal.py`` holds.
``encode_run`` / ``decode_run`` give and read a run file's records
(``storage/run_io.py``) straight from and into version objects, the same
bytes as ``encode`` / ``decode`` of the record lists.

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


def encode(v) -> bytes:
    out = bytearray()
    _encode_into(out, v)
    return bytes(out)


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


def decode(buf: bytes):
    v, pos = _decode_from(buf, 0)
    if pos != len(buf):
        raise ValueError(f"codec: {len(buf) - pos} trailing bytes")
    return v


# -- a run file's records --------------------------------------------------
# A run file is ``encode([magic, payload])``, payload
#   [[key, [[ht, tombstone, liveness, {str(col): val}, expire_ht,
#            write_id], ... ht-desc]], ... key-asc]
# Its layout is fixed, so ``encode_run`` encodes a record's head (hybrid
# time, flags, column count) and tail (expiry, write id) once for each
# distinct value and sends only the column values through the encoder,
# and ``decode_run`` reads the records without building the lists.


def encode_run(magic: str, entries) -> bytes:
    """``encode([magic, payload])`` of (key, versions) ``entries`` (each
    version has ``ht``, ``tombstone``, ``liveness``, ``columns``,
    ``expire_ht`` and ``write_id``), written straight from the versions."""
    out = bytearray((_T_LIST, 2))
    _encode_into(out, magic)
    out.append(_T_LIST)
    _write_varint(out, len(entries))
    small = _SMALL_INTS
    pack = _F64.pack
    heads: dict = {}
    tails: dict = {}
    colkeys: dict = {}
    for key, versions in entries:
        out.append(_T_LIST)
        out.append(2)
        if type(key) is bytes and len(key) < 0x80:
            out.append(_T_BYTES)
            out.append(len(key))
            out += key
        else:
            _encode_into(out, key)
        out.append(_T_LIST)
        _write_varint(out, len(versions))
        for v in versions:
            cols = v.columns
            ht, tomb, live = v.ht, v.tombstone, v.liveness
            if type(ht) is int and type(tomb) is bool \
                    and type(live) is bool:
                hk = (ht, tomb, live, len(cols))
                head = heads.get(hk)
                if head is None:
                    head = heads[hk] = _record_head(ht, tomb, live, len(cols))
                out += head
            else:
                out += _record_head(ht, tomb, live, len(cols))
            for c, val in cols.items():
                ck = colkeys.get(c)
                if ck is None:
                    ck = colkeys[c] = encode(str(c))
                out += ck
                t = type(val)
                if t is int:
                    b = small.get(val)
                    if b is not None:
                        out += b
                        continue
                    out.append(_T_INT)
                    z = (val << 1) if val >= 0 else ((-val - 1) << 1) | 1
                    while z >= 0x80:
                        out.append((z & 0x7F) | 0x80)
                        z >>= 7
                    out.append(z)
                elif t is float:
                    out.append(_T_F64)
                    out += pack(val)
                else:
                    _encode_into(out, val)
            exp, wid = v.expire_ht, v.write_id
            if type(exp) is int and type(wid) is int:
                tk = (exp, wid)
                tail = tails.get(tk)
                if tail is None:
                    tail = tails[tk] = encode(exp) + encode(wid)
                out += tail
            else:
                out += encode(exp) + encode(wid)
    return bytes(out)


def _record_head(ht, tomb, live, ncols: int) -> bytes:
    """A record's bytes up to its column map's entries."""
    out = bytearray((_T_LIST, 6))
    for x in (ht, tomb, live):
        _encode_into(out, x)
    out.append(_T_MAP)
    _write_varint(out, ncols)
    return bytes(out)


class _OtherLayout(Exception):
    """The bytes are not in the layout ``decode_run`` reads."""


def decode_run(buf: bytes, magic: str, make) -> list | None:
    """The (key, versions) entries of ``encode_run``'s bytes, each version
    ``make(key, ht, tombstone, liveness, columns, expire_ht, write_id)``
    with int column ids; None when ``buf`` holds another layout (say, an
    older record without the write id), which ``decode`` reads."""
    try:
        return _decode_run(buf, magic, make)
    except _OtherLayout:
        return None


def _decode_run(buf: bytes, magic: str, make) -> list:
    dec = _decode_from
    unpack = _F64.unpack_from
    varint = _read_varint
    bools = (_T_TRUE, _T_FALSE)
    head = encode(magic)
    if buf[:2] != bytes((_T_LIST, 2)) or buf[2:2 + len(head)] != head:
        raise _OtherLayout
    pos = 2 + len(head)
    if buf[pos] != _T_LIST:
        raise _OtherLayout
    n, pos = varint(buf, pos + 1)
    colkeys: dict = {}
    out = []
    append = out.append
    for _ in range(n):
        if buf[pos] != _T_LIST or buf[pos + 1] != 2 \
                or buf[pos + 2] != _T_BYTES:
            raise _OtherLayout
        klen, pos = varint(buf, pos + 3)
        key = buf[pos:pos + klen]
        pos += klen
        if buf[pos] != _T_LIST:
            raise _OtherLayout
        nv, pos = varint(buf, pos + 1)
        versions = []
        for _v in range(nv):
            if buf[pos] != _T_LIST or buf[pos + 1] != 6:
                raise _OtherLayout
            ht, pos = dec(buf, pos + 2)
            tomb = buf[pos]
            live = buf[pos + 1]
            if tomb not in bools or live not in bools or \
                    buf[pos + 2] != _T_MAP:
                raise _OtherLayout
            nc = buf[pos + 3]
            if nc < 0x80:
                pos += 4
            else:
                nc, pos = varint(buf, pos + 3)
            cols = {}
            for _c in range(nc):
                # a column id: its str tag, a one-byte length, the digits
                if buf[pos] != _T_STR:
                    raise _OtherLayout
                end = pos + 2 + buf[pos + 1]
                raw = buf[pos:end]
                c = colkeys.get(raw)
                if c is None:
                    ck, _e = dec(buf, pos)
                    c = colkeys[raw] = int(ck)
                tag = buf[end]
                if tag == _T_INT:  # inline
                    pos = end + 1
                    b = buf[pos]
                    pos += 1
                    z = b & 0x7F
                    shift = 7
                    while b >= 0x80:
                        b = buf[pos]
                        pos += 1
                        z |= (b & 0x7F) << shift
                        shift += 7
                    cols[c] = (z >> 1) if not z & 1 else -((z >> 1) + 1)
                elif tag == _T_F64:  # inline
                    cols[c] = unpack(buf, end + 1)[0]
                    pos = end + 9
                else:
                    cols[c], pos = dec(buf, end)
            expire, pos = dec(buf, pos)
            wid, pos = dec(buf, pos)
            versions.append(make(key, ht, tomb == _T_TRUE, live == _T_TRUE,
                                 cols, expire, wid))
        append((key, versions))
    if pos != len(buf):
        raise _OtherLayout
    return out
