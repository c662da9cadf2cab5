"""Row blocks: the write batch as one contiguous binary buffer.

Reference analog: the reference's write path never materializes per-row
language objects — rows live in protobuf arenas (QLWriteRequestPB) and
rocksdb WriteBatch slices end to end (src/yb/tablet/preparer.cc,
src/yb/docdb/doc_write_batch.h). A row block is this framework's
equivalent: the client encodes a batch ONCE (doc keys, partition hash,
per-tablet split), the block travels opaque through the RPC payload, the
WAL entry body, and Raft replication, is stamped with the commit hybrid
time by one native pass on the leader, and lands in the C++ memtable on
every replica.

The port's copy of the JAX package's ``storage/rowblock.py``: the
pure-Python spec of the block layout (the JAX module's fallback when its
native ``yb_wp`` is missing), whose bytes are the native module's. The
native write plane waits for ROADMAP.md §1 item 16. Layout
(little-endian):

    u32 nrows, then per row:
      u16 key_len, key bytes        (byte-comparable DocKey)
      u64 ht                        (commit hybrid time; 0 until stamped)
      u64 expire_ht                 (TTL expiry; MAX_HT = none)
      i64 ttl_us                    (-1 = none; resolved at stamping)
      u32 write_id                  (intra-batch MVCC order)
      u8  flags                     (1 = tombstone, 2 = liveness)
      u16 ncols, then per column: u32 col_id, codec-tagged value
"""

from __future__ import annotations

import struct

from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.utils import codec as _codec
from yugabyte_db_tpu_torch.utils.hybrid_time import BITS_FOR_LOGICAL

_NROWS = struct.Struct("<I")
_KEYLEN = struct.Struct("<H")
_FIXED = struct.Struct("<QQqIBH")  # ht, expire_ht, ttl_us, write_id, flags, ncols
_COLID = struct.Struct("<I")


def encode_rows(rows: list[RowVersion]) -> bytes:
    out = bytearray(_NROWS.pack(len(rows)))
    for r in rows:
        if r.increments:
            raise ValueError("encode_rows: unresolved counter increments")
        out += _KEYLEN.pack(len(r.key))
        out += r.key
        out += _FIXED.pack(r.ht, r.expire_ht,
                           -1 if r.ttl_us is None else r.ttl_us,
                           r.write_id,
                           (1 if r.tombstone else 0) | (2 if r.liveness else 0),
                           len(r.columns))
        for col_id, v in r.columns.items():
            out += _COLID.pack(col_id)
            out += _codec.encode(v)
    return bytes(out)


def block_records(block) -> list[tuple]:
    """-> [(key, ht, tombstone, liveness, columns, expire_ht, ttl_us,
    write_id)] — RowVersion's positional field order."""
    buf = bytes(block)
    (nrows,) = _NROWS.unpack_from(buf, 0)
    pos = _NROWS.size
    out = []
    for _ in range(nrows):
        (klen,) = _KEYLEN.unpack_from(buf, pos)
        pos += _KEYLEN.size
        key = buf[pos:pos + klen]
        pos += klen
        ht, expire_ht, ttl_us, write_id, flags, ncols = _FIXED.unpack_from(
            buf, pos)
        pos += _FIXED.size
        columns = {}
        for _c in range(ncols):
            (col_id,) = _COLID.unpack_from(buf, pos)
            pos += _COLID.size
            v, pos = _codec._decode_from(buf, pos)
            columns[col_id] = v
        out.append((key, ht, bool(flags & 1), bool(flags & 2), columns,
                    expire_ht, None if ttl_us < 0 else ttl_us, write_id))
    if pos != len(buf):
        raise ValueError("row block: trailing bytes")
    return out


def block_count(block) -> int:
    (nrows,) = _NROWS.unpack_from(bytes(block), 0)
    return nrows


def block_keys(block) -> list[bytes]:
    return [t[0] for t in block_records(block)]


def stamp_block(block, ht: int, shift: int = BITS_FOR_LOGICAL) -> bytes:
    rows = [RowVersion(t[0], ht=ht, tombstone=t[2], liveness=t[3],
                       columns=t[4],
                       expire_ht=(ht + (t[6] << shift)) if t[6] is not None
                       else t[5],
                       write_id=i)
            for i, t in enumerate(block_records(block))]
    return encode_rows(rows)


def block_ht_range(block):
    hts = [t[1] for t in block_records(block)]
    return (min(hts), max(hts)) if hts else None


def rows_from_block(block) -> list[RowVersion]:
    """Materialize a block into RowVersions (fallback/read paths only —
    the hot pipeline never calls this)."""
    return [RowVersion(*t) for t in block_records(block)]
