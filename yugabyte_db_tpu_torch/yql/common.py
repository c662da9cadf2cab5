"""Helpers shared by the YQL frontends (CQL processor, SQL executor).

One implementation of value coercion and key->tablet routing so the two
frontends cannot drift (they lower to the same DocDB write/read ops;
reference: the shared QLValue coercion + partition routing both the CQL
executor and pggate use, src/yb/common/ql_value.h, partition.h:204).
"""

from __future__ import annotations

from decimal import InvalidOperation as decimal_InvalidOperation

from yugabyte_db_tpu_torch.models.datatypes import DataType, python_value_matches
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import ColumnSchema
from yugabyte_db_tpu_torch.utils.status import InvalidArgument


def coerce_udt(col: ColumnSchema, value, fields):
    """Coerce a UDT literal ({field: value} map) against the type's
    declared fields: unknown fields rejected, missing fields NULL, each
    field coerced to its declared type; normalized to declared field
    order so replicas/serializers agree."""
    if value is None:
        return None
    if not isinstance(value, dict):
        raise InvalidArgument(
            f"bad value {value!r} for {col.name} (UDT {col.udt})")
    declared = {f[0] for f in fields}
    for k in value:
        if k not in declared:
            raise InvalidArgument(
                f"unknown field {k!r} for UDT {col.udt}")
    out = {}
    for fname, fdtype in fields:
        v = value.get(fname)
        if v is None:
            out[fname] = None
            continue
        fcol = ColumnSchema(f"{col.name}.{fname}", DataType(fdtype))
        out[fname] = coerce_value(fcol, v)
    return out


def coerce_value(col: ColumnSchema, value):
    """Coerce a resolved (marker-free) literal to the column's type."""
    if value is None:
        return None
    dt = col.dtype
    if dt == DataType.JSONB and isinstance(value, str):
        import json

        try:
            value = json.loads(value)
        except ValueError as e:
            raise InvalidArgument(f"invalid json for {col.name}: {e}")
    if dt.is_integer and isinstance(value, bool):
        raise InvalidArgument(f"bad value for {col.name}")
    if dt in (DataType.DOUBLE, DataType.FLOAT) and \
            isinstance(value, int) and not isinstance(value, bool):
        value = float(value)
    if dt == DataType.BINARY and isinstance(value, str):
        value = value.encode("utf-8")
    # Extended scalar surface: accept the natural literal spellings and
    # normalize to the rich storage value (reference type parsing:
    # src/yb/util/decimal.cc, date_time.cc, net/inetaddress.cc).
    try:
        if dt == DataType.DECIMAL:
            import decimal

            if isinstance(value, (int, float, str)):
                value = decimal.Decimal(str(value))
            if isinstance(value, decimal.Decimal) and \
                    (value.is_nan() or value.is_infinite()):
                raise InvalidArgument(
                    f"non-finite DECIMAL for {col.name}")
        elif dt == DataType.VARINT and isinstance(value, str):
            value = int(value)
        elif dt in (DataType.UUID, DataType.TIMEUUID) and \
                isinstance(value, str):
            import uuid as _uuid

            from yugabyte_db_tpu_torch.models.datatypes import TimeUuid

            u = _uuid.UUID(value)
            value = TimeUuid(u) if dt == DataType.TIMEUUID else u
        elif dt == DataType.TIMEUUID:
            import uuid as _uuid

            from yugabyte_db_tpu_torch.models.datatypes import TimeUuid

            if isinstance(value, _uuid.UUID):
                value = TimeUuid(value)
        elif dt == DataType.INET and isinstance(value, (str, bytes)):
            from yugabyte_db_tpu_torch.models.datatypes import Inet

            value = Inet(value)
        elif dt == DataType.DATE and isinstance(value, str):
            import datetime

            value = datetime.date.fromisoformat(value)
        elif dt == DataType.TIME and isinstance(value, str):
            import datetime

            value = datetime.time.fromisoformat(value)
        elif dt == DataType.TUPLE and isinstance(value, (list, tuple)):
            value = tuple(value)
        elif dt == DataType.FROZEN and isinstance(value, (set, frozenset)):
            value = sorted(value, key=lambda v: (type(v).__name__, v))
        elif dt == DataType.FROZEN and isinstance(value, dict):
            value = dict(sorted(value.items(),
                                key=lambda kv: (type(kv[0]).__name__,
                                                kv[0])))
    except (ValueError, TypeError, decimal_InvalidOperation) as e:
        raise InvalidArgument(
            f"bad {dt.name} literal for {col.name}: {e}") from None
    if not python_value_matches(dt, value):
        raise InvalidArgument(
            f"bad value {value!r} for {col.name} ({dt.name})")
    # Normalize containers so every replica and every client serializes
    # them identically (SET: sorted unique list; MAP: sorted key order).
    if dt == DataType.SET:
        value = sorted(set(value))
    elif dt == DataType.MAP:
        value = dict(sorted(value.items()))
    elif dt == DataType.JSONB:
        value = _normalize_json(value)
    return value


def _normalize_json(v):
    """Recursively sort object keys so identical JSON values serialize
    identically on every replica (reference: jsonb.cc's sorted key
    layout)."""
    if isinstance(v, dict):
        return {k: _normalize_json(v[k]) for k in sorted(v)}
    if isinstance(v, list):
        return [_normalize_json(x) for x in v]
    return v


def evolve_schema(handle, action: str, column: str | None,
                  dtype=None, new_name: str | None = None):
    """Compute the next schema version for an ALTER TABLE action (shared
    by both frontends): ADD -> NULL for existing rows, DROP retires the
    id (never reused) and is refused while the column is indexed,
    RENAME touches no data."""
    schema = handle.schema
    try:
        if action == "add":
            return schema.with_added_column(column, dtype)
        if action == "drop":
            from yugabyte_db_tpu_torch.index import normalize_index

            for i in getattr(handle, "indexes", []):
                ni = normalize_index(i)
                if column in ni["columns"] or column in ni["include"]:
                    raise InvalidArgument(
                        f"column {column} is indexed; drop the index first")
            return schema.with_dropped_column(column)
        return schema.with_renamed_column(column, new_name)
    except (ValueError, KeyError) as e:
        raise InvalidArgument(str(e)) from None


def key_and_tablet(cluster, handle, key_values: dict):
    """Encode the primary key and route to the owning tablet (hash
    tables route by hash code; range tables have a single tablet)."""
    schema = handle.schema
    hash_code = compute_hash_code(schema, key_values)
    key = schema.encode_primary_key(key_values, hash_code)
    tablet = (cluster.tablet_for_hash(handle, hash_code)
              if schema.num_hash else handle.tablets[0])
    return key, tablet
