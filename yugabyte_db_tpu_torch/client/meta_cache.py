"""MetaCache: table -> tablet locations + leader tracking.

Reference analog: src/yb/client/meta_cache.cc — the client-side cache of
tablet partition ranges, replica sets, and last-known leaders; refreshed
from the master on miss and corrected by NOT_THE_LEADER responses.

The port's copy of the JAX package's ``client/meta_cache.py``, whole.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.utils.locking import guarded_by
from yugabyte_db_tpu_torch.utils.retry import RetryPolicy

# A location lookup retries only transient master-side failures; a
# missing table ("not_found") is terminal here — unlike the tablet-RPC
# loop, where not_found means a replica is mid-move.
_LOOKUP_RETRIABLE = frozenset({"timed_out", "service_unavailable",
                               "try_again"})


@dataclass
class TabletLocation:
    tablet_id: str
    partition_start: int
    partition_end: int
    replicas: list[str] = field(default_factory=list)
    leader: str | None = None
    # replica uuid -> {"cloud", "region", "zone"} (zone-aware routing)
    replica_clouds: dict = field(default_factory=dict)

    def contains(self, hash_code: int) -> bool:
        return self.partition_start <= hash_code < self.partition_end


@dataclass
class TableLocations:
    table_id: str
    schema_dict: dict
    tablets: list[TabletLocation] = field(default_factory=list)  # sorted


@guarded_by("_lock", "_tables")
class MetaCache:
    def __init__(self, client):
        self._client = client
        self._lock = threading.Lock()
        self._tables: dict[str, TableLocations] = {}
        self.retry_policy = RetryPolicy(
            timeout_s=5.0, initial_backoff_s=0.05, max_backoff_s=0.5,
            retriable_wire_codes=_LOOKUP_RETRIABLE)

    def locations(self, table_name: str,
                  refresh: bool = False) -> TableLocations:
        with self._lock:
            locs = self._tables.get(table_name)
        if locs is not None and not refresh:
            return locs
        resp = None
        for attempt in self.retry_policy.attempts():
            resp = self._client.master_rpc("master.get_table_locations",
                                           {"name": table_name})
            if not self.retry_policy.retriable(resp):
                break
            attempt.note(resp)
        if resp is None or resp.get("code") != "ok":
            raise KeyError(f"table {table_name!r}: {resp}")
        locs = TableLocations(resp["table_id"], resp["schema"])
        for t in resp["tablets"]:
            locs.tablets.append(TabletLocation(
                t["tablet_id"], t["partition_start"], t["partition_end"],
                [r["uuid"] for r in t["replicas"]], t.get("leader"),
                {r["uuid"]: r.get("cloud_info") or {}
                 for r in t["replicas"]}))
        with self._lock:
            self._tables[table_name] = locs
        return locs

    def lookup_by_hash(self, table_name: str, hash_code: int) -> TabletLocation:
        """Route a key's hash code to its tablet (the EP-routing analog).
        A miss inside the table's range (invalidate_tablet punched the
        owning tablet out after a split) does ONE refreshing lookup."""
        locs = self.locations(table_name)
        for t in locs.tablets:
            if t.contains(hash_code):
                return t
        locs = self.locations(table_name, refresh=True)
        for t in locs.tablets:
            if t.contains(hash_code):
                return t
        raise KeyError(f"no tablet for hash {hash_code} in {table_name}")

    def mark_leader(self, table_name: str, tablet_id: str,
                    leader: str | None) -> None:
        with self._lock:
            locs = self._tables.get(table_name)
            if locs is None:
                return
            for t in locs.tablets:
                if t.tablet_id == tablet_id:
                    t.leader = leader

    def invalidate(self, table_name: str | None = None) -> None:
        with self._lock:
            if table_name is None:
                self._tables.clear()
            else:
                self._tables.pop(table_name, None)

    def invalidate_tablet(self, table_name: str, tablet_id: str) -> None:
        """Per-TABLET invalidation (the tablet_split wire code's
        contract): punch just the split tablet out of the cached
        location list so the next lookup touching its range re-fetches,
        while every sibling's cached location — and its learned leader
        hint — survives (reference: meta_cache.cc marking one
        RemoteTablet stale on TABLET_SPLIT instead of dropping the
        table)."""
        with self._lock:
            locs = self._tables.get(table_name)
            if locs is None:
                return
            kept = [t for t in locs.tablets if t.tablet_id != tablet_id]
            if len(kept) == len(locs.tablets):
                return  # unknown tablet: nothing cached to punch out
            if kept:
                locs.tablets = kept
            else:
                self._tables.pop(table_name, None)

    def covers(self, table_name: str, hash_code: int) -> bool:
        """True when the cached location list has a tablet owning
        ``hash_code`` (False after invalidate_tablet punched its range
        out — the caller should do a refreshing lookup)."""
        with self._lock:
            locs = self._tables.get(table_name)
            if locs is None:
                return False
            return any(t.contains(hash_code) for t in locs.tablets)
