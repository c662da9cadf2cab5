"""Device residency manager: the device block-cache analog.

Reference analog: src/yb/rocksdb/util/cache.cc — the LRU block cache
with a high-pri/low-pri pool split (sized and wired for docdb in
docdb_rocksdb_util.cc) that lets SSTable working sets exceed RAM. The
port's copy of the JAX package's ``storage/residency.py``, with the same
behaviour. The cached unit is a whole columnar run's device plane
group: the host-side ``ColumnarRun`` stays authoritative, ``GpuRun``
demand-uploads its planes through this cache on first access, and when
a device's budget (the ``gpu_hbm_budget_bytes`` flag, PER DEVICE) is
exceeded the least recently used unpinned plane group *on that device*
is dropped, releasing its device tensors and debiting the owning
engine's ``device`` MemTracker subtree. Derived tensors of a run (K10's
side-car, a resolved view, a decode plan) ride on its entry as aux
tensors: charged with it and dropped with it.

The budget is a per-device map: every entry belongs to exactly one
owning device (demand re-uploads go back to it). Admission and eviction
are scoped to the admitting device. On one card the map has one bucket.
``release`` drops an entry's payload and keeps its registration (planes
rebuilt in place by ``alter_schema``). The JAX cache's per-device byte
map of an external registration (a sharded upload) comes with the port's
path that needs it (ROADMAP.md §1 item 14).

Scan resistance mirrors the reference's two-pool policy: point-get and
bounded-scan traffic is admitted to (or promoted into) the protected
high-pri pool; full-table-scan traffic is admitted to the low-pri pool,
so one large scan streams through the low pool and cannot flush the hot
working set. A fraction of the budget (``HIGH_PRI_POOL_RATIO``) caps the
high pool; overflow demotes its LRU entries into the low pool.

Pins keep a plane group resident across a dispatch window (launch to
finish in ``scan_batch_async``, compaction's retention mask, the cached
delta-overlay primary). Pinned entries are never evicted — a pinned set
larger than the budget overflows it rather than failing the dispatch.

This module imports no device framework: payloads are built by
caller-supplied closures. The JAX module's Prometheus series
(``yb_hbm_*``) and its resource-witness pin hooks are not wired to the
port's ``utils.metrics`` and ``utils.resources`` yet (ROADMAP.md §1 item
16); every number of those series is in ``stats()``.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict, deque

from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.memtracker import root_tracker
from yugabyte_db_tpu_torch.utils.sync_point import sync_point

# Fraction of the budget reserved for the protected (high-pri) pool.
HIGH_PRI_POOL_RATIO = 0.8

# Device bucket for callers that never name a device (tests driving the
# cache directly). The engine passes its device's label
# (``gpu_engine.device_label``: "cuda:0", "cpu:0").
DEFAULT_DEVICE = "device:0"

# Sentinel payload for externally-owned residency (bytes uploaded outside
# the cache but accounted through it, e.g. the overlay's masked plane).
_EXTERNAL = object()


class _Entry:
    __slots__ = ("key", "label", "tracker", "owner_ref", "payload",
                 "nbytes", "aux", "aux_bytes", "pins", "pool", "external",
                 "encoding", "device")

    def __init__(self, key: int, label: str, tracker,
                 device: str = DEFAULT_DEVICE):
        self.key = key
        self.label = label
        self.tracker = tracker
        self.owner_ref = None
        self.payload = None
        self.nbytes = 0
        # aux key -> (value, bytes charged for it): the port's aux_pop
        # releases one aux value's bytes.
        self.aux: dict = {}
        self.aux_bytes = 0
        self.pins = 0
        self.pool = "high"
        self.external = False
        # Plane-format tag of the resident payload ("plain", "encoded",
        # "external"), sampled duck-typed from the payload at admit.
        self.encoding = "plain"
        # The owning device: demand re-uploads target it, and its budget
        # bucket is the one this entry's bytes count against.
        self.device = device
        # External multi-device entries only: per-device byte map.

    @property
    def total_bytes(self) -> int:
        return self.nbytes + self.aux_bytes


class HbmCache:
    """Process-wide capacity-budgeted cache of device plane groups.

    Keys are integer tokens handed out by :meth:`register`; each token is
    tied to its owner by a weakref, so a dropped run releases its device
    bytes without the cache keeping the host run alive. ``acquire`` is
    the one read path: hit → LRU touch (plus promotion into the
    protected pool when the access is ``priority="high"``), miss → evict
    down to budget, build the payload via the caller's closure (the
    demand re-upload), charge the owner's MemTracker, admit.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: dict[int, _Entry] = {}
        # Keys whose owners were collected. Weakref death callbacks run
        # at arbitrary allocation points — including re-entrantly on a
        # thread already inside the cache (the lock is an RLock) — so
        # they must not mutate _entries/_pools directly; they append
        # here (deque.append is atomic) and every public method drains
        # the queue under the lock before touching shared state.
        self._dead: deque[int] = deque()
        # Eviction order: oldest first. "low" drains before "high".
        self._pools: dict[str, OrderedDict] = {"low": OrderedDict(),
                                               "high": OrderedDict()}
        self._next_key = 1
        self._resident = 0
        self._peak_resident = 0
        # Per-device residency; buckets are created on first charge.
        self._dev_resident: dict[str, int] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._upload = 0

    # -- configuration --------------------------------------------------------

    @staticmethod
    def budget() -> int:
        """Current byte budget PER DEVICE; 0 means unbounded."""
        try:
            return int(FLAGS.get("gpu_hbm_budget_bytes"))
        except KeyError:
            return 0

    # -- registration ---------------------------------------------------------

    def register(self, owner, tracker=None, label: str = "",
                 device: str = DEFAULT_DEVICE) -> int:
        """A residency key for ``owner`` (a GpuRun or similar). The
        entry auto-invalidates when ``owner`` is collected; ``tracker``
        (the engine's device MemTracker) is charged while resident.
        ``device`` names the owning device's budget bucket — demand
        re-uploads for this key must target that device."""
        with self._lock:
            self._drain_dead()
            key = self._next_key
            self._next_key += 1
            e = _Entry(key, label or type(owner).__name__, tracker,
                       device=device or DEFAULT_DEVICE)
            if owner is not None:
                # The death callback only ENQUEUES (deque.append is
                # atomic); _drain_dead consumes under _lock.
                e.owner_ref = weakref.ref(
                    owner, lambda _r, k=key: self._dead.append(k))
            self._entries[key] = e
            return key

    def add_external(self, owner, nbytes: int, tracker=None,
                     label: str = "external",
                     device: str = DEFAULT_DEVICE) -> int:
        """Account ``nbytes`` of device residency uploaded outside the
        cache (the overlay's masked valid plane). External entries are
        permanently pinned until invalidated (or their owner is
        collected); they overflow the budget rather than being
        evictable."""
        key = self.register(owner, tracker, label, device=device)
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is None:  # owner died during registration
                return key
            e.external = True
            e.payload = _EXTERNAL
            e.encoding = "external"
            e.nbytes = int(nbytes)
            e.pins = 1
            self._pools["high"][key] = e
            self._charge(e, e.nbytes)
        return key

    def invalidate(self, key: int) -> None:
        """Drop the entry entirely: release device bytes and forget the
        key. Owner-teardown only — a later acquire() on this key takes
        the unmanaged fallback."""
        with self._lock:
            self._drain_dead()
            e = self._entries.pop(key, None)
            if e is not None and e.payload is not None:
                self._release_entry(e, evicted=False)

    def release(self, key: int) -> None:
        """Drop the entry's resident payload (and its aux values) but keep
        the registration: the next acquire() demand-rebuilds through the
        cache, still budgeted and tracker-charged, and counts a miss. The
        call for an owner that outlives its current upload (ALTER grows
        the host planes and the stale device copy must go)."""
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is not None and e.payload is not None:
                self._release_entry(e, evicted=False)

    # -- the read path --------------------------------------------------------

    def acquire(self, key: int, build, nbytes_hint: int | None = None,
                priority: str | None = None, pin: bool = False):
        """The payload for ``key``, demand-built on miss.

        ``build`` returns ``(payload, nbytes)`` — it runs under the cache
        lock, serializing uploads (concurrent uploads under memory
        pressure would overshoot the budget). ``nbytes_hint`` lets the
        cache evict *before* uploading so residency never transiently
        exceeds the budget. ``priority`` is "high", "low", or None; None
        admits high but never promotes an existing low entry (so
        follow-up accesses inside a full scan don't defeat scan
        resistance). ``pin=True`` takes a pin before returning.
        """
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is None:
                # Owner already unregistered (e.g. a scan finishing after
                # compaction dropped its run): serve unmanaged so in-flight
                # reads stay correct; nothing to account.
                payload, _ = build()
                return payload
            if e.payload is not None:
                pool = self._pools[e.pool]
                pool.move_to_end(key)
                if priority == "high" and e.pool == "low":
                    self._move_pool(e, "high")
                if pin:
                    e.pins += 1
                self._hits += 1
                return e.payload
            payload = self._admit(e, build, nbytes_hint, priority, pin)
            self._misses += 1
            return payload

    def pin(self, key: int, build, nbytes_hint: int | None = None,
            priority: str | None = None):
        """Acquire + pin: the payload stays resident until :meth:`unpin`."""
        return self.acquire(key, build, nbytes_hint, priority, pin=True)

    def peek(self, key: int):
        """The resident payload, or None — never builds, never reorders
        the LRU pools."""
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            return e.payload if e is not None else None

    def unpin(self, key: int) -> None:
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is None:
                return
            if e.pins > 0:
                e.pins -= 1
            # Unpinning may unlock deferred evictions on this device.
            b = self.budget()
            if b and self._dev_resident.get(e.device, 0) > b:
                self._evict_until(b, e.device)

    # -- derived-tensor side cars ---------------------------------------------

    def aux_get(self, key: int, aux_key):
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is None or e.payload is None:
                return None
            held = e.aux.get(aux_key)
            return None if held is None else held[0]

    def aux_put(self, key: int, aux_key, value, nbytes: int) -> None:
        """Attach a derived device tensor set to a resident entry; it is
        charged with — and dropped with — the entry. A no-op if the
        entry was evicted meanwhile (the caller still holds ``value``)."""
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is None or e.payload is None or aux_key in e.aux:
                return
            e.aux[aux_key] = (value, int(nbytes))
            e.aux_bytes += int(nbytes)
            self._charge(e, int(nbytes))
            b = self.budget()
            if b and self._dev_resident.get(e.device, 0) > b:
                self._evict_until(b, e.device)

    def aux_pop(self, key: int, aux_key) -> None:
        """Drop one aux value of a resident entry and its charge (the
        port's: a run's resolved view is replaced, not accumulated)."""
        with self._lock:
            self._drain_dead()
            e = self._entries.get(key)
            if e is None or aux_key not in e.aux:
                return
            _value, nbytes = e.aux.pop(aux_key)
            e.aux_bytes -= nbytes
            self._charge(e, -nbytes)

    # -- internals ------------------------------------------------------------

    def _drain_dead(self) -> None:
        """Reap entries whose owners were collected (lock held). The
        weakref callbacks only enqueue; all structural mutation happens
        here, at a point where no pool iteration is in progress."""
        while True:
            try:
                key = self._dead.popleft()
            except IndexError:
                return
            e = self._entries.pop(key, None)
            if e is not None and e.payload is not None:
                self._release_entry(e, evicted=False)

    def _admit(self, e: _Entry, build, hint, priority, pin: bool):
        b = self.budget()
        # The device MemTracker limit is the SUM of per-device budgets:
        # one flag value per device seen so far.
        ndev = max(1, len(self._dev_resident))
        root_tracker().child("device").set_limit((b * ndev) or None)
        if b and hint:
            self._evict_until(max(b - int(hint), 0), e.device)
        payload, nbytes = build()
        e.payload = payload
        e.encoding = ("encoded" if getattr(payload, "encoded", False)
                      else "plain")
        e.nbytes = int(nbytes)
        e.aux = {}
        e.aux_bytes = 0
        e.pool = "low" if priority == "low" else "high"
        self._pools[e.pool][e.key] = e
        if pin:
            e.pins += 1
        self._charge(e, e.nbytes)
        self._upload += e.nbytes
        if b:
            self._rebalance_high(b, e.device)
            self._evict_until(b, e.device)
        sync_point("hbm_cache:admit", e.label)
        return payload

    def _bump_dev(self, device: str, nbytes: int) -> None:
        """Adjust one device's residency bucket (lock held)."""
        self._dev_resident[device] = (self._dev_resident.get(device, 0)
                                      + nbytes)

    def _charge(self, e: _Entry, nbytes: int) -> None:
        self._resident += nbytes
        if self._resident > self._peak_resident:
            self._peak_resident = self._resident
        self._bump_dev(e.device, nbytes)
        if e.tracker is not None:
            e.tracker.consume(nbytes)

    def _move_pool(self, e: _Entry, pool: str) -> None:
        self._pools[e.pool].pop(e.key, None)
        e.pool = pool
        self._pools[pool][e.key] = e

    def _rebalance_high(self, b: int, device: str) -> None:
        """High-pool cap, per device: one device's protected working set
        can't demote another device's."""
        cap = int(b * HIGH_PRI_POOL_RATIO)
        high = self._pools["high"]
        hb = sum(en.total_bytes for en in high.values()
                 if not en.external and en.device == device)
        for k in list(high.keys()):
            if hb <= cap:
                break
            en = high[k]
            if en.external or en.device != device:
                continue
            self._move_pool(en, "low")
            hb -= en.total_bytes

    def _evict_until(self, target: int, device: str | None = None) -> None:
        """Evict LRU-first until ``device``'s bucket (or, with
        device=None, global residency) is within ``target``."""
        def over():
            if device is None:
                return self._resident > target
            return self._dev_resident.get(device, 0) > target
        while over():
            if not self._evict_one(device):
                break  # everything left is pinned: allowed overflow

    def _evict_one(self, device: str | None = None) -> bool:
        for pool_name in ("low", "high"):
            for en in self._pools[pool_name].values():
                if en.pins == 0 and not en.external and (
                        device is None or en.device == device):
                    self._release_entry(en, evicted=True)
                    return True
        return False

    def _release_entry(self, e: _Entry, evicted: bool) -> None:
        total = e.total_bytes
        self._pools[e.pool].pop(e.key, None)
        e.payload = None
        e.aux = {}
        self._resident -= total
        self._bump_dev(e.device, -total)
        if e.tracker is not None:
            e.tracker.release(total)
        e.nbytes = 0
        e.aux_bytes = 0
        e.pins = 0
        e.encoding = "plain"
        if evicted:
            self._evictions += 1
            sync_point("hbm_cache:evict", e.label)

    # -- introspection --------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            self._drain_dead()
            return self._resident

    def device_resident_bytes(self, device: str | None = None):
        """One device's resident bytes, or the full {device: bytes} map
        when ``device`` is None."""
        with self._lock:
            if device is not None:
                return self._dev_resident.get(device, 0)
            return dict(self._dev_resident)

    def pinned_bytes(self) -> int:
        with self._lock:
            self._drain_dead()
            return sum(e.total_bytes
                       for pool in self._pools.values()
                       for e in pool.values() if e.pins > 0)

    def peak_resident_bytes(self) -> int:
        with self._lock:
            return self._peak_resident

    def evict_unpinned(self) -> int:
        """Drop every unpinned entry (test hook for eviction pressure);
        returns how many entries were evicted."""
        n = 0
        with self._lock:
            self._drain_dead()
            while self._evict_one():
                n += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            self._drain_dead()
            pools = {
                name: {"entries": len(pool),
                       "bytes": sum(e.total_bytes for e in pool.values())}
                for name, pool in self._pools.items()}
            by_enc: dict[str, dict] = {}
            for pool in self._pools.values():
                for e in pool.values():
                    d = by_enc.setdefault(e.encoding,
                                          {"entries": 0, "bytes": 0})
                    d["entries"] += 1
                    d["bytes"] += e.total_bytes
            b = self.budget()
            by_dev: dict[str, dict] = {
                dev: {"resident_bytes": n, "budget_bytes": b,
                      "entries": 0, "pinned_bytes": 0}
                for dev, n in sorted(self._dev_resident.items())}
            for pool in self._pools.values():
                for e in pool.values():
                    d = by_dev.setdefault(
                        e.device, {"resident_bytes": 0, "budget_bytes": b,
                                   "entries": 0, "pinned_bytes": 0})
                    d["entries"] += 1
                    if e.pins > 0:
                        d["pinned_bytes"] += e.total_bytes
            out = {
                "budget_bytes": b,
                "resident_bytes": self._resident,
                "peak_resident_bytes": self._peak_resident,
                "registered": len(self._entries),
                "pools": pools,
                "by_encoding": by_enc,
                "by_device": by_dev,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "demand_upload_bytes": self._upload,
            }
        out["pinned_bytes"] = self.pinned_bytes()
        return out


def device_nbytes(tree, *held) -> int:
    """Device bytes of the distinct allocations the tensors of ``tree``
    (nested dicts, lists, tuples; encoded leaves included) live in, less
    those any tree of ``held`` also lives in: what ``tree`` adds to the
    device's allocated memory. Duck-typed, so that this module imports no
    device framework: a torch tensor counts its ``untyped_storage()`` once
    however many views share it; an array without one (numpy) counts its
    ``size * dtype.itemsize``. The footprint charged for cache payloads
    and aux entries, so that what an eviction releases is what the
    allocator frees."""
    def allocations(t) -> dict:
        out = {}
        stack = [t]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            elif node is None:
                continue
            elif hasattr(node, "untyped_storage"):
                st = node.untyped_storage()
                out[("storage", st.data_ptr())] = st.nbytes()
            else:
                out[("array", id(node))] = (int(node.size)
                                            * node.dtype.itemsize)
        return out

    own = allocations(tree)
    for h in held:
        for key in allocations(h):
            own.pop(key, None)
    return sum(own.values())


_CACHE: HbmCache | None = None
_CACHE_LOCK = threading.Lock()


def hbm_cache() -> HbmCache:
    """The process-wide residency cache (one budget a device)."""
    global _CACHE
    if _CACHE is None:
        with _CACHE_LOCK:
            if _CACHE is None:
                _CACHE = HbmCache()
    return _CACHE
