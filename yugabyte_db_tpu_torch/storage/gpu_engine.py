"""GPU storage engine: the ``tablet_storage_engine=gpu`` data plane.

A slice of the JAX package's ``storage/tpu_engine.py``: writes go to the
host memtable, ``flush`` turns it into a columnar run resident on the
engine's device, ``compact`` merges the runs into one with history GC,
and aggregate scans fold on the device, over a flat run (one version per
key) or a multi-version one.

The write side takes the JAX engine's routes:

- **flush**, the device route (its default): the memtable's versions are
  staged in apply order through the columnar encoders, sorted and packed
  into blocks on the host (one argsort over memcmp keys), and one launch
  of K12 (``ops.flush``, a CUDA kernel) writes the run's padded planes on
  the device; the run adopts them (no upload) and its host planes are
  read back from them. A key longer than the prefix planes, a value the
  encoders reject or a key group longer than a block takes the host
  build (``drain_sorted`` + ``ColumnarRun.build``) and an upload.
  ``stats()["flush_paths"]`` counts both;
- **compact**: the merge order of the runs on the host (a k-way merge of
  the presorted runs over memcmp keys), the retention mask over the
  sorted union (K11, ``ops.compact``, a CUDA kernel reading the resident
  planes, past ``HOST_GC_MASK_MAX`` rows; its numpy twin below), and a
  gather of the survivors' planes into the merged run; keys past the
  prefix planes take the host merge and a build. The old runs' device
  planes, the overlay state and the plan caches go with them. ``apply``
  flushes at ``memtable_flush_versions`` and then calls ``maybe_compact``.

Runs keep their planes compressed (``plane_encoding`` "auto", the JAX
flag's default): host-built and compacted runs upload their encoded
tree, the flush writes string columns as dictionary codes (K12's codes
route), the kernels that read plain planes read the run's side-car
(``GpuRun.plain``: K10, ``ops.decode``), K8 decodes the encoded leaves
itself, and a single-run aggregate's string predicates on a dictionary
column are promoted to exact code compares (``_promote_code_preds``).

Runs are resident through the process-wide residency cache
(``storage.residency``, the JAX engine's): a run uploads on demand, a
budget a device (the ``gpu_hbm_budget_bytes`` flag) evicts the least
recently used unpinned runs with their side-cars and views, a batch pins
the runs it launches on until it finishes, and the cached overlay pins
its primary. The flush takes the host build when its planes would exceed
the budget, and compaction takes the numpy twin of the mask when the
runs would not fit it together.

The fault domain is the JAX engine's circuit breaker
(``storage.breaker``): a device fault while a batch is planned, launched
or finished (``breaker.is_device_fault``: device memory exhausted, an
injected ``fault.gpu_dispatch``) is recorded, and the batch is re-served
from the host structures (``_serve_host_batch``: the row scan with host
candidates); while the breaker is open every batch is, until a half-open
probe succeeds. A fault in the device flush sends it to the host build.
Any other raise, a CUDA runtime error of a faulty kernel included, is
recorded on the breaker and propagates.

The rest of the JAX engine's seam, which the tablet (``tablet.Tablet``)
calls: runs are saved on disk under the ``data_dir`` option
(``storage.run_io.RunPersistence``, the JAX engine's files byte for byte):
each flush saves its run's entries, a compaction replaces every file with
the merged run's, and a new engine on the directory loads them at
construction (they upload on demand through the cache).
``apply_block`` decodes a row block (``storage.rowblock``);
``restore_entries`` replaces everything with a snapshot's entries and
``dump_entries`` gives every run's entries key-merged; ``alter_schema``
flushes, gives every run all-unset planes for each added column and
drops each grown run's device payload (``GpuRun.invalidate_device``: the
next access re-uploads, a counted miss); ``scan_batch`` /
``scan_batch_async`` check a ``deadline`` (``utils.retry.Deadline``) where
the JAX engine does, and an expired one raises ``Code.TIMED_OUT`` without
a host re-serve and without counting as a breaker failure. ``point_serve`` answers ``None`` (the seam's default: the
port's memtable has no native lookup). Not in this slice: the native
one-pass flush and the native wire page server (ROADMAP.md §1 item 16).

The scans:

- a multi-version run is first resolved at the spec's read point into a
  flat view (``ops.mvcc_resolve``, a CUDA kernel; the counterpart of the
  resolve inside the JAX package's ``lookback_fold`` / ``seg_fold``):
  one resolve per run and set of visible versions and expiries, shared
  by the specs of a batch, and the run keeps its latest view for the
  next batch. The view is then folded as a flat run is;
- signatures the CUDA fold kernel takes (``ops.flat_agg.eligible``:
  COUNT, i32/i64 SUM/MIN/MAX, i32/i64 predicates) go through it, and the
  specs of one batch that share a signature and a run (or view) go as
  ONE launch with an [N, P] parameter tensor (the counterpart of
  ``_batched_agg_fn``);
- the other signatures (f64 predicates, float aggregates) go through
  ``ops.flat_fold`` in plain PyTorch, one spec at a time, within its
  bounds (``flat_fold.MAX_B`` blocks, ``MAX_R`` rows a block);
- past those bounds they go through the windowed fold K5
  (``ops.full_agg``, a CUDA kernel; the JAX engine's ``full`` route,
  ``agg_fold.compiled_full_aggregate``): the windows of K blocks that
  the spec's rows cover, folded in window order into exact digits. The
  specs of one batch that share a signature and a run (or view) go as
  ONE launch, a spec a row of the grid's second axis.

All three return ``agg_fold.pack``'s layout, which ``unpack`` /
``finalize`` turn into a ``ScanResult``; ``stats()["agg_routes"]``
counts the specs each route served and ``stats()["full_launches"]`` the
K5 launches. ``rows_scanned`` is what the JAX ``tpu``
engine reports on these routes: the rows (key groups, on a multi-version
run) that pass every predicate.

GROUP BY and expression aggregates (TPC-H Q1/Q6) over one run take the
grouped route (``_grouped_prep``, the JAX engine's): the bucket-table fold
K8 (``ops.group_agg``, a CUDA kernel) over the run or its view, every
spec of a batch that shares a source and a signature in one launch; the
host decodes the live buckets (``_finish_grouped``). ``rows_scanned`` is
there the rows (key groups) that exist in range, before predicates, as
the JAX program's ``pre_pred``. A spec whose buckets show a negative sum
input or a hash collision is re-served by a host fold of the run's keys
in range (``_grouped_host_fold``, counted in ``grouped_host_folds``), as
the JAX engine re-serves it with its row scan.

A scan over several sources (a live memtable over a run, several runs,
or both) goes through the **delta overlay**, as in the JAX engine: the
largest run is the primary, and every key held by another run or by the
memtable is dirty. The dirty keys' rows are cleared from a copy of the
primary's ``valid`` plane (K13, a torch op), the masked primary takes the
routes above (a multi-version one resolved into a view of its own), and
the dirty keys' version sets, merged on the host, are folded there after
the launches and before the batch waits. The two partials cover disjoint
keys and are combined at the finalized level; ``rows_scanned`` adds the
dirty keys that exist at the read point, before predicates, as the JAX
engine adds them.

Row scans, and the aggregates none of the folds above take, go down the
JAX engine's row path (``storage.gpu_rows``): exact-key reads, host LIMIT
pages on a flat run, the gather through K7 (``ops.row_gather``, a CUDA
kernel) on one run, and the row scan over several sources, whose
candidates K9 gives (also a dirty set past half the primary, a grouped
spec over several sources, and the memtable before the first flush).
"""

from __future__ import annotations

import bisect
import functools
import gc
import operator
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.ops import (agg_fold, flat_agg, flat_fold,
                                      full_agg, group_agg, mvcc_resolve)
from yugabyte_db_tpu_torch.ops import compact as dcompact
from yugabyte_db_tpu_torch.ops import decode
from yugabyte_db_tpu_torch.ops import encodings as enc
from yugabyte_db_tpu_torch.ops import flush as dflush
from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.ops.device_run import (PLANE_ENCODINGS,
                                                  DeviceRun, dtype_kind,
                                                  padded_blocks,
                                                  plane_nbytes,
                                                  resolve_device)
from yugabyte_db_tpu_torch.storage.columnar import (DEFAULT_ROWS_PER_BLOCK,
                                                    KEY_WORDS, BlockMeta,
                                                    ColumnarRun, ColumnData,
                                                    _varlen_raw,
                                                    dictionary_planes,
                                                    sorted_dictionary)
from yugabyte_db_tpu_torch.storage.cpu_engine import (Aggregator,
                                                      RowMaterializer,
                                                      gc_versions)
from yugabyte_db_tpu_torch.storage import expr as X
from yugabyte_db_tpu_torch.storage import host_page
from yugabyte_db_tpu_torch.storage.breaker import (CircuitBreaker,
                                                   is_device_fault)
from yugabyte_db_tpu_torch.storage.engine import (MEMTABLE_FLUSH_VERSIONS,
                                                  StorageEngine,
                                                  register_engine)
from yugabyte_db_tpu_torch.storage.gpu_rows import RowPath
from yugabyte_db_tpu_torch.storage.memtable import MemTable
from yugabyte_db_tpu_torch.storage.merge import (merge_entry_streams,
                                                 merge_versions)
from yugabyte_db_tpu_torch.storage.residency import (device_nbytes,
                                                     hbm_cache)
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.storage.run_io import RunPersistence, load_run
from yugabyte_db_tpu_torch.storage.scan_spec import (ScanResult, ScanSpec,
                                                     point_key_of)
from yugabyte_db_tpu_torch.utils import planes as P
from yugabyte_db_tpu_torch.utils.fault_injection import (FaultInjected,
                                                         maybe_fault)
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.memtracker import root_tracker
from yugabyte_db_tpu_torch.utils.retry import DeadlineExpired
from yugabyte_db_tpu_torch.utils.sync_point import sync_point

PAD_BLOCKS = 64  # run block-axis padding, as the JAX engine pads
# The plane_encoding option's default (the JAX flag's: "auto").
DEFAULT_PLANE_ENCODING = "auto"
# Compaction unions of at most this many rows take the retention mask's
# numpy twin, larger ones K11 (the JAX engine's constant, set for its
# TPU's link; PERF.md records where the crossover lies on the card).
HOST_GC_MASK_MAX = 2_000_000
# The longest key the device routes take: its KEY_WORDS prefix planes
# hold it whole, so plane order and equality are exact.
MAX_DEVICE_KEY = 4 * KEY_WORDS


def device_label(device: torch.device) -> str:
    """The residency cache's budget bucket of ``device`` ("cuda:0")."""
    return f"{device.type}:{device.index or 0}"


class _Resident:
    """A run's payload in the residency cache: its planes (``dev``, a
    DeviceRun), K10's part table of an encoded tree (``decode_plan``,
    laid out and uploaded with the planes so that the run's first decode
    is one launch) and a multi-version run's constant view planes
    (``const``). Built together, charged together, dropped together."""

    __slots__ = ("dev", "decode_plan", "const", "nbytes")

    def __init__(self, dev: DeviceRun, const: dict | None):
        self.dev = dev
        self.const = const
        self.decode_plan = None
        if dev.encoded and dev.device.type == "cuda":
            self.decode_plan = decode.plan_tree(dev.arrays)
        self.nbytes = device_nbytes(
            [dev.arrays, const,
             self.decode_plan.table if self.decode_plan else None])

    @property
    def encoded(self) -> bool:
        return self.dev.encoded


class GpuRun:
    """A columnar run and its device residency (the JAX engine's
    ``TpuRun``). ``dev`` demand-uploads the run's planes through the
    process-wide residency cache (``storage.residency``) and may be
    evicted once the access returns when ``gpu_hbm_budget_bytes`` is under
    pressure; the host ``ColumnarRun`` stays authoritative and the next
    access uploads again, encoded under ``setting`` ``"auto"``. A run the
    device flush made is seeded with the planes it adopts
    (``seed_device``). Hold a ``pin`` across a batch's launches and its
    finish so that eviction cannot drop planes a launch still reads.

    ``plain()`` is the plain tree the kernels that read plain planes take:
    the resident arrays of a plain run, else K10's decode of the encoded
    tree (``ops.decode``), made at first use by one launch over the part
    table laid out at upload. The decode is an aux entry of the run's
    cache entry: charged with it and evicted with it, as the JAX engine
    charges K1's tensors (``pallas_tensors``). So are a multi-version
    run's resolved view (``view``; one at a time, held by the run or by
    one masked copy of it) and K13b's plan of a bit-packed ``valid``. A
    multi-version run also holds, on the host, the sorted hybrid times of
    its versions and expiries (the view keys). Every device tensor of a
    run is reachable only through its cache entry, so that an eviction
    frees what it releases."""

    def __init__(self, crun: ColumnarRun, device: torch.device,
                 dev: DeviceRun | None = None, setting: str = "auto",
                 tracker=None):
        self.crun = crun
        self.device = device
        self.setting = setting
        self.B = padded_blocks(crun.B, PAD_BLOCKS)  # the planes' blocks
        self.flat = crun.max_group_versions <= 1
        self.host_index = None  # storage.host_page.HostPageIndex, lazy
        self._dev_nbytes_hint: int | None = None
        # This run's mark in the "view" aux slot (never the run itself:
        # the cache must not keep its owner alive).
        self._token = object()
        if not self.flat:
            v = crun.valid
            self._hts = np.sort(P.planes_to_u64(
                crun.ht_hi[v], crun.ht_lo[v]).astype(np.int64))
            exps = P.planes_to_u64(crun.exp_hi[v],
                                   crun.exp_lo[v]).astype(np.int64)
            self._exps = np.sort(exps[exps != MAX_HT])
        self._res_key = hbm_cache().register(self, tracker, "run",
                                             device=device_label(device))
        if dev is not None:
            self.seed_device(dev)

    @property
    def source(self) -> "GpuRun":
        """The run whose planes these are."""
        return self

    # -- residency (the JAX engine's TpuRun) ---------------------------------
    def _const_planes(self) -> dict | None:
        if self.flat:
            return None
        return mvcc_resolve.constant_planes(self.B, self.crun.R,
                                            self.device)

    def _build_dev(self):
        res = _Resident(DeviceRun(self.crun, PAD_BLOCKS, device=self.device,
                                  setting=self.setting),
                        self._const_planes())
        return res, res.nbytes

    def _nbytes_hint(self) -> int:
        """The payload's predicted bytes, from the host planes' shapes."""
        if self._dev_nbytes_hint is None:
            const = 0 if self.flat else self.B * self.crun.R * 18
            self._dev_nbytes_hint = const + plane_nbytes(
                self.crun, PAD_BLOCKS, self.setting)
        return self._dev_nbytes_hint

    def resident(self, priority: str | None = None) -> _Resident:
        """The run's payload, uploaded on a miss."""
        return hbm_cache().acquire(self._res_key, self._build_dev,
                                   nbytes_hint=self._nbytes_hint(),
                                   priority=priority)

    @property
    def dev(self) -> DeviceRun:
        return self.resident().dev

    def pin(self, priority: str | None = None) -> _Resident:
        """Acquire + pin the payload until ``unpin``: the guard of a
        batch's launches, a compaction's mask and the overlay's primary."""
        return hbm_cache().pin(self._res_key, self._build_dev,
                               nbytes_hint=self._nbytes_hint(),
                               priority=priority)

    def unpin(self) -> None:
        hbm_cache().unpin(self._res_key)

    def peek_device(self) -> DeviceRun | None:
        """The resident planes, or None: no upload, no LRU touch."""
        res = hbm_cache().peek(self._res_key)
        return None if res is None else res.dev

    def seed_device(self, dev: DeviceRun) -> None:
        """Admit planes built on the device (the device flush's) as the
        run's payload, budgeted and tracker-charged like an upload; the
        next access after an eviction uploads the host planes. The hint is
        the payload's own bytes (no host encoding on the flush's path)."""
        res = _Resident(dev, self._const_planes())
        hbm_cache().acquire(self._res_key, lambda: (res, res.nbytes),
                            nbytes_hint=res.nbytes)

    def invalidate_device(self) -> None:
        """Drop the resident payload of a run that stays live (its host
        planes grew in place: ALTER added columns): the planes, adopted
        ones included, K10's part table, and every aux entry (the
        side-car, the view, K13b's plan). The registration survives, so
        the next access uploads the grown host planes through the cache,
        budgeted and charged, as a counted miss (the JAX ``TpuRun``'s)."""
        hbm_cache().release(self._res_key)
        self.host_index = None
        self._dev_nbytes_hint = None

    def retire(self) -> None:
        """The run left the run set for good (a compaction merged it, or
        the engine closed): its payload, its aux tensors and its
        registration go; so does its host page index."""
        hbm_cache().invalidate(self._res_key)
        self.host_index = None

    def _aux(self, name: str, make):
        """The aux value ``name`` of the resident payload, made by
        ``make(payload) -> (value, bytes)`` on a miss and charged to the
        run's entry (not kept where the entry was evicted meanwhile)."""
        cache = hbm_cache()
        res = self.resident()
        value = cache.aux_get(self._res_key, name)
        if value is None:
            value, nbytes = make(res)
            cache.aux_put(self._res_key, name, value, nbytes)
        return value

    # -- the planes the kernels read -----------------------------------------
    def plain(self) -> dict:
        """The run's plain plane tree (its side-car when it is encoded)."""
        res = self.resident()
        if not res.dev.encoded:
            return res.dev.arrays

        def make(r):
            side = decode.decode_tree(r.dev.arrays, r.decode_plan)
            return side, device_nbytes(side, r.dev.arrays)

        return self._aux("plain", make)

    @property
    def sidecar_nbytes(self) -> int:
        """Device bytes of K10's side-car (0 while it is not resident)."""
        cache = hbm_cache()
        res = cache.peek(self._res_key)
        side = cache.aux_get(self._res_key, "plain")
        return 0 if side is None else device_nbytes(side, res.dev.arrays)

    def valid_plan(self, leaf, B: int, R: int):
        """K10's plan of the bit-packed ``valid`` leaf (K13b), laid out
        once and kept as an aux entry; None on the CPU."""
        if self.device.type != "cuda":
            return None

        def make(_r):
            plan = decode.plan_leaves([leaf], B, R)
            return plan, device_nbytes(plan.table)

        return self._aux("valid_plan", make)

    # -- the resolved view ---------------------------------------------------
    def view_key(self, read_ht: int) -> tuple:
        """Two read points resolve to one view exactly when they see the
        same versions (commit time <= read point) and the same expiries
        (expiry <= the expiry read point)."""
        return (int(np.searchsorted(self._hts, min(read_ht, MAX_HT),
                                    side="right")),
                int(np.searchsorted(self._exps, min(read_ht, MAX_HT - 1),
                                    side="right")))

    def view(self, key: tuple, read_planes: tuple) -> dict:
        """The resolved view of ``key`` (``read_planes``: those of any read
        point of that key). The source run's entry keeps one view, in its
        "view" aux slot, made by the run or by one masked copy of it: the
        previous one is let go before the new one is made."""
        cached = self.held_view()
        if cached is not None and cached[0] == key:
            return cached[1]
        del cached
        source = self.source
        cache = hbm_cache()
        cache.aux_pop(source._res_key, "view")
        res = source.resident()
        plain = self.plain()
        # A dictionary column's code plane is resolved as a column of its
        # own and comes back as the view column's code plane.
        arrays = decode.fold_code_columns(mvcc_resolve.resolve_view(
            decode.code_columns(plain), *read_planes, res.const))
        cache.aux_put(source._res_key, "view", (self._token, key, arrays),
                      device_nbytes(arrays, plain, res.dev.arrays,
                                     res.const))
        return arrays

    def held_view(self) -> tuple | None:
        """(view key, view arrays) when the view slot holds this run's
        (or this masked copy's) view, else None."""
        slot = hbm_cache().aux_get(self.source._res_key, "view")
        if slot is None or slot[0] is not self._token:
            return None
        return slot[1], slot[2]

    def drop_view(self) -> None:
        """Let this run's (or this masked copy's) view go."""
        if self.held_view() is not None:
            hbm_cache().aux_pop(self.source._res_key, "view")


class _MaskedRun(GpuRun):
    """The delta overlay's primary with its dirty keys' rows cleared from
    ``valid`` (the JAX engine's ``_MaskedRun``). It shares the source's
    ``ColumnarRun``, residency entry, view keys and constant view planes,
    and takes the source's view slot with a mark of its own: a masked
    view is never taken for the plain run's. Its planes are the source's
    plain tree with the masked ``valid``, assembled at each use, so that
    it holds no reference to the source's tensors; the masked plane is
    charged as an external entry while the overlay cache holds it."""

    def __init__(self, source: GpuRun, valid: torch.Tensor):
        self.crun = source.crun
        self._source = source
        self.flat = source.flat
        self.B = source.B
        self.device = source.device
        self.valid = valid
        self._token = object()
        if not self.flat:
            self._hts, self._exps = source._hts, source._exps

    @property
    def source(self) -> GpuRun:
        return self._source

    def resident(self, priority: str | None = None) -> _Resident:
        return self._source.resident(priority)

    def plain(self) -> dict:
        return dict(self._source.plain(), valid=self.valid)

    @property
    def dev(self) -> SimpleNamespace:
        return SimpleNamespace(B=self.B, arrays=self.plain(), encoded=False,
                               device=self.device)


def masked_valid(primary: GpuRun, idx: np.ndarray) -> torch.Tensor:
    """The primary's ``valid`` with the flattened rows ``idx`` cleared: K13
    on the plain plane, or, where the resident leaf is bit-packed, K13b
    (the JAX engine's ``_scatter_invalid_bits``): K10's decode of that one
    leaf into a new plane (its part table made once and kept as an aux
    entry of the run), then K13."""
    leaf = primary.dev.arrays["valid"]
    if enc.leaf_kind(leaf) == "bits":
        B, R = enc.tree_dims(primary.dev.arrays)
        (plane,), = decode.decode_leaves([leaf], B, R,
                                         primary.valid_plan(leaf, B, R))
        return scatter_invalid(plane, idx, copy=False)
    return scatter_invalid(primary.plain()["valid"], idx)


def scatter_invalid(valid: torch.Tensor, idx: np.ndarray,
                    copy: bool = True) -> torch.Tensor:
    """K13 (the JAX engine's ``_scatter_invalid``) as a torch op: a copy of
    ``valid`` with the flattened rows ``idx`` (int64) cleared. The copy is
    made from the source every time, so a plane that an in-flight batch
    may read is never written. The JAX engine pads ``idx`` to a few bucket
    sizes to bound its compiles; nothing compiles here, so it goes as it
    is. ``copy`` False clears, in place, a plane no one else holds."""
    out = valid.clone() if copy else valid
    out.view(-1).index_fill_(0, torch.from_numpy(idx).to(out.device), False)
    return out


class _CodePred:
    """A string predicate promoted to an exact int32 compare against a
    dictionary column's code plane (the JAX engine's ``_CodePred``): the
    run's dictionary is sorted, so the engine bisects the literal into a
    code bound and the kernels compare codes, with no host verify round.
    ``value`` is the code bound, ``op`` the (possibly rewritten) compare."""

    __slots__ = ("column", "op", "value")
    promoted = True

    def __init__(self, column: str, op: str, value: int):
        self.column = column
        self.op = op
        self.value = value


class _OverlayState:
    """The cached delta-overlay state (``GpuStorageEngine._overlay``): the
    masked primary, the key-sorted dirty rows ``(key, versions ht-desc
    across every source)`` with a parallel key list and a by-key map
    (what the incremental copy-on-write update bisects into), the cleared
    primary rows, the memtable version count the state includes, the
    host-partial cache, and the dirty rows merged and read at each of the
    last 8 read points (``_overlay_columns_at``)."""

    __slots__ = ("masked", "rows", "keys", "by_key", "idx", "mem_count",
                 "partial", "merged")

    def __init__(self, masked, rows, keys, by_key, idx, mem_count):
        self.masked = masked
        self.rows = rows
        self.keys = keys
        self.by_key = by_key
        self.idx = idx
        self.mem_count = mem_count
        self.partial: dict = {}
        self.merged: dict = {}


# A dirty row's column not read yet at a read point (_overlay_columns_at).
_UNREAD = object()

# _overlay_apply_delta verdict: the delta can't be applied (no memtable
# log) and the caller must rebuild from scratch.
_OVERLAY_REBUILD = object()


def _dirty_entry(crun: ColumnarRun, key: bytes, versions: list) -> tuple:
    """((key, ``versions`` and the primary's versions of ``key``, ht-desc),
    first primary row, primary rows of the key)."""
    start, own = crun.key_rows(key)
    versions = versions + own
    if len(versions) > 1:
        versions.sort(key=lambda x: (x.ht, x.write_id), reverse=True)
    return (key, versions), start, len(own)


def _row_spans(starts: list, counts: list) -> np.ndarray:
    """The int64 rows [start, start + count) of every span, in order."""
    starts = np.asarray(starts, np.int64)
    counts = np.asarray(counts, np.int64)
    first = np.cumsum(counts) - counts
    return np.repeat(starts - first, counts) + np.arange(int(counts.sum()))


@dataclass
class _AggPrep:
    """Host planning of one single-source flat aggregate."""

    spec: ScanSpec
    trun: GpuRun
    sig: dscan.ScanSig    # the fold's signature (a view's is flat)
    route: str            # "kernel" (K1), "flat" (the plain flat fold) or
                          # "full" (K5, past the flat fold's bounds); a
                          # multi-version run's view: "mv_" + the same
    row_lo: int
    row_hi: int
    read_planes: tuple    # read hi/lo, expiry hi/lo
    lits: tuple           # host predicate literals
    dev_aggs: tuple
    lowering: list
    view_key: tuple | None  # multi-version routes: the resolve's key
    overlay: _OverlayState | None = None  # an overlay spec's state
    host: tuple | None = None  # its dirty keys' host partial, once folded

    def arrays(self) -> dict:
        """The plain planes the fold reads: the run's (its side-car when it
        is encoded), or its resolved view."""
        if self.view_key is None:
            return self.trun.plain()
        return self.trun.view(self.view_key, self.read_planes)


@dataclass
class _GroupPrep:
    """Host planning of one single-run grouped or expression aggregate."""

    spec: ScanSpec
    trun: GpuRun
    sig: group_agg.GroupAggSig
    route: str            # "grouped" | "mv_grouped"
    row_lo: int
    row_hi: int
    read_planes: tuple    # read hi/lo, expiry hi/lo
    lits: tuple           # host predicate literals
    view_key: tuple | None  # a multi-version run: the resolve's key
    overlay = None        # never: the grouped route reads one run

    arrays = _AggPrep.arrays

    def k8_arrays(self) -> dict:
        """The planes K8 reads: a flat run's resident tree, encoded leaves
        and all (K8 decodes them as it stages its tiles), or the view."""
        if self.view_key is None:
            return self.trun.dev.arrays
        return self.arrays()


class GpuStorageEngine(RowPath, StorageEngine):
    """Options: ``device`` (default ``cuda``; raises when there is no
    GPU), ``rows_per_block`` (2048), ``memtable_flush_versions`` (the
    memtable size at which ``apply`` flushes and then calls
    ``maybe_compact``; 1 << 60) and ``compaction_trigger`` (the run count
    at which ``maybe_compact`` compacts; 4). A run may hold any number of
    versions per key; an aggregate over several runs or a live memtable
    beside them goes through the delta overlay, and the rest over several
    sources through the row scan (``storage.gpu_rows``).

    ``plane_encoding`` (``"auto"``, the default as in the JAX package, or
    ``"off"``) is the JAX flag ``tpu_plane_encoding``'s counterpart: under
    ``"auto"`` host-built and compacted runs upload their encoded tree,
    flushed string columns are written as dictionary codes, and string
    predicates of a single-run aggregate are promoted to exact code
    compares (``stats()["code_promotions"]``); under ``"off"`` every run
    uploads its plain planes, as before.

    ``stats()["flush_paths"]`` counts the flushes by route (``device``,
    ``host``) and ``stats()["compact_paths"]`` the compactions by the
    route of their retention mask (``k11``, ``twin``) or the host merge
    (``host``); ``last_flush`` / ``last_compact`` hold the host-clock
    seconds of the last one's parts. ``stats()["plane_encoding"]`` holds
    the runs' bytes by encoding (the JAX engine's ``plane_stats``) and
    the K10 side-cars' device bytes.

    ``tracker_name`` names the engine's device tracker (the tablet passes
    its id). ``data_dir`` (default None: nothing on disk) is the directory
    of the engine's run files (``storage.run_io.RunPersistence``): the
    runs found there are loaded at construction, each flush saves its
    run, and a compaction or ``restore_entries`` replaces every file.

    ``breaker_failure_threshold`` and ``breaker_cooldown_s`` (defaults:
    the flags ``gpu_breaker_failure_threshold`` / ``gpu_breaker_cooldown_s``,
    3 and 1.0 s) configure the circuit breaker; ``stats()["breaker"]``
    gives its state and trips, ``stats()["host_reserves"]`` the batches
    re-served from the host, and ``stats()["residency"]`` the residency
    cache's stats. The runs' resident bytes are charged to the engine's
    ``device_tracker`` (a child of the root tracker's ``device``);
    ``close()`` retires the runs and detaches it."""

    def __init__(self, schema: Schema, options: dict | None = None):
        super().__init__(schema, options)
        self.device = resolve_device(self.options.get("device"))
        # The runs' resident bytes, charged and released entry by entry
        # by the residency cache.
        self.device_tracker = root_tracker().child("device").child(
            self.options.get("tracker_name", f"engine-{id(self):x}"))
        # Fault domain: the breaker quarantines the device path after
        # repeated device faults; meanwhile every batch is re-served from
        # the host structures (_serve_host_batch).
        self.breaker = CircuitBreaker(
            f"gpu_engine:{self.device_tracker.name}",
            failure_threshold=int(self.options.get(
                "breaker_failure_threshold",
                FLAGS.get("gpu_breaker_failure_threshold"))),
            cooldown_s=float(self.options.get(
                "breaker_cooldown_s", FLAGS.get("gpu_breaker_cooldown_s"))))
        self.host_reserves = 0  # batches re-served from the host
        # The cached overlay's pin on its primary and the residency entry
        # of its masked valid plane (_cache_overlay / _drop_overlay_cache).
        self._overlay_pinned: GpuRun | None = None
        self._overlay_ext_key: int | None = None
        self.plane_encoding = self.options.get("plane_encoding",
                                               DEFAULT_PLANE_ENCODING)
        if self.plane_encoding not in PLANE_ENCODINGS:
            raise ValueError(f"plane_encoding {self.plane_encoding!r}: want "
                             f"one of {PLANE_ENCODINGS}")
        self.memtable = MemTable()
        self.runs: list[GpuRun] = []
        self.flushed_frontier_ht = 0
        self.rows_per_block = int(self.options.get(
            "rows_per_block", DEFAULT_ROWS_PER_BLOCK))
        self.mat = RowMaterializer(schema)
        # (run list, memtable, its version count, _OverlayState or None).
        self._overlay_cache = None
        # Scans of the memtable alone: no run holds their range.
        self.memtable_scans = 0
        # Grouped specs re-served by a host fold of their run (a negative
        # sum input or a bucket collision).
        self.grouped_host_folds = 0
        self._kinds = {c.col_id: dtype_kind(c.dtype)
                       for c in schema.value_columns}
        self._dtypes = {c.col_id: c.dtype for c in schema.value_columns}
        self._name_to_id = {c.name: c.col_id for c in schema.value_columns}
        self._key_col_names = {c.name for c in schema.key_columns}
        self._plan_cache: dict = {}        # gather plans by structure
        self._read_plane_cache: dict = {}  # read planes by read point
        # Single-source aggregate specs served, by route (_AggPrep.route).
        self.agg_routes = {r: 0 for r in ("kernel", "flat", "full",
                                          "mv_kernel", "mv_flat", "mv_full")}
        self.full_launches = 0  # K5 launches
        # Aggregates whose string predicates were promoted to code compares.
        self.code_promotions = 0
        self.flush_paths = {"device": 0, "host": 0}
        self.compact_paths = {"k11": 0, "twin": 0, "host": 0}
        self.last_flush: dict = {}
        self.last_compact: dict = {}
        # The runs saved on disk (the JAX engine's): loaded here, built on
        # the host, uploaded at their first access through the cache.
        # ``last_load`` holds the host-clock seconds of reading the files
        # and of building their runs.
        self.persist = RunPersistence(self.options.get("data_dir"))
        self.last_load = {"load_s": 0.0, "build_s": 0.0}
        for path in self.persist.files:
            t0 = time.perf_counter()
            entries = load_run(path)
            t1 = time.perf_counter()
            crun = ColumnarRun.build(self.schema, entries,
                                     self.rows_per_block)
            self.last_load["load_s"] += t1 - t0
            self.last_load["build_s"] += time.perf_counter() - t1
            self.runs.append(GpuRun(crun, self.device,
                                    setting=self.plane_encoding,
                                    tracker=self.device_tracker))
            self.flushed_frontier_ht = max(self.flushed_frontier_ht,
                                           crun.max_ht)

    # -- writes --------------------------------------------------------------
    def apply(self, rows: list[RowVersion]) -> None:
        """Apply committed versions; once the memtable holds
        ``memtable_flush_versions`` of them, flush and let the compaction
        trigger decide (the JAX engine's ``_after_apply``)."""
        self.memtable.apply(rows)
        limit = self.options.get("memtable_flush_versions",
                                 MEMTABLE_FLUSH_VERSIONS)
        if self.memtable.num_versions >= limit:
            self.flush()
            self.maybe_compact()

    def flush(self) -> None:
        """The memtable into a new run: the device flush (K12) when it is
        eligible, else the host build (the JAX engine's generic drain +
        build) and an upload."""
        if self.memtable.is_empty:
            return
        self.flushed_frontier_ht = max(self.flushed_frontier_ht,
                                       self.memtable.max_ht)
        trun = self._device_flush()
        if trun is not None:
            self.flush_paths["device"] += 1
            if self.persist.enabled:
                # The run's own entries: its row objects are the memtable's
                # versions, so the file is the JAX engine's for the same
                # memtable.
                t0 = time.perf_counter()
                self.persist.save_new(list(trun.crun.iter_entries()))
                self.last_flush["persist_s"] = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            entries = self.memtable.drain_sorted()
            t1 = time.perf_counter()
            crun = ColumnarRun.build(self.schema, entries,
                                     self.rows_per_block)
            trun = GpuRun(crun, self.device, setting=self.plane_encoding,
                          tracker=self.device_tracker)
            # The run uploads at its first access, through the cache.
            t2 = time.perf_counter()
            self.persist.save_new(entries)
            self.last_flush = {"route": "host", "drain_s": t1 - t0,
                               "build_s": t2 - t1,
                               "persist_s": time.perf_counter() - t2}
            self.flush_paths["host"] += 1
        self.runs.append(trun)
        self.memtable = MemTable()
        # The run set changed: the overlay is built anew at its next use.
        self._drop_overlay_cache()
        self._plan_cache.clear()

    def _device_flush(self) -> GpuRun | None:
        """The JAX engine's ``_device_flush``: stage the memtable's
        apply-order versions through the columnar encoders in one block of
        m rows (the next power of two >= n, at least 1024), sort them
        (key asc, hybrid time desc, write id desc: ``drain_sorted``'s
        order) with one stable argsort over memcmp keys, pack the key
        groups into blocks, and scatter the sorted planes on the device
        (``_device_flush_dispatch``). None where the JAX engine takes the
        host build: a key longer than the prefix planes hold, a value the
        encoders reject, a key group longer than a block, planes past the
        residency budget, the breaker open, or a device fault in the
        dispatch (recorded on the breaker)."""
        rows = self.memtable.versions_since(0)
        if not rows:
            return None
        n = len(rows)
        keys = [r.key for r in rows]
        max_key_len = max(map(len, keys))
        if max_key_len > MAX_DEVICE_KEY:
            return None
        t0 = time.perf_counter()
        m = 1 << max(10, (n - 1).bit_length())
        try:
            staged = ColumnarRun(self.schema, rows_per_block=m)
            staged.B = 1
            staged._alloc(1)
            staged.stage_rows(rows)
        except (OverflowError, ValueError, TypeError):
            return None  # a value shape the encoders reject: host build
        t1 = time.perf_counter()
        wid = np.fromiter((r.write_id for r in rows), np.int64, n)
        sk = _flush_sortkey(staged.key_planes[0, :n], staged.ht_hi[0, :n],
                            staged.ht_lo[0, :n], wid)
        perm = np.argsort(sk, kind="stable").astype(np.int32)
        kw_s = staged.key_planes[0][perm]
        new_group = np.empty(n, dtype=bool)
        new_group[0] = True
        new_group[1:] = (kw_s[1:] != kw_s[:-1]).any(axis=1)
        gstarts = np.flatnonzero(new_group)
        sizes = np.diff(np.append(gstarts, n))
        try:
            ranges = ColumnarRun.pack_group_ranges(sizes.tolist(),
                                                   self.rows_per_block)
        except ValueError:
            return None  # a key group longer than a block: host build
        budget = hbm_cache().budget()
        if budget and dflush.flush_plane_nbytes(
                padded_blocks(len(ranges), PAD_BLOCKS), self.rows_per_block,
                self.schema) > budget:
            return None  # the run exceeds the residency budget: host build
        if not self.breaker.allow():
            return None
        parts = {"route": "device", "staging_s": t1 - t0,
                 "sort_s": time.perf_counter() - t1}
        try:
            return self._device_flush_dispatch(
                rows, keys, staged, perm, kw_s, new_group, gstarts, sizes,
                ranges, max_key_len, parts)
        except BaseException as e:
            # Any raise retires the probe allow() admitted; a device fault
            # sends the flush to the host build, anything else propagates.
            self.breaker.record_failure(e)
            if is_device_fault(e):
                return None
            raise

    def _device_flush_dispatch(self, rows, keys, staged, perm, kw_s,
                               new_group, gstarts, sizes, ranges,
                               max_key_len, parts) -> GpuRun:
        """K12 over the staged planes; the run's host planes read back
        from the very device planes it adopts; keys, row objects and
        varlen payloads scattered on the host by the same packing."""
        self._device_fault_point()
        n = len(rows)
        R = self.rows_per_block
        B = len(ranges)
        Bp = padded_blocks(B, PAD_BLOCKS)
        dev = self.device
        rows_per = np.array([nr for _g0, _gn, nr in ranges], np.int64)
        offs = np.cumsum(rows_per) - rows_per
        block_of = np.repeat(np.arange(B, dtype=np.int64), rows_per)
        dst = (block_of * R + (np.arange(n, dtype=np.int64)
                               - np.repeat(offs, rows_per))).astype(np.int32)
        t0 = time.perf_counter()

        def up(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

        # Only the n staged rows travel: the block's pad rows are never
        # gathered.
        staged_tree = {name: up(getattr(staged, name)[0, :n])
                       for name in ("ht_hi", "ht_lo", "exp_hi", "exp_lo",
                                    "tomb", "live")}
        staged_tree["cols"] = {}
        dict_cols = self._flush_dict_cols(staged, n)
        for cid, col in staged.cols.items():
            entry = {"set": up(col.set_[0, :n]),
                     "isnull": up(col.isnull[0, :n])}
            if cid in dict_cols:
                codes, dhi, dlo, _uniq = dict_cols[cid]
                entry.update(codes=up(codes.view(np.int16)), dhi=up(dhi),
                             dlo=up(dlo))
            else:
                entry["cmp"] = up(col.cmp_planes[0, :n])
            if col.arith is not None:
                entry["arith"] = up(col.arith[0, :n])
            staged_tree["cols"][cid] = entry
        is_real = np.zeros(Bp, dtype=bool)
        is_real[:B] = True
        ehi, elo = P.scalar_ht_planes(MAX_HT)
        perm_t, dst_t, gs_t, real_t = (up(perm), up(dst), up(new_group),
                                       up(is_real))
        t1 = time.perf_counter()
        out = dflush.replay_flush(staged_tree, perm_t, dst_t, gs_t, real_t,
                                  ehi, elo, R)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the readback below waits anyway
        t2 = time.perf_counter()
        host = _tree_to_host(out)
        t3 = time.perf_counter()

        run = ColumnarRun(self.schema, R)
        run.B = B
        run._alloc(B)
        for name in ("valid", "group_start", "tomb", "live", "ht_hi",
                     "ht_lo", "exp_hi", "exp_lo"):
            setattr(run, name, host[name][:B])
        for cid, col in run.cols.items():
            h = host["cols"][cid]
            col.set_ = h["set"][:B]
            col.isnull = h["isnull"][:B]
            if cid in dict_cols:
                # The host planes decode the codes through the dictionary
                # (a numpy gather: what the kernels decode).
                e = h["cmp"]["dict"]
                codes = e["codes"][:B].view(np.uint16).astype(np.int64)
                col.cmp_planes = np.ascontiguousarray(np.stack(
                    [e["dhi"][codes], e["dlo"][codes]], axis=-1))
            else:
                col.cmp_planes = h["cmp"][:B]
            if col.arith is not None:
                col.arith = h["arith"][:B]
        # The run's dictionaries are the flush's (the ones its encoded
        # tree would build): string predicates promote against them.
        run.enc_dicts = {cid: d[3] for cid, d in dict_cols.items()}

        # Keys and row payloads stay on the host: the same packing.
        def scatter(dest, vals):
            dest.reshape((B * R,) + dest.shape[2:])[dst] = vals

        scatter(run.key_planes, kw_s)
        keys_arr = np.empty(n, dtype=object)
        keys_arr[:] = keys
        keys_s = keys_arr[perm]
        scatter(run.row_keys, keys_s)
        vers_arr = np.empty(n, dtype=object)
        vers_arr[:] = rows
        scatter(run.row_versions, vers_arr[perm])
        order = None
        for cid, col in run.cols.items():
            if col.varlen is None:
                continue
            if order is None:
                order = perm.tolist()
            src = staged.cols[cid].varlen[0]
            vals = [src[i] for i in order]
            for b, (o, nr) in enumerate(zip(offs.tolist(),
                                            rows_per.tolist())):
                col.varlen[b][:nr] = vals[o:o + nr]
        group_keys = keys_s[gstarts]
        for b, (g0, gn, nrows) in enumerate(ranges):
            run.blocks[b] = BlockMeta(group_keys[g0],
                                      group_keys[g0 + gn - 1], nrows)
        run.min_key = group_keys[0]
        run.max_key = run.blocks[B - 1].max_key
        run.num_versions = n
        run.max_ht = staged.max_ht
        run.max_group_versions = int(sizes.max())
        run.max_key_len = max_key_len
        run.varlen_max_len = dict(staged.varlen_max_len)
        t4 = time.perf_counter()
        trun = GpuRun(run, dev, DeviceRun.from_arrays(out, R),
                      setting=self.plane_encoding,
                      tracker=self.device_tracker)
        del out
        self.last_flush = dict(parts, upload_s=t1 - t0, k12_s=t2 - t1,
                               readback_s=t3 - t2, host_scatter_s=t4 - t3,
                               run_s=time.perf_counter() - t4)
        self.breaker.record_success()
        return trun

    def _flush_dict_cols(self, staged, n: int) -> dict:
        """The JAX engine's ``_flush_dict_cols``: under ``plane_encoding``
        ``"auto"``, each string or binary column's dictionary over its
        staged set non-NULL values, ``{cid: (codes [m] u16, dhi, dlo,
        sorted raw values)}``, built as ``ColumnarRun._encode_dict_col``
        builds a run's (same dictionary, same codes); a column past
        ``DICT_MAX_VALUES`` values keeps its prefix planes."""
        if self.plane_encoding == "off":
            return {}
        out = {}
        m = staged.R
        for cid, col in staged.cols.items():
            if col.varlen is None:
                continue
            idxs = np.flatnonzero(col.set_[0, :n] & ~col.isnull[0, :n])
            if idxs.size == 0:
                continue
            src = col.varlen[0]
            built = sorted_dictionary([src[i] for i in idxs.tolist()])
            if built is None:
                continue
            uniq, row_codes = built
            dhi, dlo = dictionary_planes(uniq)
            codes = np.full(m, dhi.shape[0] - 1, np.int64)
            codes[idxs] = row_codes
            out[cid] = (codes.astype(np.uint16)[:n], dhi, dlo, uniq)
        return out

    # -- compaction ----------------------------------------------------------
    def compact(self, history_cutoff_ht: int = 0) -> None:
        """Merge every run into one, GCing history at the cutoff (the JAX
        engine's ``compact``): when every key fits the prefix planes, the
        merge order on the host, the retention mask (K11 over the resident
        planes past ``HOST_GC_MASK_MAX`` rows, the numpy twin below) and a
        gather of the survivors' planes into the merged run; else the host
        merge (``merge_entry_streams`` + ``gc_versions``) and a build. The
        memtable stays as it is. Reference hot loop: CompactionJob::Run
        (src/yb/rocksdb/db/compaction_job.cc:622)."""
        if len(self.runs) <= 1 and history_cutoff_ht == 0:
            return
        # Moving hundreds of thousands of row objects between containers
        # makes the cyclic GC fire on allocation and rescan the heap;
        # nothing here makes cycles, so it pauses for the compaction.
        gc_was = gc.isenabled()
        gc.disable()
        try:
            self._compact_locked(history_cutoff_ht)
        finally:
            if gc_was:
                gc.enable()

    def _compact_locked(self, cutoff: int) -> None:
        self.last_compact = {}
        result = None
        if self.runs and all(t.crun.max_key_len <= MAX_DEVICE_KEY
                             for t in self.runs) \
                and sum(t.crun.num_versions for t in self.runs) > 0:
            result = self._device_compact_entries(cutoff)
        if result is None:
            t0 = time.perf_counter()
            merged = []
            for key, versions in merge_entry_streams(
                    [t.crun.iter_entries() for t in self.runs]):
                kept = gc_versions(key, versions, cutoff)
                if kept:
                    merged.append((key, kept))
            crun = (ColumnarRun.build(self.schema, merged,
                                      self.rows_per_block)
                    if merged else None)
            self.compact_paths["host"] += 1
            self.last_compact = {"route": "host",
                                 "merge_build_s": time.perf_counter() - t0}
            self.persist.replace_all(merged)
        else:
            (crun,) = result
            if self.persist.enabled:
                t0 = time.perf_counter()
                self.persist.replace_all(list(crun.iter_entries())
                                         if crun is not None else [])
                self.last_compact["persist_s"] = time.perf_counter() - t0
        old_runs = self.runs
        # The merged run uploads at its first access, as any host-built
        # run.
        self.runs = ([GpuRun(crun, self.device, setting=self.plane_encoding,
                             tracker=self.device_tracker)]
                     if crun is not None else [])
        # Everything that pointed at the old runs goes: the overlay state
        # and its pin, the gather plans, the read planes, the runs'
        # residency entries.
        self._drop_overlay_cache()
        self._plan_cache.clear()
        self._read_plane_cache.clear()
        for t in old_runs:
            t.retire()

    def _drop_overlay_cache(self) -> None:
        """Forget the cached delta-overlay state, releasing its pin on
        the primary run and its masked-valid residency entry (the JAX
        engine's). Must run whenever the run set changes (flush, compact,
        close): validity checks alone would leak the pin."""
        self._overlay_cache = None
        if self._overlay_pinned is not None:
            self._overlay_pinned.unpin()
            self._overlay_pinned = None
        if self._overlay_ext_key is not None:
            hbm_cache().invalidate(self._overlay_ext_key)
            self._overlay_ext_key = None

    def close(self) -> None:
        """Let go of the device: the overlay, every run's residency entry,
        and the engine's device tracker."""
        self._drop_overlay_cache()
        for t in self.runs:
            t.retire()
        self._plan_cache.clear()
        self.device_tracker.detach()

    # -- the rest of the tablet's seam (the JAX engine's) --------------------
    def restore_entries(self, entries) -> None:
        """Replace everything (memtable, runs, files) with ``entries``
        (key asc, versions ht-desc): the snapshot-restore primitive. The
        new run uploads at its first access."""
        self.memtable = MemTable()
        self.persist.replace_all(entries)
        old_runs = list(self.runs)
        if entries:
            crun = ColumnarRun.build(self.schema, entries,
                                     self.rows_per_block)
            self.runs = [GpuRun(crun, self.device,
                                setting=self.plane_encoding,
                                tracker=self.device_tracker)]
            self.flushed_frontier_ht = max(self.flushed_frontier_ht,
                                           crun.max_ht)
        else:
            self.runs = []
        self._plan_cache.clear()
        self._read_plane_cache.clear()
        self._drop_overlay_cache()
        for t in old_runs:
            t.retire()

    def dump_entries(self) -> list:
        """Every run's (key, versions ht-desc) pairs, key-merged across
        runs: the storage payload of a remote-bootstrap session."""
        return list(merge_entry_streams(
            [t.crun.iter_entries() for t in self.runs]))

    def alter_schema(self, new_schema: Schema) -> None:
        """Adopt an evolved schema (the JAX engine's): the memtable flushes
        first, so that no old-schema rows build a run after the switch;
        every run gets all-unset planes for each ADDED column (its rows
        read NULL there) and drops its device payload and everything
        derived from the old column set (``invalidate_device``: planes,
        K10's part table, side-car, view, K13b's plan; and the encoded
        tree with its byte accounting), so that the next access re-uploads
        the grown planes through the cache; dropped columns keep their
        (now unreachable) planes. Then the overlay and the plan caches
        go."""
        self.flush()
        super().alter_schema(new_schema)
        self.mat = RowMaterializer(new_schema)
        self._kinds = {c.col_id: dtype_kind(c.dtype)
                       for c in new_schema.value_columns}
        self._dtypes = {c.col_id: c.dtype for c in new_schema.value_columns}
        self._name_to_id = {c.name: c.col_id
                            for c in new_schema.value_columns}
        self._key_col_names = {c.name for c in new_schema.key_columns}
        self._drop_overlay_cache()
        self._plan_cache.clear()
        self._read_plane_cache.clear()
        for trun in self.runs:
            crun = trun.crun
            B, R = crun.key_planes.shape[0], crun.R
            changed = False
            for c in new_schema.value_columns:
                if c.col_id in crun.cols:
                    continue
                planes = 2 if c.dtype.device_planes == 2 else 1
                crun.cols[c.col_id] = ColumnData(
                    dtype=c.dtype,
                    set_=np.zeros((B, R), dtype=bool),
                    isnull=np.zeros((B, R), dtype=bool),
                    cmp_planes=np.zeros((B, R, planes), dtype=np.int32),
                    arith=(np.zeros((B, R), dtype=np.float32)
                           if c.dtype.is_numeric else None),
                    varlen=([[None] * R for _ in range(B)]
                            if not c.dtype.is_fixed_width else None),
                )
                changed = True
            crun.schema = new_schema
            trun.host_index = None  # column planes changed shape or set
            if changed:
                crun._enc_cache = None
                crun.enc_stats = None
                trun.invalidate_device()

    def _device_gc_fits_budget(self) -> bool:
        """The retention mask K11 needs every run pinned at once, with
        its plain planes (an encoded run's side-car); under a budget
        smaller than those bytes that would force a pinned overflow, so
        the caller takes the numpy twin instead (the JAX engine's)."""
        b = hbm_cache().budget()
        if not b:
            return True
        need = 0
        for t in self.runs:
            plain = plane_nbytes(t.crun, PAD_BLOCKS, "off")
            hint = t._nbytes_hint()
            need += hint if hint == plain else hint + plain
        return need <= b

    def _device_compact_entries(self, cutoff: int):
        """The JAX engine's ``_device_compact_entries``: ``(merged run or
        None when nothing survives,)``, or None when the union is empty.
        The union's planes are concatenated from the runs' valid rows, the
        merge order is a k-way merge of the presorted runs over memcmp
        keys (``_merge_sorted``), the retention mask runs over the sorted
        union, and the merged run is assembled by gathering the
        survivors' existing planes (``_gather_run``), with no re-encoding.
        The union is not padded: nothing compiles per shape here."""
        t0 = time.perf_counter()
        crs = [t.crun for t in self.runs]
        col_ids = [c.col_id for c in self.schema.value_columns]
        parts_kw = []
        parts = {k: [] for k in ("ht_hi", "ht_lo", "exp_hi", "exp_lo",
                                 "tomb", "live")}
        set_parts = {cid: [] for cid in col_ids}
        null_parts = {cid: [] for cid in col_ids}
        cmp_parts = {cid: [] for cid in col_ids}
        arith_parts = {cid: [] for cid in col_ids}
        varlen_all = {cid: [] for cid in col_ids}
        src_parts = []  # each valid row's flat row in the resident planes
        run_row_counts = []
        off = 0
        for t, cr in zip(self.runs, crs):
            nrun = 0
            for b in range(cr.B):
                nv = cr.blocks[b].num_valid
                if nv == 0:
                    continue
                nrun += nv
                parts_kw.append(cr.key_planes[b, :nv])
                for k, lst in parts.items():
                    lst.append(getattr(cr, k)[b, :nv])
                for cid in col_ids:
                    col = cr.cols[cid]
                    set_parts[cid].append(col.set_[b, :nv])
                    null_parts[cid].append(col.isnull[b, :nv])
                    cmp_parts[cid].append(col.cmp_planes[b, :nv])
                    if col.arith is not None:
                        arith_parts[cid].append(col.arith[b, :nv])
                    if col.varlen is not None:
                        varlen_all[cid].extend(col.varlen[b][:nv])
                src_parts.append(np.arange(off + b * cr.R,
                                           off + b * cr.R + nv,
                                           dtype=np.int32))
            run_row_counts.append(nrun)
            off += t.B * cr.R
        if not parts_kw:
            return None
        N = sum(run_row_counts)
        kw = np.concatenate(parts_kw)
        ht_hi = np.concatenate(parts["ht_hi"])
        ht_lo = np.concatenate(parts["ht_lo"])
        exp_hi = np.concatenate(parts["exp_hi"])
        exp_lo = np.concatenate(parts["exp_lo"])
        tomb = np.concatenate(parts["tomb"])
        live = np.concatenate(parts["live"])
        cat_set = {cid: np.concatenate(set_parts[cid]) for cid in col_ids}
        t1 = time.perf_counter()

        # The merge ORDER on the host: each run is (key asc, ht desc)
        # already, so a k-way merge of the runs over memcmp sort keys.
        run_items = []
        start = 0
        for nrows in run_row_counts:
            if nrows == 0:
                continue
            sk = _sortkey_bytes(kw[start:start + nrows],
                                ht_hi[start:start + nrows],
                                ht_lo[start:start + nrows])
            run_items.append((np.arange(start, start + nrows,
                                        dtype=np.int64), sk))
            start += nrows
        perm = _merge_sorted(run_items)
        skw = kw[perm]
        new_group = np.empty(N, dtype=bool)
        new_group[0] = True
        new_group[1:] = (skw[1:] != skw[:-1]).any(axis=1)
        t2 = time.perf_counter()

        c_hi, c_lo = P.scalar_ht_planes(max(cutoff, 0))
        cutoff_planes = (c_hi, c_lo, c_hi, c_lo)
        keep_host = None
        gc_pins: list[GpuRun] = []
        if N > HOST_GC_MASK_MAX and self._device_gc_fits_budget():
            # K11 over the resident planes: only the sorted flat-index
            # vector, the group bits and the group starts go up. Every run
            # is pinned until the mask is on the host, so that no eviction
            # drops planes the launch reads.
            dev = self.device
            idx = np.concatenate(src_parts)[perm]
            try:
                for t in self.runs:
                    t.pin("low")
                    gc_pins.append(t)
                plains = [t.plain() for t in self.runs]
                runs_planes = tuple(
                    {"ht_hi": p["ht_hi"], "ht_lo": p["ht_lo"],
                     "exp_hi": p["exp_hi"], "exp_lo": p["exp_lo"],
                     "tomb": p["tomb"], "live": p["live"],
                     "sets": tuple(p["cols"][cid]["set"]
                                   for cid in col_ids)}
                    for p in plains)
                del plains
                keep_dev = dcompact.resident_gc_mask(
                    runs_planes, torch.from_numpy(idx).to(dev),
                    torch.from_numpy(new_group).to(dev),
                    torch.from_numpy(np.flatnonzero(new_group).astype(
                        np.int32)).to(dev), cutoff_planes)
                del runs_planes
                keep_host = _to_host(keep_dev)
                event = None
                if keep_dev.is_cuda:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
            except BaseException:
                for t in gc_pins:
                    t.unpin()
                raise
            self.compact_paths["k11"] += 1
        else:
            keep = dcompact.gc_mask_host(
                len(col_ids),
                {"new_group": new_group, "ht_hi": ht_hi[perm],
                 "ht_lo": ht_lo[perm], "exp_hi": exp_hi[perm],
                 "exp_lo": exp_lo[perm], "tomb": tomb[perm],
                 "live": live[perm],
                 "set_": [cat_set[cid][perm] for cid in col_ids]},
                cutoff_planes)
            self.compact_paths["twin"] += 1
        t3 = time.perf_counter()
        # While the mask computes, the row payloads: block views of the
        # runs' object planes, one pointer-copying concatenate each.
        valid_blocks = [(cr, b, cr.blocks[b].num_valid)
                        for cr in crs for b in range(cr.B)
                        if cr.blocks[b].num_valid]
        all_keys = np.concatenate([cr.row_keys[b, :nv]
                                   for cr, b, nv in valid_blocks])
        all_vers = np.concatenate([cr.row_versions[b, :nv]
                                   for cr, b, nv in valid_blocks])
        t4 = time.perf_counter()
        if keep_host is not None:
            try:
                if event is not None:
                    event.synchronize()
            finally:
                for t in gc_pins:
                    t.unpin()
            keep = keep_host.numpy()
        t5 = time.perf_counter()
        kept_pos = np.flatnonzero(keep)
        kept_src = perm[kept_pos]
        crun = None
        if kept_src.size:
            # Group boundaries among the kept rows (still key-sorted).
            gid_sorted = np.cumsum(new_group.astype(np.int64)) - 1
            kept_gids = gid_sorted[kept_pos]
            kept_new_group = np.empty(kept_src.size, dtype=bool)
            kept_new_group[0] = True
            kept_new_group[1:] = kept_gids[1:] != kept_gids[:-1]
            planes = {"ht_hi": ht_hi, "ht_lo": ht_lo, "exp_hi": exp_hi,
                      "exp_lo": exp_lo, "tomb": tomb, "live": live,
                      "set": cat_set}
            crun = self._gather_run(kept_src, kept_new_group, all_keys,
                                    all_vers, kw, planes, col_ids,
                                    null_parts, cmp_parts, arith_parts,
                                    varlen_all)
        self.last_compact = {
            "route": "k11" if keep_host is not None else "twin",
            "rows": N, "kept": int(kept_src.size), "concat_s": t1 - t0,
            "order_s": t2 - t1, "mask_s": t3 - t2 + t5 - t4,
            "gather_s": t4 - t3 + time.perf_counter() - t5}
        return (crun,)

    def _gather_run(self, kept_src, kept_new_group, all_keys, all_vers, kw,
                    planes, col_ids, null_parts, cmp_parts, arith_parts,
                    varlen_all) -> ColumnarRun:
        """The merged run, assembled by gathering the surviving rows'
        planes (the JAX engine's ``_gather_run``): key groups packed by
        ``pack_group_ranges``, one flat scatter a plane."""
        R = self.rows_per_block
        nk = kept_src.size
        bounds = np.flatnonzero(kept_new_group).tolist() + [nk]
        sizes = [bounds[gi + 1] - bounds[gi] for gi in range(len(bounds) - 1)]
        ranges = [(bounds[g0], rows) for g0, _gn, rows
                  in ColumnarRun.pack_group_ranges(sizes, R)]
        run = ColumnarRun(self.schema, R)
        B = len(ranges)
        run.B = B
        run._alloc(B)
        starts = np.array([s0 for s0, _n in ranges], dtype=np.int64)
        ns = np.array([n for _s0, n in ranges], dtype=np.int64)
        block_of = np.repeat(np.arange(B, dtype=np.int64), ns)
        dst = block_of * R + (np.arange(nk, dtype=np.int64)
                              - np.repeat(starts, ns))

        def scatter(dest, vals):
            dest.reshape((B * R,) + dest.shape[2:])[dst] = vals

        scatter(run.key_planes, kw[kept_src])
        for name in ("ht_hi", "ht_lo", "exp_hi", "exp_lo", "tomb", "live"):
            scatter(getattr(run, name), planes[name][kept_src])
        run.valid.reshape(-1)[dst] = True
        scatter(run.group_start, kept_new_group)
        for cid in col_ids:
            col = run.cols[cid]
            scatter(col.set_, planes["set"][cid][kept_src])
            scatter(col.isnull, np.concatenate(null_parts[cid])[kept_src])
            scatter(col.cmp_planes, np.concatenate(cmp_parts[cid])[kept_src])
            if col.arith is not None and arith_parts[cid]:
                scatter(col.arith, np.concatenate(arith_parts[cid])[kept_src])
        scatter(run.row_keys, all_keys[kept_src])
        scatter(run.row_versions, all_vers[kept_src])
        varlen_cols = [cid for cid in col_ids
                       if run.cols[cid].varlen is not None]
        for b, (s0, n) in enumerate(ranges):
            if varlen_cols:
                sel = kept_src[s0:s0 + n].tolist()
                for cid in varlen_cols:
                    vl = varlen_all[cid]
                    run.cols[cid].varlen[b][:n] = [vl[i] for i in sel]
            run.blocks[b] = BlockMeta(run.row_keys[b][0],
                                      run.row_keys[b][n - 1], n)
        run.min_key = run.row_keys[0][0]
        run.max_key = run.blocks[B - 1].max_key
        run.num_versions = nk
        run.max_ht = int(P.planes_to_u64(planes["ht_hi"][kept_src],
                                         planes["ht_lo"][kept_src]).max())
        run.max_group_versions = max(sizes)
        # Exact maxima over the SURVIVING rows, so that GC'd long keys or
        # values do not turn the device routes off for good.
        kept_keys = all_keys[kept_src]
        run.max_key_len = int(np.fromiter(map(len, kept_keys), np.int64,
                                          kept_keys.size).max())
        for b in range(B):
            n = run.blocks[b].num_valid
            for cid in varlen_cols:
                lens = [len(_varlen_raw(v)) for v in
                        run.cols[cid].varlen[b][:n] if v is not None]
                if lens:
                    run.varlen_max_len[cid] = max(
                        run.varlen_max_len.get(cid, 0), max(lens))
        return run

    def stats(self) -> dict:
        """Counters; ``device_bytes`` are the runs' planes resident now
        (a run evicted or not yet uploaded counts 0: nothing uploads
        here)."""
        resident = [t.peek_device() for t in self.runs]
        return {
            "num_runs": len(self.runs),
            "memtable_versions": self.memtable.num_versions,
            "run_versions": sum(t.crun.num_versions for t in self.runs),
            "flushed_frontier_ht": self.flushed_frontier_ht,
            "device_bytes": sum(d.nbytes for d in resident if d is not None),
            "flush_paths": dict(self.flush_paths),
            "compact_paths": dict(self.compact_paths),
            "agg_routes": dict(self.agg_routes),
            "full_launches": self.full_launches,
            "code_promotions": self.code_promotions,
            "plane_encoding": self.plane_stats(),
            "residency": hbm_cache().stats(),
            "breaker": {"state": self.breaker.state,
                        "trips": self.breaker.trips},
            "host_reserves": self.host_reserves,
        }

    def plane_stats(self) -> dict:
        """The JAX engine's ``plane_stats``: bytes per encoding kind as the
        runs store them (a run's encoded tree's, once built; else its
        plain planes') against the logical (plain-format) bytes they
        replace, plus the K10 side-cars' device bytes on their own."""
        by: dict[str, int] = {}
        logical = 0
        for t in self.runs:
            st = t.crun.enc_stats
            if st is not None:
                for k, v in st["by_encoding"].items():
                    by[k] = by.get(k, 0) + int(v)
                logical += int(st["logical_bytes"])
            else:
                nb = _plain_run_nbytes(t.crun)
                by["plain"] = by.get("plain", 0) + nb
                logical += nb
        return {"setting": self.plane_encoding, "by_encoding": by,
                "encoded_bytes": sum(by.values()), "logical_bytes": logical,
                "sidecar_device_bytes": sum(t.sidecar_nbytes
                                            for t in self.runs)}

    # -- reads ---------------------------------------------------------------
    def scan(self, spec: ScanSpec) -> ScanResult:
        return self.scan_batch([spec])[0]

    def scan_batch(self, specs: list[ScanSpec],
                   deadline=None) -> list[ScanResult]:
        return self.scan_batch_async(specs, deadline=deadline).finish()

    def _device_fault_point(self) -> None:
        """The fault point of the device dispatch path (flag and armed
        fault ``fault.gpu_dispatch``): it raises as a device fault, which
        the breaker quarantines."""
        if maybe_fault("fault.gpu_dispatch"):
            raise FaultInjected("injected device dispatch fault")

    @staticmethod
    def _scan_priority(spec: ScanSpec) -> str:
        """Residency-pool priority of a scan: unbounded full-table traffic
        is admitted low-pri (scan-resistant), bounded ranges and point
        shapes protect their runs in the high-pri pool."""
        return "low" if (not spec.lower and not spec.upper) else "high"

    def scan_batch_async(self, specs: list[ScanSpec], deadline=None):
        """Plan every scan, launch all device work and start the results'
        copies to the host without waiting, then fold the overlay specs'
        dirty keys on the host; ``.finish()`` waits and builds the
        results. A multi-version run (or a masked copy of it) is resolved
        once per view key; same-signature kernel specs (K1, K5 or K8) on
        one run, masked run or view share one launch.

        Fault containment (the JAX engine's): while the breaker
        quarantines the device path, or when a device fault strikes while
        the batch is planned or launched, the batch is served from the
        host structures instead (``_HostServeBatch``); any other raise is
        recorded on the breaker (it retires an admitted probe) and
        propagates. An expired deadline is not recorded as a failure: it
        only frees an admitted probe's slot.

        ``deadline`` (``utils.retry.Deadline``) is the propagated budget:
        an expired one raises ``DeadlineExpired`` (``Code.TIMED_OUT``)
        before any work is issued, between the host re-serve's specs, and
        in ``finish`` before the results are built and between the
        gathers' rounds, letting the batch's pins go. It is not a device
        fault: nothing is re-served."""
        if deadline is not None:
            deadline.check("gpu_engine.scan_batch")
        if not self.breaker.allow():
            return _HostServeBatch(self, specs, deadline)
        try:
            return self._scan_batch_async_device(specs, deadline)
        except DeadlineExpired:
            self.breaker.release_probe()
            raise
        except BaseException as e:
            self.breaker.record_failure(e)
            if is_device_fault(e):
                return _HostServeBatch(self, specs, deadline)
            raise

    def _scan_batch_async_device(self, specs: list[ScanSpec],
                                 deadline=None) -> "_AsyncBatch":
        self._device_fault_point()
        results: list = [None] * len(specs)
        # Per source, a run or one view of it: K1 specs by plan, the specs
        # of the plain flat fold, K8 specs by plan and K5 specs by plan.
        sources: dict = {}
        overlay = []
        rows = {"host": [], "page": [], "gather": []}  # the row path
        for i, spec in enumerate(specs):
            prep = self._plan_scan(spec)
            if isinstance(prep, ScanResult):
                results[i] = prep
                continue
            if isinstance(prep, tuple):
                rows[prep[0]].append((i, prep[1]))
                continue
            if prep.overlay is not None:
                overlay.append(prep)
            kernels, folds, grouped, fulls = sources.setdefault(
                (id(prep.trun), prep.view_key), ({}, [], {}, {}))
            if isinstance(prep, _GroupPrep):
                grouped.setdefault(group_agg.make_plan(prep.sig), []).append(
                    (i, prep))
                continue
            self.agg_routes[prep.route] += 1
            if prep.route in ("full", "mv_full"):
                # K5 compares a promoted predicate's code plane as an i32
                # column of its own.
                sig = decode.lower_code_preds(prep.sig, {"cols": {}})[0]
                plan = full_agg.make_plan(sig.aggs, sig.preds, sig.cols,
                                          sig.R, sig.K)
                fulls.setdefault(plan, []).append((i, prep))
            elif prep.route in ("kernel", "mv_kernel"):
                plan = flat_agg.make_plan(
                    prep.sig.aggs, prep.sig.preds,
                    tuple(cs.col_id for cs in prep.sig.cols))
                kernels.setdefault(plan, []).append((i, prep))
            else:
                folds.append((i, prep))

        # Residency pins from the launches to the end of finish(): every
        # run a launch reads stays resident until the batch lets it go.
        # Unbounded full scans pin at low priority, so that they stream
        # through the low-pri pool (the overlay's primary is pinned by the
        # overlay cache).
        want_pins: dict[int, tuple] = {}

        def want_pin(trun, priority):
            if isinstance(trun, _MaskedRun):
                return
            prev = want_pins.get(id(trun))
            if prev is None or priority == "high":
                want_pins[id(trun)] = (trun, priority)

        for srcs in sources.values():
            for group in (*srcs[0].values(), srcs[1], *srcs[2].values(),
                          *srcs[3].values()):
                for _i, prep in group:
                    want_pin(prep.trun, self._scan_priority(prep.spec))
        for _i, st in rows["gather"]:
            want_pin(st.trun, "low" if st.mode == "chunks" else "high")
        # Until the _AsyncBatch takes them (its finish unpins), any raise
        # while pinning or launching lets the pins taken so far go.
        pins = []
        try:
            for trun, priority in want_pins.values():
                trun.pin(priority)
                pins.append(trun)
            pending = []  # (device tensors, finish(host tensors))
            for kernels, folds, grouped, fulls in sources.values():
                pending += self._launch_source(kernels, folds, grouped,
                                               fulls, results)
            # The gathers' first round: one K7 launch per (signature, run).
            states = dict(rows["gather"])
            round1 = {i: st.pending for i, st in rows["gather"]
                      if st.pending}
            dispatches = self._issue_round(states, round1) if round1 else []
            for prep in overlay:  # while the device works
                prep.host = self._overlay_host_partial(prep.overlay,
                                                       prep.spec)
            return _AsyncBatch(self, results, pending, rows, round1,
                               dispatches, pins, specs, deadline)
        except BaseException:
            for trun in pins:
                trun.unpin()
            raise

    def _launch_source(self, kernels: dict, folds: list, grouped: dict,
                       fulls: dict, results: list) -> list:
        """Queue every launch that reads one source. A view is held only
        here, so it is let go before the next source's view is resolved:
        a batch holds at most one view of a run at a time."""
        first = next(g[0] for g in (*kernels.values(), folds,
                                    *grouped.values(), *fulls.values())
                     if g)
        # The plain planes (an encoded run's side-car), unless K8 alone
        # reads this source: K8 takes the resident tree itself.
        arrays = (first[1].arrays() if kernels or folds or fulls
                  or first[1].view_key is not None else None)
        pending = []
        for plan, group in grouped.items():
            params = torch.tensor(
                [plan.param_row(p.row_lo, p.row_hi, p.read_planes, p.lits)
                 for _i, p in group], dtype=torch.int32).to(self.device)
            tables = group_agg.grouped_aggregate(
                plan, plan.plane_table(group[0][1].k8_arrays()), params)
            pending.append(([tables], self._grouped_finish(plan, group,
                                                           results)))
        for plan, group in kernels.items():
            params = torch.tensor(
                [plan.param_row(p.row_lo, p.row_hi, p.read_planes, p.lits)
                 for _i, p in group], dtype=torch.int32).to(self.device)
            partials = flat_agg.flat_aggregate(
                plan, plan.plane_table(arrays), params)
            folded = flat_agg.fold_partials(plan, partials)
            pending.append(([folded], _kernel_finish(plan, group, results)))
        for plan, group in fulls.items():
            # The windows each spec's rows cover (the JAX engine's
            # _dispatch_prepped), one parameter row a spec.
            W = arrays["valid"].shape[0] // plan.K
            params = np.array([plan.param_row(
                p.row_lo, p.row_hi,
                *agg_fold.window_bounds(p.row_lo, p.row_hi, plan.R, plan.K,
                                        W), p.read_planes, p.lits)
                for _i, p in group], np.int32)
            ivec, fvec = full_agg.full_aggregate(
                plan, decode.code_columns(arrays), params)
            if ivec.is_cuda:
                self.full_launches += 1
            pending.append(([ivec, fvec], _full_finish(group, results)))
        for i, p in folds:
            fn = flat_fold.compiled_flat_aggregate(p.sig)
            ivec, fvec = fn(arrays, p.row_lo, p.row_hi, *p.read_planes,
                            p.lits)
            pending.append(([ivec, fvec], _fold_finish(i, p, results)))
        return pending

    # -- planning ------------------------------------------------------------
    @staticmethod
    def _prune_prefix(spec: ScanSpec) -> bytes | None:
        """The hashed-components prefix shared by every key in the scan
        range, or None: present for point gets and scans within one hash
        section, the shapes the runs' blooms prune."""
        if not spec.lower or not spec.upper:
            return None
        from yugabyte_db_tpu_torch.models.encoding import (hashed_prefix,
                                                           prefix_successor)

        hp = hashed_prefix(spec.lower)
        if not hp:
            return None
        ps = prefix_successor(hp)
        if ps and spec.upper > ps:
            return None  # the range leaves the hash section
        return hp

    def _overlapping_runs(self, spec: ScanSpec) -> list[GpuRun]:
        hp = self._prune_prefix(spec)
        return [t for t in self.runs
                if t.crun.num_versions
                and not (spec.upper and t.crun.min_key >= spec.upper)
                and not t.crun.max_key < spec.lower
                and (hp is None or t.crun.may_contain_hashed(hp))]

    def _memtable_in_range(self, spec: ScanSpec) -> bool:
        """Whether the memtable holds a key of the spec's range (the mesh
        scans serve only a single run: ``tserver.mesh_scan``)."""
        if self.memtable.is_empty:
            return False
        return self.memtable.has_keys(spec.lower, spec.upper)

    def _split_predicates(self, spec: ScanSpec):
        """(device-exact preds, device-superset preds, host-only preds):
        'str' prefixes and rounded 'f32' values give superset masks (ties
        are maybe-matches the host verifies); key-column, IN and opaque
        (collection, jsonb) predicates are host-only."""
        exact, superset, host_only = [], [], []
        for p in spec.predicates:
            if p.column in self._key_col_names or p.op == "IN":
                host_only.append(p)
                continue
            cid = self._name_to_id[p.column]
            dt = self._dtypes[cid]
            if not dt.is_fixed_width and dt not in (DataType.STRING,
                                                    DataType.BINARY):
                # opaque payloads: the device prefix is repr-ordered, not
                # value-ordered
                host_only.append(p)
            elif self._kinds[cid] in ("str", "f32"):
                superset.append(p)
            else:
                exact.append(p)
        return exact, superset, host_only

    def _promote_code_preds(self, trun: GpuRun, preds):
        """The JAX engine's ``_promote_code_preds``: ``preds`` (superset
        string predicates) as exact ``_CodePred`` compares against
        ``trun``'s sorted per-run dictionaries, or None where any of them
        cannot promote (encoding off, a column not dictionary-encoded on
        this run, another operator) or the run's resident planes are
        plain. A bisect translates each literal: '<' v -> code <
        bisect_left, '<=' v -> code < bisect_right, '>' v -> code >=
        bisect_right, '>=' v -> code >= bisect_left; '=' / '!=' take the
        exact code, or -1 for a literal not in the dictionary (it matches
        no set row: every fold ANDs the column's not-NULL mask)."""
        dicts = trun.crun.enc_dicts
        if not dicts or self.plane_encoding == "off" or \
                not trun.crun.num_versions:
            return None
        out = []
        for p in preds:
            d = dicts.get(self._name_to_id[p.column])
            if d is None or p.op not in ("=", "!=", "<", "<=", ">", ">="):
                return None
            raw = (p.value.encode("utf-8", "surrogateescape")
                   if isinstance(p.value, str) else bytes(p.value))
            if p.op in ("=", "!="):
                i = bisect.bisect_left(d, raw)
                code = i if i < len(d) and d[i] == raw else -1
                out.append(_CodePred(p.column, p.op, code))
            elif p.op == "<":
                out.append(_CodePred(p.column, "<",
                                     bisect.bisect_left(d, raw)))
            elif p.op == "<=":
                out.append(_CodePred(p.column, "<",
                                     bisect.bisect_right(d, raw)))
            elif p.op == ">":
                out.append(_CodePred(p.column, ">=",
                                     bisect.bisect_right(d, raw)))
            else:  # >=
                out.append(_CodePred(p.column, ">=",
                                     bisect.bisect_left(d, raw)))
        if not trun.dev.encoded:
            return None  # the resident planes are plain
        return out

    def _aggs_device_eligible(self, spec: ScanSpec) -> bool:
        """Every aggregate column must be a value column (key columns live
        in the encoded key), and strings only COUNT on the device."""
        for a in spec.aggregates:
            if a.column is None:
                continue
            cid = self._name_to_id.get(a.column)
            if cid is None or (self._kinds[cid] == "str" and
                               a.fn != "count"):
                return False
        return True

    def _plan_scan(self, spec: ScanSpec):
        """The JAX engine's routing (its ``_plan_scan``) -> a finished
        ScanResult (nothing in range), an _AggPrep (with its
        overlay state when the spec reads several sources) or a
        _GroupPrep for the device folds, or a row-path plan:
        ("host", finish()) for an exact-key read or a row scan,
        ("page", (run, spec, predicate items)) for a host page,
        ("gather", _GatherScan)."""
        # Snapshot the memtable before the run list (as the JAX engine
        # does): a concurrent flush appends its run before swapping in an
        # empty memtable.
        mem = self.memtable
        sync_point("gpu_engine:plan:mem_snapshotted")
        runs = self._overlapping_runs(spec)
        mem_live = not mem.is_empty and mem.has_keys(spec.lower, spec.upper)
        pred_split = self._split_predicates(spec)
        exact, superset, host_only = pred_split
        single = len(runs) == 1 and not mem_live
        if not runs and not mem_live:  # nothing in range: no source to read
            return self._row_scan(spec, [], False, pred_split,
                                  spec.is_aggregate, mem)

        def row_scan(aggregate):
            if not runs:
                self.memtable_scans += 1
            return ("host", lambda: self._row_scan(
                spec, runs, mem_live, pred_split, aggregate, mem))

        if spec.is_aggregate:
            if single and superset and not host_only:
                # Dictionary-encoded string predicates promote to exact
                # code compares: the aggregate stays a device fold instead
                # of the gather and its host verify.
                promoted = self._promote_code_preds(runs[0], superset)
                if promoted is not None:
                    exact = exact + promoted
                    superset = []
                    pred_split = (exact, superset, host_only)
                    self.code_promotions += 1
            grouped = bool(spec.group_by) or any(a.expr is not None
                                                 for a in spec.aggregates)
            if single and grouped and not superset and not host_only:
                prep = self._grouped_prep(runs[0], spec, exact)
                if prep is not None:
                    return prep
            eligible = (not superset and not host_only and not grouped
                        and self._aggs_device_eligible(spec))
            if eligible and single:
                return self._device_agg_prep(runs[0], spec, exact)
            if eligible and not single and (runs or mem_live) and self.runs:
                ov = self._overlay(mem)
                if ov is not None:
                    prep = self._device_agg_prep(ov.masked, spec, exact)
                    prep.overlay = ov
                    return prep
            if single:
                return ("gather", self._plan_gather(runs[0], spec, pred_split,
                                                    aggregate=True))
            return row_scan(True)
        page_eligible = (single and spec.limit is not None
                         and spec.limit <= host_page.MAX_PAGE_LIMIT
                         and runs[0].flat and not superset and not host_only)
        page_items = (host_page.encode_pred_items(self, exact)
                      if page_eligible else None)
        pk = point_key_of(spec, self.schema)
        if pk is not None and page_items is None:
            # An exact-key read: the bloom-pruned version lookup.
            return ("host", lambda: self._point_get_row(spec, mem, pk))
        if single:
            if page_items is not None:
                return ("page", (runs[0], spec, page_items))
            return ("gather", self._plan_gather(runs[0], spec, pred_split,
                                                aggregate=False))
        return row_scan(False)

    # -- delta overlay (masked primary + host-folded dirty keys) -------------
    def _overlay(self, mem: MemTable) -> _OverlayState | None:
        """The cached delta-overlay state for the engine's runs and ``mem``
        (the JAX engine's ``_overlay``): the largest run is the primary;
        every key present in another run or in the memtable is dirty,
        with its versions from every source merged into one list; the
        dirty keys' primary rows are cleared from the masked primary's
        ``valid``. Keyed by (run list, memtable, version count): a later
        write to the same memtable advances the state incrementally
        (``_overlay_apply_delta``). None when the dirty keys are more
        than half the primary's rows: a compaction is the answer there."""
        runs = list(self.runs)
        cache = self._overlay_cache
        if cache is not None:
            c_runs, c_mem, c_ver, state = cache
            if c_runs == runs and c_mem is mem:
                if c_ver == mem.num_versions:
                    return state
                if state is not None and mem.num_versions > c_ver:
                    inc = self._overlay_apply_delta(state, mem, c_ver)
                    if inc is not _OVERLAY_REBUILD:
                        ver = (inc.mem_count if inc is not None
                               else mem.num_versions)
                        self._cache_overlay(runs, mem, inc, ver)
                        return inc
        primary = max(runs, key=lambda t: t.crun.total_rows())
        # Snapshot the counter BEFORE collecting: rows racing in during
        # collection are re-applied by the next delta, which dedups them.
        ver0 = mem.num_versions
        dirty: dict[bytes, list] = {}
        for t in runs:
            if t is not primary:
                for key, versions in t.crun.iter_entries():
                    dirty.setdefault(key, []).extend(versions)
        for key in mem.scan_keys(b"", b""):
            dirty.setdefault(key, []).extend(mem.versions(key))
        state = None
        if dirty and len(dirty) * 2 <= max(primary.crun.total_rows(), 64):
            primary.pin("high")
            try:
                rows, starts, counts = [], [], []
                for key in sorted(dirty):
                    entry, start, n = _dirty_entry(primary.crun, key,
                                                   dirty[key])
                    rows.append(entry)
                    starts.append(start)
                    counts.append(n)
                idx = _row_spans(starts, counts)
                state = _OverlayState(
                    _MaskedRun(primary, masked_valid(primary, idx)),
                    rows, [e[0] for e in rows], {e[0]: e for e in rows},
                    idx, ver0)
                self._cache_overlay(runs, mem, state, ver0)
            finally:
                primary.unpin()
        else:
            self._cache_overlay(runs, mem, None, mem.num_versions)
        return state

    def _cache_overlay(self, runs, mem, state, ver) -> None:
        """Publish an overlay cache entry, moving the pin on the primary
        run and the masked valid plane's residency entry with it (the JAX
        engine's ``_cache_overlay``)."""
        new_primary = state.masked.source if state is not None else None
        old = self._overlay_pinned
        if old is not new_primary:
            if new_primary is not None:
                new_primary.pin("high")
            if old is not None:
                old.unpin()
            self._overlay_pinned = new_primary
            if self._overlay_ext_key is not None:
                hbm_cache().invalidate(self._overlay_ext_key)
                self._overlay_ext_key = None
            if state is not None:
                self._overlay_ext_key = hbm_cache().add_external(
                    None, device_nbytes(state.masked.valid),
                    self.device_tracker, "overlay_mask",
                    device=device_label(self.device))
        self._overlay_cache = (runs, mem, ver, state)

    def _overlay_apply_delta(self, state: _OverlayState, mem: MemTable,
                             since: int):
        """Advance the cached overlay by the memtable versions applied
        after index ``since``, copy-on-write: the old state's rows list,
        entries and masked plane are never written, so a batch issued
        before the write still reads the old state. Returns the new
        state, None when the dirty keys outgrew the overlay's shape, or
        _OVERLAY_REBUILD when the memtable has no delta log."""
        delta = mem.versions_since(since)
        if delta is None:
            return _OVERLAY_REBUILD
        if not delta:
            return state
        changed: dict[bytes, list] = {}
        for r in delta:
            changed.setdefault(r.key, []).append(r)
        primary = state.masked.source
        crun = primary.crun
        n_new = sum(1 for k in changed if k not in state.by_key)
        if (len(state.rows) + n_new) * 2 > max(crun.total_rows(), 64):
            return None
        rows = list(state.rows)
        by_key = dict(state.by_key)
        added, starts, counts = [], [], []
        for key in sorted(changed):
            old = by_key.get(key)
            if old is None:
                entry, start, n = _dirty_entry(crun, key, changed[key])
                added.append(entry)  # in key order
                starts.append(start)
                counts.append(n)
            else:
                # Re-applied versions (a build racing a write) dedup by
                # the version identity the merge sorts on.
                seen = {(v.ht, v.write_id) for v in old[1]}
                versions = old[1] + [v for v in changed[key]
                                     if (v.ht, v.write_id) not in seen]
                versions.sort(key=lambda x: (x.ht, x.write_id), reverse=True)
                entry = (key, versions)
                rows[bisect.bisect_left(state.keys, key)] = entry
            by_key[key] = entry
        idx, masked, keys = state.idx, state.masked, state.keys
        if added:
            # Two sorted lists: the sort merges them as two runs.
            rows = sorted(rows + added, key=operator.itemgetter(0))
            keys = [e[0] for e in rows]
            new_idx = _row_spans(starts, counts)
            if new_idx.size:
                idx = np.concatenate([idx, new_idx])
                masked = _MaskedRun(primary, masked_valid(primary, idx))
        return _OverlayState(masked, rows, keys, by_key, idx,
                             since + len(delta))

    def _overlay_columns_at(self, ov: _OverlayState, read_ht: int,
                            names: list, lo: int, hi: int) -> tuple:
        """The dirty rows ``lo:hi`` at ``read_ht``: (whether each key
        exists there, and for each column of ``names`` its values there,
        None where the key or the value is absent). Each row is merged
        once and each column read once per read point, however many specs
        of a batch read them; the last 8 read points are kept."""
        at = ov.merged.get(read_ht)
        if at is None:
            if len(ov.merged) >= 8:
                ov.merged.pop(next(iter(ov.merged)))
            at = ov.merged[read_ht] = ([None] * len(ov.rows), {})
        merged, columns = at
        for i in range(lo, hi):
            if merged[i] is None:
                rkey, versions = ov.rows[i]
                m = merge_versions(rkey, versions, read_ht)
                merged[i] = m if m.exists else False
        out = []
        for name in names:
            col = columns.get(name)
            if col is None:
                col = columns[name] = [_UNREAD] * len(ov.rows)
            for i in range(lo, hi):
                if col[i] is _UNREAD:
                    m = merged[i]
                    col[i] = self.mat.value(name, None, m) if m else None
            out.append(col[lo:hi])
        return [bool(m) for m in merged[lo:hi]], out

    def _overlay_host_partial(self, ov: _OverlayState, spec: ScanSpec):
        """Exact host fold of the dirty keys in the spec's range at its
        read point: (keys that exist, before predicates; per aggregate
        (n, value)), the value being the sum (a left fold in key order),
        min or max (COUNT rides n). The last 8 (read point, bounds,
        predicates, aggregates) are cached on the state."""
        key = (self._read_plane_ints(spec), spec.lower, spec.upper,
               tuple((p.column, p.op, p.value) for p in spec.predicates),
               tuple((a.fn, a.column) for a in spec.aggregates))
        hit = ov.partial.get(key)
        if hit is not None:
            return hit
        lo = bisect.bisect_left(ov.keys, spec.lower)
        hi = (bisect.bisect_left(ov.keys, spec.upper) if spec.upper
              else len(ov.keys))
        names = [p.column for p in spec.predicates] + \
            [a.column for a in spec.aggregates if a.column is not None]
        ok, cols = self._overlay_columns_at(ov, spec.read_ht, names, lo, hi)
        scanned = sum(ok)
        cols = iter(cols)
        for p in spec.predicates:
            ok = [o and p.matches(v) for o, v in zip(ok, next(cols))]
        parts = []
        for a in spec.aggregates:
            if a.column is None:
                parts.append((sum(ok), None))
                continue
            vals = [v for o, v in zip(ok, next(cols)) if o and v is not None]
            if not vals or a.fn == "count":
                parts.append((len(vals), None))
            elif a.fn in ("sum", "avg"):
                parts.append((len(vals), functools.reduce(operator.add,
                                                          vals)))
            else:
                parts.append((len(vals), min(vals) if a.fn == "min"
                              else max(vals)))
        result = (scanned, parts)
        if len(ov.partial) >= 8:
            ov.partial.pop(next(iter(ov.partial)))
        ov.partial[key] = result
        return result

    def _device_agg_prep(self, trun: GpuRun, spec: ScanSpec,
                         exact_preds) -> _AggPrep:
        crun = trun.crun
        pred_sigs, lits = [], []
        for p in exact_preds:
            cid = self._name_to_id[p.column]
            kind = self._pred_kind(p)
            pred_sigs.append(dscan.PredSig(cid, kind, p.op))
            lits.append(agg_fold.pred_literal_host(kind, p.value))
        dev_aggs, lowering = agg_fold.lower_aggs(
            spec.aggregates, self._name_to_id, self._kinds)
        R = crun.R
        # The fold's signature: a multi-version run is folded through its
        # resolved view, which is flat.
        sig = dscan.ScanSig(
            B=trun.B, R=R,
            K=agg_fold.safe_window_blocks(R, agg_fold.FULL_WINDOW_BLOCKS),
            cols=tuple(dscan.ColSig(c.col_id, self._kinds[c.col_id])
                       for c in self.schema.value_columns),
            preds=tuple(pred_sigs), aggs=dev_aggs, apply_preds=True,
            flat=True)
        prefix, view_key = "", None
        if not trun.flat:
            prefix, view_key = "mv_", trun.view_key(spec.read_ht)
        if flat_agg.eligible(sig):
            route = prefix + "kernel"
        elif flat_fold.supports(sig):
            route = prefix + "flat"
        else:  # past the flat fold's bounds: the windowed fold
            route = prefix + "full"
        return _AggPrep(spec, trun, sig, route, crun.lower_row(spec.lower),
                        crun.upper_row(spec.upper), self._read_plane_ints(spec),
                        tuple(lits), dev_aggs, lowering, view_key)

    # -- grouped and expression aggregates (K8) ------------------------------
    def _dtype_of(self, name: str):
        cid = self._name_to_id.get(name)
        if cid is None:
            raise ValueError(f"{name} is not a value column")
        return self._dtypes[cid]

    def _encode_factor(self, node) -> tuple:
        """A ``storage.expr`` tree -> the kernel's factor tuples."""
        if isinstance(node, X.Col):
            return ("c", self._name_to_id[node.name])
        if isinstance(node, X.Const):
            return ("k", int(node.value))
        return (node.op, self._encode_factor(node.left),
                self._encode_factor(node.right))

    def _grouped_aggs(self, spec: ScanSpec) -> list | None:
        """The spec's aggregates as ``group_agg.GAgg``s, or None where the
        device cannot take one (the JAX engine's ``_grouped_prep`` rules):
        COUNT of a value column or of *, SUM of an i32/i64 column, or SUM
        of an expression ``lower_product`` lowers; no MIN, MAX or AVG."""
        gaggs = []
        for a in spec.aggregates:
            if a.fn == "count" and a.expr is None:
                cid = self._name_to_id.get(a.column) if a.column else None
                if a.column and cid is None:
                    return None
                gaggs.append(group_agg.GAgg(
                    "count", cid, need_cols=(cid,) if cid is not None else ()))
            elif a.fn == "sum" and a.expr is None:
                cid = self._name_to_id.get(a.column)
                if cid is None or self._kinds[cid] not in ("i32", "i64"):
                    return None
                gaggs.append(group_agg.GAgg(
                    "sum_prod", cid, planes=1 if self._kinds[cid] == "i32"
                    else 2, need_cols=(cid,)))
            elif a.fn == "sum":
                lowered = X.lower_product(a.expr, self._dtype_of)
                if lowered is None:
                    return None
                base, factors = lowered
                base_cid = self._name_to_id[base]
                need = [base_cid] + [self._name_to_id[c] for f in factors
                                     for c in sorted(X.columns_of(f))]
                gaggs.append(group_agg.GAgg(
                    "sum_prod", base_cid,
                    planes=1 if self._kinds[base_cid] == "i32" else 2,
                    factors=tuple(self._encode_factor(f) for f in factors),
                    need_cols=tuple(dict.fromkeys(need))))
            else:
                return None
        return gaggs

    def _grouped_prep(self, trun: GpuRun, spec: ScanSpec, exact_preds):
        """The JAX engine's ``_grouped_prep``: a _GroupPrep for K8, a
        finished ScanResult for an empty range, or None where the JAX
        engine goes to its gather (the caller does too): a key, f32 or
        over-8-byte string group column, MIN/MAX/AVG, a sum
        ``lower_product`` does not lower, or a signature past K8's
        descriptor."""
        crun = trun.crun
        group_cols = []
        for name in spec.group_by or []:
            cid = self._name_to_id.get(name)
            if cid is None:
                return None  # a key column
            kind = self._kinds[cid]
            if kind == "f32" or (kind == "str" and
                                 crun.varlen_max_len.get(cid, 0) > 8):
                # f32 raw bits conflate -0.0 and 0.0; a longer string's
                # 8-byte prefix is not its value.
                return None
            group_cols.append((cid, 2 if kind in ("i64", "f64", "str")
                               else 1))
        gaggs = self._grouped_aggs(spec)
        if gaggs is None:
            return None
        pred_sigs, lits = [], []
        for p in exact_preds:
            cid = self._name_to_id[p.column]
            kind = self._pred_kind(p)
            pred_sigs.append(dscan.PredSig(cid, kind, p.op))
            lits.append(agg_fold.pred_literal_host(kind, p.value))
        sig = group_agg.GroupAggSig(
            NB=group_agg.NUM_BUCKETS,
            cols=tuple(dscan.ColSig(c.col_id, self._kinds[c.col_id])
                       for c in self.schema.value_columns),
            preds=tuple(pred_sigs), group_cols=tuple(group_cols),
            aggs=tuple(gaggs))
        if not group_agg.eligible(sig):
            return None
        row_lo, row_hi = crun.lower_row(spec.lower), crun.upper_row(spec.upper)
        if row_lo >= row_hi:
            agg = Aggregator(spec.aggregates, spec.group_by or [])
            return ScanResult(agg.column_names(), agg.results(), None, 0)
        flat = trun.flat
        return _GroupPrep(spec, trun, sig, "grouped" if flat else "mv_grouped",
                          row_lo, row_hi, self._read_plane_ints(spec), tuple(lits),
                          None if flat else trun.view_key(spec.read_ht))

    def _grouped_finish(self, plan, group, results):
        def finish(host):
            tables = host[0].numpy()
            for n, (i, prep) in enumerate(group):
                results[i] = self._finish_grouped(prep, plan, tables[n])
        return finish

    def _finish_grouped(self, prep: _GroupPrep, plan, table) -> ScanResult:
        """One spec's bucket table -> its ScanResult (the JAX engine's
        ``_finish_grouped``): the live buckets' group values and exact
        sums (NULL where no row had its inputs), rows sorted by group
        values with NULL first. A negative sum input or a collision (a
        live bucket whose key planes differ) re-serves the spec on the
        host."""
        spec, sig, nb, kp = prep.spec, plan.sig, group_agg.NUM_BUCKETS, plan.kp
        scanned, negs = int(table[nb, 0]), int(table[nb, 1])
        live = np.nonzero(table[:nb, 0] > 0)[0]
        if negs > 0:
            return self._grouped_host_fold(prep)
        key_min = table[:nb, 2:2 + kp]
        key_max = table[:nb, 2 + kp:2 + 2 * kp]
        if live.size and sig.group_cols and \
                not (key_min[live] == key_max[live]).all():
            return self._grouped_host_fold(prep)
        group_names = list(spec.group_by or [])
        rows = []
        for b in live:
            gvals = self._decode_group(prep, sig, key_min[b], int(table[b, 1]))
            if gvals is None:
                return self._grouped_host_fold(prep)
            aggs = []
            for i, (ga, off) in enumerate(zip(sig.aggs, plan.offsets)):
                if ga.kind == "count":
                    aggs.append(int(table[b, off]))
                else:  # SQL's sum over no non-NULL input is NULL
                    aggs.append(plan.sum_value(table[b], i)
                                if table[b, off] else None)
            rows.append(tuple(gvals) + tuple(aggs))
        if not rows and not spec.group_by:
            agg = Aggregator(spec.aggregates, [])
            return ScanResult(agg.column_names(), agg.results(), None, scanned)
        rows.sort(key=lambda r: tuple((v is None, v)
                                      for v in r[:len(group_names)]))
        names = group_names + [a.output_name for a in spec.aggregates]
        return ScanResult(names, rows, None, scanned)

    def _decode_group(self, prep: _GroupPrep, sig, key_planes, rep: int):
        """A live bucket's key planes (min == max) -> its group values;
        strings from the representative row's merged state at the read
        point. None when the representative is out of the run."""
        crun = prep.trun.crun
        out = []
        off = 0
        for cid, planes in sig.group_cols:
            vals = key_planes[off:off + planes]
            null = key_planes[off + planes]
            off += planes + 1
            if null:
                out.append(None)
                continue
            kind = self._kinds[cid]
            if kind == "i32":
                v = int(vals[0])
                out.append(bool(v) if self._dtypes[cid] == DataType.BOOL
                           else v)
            elif kind == "i64":
                out.append(int(P.ordered_planes_to_i64(
                    np.array([vals[0]], np.int32),
                    np.array([vals[1]], np.int32))[0]))
            elif kind == "f64":
                out.append(float(P.ordered_planes_to_f64(
                    np.array([vals[0]], np.int32),
                    np.array([vals[1]], np.int32))[0]))
            else:
                if rep >= crun.total_rows():
                    return None
                key, versions = crun.group_versions(*divmod(rep, crun.R))
                out.append(merge_versions(key, versions,
                                          prep.spec.read_ht).get(cid))
        return out

    def _grouped_host_fold(self, prep: _GroupPrep) -> ScanResult:
        """The JAX engine's ``_row_scan`` over the spec's one run: every
        key group in range merged at the read point, its predicates
        applied on the host and the rest folded by the ``Aggregator``.
        ``rows_scanned`` counts the keys that exist and match, as the JAX
        engine's device candidates there."""
        self.grouped_host_folds += 1
        spec = prep.spec
        agg = Aggregator(spec.aggregates, spec.group_by or [])
        scanned = 0
        for key, versions in prep.trun.crun.iter_groups(prep.row_lo,
                                                        prep.row_hi):
            merged = merge_versions(key, versions, spec.read_ht)
            if not merged.exists:
                continue
            kv = self.mat.key_values(key)
            if not self.mat.matches(spec, kv, merged):
                continue
            scanned += 1
            agg.add(lambda name: self.mat.value(name, kv, merged))
        return ScanResult(agg.column_names(), agg.results(), None, scanned)


def _plain_run_nbytes(crun: ColumnarRun) -> int:
    """A run's plain plane bytes (the JAX engine's ``_plain_run_nbytes``)."""
    total = sum(a.nbytes for a in (
        crun.valid, crun.group_start, crun.tomb, crun.live,
        crun.ht_hi, crun.ht_lo, crun.exp_hi, crun.exp_lo))
    for col in crun.cols.values():
        total += col.set_.nbytes + col.isnull.nbytes + col.cmp_planes.nbytes
        if col.arith is not None:
            total += col.arith.nbytes
    return total


def _agg_name(a) -> str:
    return f"{a.fn}({a.column or '*'})"


def _agg_result(prep: _AggPrep, ivec, fvec) -> ScanResult:
    acc, scanned = agg_fold.unpack(prep.dev_aggs, ivec, fvec)
    names = [_agg_name(a) for a in prep.spec.aggregates]
    if prep.host is None:
        row = tuple(agg_fold.finalize(prep.dev_aggs[di], acc[di], fn_name)
                    for fn_name, di in prep.lowering)
        return ScanResult(names, [row], None, scanned)
    h_scanned, h_parts = prep.host
    row = tuple(_combine(fn_name, prep.dev_aggs[di], acc[di], h)
                for (fn_name, di), h in zip(prep.lowering, h_parts))
    return ScanResult(names, [row], None, scanned + h_scanned)


def _combine(fn: str, ag, acc: dict, host: tuple):
    """The finalized value of an overlay aggregate: the masked primary's
    accumulator and the dirty keys' host partial ``(n, value)`` over
    disjoint keys (the JAX engine's ``_plan_overlay_aggregate``)."""
    h_n, h_v = host
    if fn == "count":
        return agg_fold.finalize(ag, acc, "count") + h_n
    if fn in ("sum", "avg"):
        ds = agg_fold.finalize(ag, acc, "sum")
        total = None
        if ds is not None or h_v is not None:
            total = (ds or 0) + (h_v or 0)
        if fn == "sum":
            return total
        n = int(acc.get("n", 0)) + h_n
        return total / n if n else None
    vals = [v for v in (agg_fold.finalize(ag, acc, fn), h_v)
            if v is not None]
    if not vals:
        return None
    return min(vals) if fn == "min" else max(vals)


def _kernel_finish(plan, group, results):
    def finish(host):
        folded = host[0].numpy()
        for n, (i, prep) in enumerate(group):
            results[i] = _agg_result(prep, *plan.to_packed(folded[n]))
    return finish


def _full_finish(group, results):
    def finish(host):
        ivecs, fvecs = host[0].numpy(), host[1].numpy()
        for n, (i, prep) in enumerate(group):
            results[i] = _agg_result(prep, ivecs[n], fvecs[n])
    return finish


def _fold_finish(i, prep, results):
    def finish(host):
        results[i] = _agg_result(prep, host[0].numpy(), host[1].numpy())
    return finish


class _AsyncBatch:
    """An in-flight scan batch: the device work is launched and its
    results are on their way to host memory; ``finish()`` serves the
    batch's host plans and pages while the device works, waits, builds
    the fold results, and drives the gathers' continuation rounds. It
    owns the batch's residency pins: ``finish`` lets them go after the
    continuation rounds, and so does an abandoned batch when it is
    collected. A device fault in ``finish`` re-serves the whole batch
    from the host (the specs' read points make the answers the same)."""

    def __init__(self, eng, results: list, pending: list, rows: dict,
                 round1: dict, dispatches: list, pins: list, specs: list,
                 deadline=None):
        self.pins: list = []
        self.eng = eng
        self.deadline = deadline
        self.results = results
        self.rows = rows
        self.round1 = round1
        self.specs = list(specs)
        self._finishers = [([_to_host(t) for t in outs], fin)
                           for outs, fin in pending]
        self._members = [m for m, _out in dispatches]
        self._bufs = [_to_host(out) for _m, out in dispatches]
        cuda = [t for outs, _f in pending for t in outs if t.is_cuda]
        cuda += [out for _m, out in dispatches if out.is_cuda]
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0].device))
        self._done = False
        self.pins = list(pins)  # last: a raise above leaves them to the caller

    def _release_pins(self) -> None:
        pins, self.pins = self.pins, []
        for trun in pins:
            trun.unpin()

    def __del__(self):
        # An abandoned batch (never finished) still lets its pins go.
        try:
            self._release_pins()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def finish(self) -> list[ScanResult]:
        if self._done:
            return self.results
        try:
            out = self._finish()
        except DeadlineExpired:
            # The caller's budget, not a fault of the device: the failure
            # count stays, and an admitted half-open probe frees its slot.
            self._release_pins()
            self.eng.breaker.release_probe()
            raise
        except BaseException as e:
            self._release_pins()
            # Recorded either way: a raise out of an admitted half-open
            # probe must retire it, or the breaker stays half-open.
            self.eng.breaker.record_failure(e)
            if not is_device_fault(e):
                raise
            # A device fault in flight: re-serve the whole batch from the
            # host.
            self._finishers = self._bufs = []
            self.results = self.eng._serve_host_batch(self.specs,
                                                      self.deadline)
            self._done = True
            return self.results
        self._release_pins()
        self.eng.breaker.record_success()
        return out

    def _check_deadline(self) -> None:
        if self.deadline is not None:
            self.deadline.check("gpu_engine.scan_batch.finish")

    def _finish(self) -> list[ScanResult]:
        eng, results, rows = self.eng, self.results, self.rows
        self._check_deadline()
        for i, fin in rows["host"]:
            results[i] = fin()
        if rows["page"]:
            served = host_page.serve_pages(eng, [it for _i, it in rows["page"]])
            for (i, _it), res in zip(rows["page"], served):
                results[i] = res
        if self._event is not None:
            self._event.synchronize()
        for host, fin in self._finishers:
            fin(host)
        states = dict(rows["gather"])
        pending = eng._feed_round(states, self.round1, self._members,
                                  [b.numpy() for b in self._bufs])
        while pending:  # continuation rounds: synchronous
            self._check_deadline()
            dispatches = eng._issue_round(states, pending)
            pending = eng._feed_round(
                states, pending, [m for m, _o in dispatches],
                [out.cpu().numpy() for _m, out in dispatches])
        for i, st in rows["gather"]:
            results[i] = st.result()
        self._finishers = self._bufs = []
        self._done = True
        return self.results


class _HostServeBatch:
    """The stand-in for ``_AsyncBatch`` while the breaker quarantines the
    device path, or after a device fault while the batch was planned or
    launched (the JAX engine's): nothing was launched and no pin is held;
    ``finish()`` serves the whole batch from the host."""

    def __init__(self, eng, specs: list, deadline=None):
        self.eng = eng
        self.specs = list(specs)
        self.deadline = deadline
        self.results: list | None = None

    def finish(self) -> list[ScanResult]:
        if self.results is None:
            self.results = self.eng._serve_host_batch(self.specs,
                                                      self.deadline)
        return self.results


def _tree_to_host(tree: dict) -> dict:
    """A plane tree's numpy copies (never a view of a device tensor, nor
    of a CPU one the run's device planes keep)."""
    def host(t):
        if isinstance(t, dict):  # an encoded leaf
            return {k: host(v) for k, v in t.items()}
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    out = {k: host(v) for k, v in tree.items() if k != "cols"}
    out["cols"] = {cid: {k: host(v) for k, v in c.items()}
                   for cid, c in tree["cols"].items()}
    return out


def _flush_sortkey(kw_part, ht_hi_part, ht_lo_part, wid):
    """``_sortkey_bytes`` plus a trailing inverted write id: the FLUSH
    order (key asc, ht desc, write id desc; ``drain_sorted``'s order) as
    ONE memcmp key a row."""
    n, W = kw_part.shape
    buf = np.empty((n, W + 4), dtype=np.uint32)
    buf[:, :W] = (kw_part.view(np.uint32) ^ np.uint32(0x80000000)).byteswap()
    buf[:, W] = (~(ht_hi_part.view(np.uint32)
                   ^ np.uint32(0x80000000))).byteswap()
    buf[:, W + 1] = (~(ht_lo_part.view(np.uint32)
                       ^ np.uint32(0x80000000))).byteswap()
    w = wid.view(np.uint64)
    buf[:, W + 2] = (~(w >> np.uint64(32)).astype(np.uint32)).byteswap()
    buf[:, W + 3] = (~(w & np.uint64(0xFFFFFFFF)).astype(np.uint32)).byteswap()
    return np.ascontiguousarray(buf).view(f"S{4 * (W + 4)}").reshape(n)


def _sortkey_bytes(kw_part, ht_hi_part, ht_lo_part):
    """[n, W] int32 key planes + ht planes -> fixed-width big-endian byte
    strings whose memcmp order is (key asc, ht desc): the merge order, as
    ONE comparison a row."""
    n, W = kw_part.shape
    buf = np.empty((n, W + 2), dtype=np.uint32)
    buf[:, :W] = (kw_part.view(np.uint32) ^ np.uint32(0x80000000)).byteswap()
    buf[:, W] = (~(ht_hi_part.view(np.uint32)
                   ^ np.uint32(0x80000000))).byteswap()
    buf[:, W + 1] = (~(ht_lo_part.view(np.uint32)
                       ^ np.uint32(0x80000000))).byteswap()
    return np.ascontiguousarray(buf).view(f"S{4 * (W + 2)}").reshape(n)


def _merge_sorted(items):
    """Stable k-way merge of presorted (indices, sort keys) pairs by a
    pairwise searchsorted tournament: O(N log K) comparisons, all
    vectorized. Ties keep the earlier run's rows first."""
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            a_idx, a_keys = items[i]
            b_idx, b_keys = items[i + 1]
            a_dst = np.arange(a_keys.size, dtype=np.int64) + \
                np.searchsorted(b_keys, a_keys, side="left")
            b_dst = np.arange(b_keys.size, dtype=np.int64) + \
                np.searchsorted(a_keys, b_keys, side="right")
            out_n = a_keys.size + b_keys.size
            out_keys = np.empty(out_n, dtype=a_keys.dtype)
            out_idx = np.empty(out_n, dtype=np.int64)
            out_keys[a_dst] = a_keys
            out_keys[b_dst] = b_keys
            out_idx[a_dst] = a_idx
            out_idx[b_dst] = b_idx
            nxt.append((out_idx, out_keys))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0][0]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a device tensor's copy into pinned host memory (the copy is
    complete once the batch's event has fired); CPU tensors pass."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


register_engine("gpu", GpuStorageEngine)
