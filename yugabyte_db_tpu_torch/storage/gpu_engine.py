"""GPU storage engine: the ``tablet_storage_engine=gpu`` data plane.

A slice of the JAX package's ``storage/tpu_engine.py``: writes go to the
host memtable, ``flush`` builds a columnar run on the host and uploads
its planes to the engine's device, and single-source aggregate scans
fold on the device, over a flat run (one version per key, the
post-compaction shape) or a multi-version one:

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
  ``ops.flat_fold`` in plain PyTorch, one spec at a time.

Both return ``agg_fold.pack``'s layout, which ``unpack`` / ``finalize``
turn into a ``ScanResult``. ``rows_scanned`` is what the JAX ``tpu``
engine reports on these routes: the rows (key groups, on a multi-version
run) that pass every predicate.

Everything else raises ``NotImplementedError`` naming the ROADMAP.md item
that brings it. There is no host re-serve: a device error raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.ops import (agg_fold, flat_agg, flat_fold,
                                      mvcc_resolve)
from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.ops.device_run import (DeviceRun, dtype_kind,
                                                  resolve_device)
from yugabyte_db_tpu_torch.storage.columnar import (DEFAULT_ROWS_PER_BLOCK,
                                                    ColumnarRun)
from yugabyte_db_tpu_torch.storage.engine import (StorageEngine,
                                                  register_engine)
from yugabyte_db_tpu_torch.storage.memtable import MemTable
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
from yugabyte_db_tpu_torch.utils import planes as P

PAD_BLOCKS = 64  # run block-axis padding, as the JAX engine pads

# Work outside this slice, by the ROADMAP.md §1 item that brings it.
_LATER = {
    "row": "row scans (ROADMAP.md §1 item 7: row path, K7/K9)",
    "grouped": "GROUP BY and expression aggregates (ROADMAP.md §1 item 6: "
               "GROUP BY, K8)",
    "host_preds": "predicates on strings, floats, key columns or IN lists "
                  "(ROADMAP.md §1 item 7: row path, K7/K9)",
    "host_aggs": "aggregates of key columns and MIN/MAX/SUM of strings "
                 "(ROADMAP.md §1 item 7: row path, K7/K9)",
    "multi_source": "scans over several runs or a live memtable "
                    "(ROADMAP.md §1 item 5: overlay aggregates)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"not in the port yet: {_LATER[what]}")


class GpuRun:
    """A columnar run and its planes resident on the engine's device (no
    residency budget yet: a run stays resident for its lifetime). A
    multi-version run also holds its view's constant planes, the sorted
    hybrid times of its versions and expiries (the view keys), and its
    most recent resolved view."""

    def __init__(self, crun: ColumnarRun, device: torch.device):
        self.crun = crun
        self.dev = DeviceRun(crun, PAD_BLOCKS, device=device)
        self.flat = crun.max_group_versions <= 1
        self._view = None  # (view key, view arrays)
        if not self.flat:
            v = crun.valid
            self._hts = np.sort(P.planes_to_u64(
                crun.ht_hi[v], crun.ht_lo[v]).astype(np.int64))
            exps = P.planes_to_u64(crun.exp_hi[v],
                                   crun.exp_lo[v]).astype(np.int64)
            self._exps = np.sort(exps[exps != MAX_HT])
            self._const = mvcc_resolve.constant_planes(self.dev.B, crun.R,
                                                       device)

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
        point of that key). Only the latest one is kept: the previous one
        is let go before the new one is made."""
        if self._view is None or self._view[0] != key:
            self._view = None
            self._view = (key, mvcc_resolve.resolve_view(
                self.dev.arrays, *read_planes, self._const))
        return self._view[1]


@dataclass
class _AggPrep:
    """Host planning of one single-source flat aggregate."""

    spec: ScanSpec
    trun: GpuRun
    sig: dscan.ScanSig    # the fold's signature (a view's is flat)
    route: str            # "kernel" | "flat" | "mv_kernel" | "mv_flat"
    row_lo: int
    row_hi: int
    read_planes: tuple    # read hi/lo, expiry hi/lo
    lits: tuple           # host predicate literals
    dev_aggs: tuple
    lowering: list
    view_key: tuple | None  # multi-version routes: the resolve's key

    def arrays(self) -> dict:
        """The planes the fold reads: the run's, or its resolved view."""
        if self.view_key is None:
            return self.trun.dev.arrays
        return self.trun.view(self.view_key, self.read_planes)


class GpuStorageEngine(StorageEngine):
    """Options: ``device`` (default ``cuda``; raises when there is no
    GPU) and ``rows_per_block`` (2048). The memtable flushes only when
    ``flush`` is called: a second run, or a live memtable beside a run,
    could not be scanned yet (overlay aggregates, ROADMAP.md §1 item 5).
    A run may hold any number of versions per key."""

    def __init__(self, schema: Schema, options: dict | None = None):
        super().__init__(schema, options)
        self.device = resolve_device(self.options.get("device"))
        self.memtable = MemTable()
        self.runs: list[GpuRun] = []
        self.flushed_frontier_ht = 0
        self.rows_per_block = int(self.options.get(
            "rows_per_block", DEFAULT_ROWS_PER_BLOCK))
        self._kinds = {c.col_id: dtype_kind(c.dtype)
                       for c in schema.value_columns}
        self._name_to_id = {c.name: c.col_id for c in schema.value_columns}
        self._key_col_names = {c.name for c in schema.key_columns}

    # -- writes --------------------------------------------------------------
    def apply(self, rows: list[RowVersion]) -> None:
        self.memtable.apply(rows)

    def flush(self) -> None:
        """Host build of the memtable into a columnar run (the JAX
        engine's generic drain + build), uploaded to the device."""
        if self.memtable.is_empty:
            return
        self.flushed_frontier_ht = max(self.flushed_frontier_ht,
                                       self.memtable.max_ht)
        crun = ColumnarRun.build(self.schema, self.memtable.drain_sorted(),
                                 self.rows_per_block)
        self.runs.append(GpuRun(crun, self.device))
        self.memtable = MemTable()

    def stats(self) -> dict:
        return {
            "num_runs": len(self.runs),
            "memtable_versions": self.memtable.num_versions,
            "run_versions": sum(t.crun.num_versions for t in self.runs),
            "flushed_frontier_ht": self.flushed_frontier_ht,
            "device_bytes": sum(t.dev.nbytes for t in self.runs),
        }

    # -- reads ---------------------------------------------------------------
    def scan(self, spec: ScanSpec) -> ScanResult:
        return self.scan_batch([spec])[0]

    def scan_batch(self, specs: list[ScanSpec]) -> list[ScanResult]:
        return self.scan_batch_async(specs).finish()

    def scan_batch_async(self, specs: list[ScanSpec]) -> "_AsyncBatch":
        """Plan every scan, launch all device work and start the results'
        copies to the host without waiting; ``.finish()`` waits and
        builds the results. A multi-version run is resolved once per view
        key; same-signature kernel specs on one run (or view) share one
        launch."""
        results: list = [None] * len(specs)
        # Per source, a run or one view of it: kernel specs by plan, and
        # the specs of the plain flat fold.
        sources: dict = {}
        for i, spec in enumerate(specs):
            prep = self._plan_scan(spec)
            if isinstance(prep, ScanResult):
                results[i] = prep
                continue
            kernels, folds = sources.setdefault(
                (id(prep.trun), prep.view_key), ({}, []))
            if prep.route in ("kernel", "mv_kernel"):
                plan = flat_agg.make_plan(
                    prep.sig.aggs, prep.sig.preds,
                    tuple(cs.col_id for cs in prep.sig.cols))
                kernels.setdefault(plan, []).append((i, prep))
            else:
                folds.append((i, prep))

        pending = []  # (device tensors, finish(host tensors))
        for kernels, folds in sources.values():
            pending += self._launch_source(kernels, folds, results)
        return _AsyncBatch(results, pending)

    def _launch_source(self, kernels: dict, folds: list,
                       results: list) -> list:
        """Queue every launch that reads one source. A view is held only
        here, so it is let go before the next source's view is resolved:
        a batch holds at most one view of a run at a time."""
        first = next(iter(kernels.values()))[0] if kernels else folds[0]
        arrays = first[1].arrays()
        pending = []
        for plan, group in kernels.items():
            params = torch.tensor(
                [plan.param_row(p.row_lo, p.row_hi, p.read_planes, p.lits)
                 for _i, p in group], dtype=torch.int32).to(self.device)
            partials = flat_agg.flat_aggregate(
                plan, plan.plane_table(arrays), params)
            folded = flat_agg.fold_partials(plan, partials)
            pending.append(([folded], _kernel_finish(plan, group, results)))
        for i, p in folds:
            fn = flat_fold.compiled_flat_aggregate(p.sig)
            ivec, fvec = fn(arrays, p.row_lo, p.row_hi, *p.read_planes,
                            p.lits)
            pending.append(([ivec, fvec], _fold_finish(i, p, results)))
        return pending

    # -- planning ------------------------------------------------------------
    def _overlapping_runs(self, spec: ScanSpec) -> list[GpuRun]:
        return [t for t in self.runs
                if t.crun.num_versions
                and not (spec.upper and t.crun.min_key >= spec.upper)
                and not t.crun.max_key < spec.lower]

    def _split_predicates(self, spec: ScanSpec):
        """(device-exact preds, preds the device can only narrow down):
        'str' prefixes and rounded 'f32' values give superset masks, and
        key-column, IN and opaque-column predicates are host-only; the
        row path that serves both is not in this slice."""
        exact, other = [], []
        for p in spec.predicates:
            if p.column in self._key_col_names or p.op == "IN":
                other.append(p)
                continue
            cid = self._name_to_id[p.column]
            if self._kinds[cid] in ("str", "f32"):
                other.append(p)
            else:
                exact.append(p)
        return exact, other

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

    def _read_planes(self, spec: ScanSpec) -> tuple:
        r_hi, r_lo = P.scalar_ht_planes(min(spec.read_ht, MAX_HT))
        e_hi, e_lo = P.scalar_ht_planes(min(spec.read_ht, MAX_HT - 1))
        return r_hi, r_lo, e_hi, e_lo

    def _plan_scan(self, spec: ScanSpec):
        """-> a finished ScanResult (nothing in range) or an _AggPrep."""
        if not spec.is_aggregate:
            raise _later("row")
        if spec.group_by or any(a.expr is not None for a in spec.aggregates):
            raise _later("grouped")
        exact, other = self._split_predicates(spec)
        if other:
            raise _later("host_preds")
        if not self._aggs_device_eligible(spec):
            raise _later("host_aggs")
        # Snapshot the memtable before the run list (as the JAX engine
        # does): a concurrent flush appends its run before swapping in an
        # empty memtable.
        mem = self.memtable
        runs = self._overlapping_runs(spec)
        mem_live = not mem.is_empty and mem.has_keys(spec.lower, spec.upper)
        if mem_live or len(runs) > 1:
            raise _later("multi_source")
        if not runs:
            return ScanResult([_agg_name(a) for a in spec.aggregates],
                              [tuple(0 if a.fn == "count" else None
                                     for a in spec.aggregates)], None, 0)
        return self._device_agg_prep(runs[0], spec, exact)

    def _device_agg_prep(self, trun: GpuRun, spec: ScanSpec,
                         exact_preds) -> _AggPrep:
        crun = trun.crun
        pred_sigs, lits = [], []
        for p in exact_preds:
            cid = self._name_to_id[p.column]
            kind = self._kinds[cid]
            pred_sigs.append(dscan.PredSig(cid, kind, p.op))
            lits.append(agg_fold.pred_literal_host(kind, p.value))
        dev_aggs, lowering = agg_fold.lower_aggs(
            spec.aggregates, self._name_to_id, self._kinds)
        R = crun.R
        # The fold's signature: a multi-version run is folded through its
        # resolved view, which is flat.
        sig = dscan.ScanSig(
            B=trun.dev.B, R=R,
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
        else:
            raise NotImplementedError(
                f"not in the port yet: a run of {sig.B} blocks x {sig.R} "
                "rows exceeds the flat fold's exact-limb bounds "
                "(ROADMAP.md §1 item 7: the windowed fold K5, beside the "
                "row path)")
        return _AggPrep(spec, trun, sig, route, crun.lower_row(spec.lower),
                        crun.upper_row(spec.upper), self._read_planes(spec),
                        tuple(lits), dev_aggs, lowering, view_key)


def _agg_name(a) -> str:
    return f"{a.fn}({a.column or '*'})"


def _agg_result(prep: _AggPrep, ivec, fvec) -> ScanResult:
    acc, scanned = agg_fold.unpack(prep.dev_aggs, ivec, fvec)
    row = tuple(agg_fold.finalize(prep.dev_aggs[di], acc[di], fn_name)
                for fn_name, di in prep.lowering)
    return ScanResult([_agg_name(a) for a in prep.spec.aggregates], [row],
                      None, scanned)


def _kernel_finish(plan, group, results):
    def finish(host):
        folded = host[0].numpy()
        for n, (i, prep) in enumerate(group):
            results[i] = _agg_result(prep, *plan.to_packed(folded[n]))
    return finish


def _fold_finish(i, prep, results):
    def finish(host):
        results[i] = _agg_result(prep, host[0].numpy(), host[1].numpy())
    return finish


class _AsyncBatch:
    """An in-flight scan batch: the device work is launched and its
    results are on their way to host memory; ``finish()`` waits for them
    and builds the ScanResults."""

    def __init__(self, results: list, pending: list):
        self.results = results
        self._finishers = []
        self._event = None
        for outs, fin in pending:
            host = [_to_host(t) for t in outs]
            self._finishers.append((host, fin))
        cuda = [t for outs, _f in pending for t in outs if t.is_cuda]
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0].device))
        self._done = False

    def finish(self) -> list[ScanResult]:
        if not self._done:
            if self._event is not None:
                self._event.synchronize()
            for host, fin in self._finishers:
                fin(host)
            self._finishers = []
            self._done = True
        return self.results


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a device tensor's copy into pinned host memory (the copy is
    complete once the batch's event has fired); CPU tensors pass."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


register_engine("gpu", GpuStorageEngine)
