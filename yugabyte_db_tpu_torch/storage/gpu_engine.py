"""GPU storage engine: the ``tablet_storage_engine=gpu`` data plane.

The first slice of the JAX package's ``storage/tpu_engine.py``: writes go
to the host memtable, ``flush`` builds a columnar run on the host and
uploads its planes to the engine's device, and single-source aggregate
scans over a flat run (one version per key, the post-compaction shape)
fold on the device:

- signatures the CUDA kernel takes (``ops.flat_agg.eligible``: COUNT,
  i32/i64 SUM/MIN/MAX, i32/i64 predicates) go through it, and the specs
  of one batch that share a signature go as ONE launch with an [N, P]
  parameter tensor (the counterpart of ``_batched_agg_fn``);
- the other flat-run signatures (f64 predicates, float aggregates) go
  through ``ops.flat_fold`` in plain PyTorch, one spec at a time.

Both return ``agg_fold.pack``'s layout, which ``unpack`` / ``finalize``
turn into a ``ScanResult``. ``rows_scanned`` is what the JAX ``tpu``
engine reports on its flat route: the rows that pass every predicate.

Everything else raises ``NotImplementedError`` naming the ROADMAP.md item
that brings it. There is no host re-serve: a device error raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.ops import agg_fold, flat_agg, flat_fold
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
    "multi_version": "runs with several versions per key (ROADMAP.md §1 "
                     "item 4: multi-version routes, K3-K5)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"not in the port yet: {_LATER[what]}")


class GpuRun:
    """A columnar run and its planes resident on the engine's device (no
    residency budget yet: a run stays resident for its lifetime)."""

    def __init__(self, crun: ColumnarRun, device: torch.device):
        self.crun = crun
        self.dev = DeviceRun(crun, PAD_BLOCKS, device=device)


@dataclass
class _AggPrep:
    """Host planning of one single-source flat aggregate."""

    spec: ScanSpec
    trun: GpuRun
    sig: dscan.ScanSig
    route: str            # "kernel" | "flat"
    row_lo: int
    row_hi: int
    read_planes: tuple    # read hi/lo, expiry hi/lo
    lits: tuple           # host predicate literals
    dev_aggs: tuple
    lowering: list


class GpuStorageEngine(StorageEngine):
    """Options: ``device`` (default ``cuda``; raises when there is no
    GPU) and ``rows_per_block`` (2048). The memtable flushes only when
    ``flush`` is called: a second run could not be scanned in this
    slice."""

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
        builds the results. Same-signature kernel specs on one run share
        one launch."""
        results: list = [None] * len(specs)
        kernel_groups: dict = {}
        fold_preps: list[tuple[int, _AggPrep]] = []
        for i, spec in enumerate(specs):
            prep = self._plan_scan(spec)
            if isinstance(prep, ScanResult):
                results[i] = prep
            elif prep.route == "kernel":
                plan = flat_agg.make_plan(
                    prep.sig.aggs, prep.sig.preds,
                    tuple(cs.col_id for cs in prep.sig.cols))
                kernel_groups.setdefault((id(prep.trun), plan), []).append(
                    (i, prep))
            else:
                fold_preps.append((i, prep))

        pending = []  # (device tensors, finish(host tensors))
        for (_run, plan), group in kernel_groups.items():
            trun = group[0][1].trun
            params = torch.tensor(
                [plan.param_row(p.row_lo, p.row_hi, p.read_planes, p.lits)
                 for _i, p in group], dtype=torch.int32).to(self.device)
            partials = flat_agg.flat_aggregate(
                plan, plan.plane_table(trun.dev.arrays), params)
            folded = flat_agg.fold_partials(plan, partials)
            pending.append(([folded], _kernel_finish(plan, group, results)))
        for i, p in fold_preps:
            fn = flat_fold.compiled_flat_aggregate(p.sig)
            ivec, fvec = fn(p.trun.dev.arrays, p.row_lo, p.row_hi,
                            *p.read_planes, p.lits)
            pending.append(([ivec, fvec], _fold_finish(i, p, results)))
        return _AsyncBatch(results, pending)

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
        trun = runs[0]
        if trun.crun.max_group_versions > 1:
            raise _later("multi_version")
        return self._device_agg_prep(trun, spec, exact)

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
        sig = dscan.ScanSig(
            B=trun.dev.B, R=R,
            K=agg_fold.safe_window_blocks(R, agg_fold.FULL_WINDOW_BLOCKS),
            cols=tuple(dscan.ColSig(c.col_id, self._kinds[c.col_id])
                       for c in self.schema.value_columns),
            preds=tuple(pred_sigs), aggs=dev_aggs, apply_preds=True,
            flat=True)
        if flat_agg.eligible(sig):
            route = "kernel"
        elif flat_fold.supports(sig):
            route = "flat"
        else:
            raise NotImplementedError(
                f"not in the port yet: a flat run of {sig.B} blocks x "
                f"{sig.R} rows exceeds the flat fold's exact-limb bounds "
                "(ROADMAP.md §1 item 4: the windowed fold, K5)")
        return _AggPrep(spec, trun, sig, route, crun.lower_row(spec.lower),
                        crun.upper_row(spec.upper), self._read_planes(spec),
                        tuple(lits), dev_aggs, lowering)


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
